"""The current process grid and partition specs — counterpart of
``deepspeed_tpu/parallel/sharding.py`` (:45-139).

JAX installs one ambient mesh that sharding constraints and collectives
read; the port's ambient object is a ``topology.ProcessGrid``, whose axis
names resolve to process groups (``comm/comm.py``).  It lives in a
``contextvars.ContextVar`` (a thread sees the grid its own context set),
and it is only a default: each engine carries its own grid and passes it
to every collective it issues, so installing another grid reconfigures
no engine.  ``P`` is a partition
spec: one entry per dimension, ``None`` or an axis name or a tuple of
names, as ``jax.sharding.PartitionSpec`` (``tuple(P(...))`` compares with
``tuple`` of JAX's).
"""
from __future__ import annotations

import contextvars
import math

_CURRENT_MESH: contextvars.ContextVar = contextvars.ContextVar("dstpu_current_mesh",
                                                                default=None)


class P(tuple):
    """A partition spec: ``P("fsdp", None)`` shards dimension 0 over the
    ``fsdp`` axis."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def set_current_mesh(mesh) -> None:
    _CURRENT_MESH.set(mesh)


def get_current_mesh():
    return _CURRENT_MESH.get()


def axis_size(name: str) -> int:
    """Size of an axis of the current grid (1 with no grid or no such
    axis)."""
    mesh = _CURRENT_MESH.get()
    if mesh is None:
        return 1
    return mesh.spec.sizes.get(name, 1)


def collective_axis_size(axis_name) -> int:
    """The size of the group of a collective over ``axis_name`` (a name or
    a sequence of names) in the current grid."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return math.prod(axis_size(a) for a in names)


def filter_spec(shape, spec: P, mesh=None) -> P:
    """Drop the entries whose axis product does not divide their dimension
    (JAX's: tiny shapes keep working, real shapes keep the full spec)."""
    mesh = mesh if mesh is not None else _CURRENT_MESH.get()
    if mesh is None:
        return P(*([None] * len(shape)))
    sizes = mesh.spec.sizes

    def ok(dim, entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        return dim % math.prod(sizes.get(a, 1) for a in axes) == 0

    return P(*(e if (e is None or ok(d, e)) else None for d, e in zip(shape, tuple(spec))))
