"""Collective enumeration of one serving dispatch and of a ZeRO-3 step — a
copy of ``deepspeed_tpu/comm/budget.py``'s arithmetic (``plan_bytes``,
``serving_tick_plan``, ``zero3_step_plan``), which the autotuner's roofline
(``autotuning/roofline.py``) reads for its wire term.  The port runs none
of these collectives yet (tensor-parallel serving and sharded training are
ROADMAP queue 1 item 7); the plans let the cost model rank the same grid
JAX's ranks, with the same numbers.

A plan is a list of :class:`PlannedCollective`; bytes follow the
``qcomm.wire_bytes`` ring convention.  ``row_psum`` entries are the
format-dependent row-parallel transports (o + down projections); the
``overhead`` entries are the format-independent gathers and combines
around them; ``seq_ring`` is the seq-sharded attention's merge hops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from . import qcomm


@dataclass(frozen=True)
class PlannedCollective:
    """``count`` identical collectives of one dispatch."""

    op: str  # qcomm op: 'all_reduce' | 'all_gather' | 'reduce_scatter' | 'all_to_all'
    n_elements: int  # full logical tensor elements (qcomm convention)
    fmt: str  # qcomm wire format ('none' | 'int8' | 'fp8')
    world: int
    count: int = 1
    none_bytes_per_el: int = 4
    label: str = ""
    overhead: bool = False  # format-independent wire around the transports

    @property
    def bytes_on_wire(self) -> int:
        """Per-device sent bytes for all ``count`` instances."""
        return self.count * qcomm.wire_bytes(
            self.op, self.n_elements, self.fmt, self.world,
            none_bytes_per_el=self.none_bytes_per_el,
        )


def plan_bytes(plan: List[PlannedCollective],
               overhead: Optional[bool] = None) -> int:
    """Total per-device wire bytes of a plan; ``overhead`` filters to the
    transport (False) or overhead (True) subset."""
    return sum(c.bytes_on_wire for c in plan
               if overhead is None or c.overhead == overhead)


def serving_tick_plan(
    cfg,
    n_tokens: int,
    tp: int,
    fmt: str = "none",
    *,
    tiles: int = 1,
    sample_rows: int = 0,
    compute_itemsize: Optional[int] = None,
    seq_shards: int = 1,
    replicas: int = 1,
) -> List[PlannedCollective]:
    """Collectives of ONE serving dispatch (decode tick / packed prefill /
    verify) running ``n_tokens`` activation rows on a ``tp``-way model
    axis.  Empty without TP and without seq sharding.

    - 2 row-parallel transports per layer (o + down), ``n_tokens x hidden``
      at the engine's ``fmt``.  With ``tiles`` > 1 each
      projection splits into free-dim tiles reduced independently, and a
      QUANTIZED tile pads to a ``tp * chunk`` multiple before it ships —
      at small widths that padding is real extra wire, so the plan
      models per-tile padded payloads instead of the naive
      ``n_tokens x hidden`` total;
    - 1 embedding-combine all-reduce, ``n_tokens x hidden`` in the compute
      dtype (the vocab-sharded table's gather reduces partial rows);
    - 2 activation all-gathers per layer, ``n_tokens x hidden`` (the
      residual stream stays hidden-sharded between row psums; each
      column-parallel block input re-gathers), plus the pre-head gather
      of the ``sample_rows`` rows actually scored;
    - with ``seq_shards`` (S) > 1, the paged-attention log-sum-exp ring:
      ``S-1`` nearest-neighbour ``collective_permute`` hops per layer, each
      carrying the fp32 ``[rows, heads, head_dim+2]`` flash accumulator at
      its LOCAL shard shape (``rows/replicas`` batch rows, ``heads/tp``
      query heads) — the one transport the seq axis costs.
    """
    if tp <= 1 and seq_shards <= 1:
        return []
    import torch

    itemsize = (compute_itemsize if compute_itemsize is not None
                else torch.empty((), dtype=cfg.dtype).element_size())
    d = cfg.hidden_size
    n_proj = 2 * cfg.num_layers  # o + down per layer, both [n_tokens, d]
    plan: List[PlannedCollective] = []
    if seq_shards > 1:
        hq_local = (cfg.num_heads // tp if tp > 1 and cfg.num_heads % tp == 0
                    else cfg.num_heads)
        rows = -(-n_tokens // max(replicas, 1))
        plan.append(PlannedCollective(
            op="collective_permute",
            n_elements=rows * hq_local * (cfg.hd + 2),
            fmt="none", world=seq_shards,
            count=(seq_shards - 1) * cfg.num_layers,
            none_bytes_per_el=4,  # fp32 accumulator, regardless of cfg dtype
            label="seq_ring",
        ))
    if tp <= 1:
        return plan
    tiles_eff = tiles if (tiles > 1 and d >= tiles) else 1
    if tiles_eff == 1 and fmt == "none":
        plan.append(PlannedCollective(
            op="all_reduce", n_elements=n_tokens * d, fmt=fmt, world=tp,
            count=n_proj, none_bytes_per_el=itemsize, label="row_psum",
        ))
    else:
        # per-tile widths (ceil split of the out dim, trailing remainder)
        tile_n = -(-d // tiles_eff)
        widths: dict = {}
        lo = 0
        while lo < d:
            w_i = min(tile_n, d - lo)
            widths[w_i] = widths.get(w_i, 0) + 1
            lo += tile_n
        for w_i, k in sorted(widths.items()):
            n_el = n_tokens * w_i
            if fmt != "none":
                # qcomm pads each quantized all-reduce to a tp*chunk
                # multiple before the wire hops
                n_el = -(-n_el // (tp * qcomm.DEFAULT_CHUNK)) \
                    * tp * qcomm.DEFAULT_CHUNK
            plan.append(PlannedCollective(
                op="all_reduce", n_elements=n_el, fmt=fmt, world=tp,
                count=n_proj * k, none_bytes_per_el=itemsize,
                label="row_psum",
            ))
    plan.append(PlannedCollective(
        op="all_reduce", n_elements=n_tokens * d, fmt="none", world=tp,
        count=1, none_bytes_per_el=itemsize, label="embed_combine",
        overhead=True,
    ))
    plan.append(PlannedCollective(
        op="all_gather", n_elements=n_tokens * d, fmt="none", world=tp,
        count=2 * cfg.num_layers, none_bytes_per_el=itemsize,
        label="block_input_gather", overhead=True,
    ))
    if sample_rows > 0:
        plan.append(PlannedCollective(
            op="all_gather", n_elements=sample_rows * d, fmt="none",
            world=tp, count=1, none_bytes_per_el=itemsize,
            label="head_input_gather", overhead=True,
        ))
    return plan


def zero3_step_plan(n_params: int, fsdp: int, fmt: str = "none",
                    micro_batches: int = 1,
                    gather_bytes_per_el: int = 2) -> List[PlannedCollective]:
    """Per-micro-step ZeRO-3 wire plan: one parameter all-gather (bf16, or
    int8 under ZeRO++ qwZ) + one gradient reduce-scatter (fp32, or int8
    under qgZ) over the full parameter count — the arithmetic
    ``roofline.predict_train_cost`` reads."""
    if fsdp <= 1:
        return []
    return [
        PlannedCollective(
            op="all_gather", n_elements=n_params, fmt=fmt, world=fsdp,
            count=micro_batches, none_bytes_per_el=gather_bytes_per_el,
            label="param_gather",
        ),
        PlannedCollective(
            op="reduce_scatter", n_elements=n_params, fmt=fmt, world=fsdp,
            count=micro_batches, none_bytes_per_el=4, label="grad_reduce",
        ),
    ]
