"""Search-space definition for the unified autotuner — a copy of
``deepspeed_tpu/autotuning/space.py`` (pure Python): the same candidates in
the same order, the same canonical keys.

A *candidate* is a plain JSON-able ``{knob: value}`` dict; a
:class:`SearchSpace` is an ordered list of :class:`Knob`\\ s whose
cartesian product enumerates candidates in a **deterministic** order
(knob declaration order, value declaration order) — determinism is a
contract the tests pin: the same space always yields the same candidate
sequence, so seeded searches replay exactly.

Two canonical spaces cover the repo's two workloads:

- :func:`training_space` — mesh shape x ZeRO stage / ZeRO++ qwZ-qgZ x
  remat x micro-batch x quantized ZeRO collectives;
- :func:`serving_space` — TP width x serve replicas x weight quant format
  x prefill_chunk x kv_watermark x speculation (+ draft length) x
  quantized TP collectives / comm tiles.

Both run every raw product through :func:`canonicalize`, which rewrites
knob values that are *no-ops* in context (``spec_max_draft`` with
speculation off, ``quant_comm``/``comm_tiles`` without a TP mesh,
ZeRO++ quantized collectives below stage 3) to their inert form and
drops the resulting duplicates — a tuner that measures the same engine
twice under two names wastes trial budget and corrupts the leaderboard.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Sequence, Tuple


@dataclass(frozen=True)
class Knob:
    name: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        if not self.values:
            raise ValueError(f"knob {self.name!r} has no values")


def candidate_key(cand: Dict[str, Any]) -> str:
    """Stable serialization of a candidate (dedup + deterministic
    tie-breaks sort on this)."""
    return json.dumps(cand, sort_keys=True, default=str)


@dataclass
class SearchSpace:
    knobs: List[Knob] = field(default_factory=list)
    # rewrite a raw product entry to its canonical form (None = identity)
    canonicalize: Any = None

    @property
    def raw_size(self) -> int:
        n = 1
        for k in self.knobs:
            n *= len(k.values)
        return n

    def grid(self) -> Iterator[Dict[str, Any]]:
        """Deterministic candidate stream: cartesian product in knob order,
        canonicalized, deduplicated (first occurrence wins)."""
        seen = set()
        names = [k.name for k in self.knobs]
        for combo in itertools.product(*(k.values for k in self.knobs)):
            cand = dict(zip(names, combo))
            if self.canonicalize is not None:
                cand = self.canonicalize(cand)
            key = candidate_key(cand)
            if key in seen:
                continue
            seen.add(key)
            yield cand

    def candidates(self) -> List[Dict[str, Any]]:
        return list(self.grid())


# ---------------------------------------------------------------------------
# canonical spaces
# ---------------------------------------------------------------------------
def _canon_training(cand: Dict[str, Any]) -> Dict[str, Any]:
    c = dict(cand)
    # ZeRO++ quantized collectives (qwZ weight gathers / qgZ grad reduces)
    # only exist on the stage-3 gather/reduce path
    if c.get("zero_stage", 0) < 3:
        c["zero_quant"] = False
    return c


def training_space(
    micro_batches: Sequence[int] = (1, 2, 4, 8),
    remat_policies: Sequence[str] = ("none", "selective", "full"),
    zero_stages: Sequence[int] = (1, 2, 3),
    mesh_candidates: Sequence[Dict[str, int]] = ({},),
    zero_quant: Sequence[bool] = (False, True),
) -> SearchSpace:
    """Training search space.  ``mesh`` values are axis dicts understood by
    ``initialize_mesh`` (``{}`` = all-data default)."""
    return SearchSpace(
        knobs=[
            Knob("mesh", tuple(dict(m) for m in mesh_candidates)),
            Knob("zero_stage", tuple(zero_stages)),
            Knob("zero_quant", tuple(zero_quant)),
            Knob("remat", tuple(remat_policies)),
            Knob("micro_batch", tuple(micro_batches)),
        ],
        canonicalize=_canon_training,
    )


def _canon_serving(cand: Dict[str, Any],
                   longctx: bool = False) -> Dict[str, Any]:
    c = dict(cand)
    if not c.get("spec", False):
        c["spec_max_draft"] = 0  # drafter off: the knob is inert
    if c.get("tp", 1) <= 1:
        # no model axis: the row-parallel transport never runs
        c["quant_comm"] = "none"
        c["comm_tiles"] = 1
    if c.get("quant_comm", "none") == "none":
        c["comm_tiles"] = 1  # tiling only splits the quantized transport
    # pre-megastep candidate dicts (hand-tuned incumbents) canonicalize
    # onto the per-tick grid row, so candidate_key stays comparable
    c.setdefault("decode_megastep", 1)
    if c.get("spec", False):
        # the scheduler collapses a megastep to per-tick whenever live
        # speculation proposals exist, so the knob is inert under spec
        c["decode_megastep"] = 1
    # pre-seq-shard candidate dicts canonicalize onto the single-pool row
    c.setdefault("seq_shards", 1)
    if not longctx:
        # every prompt fits one replica's pool slice: striping pages over a
        # seq axis buys nothing a wider pool doesn't, so the seq_shards > 1
        # rows collapse onto their S=1 twin instead of being measured twice
        c["seq_shards"] = 1
    return c


def serving_space(
    tp: Sequence[int] = (1, 2),
    serve_replicas: Sequence[int] = (1, 2),
    quant: Sequence[Any] = (None, "int8", "fp8"),
    prefill_chunk: Sequence[Any] = (None, 128, 256),
    kv_watermark: Sequence[float] = (0.0625, 0.25),
    spec: Sequence[bool] = (False, True),
    spec_max_draft: Sequence[int] = (4,),
    quant_comm: Sequence[str] = ("none", "int8"),
    comm_tiles: Sequence[int] = (1,),
    prefix_caching: Sequence[bool] = (True,),
    decode_megastep: Sequence[int] = (1, 4),
    seq_shards: Sequence[int] = (1, 2),
    longctx: bool = False,
) -> SearchSpace:
    """Serving search space over the engine/scheduler knobs.  Values
    mirror the ``InferenceEngineV2`` constructor surface (see
    ``config.ServeEngineConfig``).

    ``roofline.serving_feasible`` only checks the structural pool split
    (``max_seqs`` / ``num_blocks`` divisibility) of ``serve_replicas`` > 1
    rows, as JAX's does; on the port those rows then reach the engine,
    which refuses them (ROADMAP queue 1 item 7), and the search records
    the refusal as the row's verdict and goes on.

    ``longctx`` is the caller's declaration that the workload's longest
    context does NOT fit one replica's pool slice; without it every
    ``seq_shards`` > 1 row canonicalizes onto its S=1 twin (seq sharding
    is a long-context capability knob — on a fits-one-pool workload it
    only adds ring hops) so the grid never measures the same effective
    config twice."""
    return SearchSpace(
        knobs=[
            Knob("tp", tuple(tp)),
            Knob("serve_replicas", tuple(serve_replicas)),
            Knob("quant", tuple(quant)),
            Knob("prefix_caching", tuple(prefix_caching)),
            Knob("prefill_chunk", tuple(prefill_chunk)),
            Knob("kv_watermark", tuple(kv_watermark)),
            Knob("spec", tuple(spec)),
            Knob("spec_max_draft", tuple(spec_max_draft)),
            Knob("quant_comm", tuple(quant_comm)),
            Knob("comm_tiles", tuple(comm_tiles)),
            Knob("decode_megastep", tuple(decode_megastep)),
            Knob("seq_shards", tuple(seq_shards)),
        ],
        canonicalize=lambda c: _canon_serving(c, longctx=longctx),
    )
