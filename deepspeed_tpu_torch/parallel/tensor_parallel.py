"""Tensor parallelism over the ``model`` axis of a process grid: the
layout of one rank's shard of a ``CausalLM`` tree, and the collectives
that move between the shard and the whole (JAX runs the same layout as
GSPMD shardings over one mesh; here each rank holds its shard and the
model's forward inserts the Megatron collectives, ``models/transformer.py``).

``TensorParallel(grid, cfg)`` takes the kernels' layout from AutoTP
(``parallel.auto_tp.infer_tp_rules`` with the head counts as hints, as
JAX's v2 engine calls it) over one layer's kernels and the vocab tables:

- column-parallel (output dim on ``model``): ``wq``, ``w_gate`` / ``w_up``,
  and ``wk`` / ``wv`` when ``num_kv_heads`` divides the axis;
- row-parallel (input dim on ``model``): ``wo``, ``w_down``;
- vocab-parallel: ``embed/embedding`` (dim 0) and ``lm_head/kernel`` (dim
  1) when the vocab divides the axis (a tied head reads the embedding's
  shard), else both replicated;
- the routed experts' FFNs (JAX's rules, ``transformer.py:1166-1169``):
  ``moe/w_gate`` / ``w_up`` column-parallel and ``moe/w_down`` row-parallel
  on the FFN dim; the router stays whole.

Two rules sit on top, for what a manual region needs that GSPMD does not:

- narrowed: a replicated leaf of which each rank reads a slice --
  ``wk`` / ``wv`` when AutoTP's head gate keeps them whole (the kv heads do
  not divide the axis; the rank reads the kv head its q heads share), and
  ``lm_head/bias`` under a vocab-parallel head.  Its gradient is partial on
  each rank: the forward reads it through the ``f`` operator (identity
  forward, all-reduce backward), so the ranks' gradients sum over
  ``model`` and the leaf stays equal on every rank;
- a bias follows its kernel (``b<x>`` beside ``w<x>``): sharded with a
  column kernel, narrowed with a narrowed one, whole beside a row kernel
  (``bo`` / ``b_down`` are added once, after the all-reduce).  Norms and
  the position table stay whole (a manual lookup reads every row), with
  equal gradients on every rank.

``shard_tree`` cuts a tree of whole leaves to this rank's shard,
``gather_tree`` all-gathers a shard tree back (a collective over
``model``): what checkpoints and ``master_tree`` hold is the logical
tree, so a save at one ``model`` size loads at another.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from .auto_tp import infer_tp_rules
from .sharding import P
from .topology import MODEL_AXIS

_ITEM7 = "(ROADMAP queue 1 item 7, the distributed layers)"
_KV = ("wk", "wv")
# the routed experts' FFN dim (counted from the end): column-parallel
# w_gate / w_up [L, E, d, f], row-parallel w_down [L, E, f, d]
_MOE_COLS = {"w_gate": -1, "w_up": -1, "w_down": -2}


def _kernel_shapes(cfg) -> Dict[str, Any]:
    """One layer's kernels and the vocab tables (``[in, out]`` / ``[vocab,
    d]`` shapes): what AutoTP classifies."""
    from ..models.transformer import init_params

    tree = init_params(cfg, device="meta")
    out: Dict[str, Any] = {"layers": {}}
    for path, x in _leaf_paths(tree.get("layers", {})):
        if x.dim() == 3 and path[0] != "moe":  # [layer, in, out]; the router stays whole
            _set(out["layers"], path, tuple(x.shape[1:]))
    for path in (("embed", "embedding"), ("lm_head", "kernel")):
        if path[0] in tree:
            _set(out, path, tuple(tree[path[0]][path[1]].shape))
    return out


def _kernel_of(path: Tuple[str, ...]) -> Optional[Tuple[str, ...]]:
    """The kernel whose layout a leaf follows: a kernel its own, a bias
    ``b<x>`` its ``w<x>``, the head's bias the head's kernel; None for the
    rest (norms, the position table)."""
    name = path[-1]
    if path[0] == "pos_embed" or path[-2:-1] and path[-2].endswith("norm"):
        return None
    if path == ("lm_head", "bias"):
        return ("lm_head", "kernel")
    if path[0] == "layers" and name.startswith("b"):
        return path[:-1] + ("w" + name[1:],)
    return path


def _leaf_paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


@dataclass(frozen=True)
class Placement:
    """How one leaf lies over ``model``: ``kind`` ``shard`` (dim ``dim``
    cut in ``size`` contiguous blocks, this rank's block ``rank``),
    ``narrow`` (whole on every rank; the forward reads ``[lo, hi)`` of
    dim ``dim``) or ``rep``."""

    kind: str
    dim: int = -1
    lo: int = 0
    hi: int = 0


class TensorParallel:
    """One rank's view of the ``model`` axis for a ``TransformerConfig``:
    the group (``grid``, the axis size and this rank's index), the local
    head and width counts, and every leaf's ``Placement``."""

    def __init__(self, grid, cfg, axis: str = MODEL_AXIS, rank: Optional[int] = None,
                 size: Optional[int] = None):
        self.grid, self.axis, self.cfg = grid, axis, cfg
        self.size = int(size if size is not None else grid.axis_size(axis))
        self.rank = int(rank if rank is not None else grid.axis_rank(axis))
        tp, hq, hkv = self.size, cfg.num_heads, cfg.num_kv_heads
        if cfg.sparse_attention is not None:
            raise NotImplementedError(f"sparse_attention under a model axis is not ported "
                                      f"yet {_ITEM7}")
        if cfg.position == "alibi":
            raise NotImplementedError(f"position='alibi' under a model axis is not ported "
                                      f"yet {_ITEM7}")
        if hq % tp:
            raise ValueError(f"num_heads {hq} must be divisible by the model axis ({tp})")
        if cfg.intermediate_size % tp:
            raise ValueError(f"intermediate_size {cfg.intermediate_size} must be divisible "
                             f"by the model axis ({tp})")
        if hkv % tp and tp % hkv:
            raise NotImplementedError(
                f"num_kv_heads {hkv} neither divisible by nor a divisor of the model axis "
                f"({tp}): a rank's q heads would read more than one kv head {_ITEM7}")
        # AutoTP's rules over one layer's kernels and the vocab tables: the
        # model-axis dim of each, counted from the end (a stacked leaf's
        # layer dim stays whole)
        self._kernel_dim = {}
        for pat, spec in infer_tp_rules(_kernel_shapes(cfg), tp, vocab_size=cfg.vocab_size,
                                        num_heads=hq, num_kv_heads=hkv):
            path = tuple(re.sub(r"\\(.)", r"\1", pat[1:-1]).split("/"))
            self._kernel_dim[path] = list(spec).index(MODEL_AXIS) - len(spec)
        self.hd = cfg.hd
        self.q_heads = hq // tp
        self.kv_sharded = ("layers", "attn", "wk") in self._kernel_dim
        self.kv_heads = hkv // tp if self.kv_sharded else 1
        # the kv head of this rank's q heads (narrowed) or its first
        self.kv_head0 = (self.rank * self.kv_heads if self.kv_sharded
                         else self.rank * self.q_heads * hkv // hq)
        self.vocab_sharded = ("embed", "embedding") in self._kernel_dim
        self.vocab_local = cfg.vocab_size // tp if self.vocab_sharded else cfg.vocab_size
        self.vocab0 = self.rank * self.vocab_local if self.vocab_sharded else 0
        self.local_cfg = cfg.replace(num_heads=self.q_heads, num_kv_heads=self.kv_heads,
                                     head_dim=self.hd,
                                     intermediate_size=cfg.intermediate_size // tp)

    # ------------------------------------------------------------------
    # the layout
    # ------------------------------------------------------------------
    def placement(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Placement:
        """The leaf at ``path`` (the whole leaf's ``shape``)."""
        from ..runtime.zero import path_str

        kernel = _kernel_of(path)
        if path[:2] == ("layers", "moe") and path[-1] in _MOE_COLS:
            # the expert FFNs' columns (JAX transformer.py:1166-1169)
            dim = len(shape) + _MOE_COLS[path[-1]]
            n = shape[dim] // self.size
            return Placement("shard", dim, self.rank * n, (self.rank + 1) * n)
        if kernel in self._kernel_dim:
            dim = len(shape) + (self._kernel_dim[kernel] if kernel == path else -1)
            if kernel != path and self._kernel_dim[kernel] != -1:
                return Placement("rep")  # a row kernel's bias: added after the all-reduce
            if kernel == ("lm_head", "kernel") and kernel != path:
                return Placement("narrow", dim, self.vocab0, self.vocab0 + self.vocab_local)
            if shape[dim] % self.size:
                raise ValueError(f"{path_str(path)} {tuple(shape)}: dim {dim} does not divide "
                                 f"over the model axis ({self.size})")
            n = shape[dim] // self.size
            return Placement("shard", dim, self.rank * n, (self.rank + 1) * n)
        if kernel is not None and kernel[:2] == ("layers", "attn") and kernel[-1] in _KV:
            # AutoTP's head gate kept the kv projection whole
            lo = self.kv_head0 * self.hd
            return Placement("narrow", len(shape) - 1, lo, lo + self.kv_heads * self.hd)
        return Placement("rep")

    def placements(self, tree) -> Dict[Tuple[str, ...], Placement]:
        """Every leaf's placement; ``tree`` holds whole leaves (or their
        shapes)."""
        return {p: self.placement(p, tuple(getattr(x, "shape", x)))
                for p, x in _leaf_paths(tree)}

    def rules(self, tree) -> List[Tuple[str, P]]:
        """The layout as ``(regex, P)`` rules over the whole tree's paths (the
        ZeRO plan composes its ``fsdp`` entries with them): a sharded leaf's
        dim on ``model``; narrowed and replicated leaves none."""
        out = []
        for p, x in _leaf_paths(tree):
            pl = self.placement(p, tuple(getattr(x, "shape", x)))
            if pl.kind == "shard":
                entries = [None] * len(tuple(getattr(x, "shape", x)))
                entries[pl.dim] = MODEL_AXIS
                out.append((f"^{re.escape('/'.join(p))}$", P(*entries)))
        return out

    def sharded_paths(self, tree) -> List[Tuple[str, ...]]:
        return [p for p, pl in self.placements(tree).items() if pl.kind == "shard"]

    # ------------------------------------------------------------------
    # whole <-> shard
    # ------------------------------------------------------------------
    def shard_tree(self, tree, placements=None):
        """This rank's shard of a tree of whole leaves (copies)."""
        placements = placements or self.placements(tree)
        out: Dict[str, Any] = {}
        for p, x in _leaf_paths(tree):
            pl = placements[p]
            x = torch.as_tensor(x)
            if pl.kind == "shard":
                x = x.narrow(pl.dim, pl.lo, pl.hi - pl.lo)
            _set(out, p, x.detach().clone().contiguous())
        return out

    @torch.no_grad()
    def gather_tree(self, local, whole_shapes):
        """The tree of whole leaves from every rank's shard (an all-gather
        over ``model`` per sharded leaf; every rank calls it).  Replicated
        and narrowed leaves are this rank's own."""
        from ..comm import comm

        out: Dict[str, Any] = {}
        shapes = dict(_leaf_paths(whole_shapes))
        for p, x in _leaf_paths(local):
            pl = self.placement(p, tuple(getattr(shapes[p], "shape", shapes[p])))
            if pl.kind == "shard":
                x = comm.all_gather(x.detach().contiguous(), self.axis, axis=pl.dim,
                                    mesh=self.grid)
            _set(out, p, x)
        return out

    # ------------------------------------------------------------------
    # serving (inference/engine_v2.py, inference/engine.py)
    # ------------------------------------------------------------------
    def serving_placement(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Placement:
        """A serving rank's placement: the training one, except that the
        embedding table stays whole (a lookup needs no collective; a tied
        head reads the rank's rows of it, ``head_rows``) and a narrowed leaf
        keeps only the columns the rank reads (its kv head, its vocab
        shard's head bias): the rank's pool then holds its kv heads."""
        pl = self.placement(path, shape)
        if path[0] == "embed":
            return Placement("rep")
        if pl.kind == "narrow":
            return Placement("shard", pl.dim, pl.lo, pl.hi)
        return pl

    def shard_serving_tree(self, params):
        """This rank's shard of a serving tree, quantized leaves included
        (``ops.quantizer.shard_serving_weight``; quantize the whole tree
        first, so that the scales are the whole kernel's)."""
        from ..ops.quantizer import QUANT_TYPES, ServingQuant, shard_serving_weight

        def logical_shape(x):
            if isinstance(x, ServingQuant):
                return tuple(x.q.shape)
            if isinstance(x, QUANT_TYPES):
                return tuple(x.s.shape[:-1]) + (x.in_dim, x.s.shape[-1])
            return tuple(x.shape)

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            pl = self.serving_placement(path, logical_shape(node))
            return node if pl.kind == "rep" else shard_serving_weight(node, pl)

        return walk(params, ())

    def head_rows(self, table: torch.Tensor) -> torch.Tensor:
        """The rows of a whole embedding table that a tied head of this
        rank's vocab shard reads."""
        return table[self.vocab0:self.vocab0 + self.vocab_local]

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Every rank's vocab shard of the logits, concatenated on the last
        dim (the same bytes on every rank, so the same sampler draws the
        same tokens on every rank)."""
        if not self.vocab_sharded:
            return logits
        from ..comm import comm

        return comm.all_gather(logits.contiguous(), self.axis, axis=logits.dim() - 1,
                               mesh=self.grid)
