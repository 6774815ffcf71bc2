"""AutoTP: tensor-parallel rules inferred from a parameter tree —
counterpart of ``deepspeed_tpu/parallel/auto_tp.py`` (:56
``infer_tp_rules``, :180 ``infer_tp_rules_stacked``).

The reference's ``module_inject/auto_tp.py:193`` classifies each
``nn.Linear`` as column-parallel or row-parallel and swaps modules; JAX
(and this port) classify parameter *paths and shapes* instead and emit
``(regex, P)`` rules that ``runtime.zero.match_rules`` reads:

- names matching the ROW patterns (out / down / o_proj / fc2 / wo ...)
  shard their INPUT dim on ``model`` (their outputs are partial sums the
  caller all-reduces);
- other 2D+ weights shard their OUTPUT dim (column-parallel), attention
  projections only at head granularity when head counts are given (a split
  below one head would cut rotary's pairs and the per-head attention);
- embedding-like leaves shard the vocab dim;
- biases follow their producer: a bias of a column-parallel output shards
  with it, a row-parallel layer's bias stays whole (added once, after the
  all-reduce); a quantized kernel's per-output-channel scale (``.../s``)
  shards with a column-parallel kernel and stays whole for a row one;
- a dim that the axis size does not divide keeps its leaf replicated.

The tree is a nested dict of tensors (or of shapes), and a quantized
serving leaf (``ops.quantizer.ServingQuant`` / ``ServingQuantFP6``) is
walked as JAX's pytree walks it: ``q`` / ``s`` (a NamedTuple's fields),
or ``0`` / ``1`` (the FP6 class's children tuple; its scale then rules by
shape alone, as in JAX).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from .sharding import P
from .topology import MODEL_AXIS

# the reference's auto_tp policy vocabulary (module_inject/auto_tp.py:270-330)
ROW_PATTERNS = (
    r"o_proj", r"down_proj", r"out_proj", r"dense_4h_to_h", r"fc2", r"wo\b",
    r"w_down", r"w2\b", r"attention\.dense", r"self_attention\.dense",
    r"mlp\.dense_4h_to_h", r"proj_out",
)
EMBED_PATTERNS = (r"embed", r"wte", r"word_embeddings", r"lm_head", r"tok_embeddings")
# attention projections shard at HEAD granularity only (JAX :38-44)
Q_PATTERNS = (r"wq\b", r"q_proj", r"/query\b", r"/bq\b")
KV_PATTERNS = (r"wk\b", r"wv\b", r"k_proj", r"v_proj", r"query_key_value",
               r"\bqkv", r"/key\b", r"/value\b", r"/b[kv]\b")


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Tuple[int, ...]]]:
    """``(path, shape)`` of every leaf in JAX's flattening order (dict keys
    sorted; a quantized leaf's fields in their declared order)."""
    from ..ops.quantizer import ServingQuant, ServingQuantFP6

    out: List[Tuple[str, Tuple[int, ...]]] = []

    def shape(x):
        return tuple(x.shape) if hasattr(x, "shape") else tuple(x)

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, ServingQuant):
            walk(node.q, path + "/q")
            walk(node.s, path + "/s")
        elif isinstance(node, ServingQuantFP6):  # JAX's pytree children: a tuple
            walk(node.packed, path + "/0")
            walk(node.s, path + "/1")
        else:
            out.append((path, shape(node)))

    walk(tree, prefix)
    return out


def infer_tp_rules(params_or_shapes: Any, model_axis_size: int,
                   vocab_size: Optional[int] = None, num_heads: Optional[int] = None,
                   num_kv_heads: Optional[int] = None) -> List[Tuple[str, P]]:
    """``(regex, P)`` rules for every shardable leaf, exact paths escaped
    (JAX ``infer_tp_rules``): ``runtime.zero.plan_sharding(tp_rules=...)``
    and ``match_rules`` take them.  ``num_heads`` / ``num_kv_heads`` gate
    the attention projections: with a hint given, q / k / v shard their
    out-features only when the head count divides the axis (GQA with
    ``num_kv_heads < tp`` keeps wk / wv replicated)."""
    flat = flatten_with_paths(params_or_shapes)
    rules: List[Tuple[str, P]] = []
    col_out_sizes: Dict[int, bool] = {}
    col_parent_dirs: Dict[str, bool] = {}

    def divides(dim: int) -> bool:
        return model_axis_size > 0 and dim % model_axis_size == 0

    def heads_ok(lower: str) -> bool:
        is_kv = any(re.search(p, lower) for p in KV_PATTERNS)
        is_q = any(re.search(p, lower) for p in Q_PATTERNS)
        if is_kv and num_kv_heads is not None and num_kv_heads % model_axis_size:
            return False
        if (is_q or is_kv) and num_heads is not None and num_heads % model_axis_size:
            return False
        return True

    # pass 1: 2D+ weights (a quantized scale waits for pass 2: its trailing
    # dim is its kernel's out dim)
    for path, shape in flat:
        if len(shape) < 2 or path.endswith("/s"):
            continue
        lead = len(shape) - 2  # stacked layer / expert dims stay whole
        fan_in, fan_out = shape[-2], shape[-1]
        entry: List[Any] = [None] * len(shape)
        lower = path.lower()
        if any(re.search(p, lower) for p in EMBED_PATTERNS):
            v_dims = [i for i, d in enumerate(shape)
                      if vocab_size and d == vocab_size and divides(d)]
            if v_dims:
                # a head kernel [..., in, vocab] shards its trailing vocab
                # dim, a table [vocab, d] its first
                pick = v_dims[-1] if re.search(r"head", lower) else v_dims[0]
                entry[pick] = MODEL_AXIS
                rules.append((f"^{re.escape(path)}$", P(*entry)))
                if pick == len(shape) - 1:
                    col_parent_dirs[path.rsplit("/", 1)[0]] = True
            continue
        if any(re.search(p, lower) for p in ROW_PATTERNS):
            if divides(fan_in):
                entry[lead] = MODEL_AXIS
                rules.append((f"^{re.escape(path)}$", P(*entry)))
            continue
        if divides(fan_out) and heads_ok(lower):
            entry[lead + 1] = MODEL_AXIS
            col_out_sizes[fan_out] = True
            col_parent_dirs[path.rsplit("/", 1)[0]] = True
            rules.append((f"^{re.escape(path)}$", P(*entry)))

    # pass 2: biases and quantized scales follow column-parallel outputs;
    # norms and the rest replicate by omission
    for path, shape in flat:
        if len(shape) < 1:
            continue
        lower = path.lower()
        if path.endswith("/s"):
            if col_parent_dirs.get(path.rsplit("/", 1)[0]) and divides(shape[-1]):
                entry = [None] * len(shape)
                entry[-1] = MODEL_AXIS
                rules.append((f"^{re.escape(path)}$", P(*entry)))
            continue
        if len(shape) >= 2:
            continue
        if "bias" in lower or re.search(r"/b[qkv]$", path):
            if any(re.search(p, lower) for p in ROW_PATTERNS):
                continue  # added once, after the all-reduce
            if re.search(r"/b[kv]$", path) and num_kv_heads is not None \
                    and num_kv_heads % model_axis_size:
                continue  # its kv projection is replicated
            if col_out_sizes.get(shape[-1]) and divides(shape[-1]):
                rules.append((f"^{re.escape(path)}$", P(MODEL_AXIS)))
    return rules


def infer_tp_rules_stacked(params_or_shapes: Any, model_axis_size: int,
                           vocab_size: Optional[int] = None) -> List[Tuple[str, P]]:
    """Stacked ``[L, in, out]`` trees: the same classification (the leading
    dims are skipped anyway)."""
    return infer_tp_rules(params_or_shapes, model_axis_size, vocab_size)
