"""Decoder-only transformer — counterpart of ``deepspeed_tpu/models/
transformer.py``: the building blocks serving reads, and the training half
(``decoder_layer``, ``forward`` with remat,
``cross_entropy_loss`` and the ``CausalLM`` adapter ``initialize`` takes).

Parameters keep the JAX layout so converting a JAX checkpoint is a copy: a
nested dict with stacked ``[L, ...]`` layer weights and ``[in, out]``
kernels (``params_from_numpy``).  ``forward`` is a Python loop over the
stacked layers (JAX scans them), each layer under a remat policy (JAX
``transformer.py:683-710``):

- ``none``; ``full``: the layer under ``torch.utils.checkpoint``;
- ``selective``: the JAX save set (q, k, v and the attention output,
  ``transformer.py:306-313``) without a selective-checkpoint policy: norm,
  q/k/v and rope run under one checkpoint, the flash attention Function
  outside it (it saves q/k/v/o/lse itself), and the output projection,
  residual, MLP norm, MLP and residual under a second checkpoint;
- ``dots`` (``checkpoint_dots_with_no_batch_dims``): the layer under one
  checkpoint whose selective policy saves the outputs of ``aten.mm`` /
  ``aten.addmm`` — the projections whose outputs the backward reads, as
  JAX saves them — and recomputes the rest.  The attention's batched products are not among
  them, and the flash kernels launch through ``ctypes`` where no policy
  sees them, so the attention forward runs again in the backward, as in
  JAX;
- ``offload`` (``save_and_offload_only_these_names``): ``selective``'s
  structure with nothing of the attention kept on the device: what the
  attention saves (q, k, v, o and the kernel's lse) and the output that
  the second checkpoint keeps (o again: one host copy serves both) go to
  host memory (pinned on CUDA) and come back in the backward.  The layer
  input stays on the device, as JAX keeps it.

A ``sparse_attention`` layout (``ops/sparse_attention.py``, set by
``initialize`` from the config) routes attention through
``block_sparse_attention``; ALiBi does not compose with it, as in JAX.

``moe_num_experts > 0`` turns the MLP into Mixtral-style top-k routed
experts (``moe/layer.py``): ``moe_block`` (capacity and drops) without a
cache, ``moe_block_dropless`` with one, as JAX routes them; ``forward``
sums the layers' aux losses and ``CausalLM.loss_fn`` adds ``coef * aux /
L``.  ``moe_qcomm`` only acts on an expert mesh axis, which one card does
not have (item 7), so it changes nothing here, as in JAX without one.

The dense KV cache (``init_kv_cache``; the v1 engine ``inference/
engine.py``): ``forward(cache=, cache_index=)`` writes each layer's k / v
at ``cache_index`` and attends over the whole cache with the queries at
that offset.  The attention body is chosen as JAX's flash entry chooses it
(``flash_supports``, JAX ``flash_kernel.supports``): the flash kernel where
that predicate holds, the plain body everywhere else (a cache longer than
the queries, a non-zero offset); ``CACHE_ATTENTION`` counts each body's
calls.

Progressive layer drop (``runtime/progressive_layer_drop.py``):
``forward(layer_keep=...)`` takes a host mask of the layers to run and
skips the others outright — nothing is launched for a dropped layer, as
JAX's ``lax.cond`` runs one branch (``transformer.py:662-680``), so it is
the identity and its weights get no gradient.  A batch carries the mask
as ``layer_keep`` (the engine draws it; a test can pass the mask JAX drew)
or, as in JAX, a ``pld_theta`` to draw it from (``CausalLM.prepare_batch``).

``act_quant_bits`` (set by ``initialize`` / ``compression.init_compression``
from ``compression_training.activation_quantization``) fake-quantizes the
attention input and the MLP input with a straight-through estimator (JAX
``transformer.py:480-505``); a parallel block's MLP reads the quantized
attention input, as in JAX.

Manual Megatron tensor parallelism (JAX ``decoder_layer``'s ``tp_axis``,
``transformer.py:421-540``): a ``parallel.context.ParallelContext`` with a
``TensorParallel`` (``par.tp``; ``CausalLM.par``, or ``forward(par=...)``)
runs each rank's shard of the tree — the local heads and MLP columns, the
row-parallel ``wo`` / ``w_down`` — between the ``f`` / ``g`` pair over
``model``: ``f`` (``par.copy``, JAX ``_tp_copy_fn``) is the identity
forward and all-reduces its gradient, ``g`` (``par.reduce``, JAX
``_tp_psum_fn``) all-reduces the row-parallel partial sums forward and
passes the gradient through.  A row-parallel bias is added once, after ``g``.  The
embedding and the head are vocab-parallel where the vocab divides the
axis: a masked lookup then ``g``; the head's local logits go to
``vocab_parallel_cross_entropy`` (the max and the sum of exponentials
all-reduced, the label's logit from the rank that owns it), which equals
``cross_entropy_loss`` over the whole logits and never forms them.
``tp_rules(cfg)`` is JAX's rule list (GSPMD's layout; a rank's shard
follows AutoTP's, ``parallel/tensor_parallel.py``).

``domino_chunks`` (JAX ``transformer.py:620-650``): each layer runs its
batch in ``C`` row chunks, one after another, and concatenates them; the
value is that of one chunk (only the collectives' overlap would differ).
With MoE it is a ``ValueError``, as in JAX.

Sequence parallelism (``sequence_parallel`` ``ulysses`` / ``ring``, JAX
``transformer.py:540-570``) and the routed experts across ranks run
through ``CausalLM.par`` (a ``parallel.context.ParallelContext``): under a
``seq`` axis the loss takes the label shift first, then this rank's slice
of the positions (their places in the whole sequence for RoPE and learned
positions); the segment ids reach the attention whole.  A length the axis
does not divide raises (JAX pads it).

Not ported, refused with ``NotImplementedError`` naming the option and its
ROADMAP queue-1 item: ``CausalLM(stack_apply=...)`` (item 7: pipeline).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from ..moe.layer import moe_block, moe_block_dropless, routed_ffn_ep
from ..ops.attention import dot_product_attention, get_attention_impl
from ..ops.kernels import resolve_device
from ..ops.kernels.flash_attention import flash_attention
from ..ops.quantizer import ServingQuant, ServingQuantFP6
from ..ops.sparse_attention import block_sparse_attention
from ..parallel.topology import MODEL_AXIS

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1408
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 8  # < num_heads => GQA
    head_dim: Optional[int] = None  # default hidden_size // num_heads
    max_seq_len: int = 2048
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    activation: str = "silu"  # 'silu' | 'gelu' | 'relu'
    gated_mlp: bool = True
    position: str = "rope"  # 'rope' | 'learned' | 'alibi' | 'none'
    rope_theta: float = 500_000.0
    rotary_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logits_soft_cap: Optional[float] = None
    parallel_block: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    embedding_norm: bool = False
    head_bias: bool = False
    # MoE (Mixtral): > 0 turns the MLP into a top-k routed expert layer
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    # the expert-parallel wire format (JAX routed_ffn_ep); acts only on an
    # expert mesh axis > 1, which one card does not have
    moe_qcomm: Optional[str] = None
    dtype: torch.dtype = torch.bfloat16
    # training
    remat: str = "none"  # 'none' | 'full' | 'selective' | 'dots' | 'offload'
    attn_impl: str = "reference"  # 'reference' | 'math' | 'flash' | 'auto'
    loss_chunk_size: int = 0  # chunked logits + loss; 0 = full logits
    # block-sparse layout (ops/sparse_attention.SparsityConfig), set by
    # initialize() from the config's sparse_attention section
    sparse_attention: Optional[Any] = None
    # activation fake-quant bits (compression); None or 0 = off
    act_quant_bits: Optional[int] = None
    # sequence parallelism is refused so far (see the module docstring)
    sequence_parallel: str = "none"
    # batch chunks a layer runs one after another (JAX's Domino overlap)
    domino_chunks: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def param_count(self) -> int:
        d, f, L, v = self.hidden_size, self.intermediate_size, self.num_layers, self.vocab_size
        hq, hkv, hd = self.num_heads, self.num_kv_heads, self.hd
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        mlp = (3 if self.gated_mlp else 2) * d * f
        if self.moe_num_experts > 0:
            mlp = mlp * self.moe_num_experts + d * self.moe_num_experts
        per_layer = attn + mlp + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return L * per_layer + emb + d

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None, keep: Optional[Callable] = None) -> Params:
    """Random parameters in the JAX layout (normal / sqrt(fan_in), norms at
    1, biases at 0), drawn from a ``torch.Generator`` seeded with ``seed``,
    on ``device`` (CUDA unless the caller names another; see
    ``ops.kernels.resolve_device``; ``"meta"`` gives the shapes alone).
    The numbers differ from JAX ``init_params`` for the same seed; tests
    that compare the two packages use ``params_from_numpy`` instead.

    ``keep(path, w)``, when given, takes each random leaf as it is drawn
    (``path`` a tuple of keys) and returns what the tree holds in its
    place: a caller that keeps a slice of each leaf holds one whole leaf at
    a time (``runtime/zero.py`` ``DeferredParams``)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    gen = torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)
    d, f, L, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd

    def dense(shape, fan_in, path):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        w = (w * fan_in ** -0.5).to(dtype)
        return keep(path, w) if keep is not None else w

    def const(shape, val):
        return torch.full(shape, val, device=device, dtype=dtype)

    layers: Params = {
        "attn": {
            "wq": dense((L, d, hq * hd), d, ("layers", "attn", "wq")),
            "wk": dense((L, d, hkv * hd), d, ("layers", "attn", "wk")),
            "wv": dense((L, d, hkv * hd), d, ("layers", "attn", "wv")),
            "wo": dense((L, hq * hd, d), hq * hd, ("layers", "attn", "wo")),
        },
        "attn_norm": {"scale": const((L, d), 1.0)},
    }
    if cfg.moe_num_experts > 0:
        E = cfg.moe_num_experts
        moe = ("layers", "moe")
        layers["moe"] = {"router": dense((L, d, E), d, moe + ("router",)),
                         "w_gate": dense((L, E, d, f), d, moe + ("w_gate",)),
                         "w_up": dense((L, E, d, f), d, moe + ("w_up",)),
                         "w_down": dense((L, E, f, d), f, moe + ("w_down",))}
    else:
        mlp = ("layers", "mlp")
        layers["mlp"] = {"w_up": dense((L, d, f), d, mlp + ("w_up",)),
                         "w_down": dense((L, f, d), f, mlp + ("w_down",))}
        if cfg.gated_mlp:
            layers["mlp"]["w_gate"] = dense((L, d, f), d, mlp + ("w_gate",))
    if not cfg.parallel_block:  # a parallel block shares attn_norm
        layers["mlp_norm"] = {"scale": const((L, d), 1.0)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            layers["attn"][name] = const((L, width), 0.0)
    if cfg.attn_out_bias:
        layers["attn"]["bo"] = const((L, d), 0.0)
    if cfg.mlp_bias and "mlp" in layers:
        layers["mlp"]["b_up"] = const((L, f), 0.0)
        layers["mlp"]["b_down"] = const((L, d), 0.0)
        if cfg.gated_mlp:
            layers["mlp"]["b_gate"] = const((L, f), 0.0)
    params: Params = {
        "embed": {"embedding": dense((v, d), d, ("embed", "embedding"))},
        "layers": layers,
        "final_norm": {"scale": const((d,), 1.0)},
    }
    if cfg.position == "learned":
        params["pos_embed"] = {"embedding": dense((cfg.max_seq_len, d), d,
                                                 ("pos_embed", "embedding"))}
    if cfg.embedding_norm:
        params["embed_norm"] = {"scale": const((d,), 1.0)}
    if cfg.norm == "layernorm":
        for name in ("attn_norm", "mlp_norm"):
            if name in layers:
                layers[name]["bias"] = torch.zeros_like(layers[name]["scale"])
        params["final_norm"]["bias"] = torch.zeros_like(params["final_norm"]["scale"])
        if cfg.embedding_norm:
            params["embed_norm"]["bias"] = const((d,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense((d, v), d, ("lm_head", "kernel"))}
        if cfg.head_bias:
            params["lm_head"]["bias"] = const((v,), 0.0)
    return params


_FP8_NUMPY = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _payload(a) -> torch.Tensor:
    """A numpy array as a tensor of the same type, bytes unchanged: fp8
    (ml_dtypes) goes through a uint8 view, never through float."""
    a = np.asarray(a)
    if a.dtype.name in _FP8_NUMPY:
        return torch.from_numpy(a.view(np.uint8).copy()).view(_FP8_NUMPY[a.dtype.name])
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_numpy(tree, cfg: TransformerConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The JAX parameter tree, after ``jax.tree_util.tree_map(np.asarray,
    ...)`` (a nested dict of numpy arrays), as the port's parameters: the
    same nested dict of tensors on ``device`` (CUDA unless the caller names
    another) in ``dtype`` (default ``cfg.dtype``).  The layouts are
    identical, so this is a copy.  A tree quantized by JAX
    ``quantize_serving_params`` keeps its payloads as they are: a
    ``ServingQuant`` leaf becomes the port's with its int8 / e4m3 bytes and
    fp32 scales, a ``ServingQuantFP6`` leaf the port's with its uint8 planes,
    scales and ``in_dim``."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "packed"):  # JAX ServingQuantFP6
            return ServingQuantFP6(_payload(x.packed).to(device), _payload(x.s).to(device),
                                   x.in_dim, x.row_shards)
        if hasattr(x, "q") and hasattr(x, "s"):  # JAX ServingQuant
            return ServingQuant(_payload(x.q).to(device), _payload(x.s).to(device))
        a = np.array(x, dtype=np.float32)  # a writable copy
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    return conv(tree)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def norm(x: torch.Tensor, w: Params, kind: str, eps: float) -> torch.Tensor:
    """RMS/LayerNorm: fp32 math, cast back to ``x``'s type, then ``* scale``
    (+ bias) — the JAX order of operations."""
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf.to(x.dtype) * w["scale"]
    if "bias" in w:
        out = out + w["bias"]
    return out


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) [b, s, 1, d/2] for per-token ``positions`` [b, s] or [s];
    computed once per dispatch and shared by every layer's q and k."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].float() * freqs[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (NOT interleaved), fp32, cast back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, [b, s, h, d] with ``positions`` [b, s] or [s]."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def mlp_block(lw: Params, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    act = _activation(cfg.activation)
    up = x @ lw["w_up"]
    if "b_up" in lw:
        up = up + lw["b_up"]
    if cfg.gated_mlp:
        gate = x @ lw["w_gate"]
        if "b_gate" in lw:
            gate = gate + lw["b_gate"]
        h = act(gate) * up
    else:
        h = act(up)
    out = h @ lw["w_down"]
    if "b_down" in lw:
        out = out + lw["b_down"]
    return out


def head_kernel(params: Params, cfg: TransformerConfig):
    """[d, v] output projection (transposed embedding when tied): a tensor,
    or in a quantized serving tree the ``ServingQuant`` /
    ``ServingQuantFP6`` that ``serving_mm`` takes as it is."""
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].t().to(cfg.dtype)
    return params["lm_head"]["kernel"]


def head_bias_vec(params: Params):
    """[v] lm_head bias or None (a quantized head keeps its bias plain)."""
    lm = params.get("lm_head")
    return lm.get("bias") if lm else None


def lm_logits(params: Params, cfg: TransformerConfig, h: torch.Tensor) -> torch.Tensor:
    """Final hidden states [..., d] -> logits [..., v]: the output
    projection and, where the tree has one, the lm_head bias."""
    out = h @ head_kernel(params, cfg)
    hb = head_bias_vec(params)
    return out + hb if hb is not None else out


# ---------------------------------------------------------------------------
# training half
# ---------------------------------------------------------------------------
_REMAT = ("none", "full", "selective", "dots", "offload")
_SEQUENCE_PARALLEL = ("none", "ulysses", "ring")
# remat="dots": the products with no batch dims, as torch dispatches them
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_context(unread: tuple):
    """The selective-checkpoint contexts of ``remat="dots"``: save the
    outputs of the unbatched products, recompute the rest.  A product
    whose weight is one of ``unread`` (by address) only feeds the residual
    sum, which the backward never reads, so JAX's residuals leave it out,
    and so does this policy."""
    def policy(ctx, op, *args, **kwargs):
        if op in _DOTS and args[-1].data_ptr() not in unread:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


# bytes that remat="offload" moved between a CUDA device and the host
OFFLOAD_BYTES = {"to_host": 0, "to_device": 0}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a saved tensor (pinned, copied without a sync, from a
    CUDA tensor; a CPU tensor is already there)."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    OFFLOAD_BYTES["to_host"] += t.numel() * t.element_size()
    return host.copy_(t, non_blocking=True)


def offload_saved(keep_on_device: Callable[[torch.Tensor], bool], copies: list):
    """Hooks that send every tensor saved for the backward inside the block
    to host memory, except those ``keep_on_device`` names, and bring each
    back to its device when the backward reads it (``remat="offload"``).
    ``copies`` holds (weak reference, host copy) pairs: a tensor saved
    twice is copied once."""

    def pack(t):
        if keep_on_device(t):
            return t
        for ref, host in copies:
            if ref() is t:
                return t.device, host
        host = _to_host(t)
        copies.append((weakref.ref(t), host))
        return t.device, host

    def unpack(saved):
        if isinstance(saved, torch.Tensor):
            return saved
        device, host = saved
        if device.type == "cuda":
            OFFLOAD_BYTES["to_device"] += host.numel() * host.element_size()
        return host.to(device, non_blocking=True)

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def _refuse_unported(cfg: TransformerConfig) -> None:
    """Raise for a JAX option the port does not run, or a value JAX does not
    take; never run a different computation quietly."""
    if cfg.sequence_parallel not in _SEQUENCE_PARALLEL:
        raise ValueError(f"unknown sequence_parallel {cfg.sequence_parallel!r}; use one of "
                         f"{_SEQUENCE_PARALLEL}")
    if cfg.sequence_parallel != "none" and cfg.position == "alibi":
        raise NotImplementedError(f"position='alibi' with sequence_parallel="
                                  f"{cfg.sequence_parallel!r}: the sequence-parallel bodies "
                                  "take no bias operand (as in JAX)")
    if cfg.sparse_attention is not None and cfg.position == "alibi":
        raise NotImplementedError("position='alibi' with sparse_attention: the block-sparse "
                                  "bodies take no bias operand (as in JAX)")
    if cfg.remat not in _REMAT:
        raise ValueError(f"unknown remat policy {cfg.remat!r}; use one of {_REMAT}")
    if cfg.domino_chunks < 1:
        raise ValueError(f"domino_chunks must be >= 1, got {cfg.domino_chunks}")
    if cfg.domino_chunks > 1 and cfg.moe_num_experts > 0:
        raise ValueError("domino_chunks does not compose with MoE (per-chunk routing "
                         "capacity changes token dropping)")


def get_attn_fn(cfg: TransformerConfig, device, par=None) -> Callable:
    """The attention body of ``cfg`` on ``device`` (JAX ``_get_attn_fn``):
    a sparse layout routes to ``block_sparse_attention``; ALiBi needs the
    reference body, the only one with a bias operand.  Sequence
    parallelism wraps the body: ``ulysses`` in ``DistributedAttention``
    (the base on a rank's heads at the whole sequence), ``ring`` replaces
    it by ``ring_attention``, each over the ``seq`` axis of ``par`` (a
    ``parallel.context.ParallelContext``); a ``seq`` axis above 1 under
    ``none`` runs the body over the gathered sequence and keeps the rank's
    rows (JAX's GSPMD gathers it for its attention)."""
    if cfg.position == "alibi" and (cfg.attn_impl not in ("reference", "math")
                                    or cfg.sparse_attention is not None
                                    or cfg.sequence_parallel != "none"):
        raise NotImplementedError(
            "position='alibi' requires attn_impl='reference' without sparse attention or "
            "sequence parallelism")
    if cfg.position == "alibi" and par is not None and par.seq > 1:
        raise NotImplementedError("position='alibi' over a seq axis: the bias of the gathered "
                                  "sequence is not ported (ROADMAP queue 1 item 7)")
    if cfg.sparse_attention is not None:
        base = functools.partial(block_sparse_attention, config=cfg.sparse_attention)
    else:
        base = get_attention_impl(cfg.attn_impl, device)
    if cfg.sequence_parallel == "ulysses":
        from ..sequence.layer import DistributedAttention

        return DistributedAttention(base, par)
    if cfg.sequence_parallel == "ring":
        from ..sequence.ring import ring_attention

        return functools.partial(ring_attention, par=par)
    if par is not None and par.seq > 1:
        from ..sequence.ring import gathered_attention

        return functools.partial(gathered_attention, base=base, par=par)
    return base


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes: the geometric sequence 2^(-8/n) with the
    standard extension for a head count that is not a power of 2."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    n = 2 ** int(math.floor(math.log2(num_heads)))
    slopes = pow2_slopes(n)
    if n < num_heads:
        slopes += pow2_slopes(2 * n)[0::2][: num_heads - n]
    return torch.tensor(slopes, dtype=torch.float32)


def alibi_bias(num_heads: int, q_positions: torch.Tensor,
               kv_positions: torch.Tensor) -> torch.Tensor:
    """Additive bias ``-slope_h * max(q_pos - k_pos, 0)``: [h, sq, skv] for
    [s] positions, [b, h, sq, skv] when either is per batch row [b, s]."""
    batched = q_positions.dim() == 2 or kv_positions.dim() == 2
    q2 = q_positions if q_positions.dim() == 2 else q_positions[None]
    k2 = kv_positions if kv_positions.dim() == 2 else kv_positions[None]
    dist = q2[:, :, None].float() - k2[:, None, :].float()
    slopes = alibi_slopes(num_heads).to(dist.device)
    bias = -slopes[None, :, None, None] * dist.clamp(min=0.0)[:, None]
    return bias if batched else bias[0]


def _qkv(lw: Params, x: torch.Tensor, cfg: TransformerConfig, rope_cs):
    """q [b, s, hq, hd], k / v [b, s, hkv, hd] with biases and (partial)
    rotary applied; ``rope_cs`` is ``rope_tables`` over the rotary dims."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = x @ lw["wq"], x @ lw["wk"], x @ lw["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.position == "rope":
        rot = cfg.rotary_dim or hd
        if rot < hd:  # partial rotary: the first `rot` dims rotate
            q = torch.cat([apply_rope(q[..., :rot], *rope_cs), q[..., rot:]], -1)
            k = torch.cat([apply_rope(k[..., :rot], *rope_cs), k[..., rot:]], -1)
        else:
            q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)
    return q, k, v


def _attend(q, k, v, cfg: TransformerConfig, positions, attn_fn, segment_ids):
    kw = {}
    if cfg.position == "alibi":
        if segment_ids is not None:
            raise NotImplementedError(
                "position='alibi' does not support packed sequences (segment_ids)")
        kw["bias"] = alibi_bias(cfg.num_heads, positions, positions)
    return attn_fn(q, k, v, causal=True, segment_ids=segment_ids,
                   logits_soft_cap=cfg.logits_soft_cap, **kw)


def _out_proj(lw: Params, o: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    out = o.reshape(b, s, -1) @ lw["wo"]
    if "bo" in lw:
        out = out + lw["bo"]
    return out


def _act_quant(x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """A sublayer's input fake-quantized to ``cfg.act_quant_bits`` (STE),
    or as it is when that is off."""
    if not cfg.act_quant_bits:
        return x
    from ..compression.compress import quantize_activation

    return quantize_activation(x, cfg.act_quant_bits)


def _attn_input(lw: Params, x, cfg: TransformerConfig):
    return _act_quant(norm(x, lw["attn_norm"], cfg.norm, cfg.norm_eps), cfg)


# ---------------------------------------------------------------------------
# manual tensor parallelism (JAX transformer.py:421-454): f and g over
# ``model`` are the context's ``copy`` / ``reduce``
# ---------------------------------------------------------------------------
def _tp(par):
    """The context's ``TensorParallel`` (None without a model axis)."""
    return par.tp if par is not None else None


def _tp_attn_weights(attn: Params, par) -> Params:
    """The attention weights a rank reads: its shards as they are; a
    replicated kv projection narrowed to the kv head its q heads share,
    through ``f`` so that its partial gradient sums over ``model``."""
    tp = par.tp
    if tp.kv_sharded:
        return attn
    out = dict(attn)
    lo, n = tp.kv_head0 * tp.hd, tp.kv_heads * tp.hd
    for name in ("wk", "wv", "bk", "bv"):
        if name in attn:
            out[name] = par.copy(attn[name], MODEL_AXIS).narrow(-1, lo, n)
    return out


def _pre_attention(lw: Params, x, cfg: TransformerConfig, rope_cs, par=None):
    lw = fetch_layer(lw)
    a = _attn_input(lw, x, cfg)
    if _tp(par) is None:
        return _qkv(lw["attn"], a, cfg, rope_cs)
    return _qkv(_tp_attn_weights(lw["attn"], par), par.copy(a, MODEL_AXIS), par.tp.local_cfg,
                rope_cs)


def _mlp_tp(mlp: Params, y, cfg: TransformerConfig, par):
    """A column / row-parallel MLP: the local columns, the partial sums
    reduced, ``b_down`` added once."""
    core = {k: v for k, v in mlp.items() if k != "b_down"}
    out = par.reduce(mlp_block(core, par.copy(y, MODEL_AXIS), cfg), MODEL_AXIS)
    return out + mlp["b_down"] if "b_down" in mlp else out


def _post_attention_tp(lw: Params, x, o, cfg: TransformerConfig, par, dropless: bool = False):
    attn = lw["attn"]
    b, s = o.shape[:2]
    h = par.reduce(o.reshape(b, s, -1) @ attn["wo"], MODEL_AXIS)
    if "bo" in attn:
        h = h + attn["bo"]
    h = h.to(x.dtype)
    if cfg.parallel_block:
        m = _mlp_tp(lw["mlp"], _attn_input(lw, x, cfg), cfg, par)
        return x + h + m.to(x.dtype), None
    x = x + h
    y = _act_quant(norm(x, lw["mlp_norm"], cfg.norm, cfg.norm_eps), cfg)
    if cfg.moe_num_experts > 0:  # the experts' columns: f / g inside the routed layer
        if dropless:
            raise NotImplementedError("MoE layers under a model axis run in training; serving "
                                      "them is not ported yet (ROADMAP queue 1 item 7)")
        m, aux = moe_block(lw["moe"], y, cfg, par)
        return x + m.to(x.dtype), aux
    return x + _mlp_tp(lw["mlp"], y, cfg, par).to(x.dtype), None


def _post_attention(lw: Params, x, o, cfg: TransformerConfig, dropless: bool = False,
                    par=None):
    """wo, residual, MLP norm, MLP (or the routed experts) and residual (a
    parallel block reads the attention norm for both branches and adds both
    to one residual).  Returns (x, MoE aux loss or None); ``dropless``
    routes the experts without capacity (the cache path, as in JAX).
    Under a model axis (``par.tp``) the row-parallel outputs go through
    ``g``; across ranks (``par``) the routed experts are
    ``moe_block_grid``, or with ``moe_qcomm`` over an expert axis above 1
    JAX's explicit region (``routed_ffn_ep``)."""
    lw = fetch_layer(lw)
    if _tp(par) is not None:
        return _post_attention_tp(lw, x, o, cfg, par, dropless)
    h = _out_proj(lw["attn"], o).to(x.dtype)
    if cfg.parallel_block:
        m = mlp_block(lw["mlp"], _attn_input(lw, x, cfg), cfg)
        return x + h + m.to(x.dtype), None
    x = x + h
    y = _act_quant(norm(x, lw["mlp_norm"], cfg.norm, cfg.norm_eps), cfg)
    if cfg.moe_num_experts > 0:
        if dropless:
            m, aux = moe_block_dropless(lw["moe"], y, cfg)
        elif par is not None and cfg.moe_qcomm is not None and par.expert > 1:
            m, aux = routed_ffn_ep(lw["moe"], y, cfg, par, fmt=cfg.moe_qcomm)
        else:
            m, aux = moe_block(lw["moe"], y, cfg, par)
        return x + m.to(x.dtype), aux
    return x + mlp_block(lw["mlp"], y, cfg).to(x.dtype), None


def decoder_layer(lw: Params, x: torch.Tensor, cfg: TransformerConfig, positions,
                  attn_fn: Callable, segment_ids, rope_cs, par=None):
    """Pre-norm residual block (dense MLP, routed experts, or the parallel
    block) -> (x, MoE aux or None).  JAX's ``attention_block`` is split in
    three here (``_qkv``, ``_attend``, ``_out_proj``) so that selective
    remat can keep the attention itself out of its two checkpoints;
    ``rope_cs`` is ``rope_tables`` over the rotary dims (None without
    rope).  ``par`` (a ``parallel.context.ParallelContext``) runs this
    rank's shard of the layer between the ``f`` / ``g`` pair under a model
    axis (``par.tp``; JAX's ``tp_axis``) and routes the experts across
    ranks (the attention's collectives ride ``attn_fn``)."""
    lw = fetch_layer(lw)  # once for both halves
    q, k, v = _pre_attention(lw, x, cfg, rope_cs, par)
    o = _attend(q, k, v, cfg, positions, attn_fn, segment_ids)
    return _post_attention(lw, x, o, cfg, par=par)


# calls of each body by the dense-cache attention (``_attend_cache``)
CACHE_ATTENTION = {"flash": 0, "plain": 0}


def flash_supports(q: torch.Tensor, k: torch.Tensor, q_offset, segment_ids=None) -> bool:
    """JAX ``flash_kernel.supports`` (causal): where JAX's flash entry runs
    its Pallas kernel — an integer ``q_offset`` of 0, as many keys as
    queries, at least 128 and a multiple of 128 (a block), head dim 64 /
    128 / 256, whole query groups, segment ids [b, s].  Everywhere else JAX
    runs its plain body."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    return (isinstance(q_offset, int) and q_offset == 0 and sq == sk and sq >= 128
            and sq % 128 == 0 and d in (64, 128, 256) and hq % hk == 0
            and (segment_ids is None or tuple(segment_ids.shape) == (b, sq)))


def _attend_cache(q, k, v, cfg: TransformerConfig, positions, attn_fn, q_offset: int):
    """Attention over the dense cache (k / v [b, S, hkv, hd]) with the
    queries at ``q_offset``: the flash kernel where ``flash_supports`` holds
    and the configured body is flash, the plain body otherwise (JAX's
    static choice, made before the call).  ALiBi's key positions are the
    cache indices, as in JAX."""
    if attn_fn is flash_attention and flash_supports(q, k, q_offset):
        CACHE_ATTENTION["flash"] += 1
        return flash_attention(q, k, v, causal=True, logits_soft_cap=cfg.logits_soft_cap)
    kw = {}
    if cfg.position == "alibi":
        kw["bias"] = alibi_bias(cfg.num_heads, positions,
                                torch.arange(k.shape[1], device=q.device))
    CACHE_ATTENTION["plain"] += 1
    return dot_product_attention(q, k, v, causal=True, q_offset=q_offset,
                                 logits_soft_cap=cfg.logits_soft_cap, **kw)


def _cached_layer(lw: Params, x, cfg: TransformerConfig, positions, attn_fn, layer_cache,
                  cache_index: int, rope_cs, par=None):
    """``decoder_layer`` over the dense cache: this layer's k / v written
    at ``cache_index`` (in place), attention over the whole cache, the
    experts dropless.  Under a model axis the cache holds the rank's kv
    heads."""
    q, k, v = _pre_attention(lw, x, cfg, rope_cs, par)
    ck, cv = layer_cache
    s = q.shape[1]
    ck[:, cache_index:cache_index + s] = k.to(ck.dtype)
    cv[:, cache_index:cache_index + s] = v.to(cv.dtype)
    o = _attend_cache(q, ck, cv, cfg, positions, attn_fn, cache_index)
    return _post_attention(lw, x, o, cfg, dropless=True, par=par)


def fetch_layer(lw):
    """A layer's parameter dict: ``lw`` itself, or what a ZeRO stage-3
    ``LayerHandle`` gathers now (``runtime/zero.py``).  Each function that
    starts a layer's work calls it, so a checkpointed region gathers its
    layer inside the region and its recomputation gathers again."""
    fetch = getattr(lw, "fetch", None)
    return fetch() if fetch is not None else lw


def _unstack(tree: Params, L: int):
    """Stacked ``[L, ...]`` leaves -> one dict per layer (or a ZeRO stage-3
    ``LayerSource``'s handles, one a layer, each gathered when the layer
    runs: ``fetch_layer``).  ``unbind`` keeps
    the backward to one stack per leaf (indexing would build an [L, ...]
    zero gradient for every layer).  A leaf may instead be the sequence of
    its L layers' tensors: an offloaded engine's compute copy
    (``runtime/offload.py``), whose per-layer leaves take each layer's
    gradient as that layer's backward ends."""
    if hasattr(tree, "layer_handles"):
        return tree.layer_handles()
    flat = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                flat[path + (key,)] = (tuple(val) if isinstance(val, (list, tuple))
                                       else torch.unbind(val, 0))

    walk(tree, ())
    out = []
    for l in range(L):
        lw: Params = {}
        for path, views in flat.items():
            node = lw
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = views[l]
        out.append(lw)
    return out


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
                  device=None, tp=None):
    """The dense KV cache of the v1 engine: ``([L, b, S, hkv, hd], same)``
    zeros in ``dtype`` (default ``cfg.dtype``) on ``device`` (CUDA unless
    the caller names another); under ``tp`` the rank's kv heads."""
    hkv = tp.kv_heads if tp is not None else cfg.num_kv_heads
    shape = (cfg.num_layers, batch, max_len, hkv, cfg.hd)
    dtype, device = dtype or cfg.dtype, resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: TransformerConfig, par=None):
    """The token embedding [b, s, d] in ``cfg.dtype``: a lookup, or under a
    vocab-parallel model axis a masked lookup into the rank's rows then
    ``g`` (each token's row lives on one rank)."""
    table = params["embed"]["embedding"]
    tp = _tp(par)
    if tp is None or not tp.vocab_sharded:
        return table[tokens].to(cfg.dtype)
    local = tokens - tp.vocab0
    inside = (local >= 0) & (local < tp.vocab_local)
    x = table[local.clamp(0, tp.vocab_local - 1)] * inside[..., None].to(table.dtype)
    return par.reduce(x, MODEL_AXIS).to(cfg.dtype)


def tp_head(params: Params, cfg: TransformerConfig, h: torch.Tensor, par):
    """The head's logits under a model axis: [..., vocab / tp] of the rank's
    vocab shard (through ``f``: the hidden's gradient sums over the
    shards), or the whole [..., vocab] when the head is replicated."""
    tp = par.tp
    if not tp.vocab_sharded:
        return lm_logits(params, cfg, h)
    out = par.copy(h, MODEL_AXIS) @ head_kernel(params, cfg)
    hb = head_bias_vec(params)
    if hb is not None:  # whole on every rank: the rank reads its columns
        out = out + par.copy(hb, MODEL_AXIS).narrow(0, tp.vocab0, tp.vocab_local)
    return out


def _rows(t, sl, b):
    """Rows ``sl`` of a per-batch-row tensor (left whole when it is shared
    by every row)."""
    return t[sl] if t is not None and t.dim() > 0 and t.shape[0] == b else t


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            return_hidden: bool = False, cache=None, cache_index=None,
            with_aux: bool = False, layer_keep=None, par=None):
    """tokens [b, s] -> logits [b, s, v] (or the final-norm hidden states):
    a Python loop over the stacked layers, each under ``cfg.remat``.
    ``layer_keep`` ([L] host bools or 0 / 1, progressive layer drop) skips
    each layer whose entry is false.

    With ``cache`` (``init_kv_cache``, written in place) or ``with_aux``,
    returns JAX's triple ``(out, cache, moe_aux)``: ``moe_aux`` is the sum
    of the layers' load-balance losses (0 for a dense model).  Positions
    then start at ``cache_index`` (JAX ``forward``), and the layers run
    without remat (the cache path serves).

    ``cfg.domino_chunks`` > 1 runs each layer over that many row chunks of
    the batch (not with a cache; a batch they do not divide runs whole, as
    in JAX).

    ``par`` (``parallel.context.ParallelContext``) is this rank's view of
    a process grid: under a model axis (``par.tp``, a
    ``parallel.tensor_parallel.TensorParallel``) it runs this rank's shard
    of ``params`` and the logits are the rank's vocab shard (``tp_head``);
    under a ``seq`` axis ``tokens`` are the rank's
    positions of each row, ``positions`` their places in the whole
    sequence and ``segment_ids`` the whole sequence's (the attention reads
    it whole); the routed experts run across ranks."""
    _refuse_unported(cfg)
    device = tokens.device
    attn_fn = get_attn_fn(cfg, device, par)
    b, s = tokens.shape
    ci = 0
    if cache is not None:
        if cfg.sparse_attention is not None:
            raise NotImplementedError("a dense KV cache with sparse_attention is not ported")
        ci = int(cache_index or 0)
    if positions is None:
        positions = (torch.arange(s, device=device) + ci)[None, :].expand(b, s)
    if segment_ids is not None:  # the kernels take contiguous int32
        segment_ids = segment_ids.to(device=device, dtype=torch.int32).contiguous()
    x = embed_tokens(params, tokens, cfg, par)
    if cfg.position == "learned":
        x = x + params["pos_embed"]["embedding"][positions].to(cfg.dtype)
    if cfg.embedding_norm:
        x = norm(x, params["embed_norm"], cfg.norm, cfg.norm_eps)
    rope_cs = None
    if cfg.position == "rope":
        rope_cs = rope_tables(positions, cfg.rotary_dim or cfg.hd, cfg.rope_theta)

    def layer(lw, x, pos, seg, cs):
        return decoder_layer(lw, x, cfg, pos, attn_fn, seg, cs, par)

    def selective(lw, x, pos, seg, cs):
        q, k, v = checkpoint(_pre_attention, lw, x, cfg, cs, par, use_reentrant=False)
        o = _attend(q, k, v, cfg, pos, attn_fn, seg)
        return checkpoint(_post_attention, lw, x, o, cfg, False, par, use_reentrant=False)

    def offload(lw, x, pos, seg, cs):
        q, k, v = checkpoint(_pre_attention, lw, x, cfg, cs, par, use_reentrant=False)
        # the attention's residuals (the segment ids aside: one tensor
        # shared by every layer), then the one input of the second
        # checkpoint that is not the layer's own (its weights and x)
        copies: list = []
        with offload_saved(lambda t: t is seg, copies):
            o = _attend(q, k, v, cfg, pos, attn_fn, seg)
        with offload_saved(lambda t: t is not o, copies):
            return checkpoint(_post_attention, lw, x, o, cfg, False, par,
                              use_reentrant=False)

    def full(lw, x, pos, seg, cs):
        return checkpoint(layer, lw, x, pos, seg, cs, use_reentrant=False)

    def dots(lw, x, pos, seg, cs):
        # a product that only feeds the residual sum is not saved
        lw = fetch_layer(lw)
        unread = tuple(w.data_ptr() for w in (
            lw["mlp"]["w_down"] if "mlp" in lw else None,
            lw["attn"]["wo"] if cfg.parallel_block else None) if w is not None)
        return checkpoint(layer, lw, x, pos, seg, cs, use_reentrant=False,
                          context_fn=functools.partial(_dots_context, unread))

    run = {"full": full, "dots": dots, "selective": selective, "offload": offload}.get(
        cfg.remat, layer)
    chunks = cfg.domino_chunks if cache is None and b % cfg.domino_chunks == 0 else 1

    def domino(lw, x):
        if chunks == 1:
            return run(lw, x, positions, segment_ids, rope_cs)
        bc, outs = b // chunks, []
        for c in range(chunks):
            sl = slice(c * bc, (c + 1) * bc)
            cs = None if rope_cs is None else tuple(_rows(t, sl, b) for t in rope_cs)
            outs.append(run(lw, x[sl], _rows(positions, sl, b), _rows(segment_ids, sl, b),
                            cs)[0])
        return torch.cat(outs, 0), None

    keep = None
    if layer_keep is not None:
        keep = [bool(k) for k in torch.as_tensor(layer_keep).reshape(-1).tolist()]
        if len(keep) != cfg.num_layers:
            raise ValueError(f"layer_keep has {len(keep)} entries for {cfg.num_layers} layers")
    aux_total = None
    for l, lw in enumerate(_unstack(params["layers"], cfg.num_layers)):
        if keep is not None and not keep[l]:
            continue  # a dropped layer is the identity: nothing runs
        if cache is not None:
            x, aux = _cached_layer(lw, x, cfg, positions, attn_fn,
                                   (cache[0][l], cache[1][l]), ci, rope_cs, par)
        else:
            x, aux = domino(lw, x)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if return_hidden:
        out = x
    else:
        out = lm_logits(params, cfg, x) if _tp(par) is None else tp_head(params, cfg, x, par)
    if cache is None and not with_aux:
        return out
    if aux_total is None:
        aux_total = torch.zeros((), device=device)
    return out, cache, aux_total


class _VocabParallelCE(torch.autograd.Function):
    """Per-token NLL [N] from the rank's vocab shard of the logits [N,
    vocab / tp] (fp32): the row max and the sum of exponentials all-reduced
    over ``model``, the label's logit from the rank that owns it (a label
    ``-100`` is owned by no rank).  Its backward is the local softmax minus
    the label's one-hot (Megatron's ``_VocabParallelCrossEntropy``).  The
    log-partition is formed as ``torch.logsumexp`` forms it (``log(sum(exp(x
    - max))) + max``) and the backward as its backward and the label
    gather's (``exp(x - logz) * grad``, then ``-grad`` added at the label),
    so that over a model axis of one the loss and its gradient equal
    ``cross_entropy_loss``'s bit for bit."""

    @staticmethod
    def forward(ctx, logits, labels, par):
        tp = par.tp
        m = par._all_reduce(logits.max(dim=-1).values, MODEL_AXIS, op="max")
        e = (logits - m[:, None]).exp()
        local = labels.long() - tp.vocab0
        own = (local >= 0) & (local < tp.vocab_local)
        idx = local.clamp(0, tp.vocab_local - 1)
        gold = torch.where(own, logits.gather(-1, idx[:, None])[:, 0], torch.zeros_like(m))
        sums = par._all_reduce(torch.stack([e.sum(-1), gold]), MODEL_AXIS)
        logz = sums[0].log() + m
        ctx.save_for_backward(logits, logz, idx, own)
        return logz - sums[1]

    @staticmethod
    def backward(ctx, grad):
        logits, logz, idx, own = ctx.saved_tensors
        g = (logits - logz[:, None]).exp() * grad[:, None]
        g.scatter_add_(-1, idx[:, None], torch.where(own, -grad, torch.zeros_like(grad))[:, None])
        return g, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, par,
                                 ignore_index: int = -100):
    """``(sum of NLL, count of labelled tokens)`` over the rank's vocab shard
    of the logits ([..., vocab / tp]; fp32 math)."""
    nll = _VocabParallelCE.apply(logits.reshape(-1, logits.shape[-1]).float(),
                                 labels.reshape(-1), par)
    mask = (labels.reshape(-1) != ignore_index).float()
    return (nll * mask).sum(), mask.sum()


def _tp_chunk_nll(params, cfg, h, labels, par):
    return vocab_parallel_cross_entropy(tp_head(params, cfg, h, par), labels, par)


def tp_loss(params: Params, cfg: TransformerConfig, hidden: torch.Tensor,
            labels: torch.Tensor, par) -> torch.Tensor:
    """The token-mean NLL of the final hidden states under a vocab-parallel
    head: the rank's logits shard a sequence chunk at a time
    (``loss_chunk_size``, each chunk under a checkpoint, as
    ``chunked_cross_entropy``) or whole; no rank forms the whole logits."""
    chunk = cfg.loss_chunk_size or hidden.shape[1]
    s = hidden.shape[1]
    if s % chunk:
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
        s += pad
    nll_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if cfg.loss_chunk_size:
            nll, n = checkpoint(_tp_chunk_nll, params, cfg, h, lab, par, use_reentrant=False)
        else:
            nll, n = _tp_chunk_nll(params, cfg, h, lab, par)
        nll_sum = nll_sum + nll
        count = count + n
    return nll_sum / count.clamp(min=1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Token-mean causal-LM loss in fp32; labels == ignore_index masked."""
    mask = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    return ((logz - gold) * mask).sum() / mask.sum().clamp(min=1.0)


class CausalLM:
    """Model adapter consumed by ``deepspeed_tpu_torch.initialize(model=...)``:
    ``loss_fn(params, batch, rng)``, ``init_params``, ``param_count`` and
    ``flops_per_token``.  Batch: ``{'input_ids': [b, s]}`` (labels are the
    shifted inputs) or ``{'input_ids', 'labels'}`` for pre-shifted data,
    optionally with ``segment_ids`` [b, s]."""

    def __init__(self, cfg: TransformerConfig, stack_apply=None):
        if stack_apply is not None:
            raise NotImplementedError("stack_apply (the pipelined stack) is not ported yet "
                                      "(ROADMAP queue 1 item 7)")
        _refuse_unported(cfg)
        self.cfg = cfg
        # a ``parallel.tensor_parallel.TensorParallel`` (``initialize`` sets
        # it in a world with a model axis, and ``par.tp`` to it): the shard
        # layout of the tree
        self.tp = None
        # a ``parallel.context.ParallelContext`` (``initialize`` sets it in a
        # world): the loss runs this rank's shard of the tree under a model
        # axis, reads this rank's slice of the sequence under a seq axis,
        # and the routed experts run across ranks
        self.par = None

    def init_params(self, seed: int = 0, device=None, keep: Optional[Callable] = None) -> Params:
        """fp32 parameters (the engine keeps fp32 masters) on ``device``,
        CUDA unless the caller names another; ``keep`` as ``init_params``'s."""
        return init_params(self.cfg, seed=seed, device=device, dtype=torch.float32, keep=keep)

    def apply(self, params: Params, tokens: torch.Tensor, **kw) -> torch.Tensor:
        return forward(params, tokens, self.cfg, **kw)

    def prepare_batch(self, batch, rng=None):
        """(inputs, labels, segment_ids, layer_keep): the label shift and
        segment trim, and the progressive-layer-drop mask — the batch's
        ``layer_keep``, or one drawn from its ``pld_theta`` with ``rng``
        when that is a CPU generator (else PyTorch's default one), as JAX
        draws it from the step's theta."""
        tokens = batch["input_ids"]
        segment_ids = batch.get("segment_ids")
        layer_keep = batch.get("layer_keep")
        if layer_keep is None and batch.get("pld_theta") is not None:
            from ..runtime.progressive_layer_drop import layer_keep_mask

            host = isinstance(rng, torch.Generator) and rng.device.type == "cpu"
            layer_keep = layer_keep_mask(rng if host else None, self.cfg.num_layers,
                                         float(batch["pld_theta"]))
        if "labels" in batch:
            return tokens, batch["labels"], segment_ids, layer_keep
        if segment_ids is not None:
            segment_ids = segment_ids[:, :-1]
        return tokens[:, :-1], tokens[:, 1:], segment_ids, layer_keep

    def valid_tokens(self, batch) -> torch.Tensor:
        """The count of labels ``loss_fn`` averages over (not
        ``ignore_index``; under a seq axis those of this rank's slice): the
        engine's weight of a rank across a world."""
        labels = batch["labels"] if "labels" in batch else batch["input_ids"][:, 1:]
        return (labels[:, self._seq_slice(labels.shape[1])] != -100).sum()

    def _seq_slice(self, s: int) -> slice:
        """This rank's positions of a length-``s`` sequence (all of them
        without a seq axis); a length the axis does not divide raises."""
        par = self.par
        if par is None or par.seq == 1:
            return slice(0, s)
        if s % par.seq:
            raise NotImplementedError(
                f"sequence length {s} does not divide over the seq axis ({par.seq}); JAX pads "
                "it, the port does not yet (ROADMAP queue 1 item 7)")
        n = s // par.seq
        return slice(par.seq_rank * n, (par.seq_rank + 1) * n)

    def loss_fn(self, params: Params, batch, rng=None) -> torch.Tensor:
        inputs, labels, segment_ids, layer_keep = self.prepare_batch(batch, rng)
        par = self.par
        tp = _tp(par)
        positions = None
        if par is not None and par.seq > 1:
            # the label shift came first: a boundary token's label is the
            # next rank's first token; the segment ids stay whole
            sl = self._seq_slice(inputs.shape[1])
            b = inputs.shape[0]
            positions = torch.arange(inputs.shape[1], device=inputs.device)[sl][None].expand(
                b, -1)
            inputs, labels = inputs[:, sl], labels[:, sl]
        kw = dict(positions=positions, segment_ids=segment_ids, with_aux=True,
                  layer_keep=layer_keep, par=par)
        aux_coef = (self.cfg.moe_aux_loss_coef / max(self.cfg.num_layers, 1)
                    if self.cfg.moe_num_experts > 0 else 0.0)
        if tp is not None:
            hidden, _, aux = forward(params, inputs, self.cfg, return_hidden=True, **kw)
            if tp.vocab_sharded:
                return tp_loss(params, self.cfg, hidden, labels, par) + aux_coef * aux
            # a replicated head: every rank forms the same whole logits
            if self.cfg.loss_chunk_size:
                from ..sequence.cross_entropy import chunked_cross_entropy

                loss = chunked_cross_entropy(hidden, head_kernel(params, self.cfg), labels,
                                             chunk_size=self.cfg.loss_chunk_size,
                                             head_bias=head_bias_vec(params))
            else:
                loss = cross_entropy_loss(lm_logits(params, self.cfg, hidden), labels)
            return loss + aux_coef * aux
        if self.cfg.loss_chunk_size:
            from ..sequence.cross_entropy import chunked_cross_entropy

            hidden, _, aux = forward(params, inputs, self.cfg, return_hidden=True, **kw)
            loss = chunked_cross_entropy(hidden, head_kernel(params, self.cfg), labels,
                                         chunk_size=self.cfg.loss_chunk_size,
                                         head_bias=head_bias_vec(params))
        else:
            logits, _, aux = forward(params, inputs, self.cfg, **kw)
            loss = cross_entropy_loss(logits, labels)
        if self.cfg.moe_num_experts > 0:  # JAX: coef * aux / L
            loss = loss + aux_coef * aux
        return loss

    @property
    def param_count(self) -> int:
        return self.cfg.param_count

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token: 6N plus the attention
        quadratic term (JAX ``CausalLM.flops_per_token``)."""
        c = self.cfg
        return 6.0 * c.param_count + 12 * c.num_layers * c.hidden_size * seq_len


def tp_rules(cfg: TransformerConfig):
    """Megatron-style tensor-parallel rules over the stacked tree (JAX
    ``tp_rules``, ``transformer.py:853``): column-parallel wq / wk / wv,
    w_gate / w_up (output dim on ``model``), row-parallel wo / w_down
    (input dim), the embedding's and the head's vocab dim; the leading
    layer dim never.  The layout GSPMD gives JAX's training; a rank's
    shard here follows AutoTP's rules with the head hints instead
    (``parallel.tensor_parallel.TensorParallel``), which keep ``wk`` /
    ``wv`` whole where the kv heads do not divide the axis."""
    from ..parallel.sharding import P

    rules = [
        (r"layers/attn/w[qkv]$", P(None, None, MODEL_AXIS)),
        (r"layers/attn/b[qkv]$", P(None, MODEL_AXIS)),
        (r"layers/attn/wo$", P(None, MODEL_AXIS, None)),
        (r"embed/embedding$", P(MODEL_AXIS, None)),
        (r"lm_head/kernel$", P(None, MODEL_AXIS)),
    ]
    if cfg.moe_num_experts > 0:
        rules += [
            (r"layers/moe/w_(gate|up)$", P(None, "expert", None, MODEL_AXIS)),
            (r"layers/moe/w_down$", P(None, "expert", MODEL_AXIS, None)),
        ]
    else:
        rules += [
            (r"layers/mlp/w_(gate|up)$", P(None, None, MODEL_AXIS)),
            (r"layers/mlp/w_down$", P(None, MODEL_AXIS, None)),
            (r"layers/mlp/b_(gate|up)$", P(None, MODEL_AXIS)),
        ]
    return rules
