"""Hugging Face checkpoint import / export (safetensors) — counterpart of
``deepspeed_tpu/checkpoint/hf_import.py``.

HF parameter names map declaratively onto the paths of the port's
parameter tree (JAX's layout): torch's ``[out, in]`` Linear weights
transpose to ``[in, out]`` kernels and per-layer tensors stack into the
leading ``L`` dimension.  Families: llama / llama2 / llama3, mistral,
qwen2, gpt2 (learned positions, Conv1D fused qkv), opt (positions offset
by 2, ReLU), bloom (ALiBi, per-head fused qkv, embedding LayerNorm),
falcon (parallel block; its three fused-qkv layouts: multi-query, per-head
interleaved and the grouped new decoder architecture), gptj (parallel
block, interleaved partial rotary permuted to half-split at import), phi
(parallel block, partial rotary, biases) and mixtral (llama attention with
``block_sparse_moe`` experts: the router ``gate`` and each expert's ``w1``
/ ``w3`` / ``w2`` as ``w_gate`` / ``w_up`` / ``w_down``, stacked ``[L, E,
...]``).

The import streams: each HF tensor is read from disk on its own
(``safetensors_io.SafetensorsReader``), moved to ``device`` and written
into its leaf there, so the host holds one tensor at a time, never the
tree.  JAX's mesh-sharded ``load_hf_checkpoint_sharded`` is item 7; on one
device this is its streamed form.  The export writes one tensor at a time
too, as float32, in JAX's llama / qwen2 / mixtral layout.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.transformer import TransformerConfig
from ..utils.logging import log_dist
from .safetensors_io import SafetensorsReader, list_shards, write_safetensors

Params = Any


def config_from_hf(hf: Dict[str, Any]) -> TransformerConfig:
    """An HF ``config.json`` dict as a ``TransformerConfig`` (JAX's mapping)."""
    model_type = hf.get("model_type", "llama")
    if model_type in ("gpt2", "gptj"):
        d, heads, L = hf["n_embd"], hf["n_head"], hf["n_layer"]
        kw = dict(vocab_size=hf["vocab_size"], hidden_size=d,
                  intermediate_size=hf.get("n_inner") or 4 * d, num_layers=L,
                  num_heads=heads, num_kv_heads=heads, max_seq_len=hf.get("n_positions", 2048),
                  norm="layernorm", activation="gelu", gated_mlp=False,
                  norm_eps=hf.get("layer_norm_epsilon", 1e-5))
        if model_type == "gpt2":
            kw.update(position="learned", tie_embeddings=True, qkv_bias=True,
                      attn_out_bias=True, mlp_bias=True)
        else:
            kw.update(position="rope", parallel_block=True, mlp_bias=True,
                      rotary_dim=hf.get("rotary_dim", 64), rope_theta=10_000.0,
                      tie_embeddings=False, head_bias=True)
        return TransformerConfig(**kw)
    if model_type == "opt":
        return TransformerConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["ffn_dim"], num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"], num_kv_heads=hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 2048), position="learned",
            norm="layernorm",
            activation={"relu": "relu", "gelu": "gelu"}.get(
                hf.get("activation_function", "relu"), "relu"),
            gated_mlp=False, qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_embeddings=hf.get("tie_word_embeddings", True), norm_eps=1e-5)
    if model_type == "bloom":
        d = hf["hidden_size"]
        heads = hf.get("n_head", hf.get("num_attention_heads"))
        return TransformerConfig(
            vocab_size=hf["vocab_size"], hidden_size=d, intermediate_size=4 * d,
            num_layers=hf.get("n_layer", hf.get("num_hidden_layers")), num_heads=heads,
            num_kv_heads=heads, max_seq_len=hf.get("seq_length", 2048), position="alibi",
            norm="layernorm", activation="gelu", gated_mlp=False, qkv_bias=True,
            attn_out_bias=True, mlp_bias=True, embedding_norm=True, tie_embeddings=True,
            norm_eps=hf.get("layer_norm_epsilon", 1e-5), attn_impl="reference")
    if model_type == "falcon":
        d = hf["hidden_size"]
        heads = hf.get("num_attention_heads", hf.get("n_head"))
        kv = heads if not hf.get("multi_query", False) else 1
        if hf.get("new_decoder_architecture"):
            kv = hf.get("num_kv_heads", kv)
        alibi = bool(hf.get("alibi", False))
        bias = bool(hf.get("bias", False))
        return TransformerConfig(
            vocab_size=hf["vocab_size"], hidden_size=d,
            intermediate_size=hf.get("ffn_hidden_size", 4 * d),
            num_layers=hf.get("num_hidden_layers", hf.get("n_layer")), num_heads=heads,
            num_kv_heads=kv, head_dim=d // heads,
            max_seq_len=hf.get("max_position_embeddings", 2048), norm="layernorm",
            activation="gelu", gated_mlp=False,
            parallel_block=bool(hf.get("parallel_attn", True)), qkv_bias=bias,
            attn_out_bias=bias, mlp_bias=bias,
            tie_embeddings=hf.get("tie_word_embeddings", False),
            position="alibi" if alibi else "rope", attn_impl="reference",
            rope_theta=hf.get("rope_theta", 10_000.0),
            norm_eps=hf.get("layer_norm_epsilon", 1e-5))
    if model_type == "phi":
        return TransformerConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads") or hf["num_attention_heads"],
            max_seq_len=hf.get("max_position_embeddings", 2048), norm="layernorm",
            activation="gelu", gated_mlp=False, parallel_block=True, qkv_bias=True,
            attn_out_bias=True, mlp_bias=True, head_bias=True,
            rotary_dim=int(hf.get("partial_rotary_factor", 0.5)
                           * (hf["hidden_size"] // hf["num_attention_heads"])),
            rope_theta=hf.get("rope_theta", 10_000.0),
            tie_embeddings=hf.get("tie_word_embeddings", False),
            norm_eps=hf.get("layer_norm_eps", 1e-5))
    return TransformerConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim"), max_seq_len=hf.get("max_position_embeddings", 2048),
        norm_eps=hf.get("rms_norm_eps", 1e-5), rope_theta=hf.get("rope_theta", 10000.0),
        tie_embeddings=hf.get("tie_word_embeddings", False), norm="rmsnorm",
        activation="silu", gated_mlp=True, position="rope",
        qkv_bias=model_type in ("qwen2", "qwen"),
        **(dict(moe_num_experts=hf.get("num_local_experts", 0),
                moe_top_k=hf.get("num_experts_per_tok", 2))
           if model_type == "mixtral" or hf.get("num_local_experts") else {}))


def _interleaved_to_half(w: torch.Tensor, heads: int, hd: int, rot: int) -> torch.Tensor:
    """GPT-J's interleaved rotary pairs (2i, 2i+1) of a ``[.., heads*hd]``
    projection to the half-split layout (i, i + rot/2) ``rope`` uses."""
    w = w.reshape(w.shape[:-1] + (heads, hd))
    perm = torch.cat([torch.arange(0, rot, 2), torch.arange(1, rot, 2)]).to(w.device)
    w = torch.cat([w[..., :rot][..., perm], w[..., rot:]], dim=-1)
    return w.reshape(w.shape[:-2] + (heads * hd,))


class _Store:
    """The tensors of every shard of a checkpoint, read one at a time and
    moved to ``device``; ``take`` marks a name used."""

    def __init__(self, model_dir: str, device):
        self.device = device
        self.where: Dict[str, SafetensorsReader] = {}
        for path in list_shards(model_dir):
            r = SafetensorsReader(path)
            for k in r.keys():
                self.where[k] = r
        self.left = set(self.where)

    def __contains__(self, name: str) -> bool:
        return name in self.left

    def take(self, name: str) -> torch.Tensor:
        if name not in self.left:
            raise KeyError(f"missing tensor {name!r} in checkpoint ({len(self.left)} tensors)")
        self.left.discard(name)
        return self.where[name].get(name).to(self.device)

    def stack(self, fmt: str, L: int, transpose: bool = True, E: int = 0) -> torch.Tensor:
        """The per-layer tensors ``fmt.format(i=i)`` stacked on the device
        (``[L, ...]``), or with ``E`` the per-layer per-expert tensors
        ``fmt.format(i=i, e=e)`` (``[L, E, ...]``), one tensor read at a
        time."""
        keys = [(i,) for i in range(L)] if not E else [(i, e) for i in range(L)
                                                       for e in range(E)]
        out = None
        for key in keys:
            w = self.take(fmt.format(i=key[0], e=key[-1]))
            w = w.T if transpose else w
            if out is None:
                lead = (L, E) if E else (L,)
                out = torch.empty(lead + tuple(w.shape), dtype=w.dtype, device=self.device)
            out[key].copy_(w)
            del w
        return out


def _family_params(t: _Store, cfg: TransformerConfig, model_type: str, hf_cfg) -> Params:
    """The parameter tree of a non-llama family (JAX ``_load_family_layers``)."""
    L, d = cfg.num_layers, cfg.hidden_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    take = t.take

    def stack(fmt, transpose=True):
        return t.stack(fmt, L, transpose)

    def ln(fmt):
        return {"scale": stack(fmt + ".weight", False), "bias": stack(fmt + ".bias", False)}

    def ln1(name):
        return {"scale": take(name + ".weight"), "bias": take(name + ".bias")}

    if model_type == "gpt2":
        p = "transformer.h.{i}."
        wq, wk, wv = stack(p + "attn.c_attn.weight", False).tensor_split(3, dim=-1)
        bq, bk, bv = stack(p + "attn.c_attn.bias", False).tensor_split(3, dim=-1)
        return {
            "embed": {"embedding": take("transformer.wte.weight")},
            "pos_embed": {"embedding": take("transformer.wpe.weight")},
            "layers": {
                "attn": {"wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
                         "wo": stack(p + "attn.c_proj.weight", False),
                         "bo": stack(p + "attn.c_proj.bias", False)},
                "attn_norm": ln(p + "ln_1"), "mlp_norm": ln(p + "ln_2"),
                "mlp": {"w_up": stack(p + "mlp.c_fc.weight", False),
                        "b_up": stack(p + "mlp.c_fc.bias", False),
                        "w_down": stack(p + "mlp.c_proj.weight", False),
                        "b_down": stack(p + "mlp.c_proj.bias", False)},
            },
            "final_norm": ln1("transformer.ln_f"),
        }
    if model_type == "opt":
        p = "model.decoder.layers.{i}."
        layers = {
            "attn": {"wq": stack(p + "self_attn.q_proj.weight"),
                     "wk": stack(p + "self_attn.k_proj.weight"),
                     "wv": stack(p + "self_attn.v_proj.weight"),
                     "wo": stack(p + "self_attn.out_proj.weight"),
                     "bq": stack(p + "self_attn.q_proj.bias", False),
                     "bk": stack(p + "self_attn.k_proj.bias", False),
                     "bv": stack(p + "self_attn.v_proj.bias", False),
                     "bo": stack(p + "self_attn.out_proj.bias", False)},
            "attn_norm": ln(p + "self_attn_layer_norm"), "mlp_norm": ln(p + "final_layer_norm"),
            "mlp": {"w_up": stack(p + "fc1.weight"), "b_up": stack(p + "fc1.bias", False),
                    "w_down": stack(p + "fc2.weight"), "b_down": stack(p + "fc2.bias", False)},
        }
        # HF OPT offsets learned positions by 2: rows [2:] are positions 0..
        return {"embed": {"embedding": take("model.decoder.embed_tokens.weight")},
                "pos_embed": {"embedding": take("model.decoder.embed_positions.weight")[2:]},
                "layers": layers, "final_norm": ln1("model.decoder.final_layer_norm")}
    if model_type == "bloom":
        p = "transformer.h.{i}."
        # fused qkv interleaved per head: [heads, 3, hd] on the output dim
        qkv_w = stack(p + "self_attention.query_key_value.weight").reshape(L, d, hq, 3, hd)
        qkv_b = stack(p + "self_attention.query_key_value.bias", False).reshape(L, hq, 3, hd)
        attn = {n: qkv_w[:, :, :, j].reshape(L, d, hq * hd) for j, n in enumerate(("wq", "wk", "wv"))}
        attn.update({n: qkv_b[:, :, j].reshape(L, hq * hd)
                     for j, n in enumerate(("bq", "bk", "bv"))})
        attn.update(wo=stack(p + "self_attention.dense.weight"),
                    bo=stack(p + "self_attention.dense.bias", False))
        return {
            "embed": {"embedding": take("transformer.word_embeddings.weight")},
            "embed_norm": ln1("transformer.word_embeddings_layernorm"),
            "layers": {
                "attn": attn, "attn_norm": ln(p + "input_layernorm"),
                "mlp_norm": ln(p + "post_attention_layernorm"),
                "mlp": {"w_up": stack(p + "mlp.dense_h_to_4h.weight"),
                        "b_up": stack(p + "mlp.dense_h_to_4h.bias", False),
                        "w_down": stack(p + "mlp.dense_4h_to_h.weight"),
                        "b_down": stack(p + "mlp.dense_4h_to_h.bias", False)},
            },
            "final_norm": ln1("transformer.ln_f"),
        }
    if model_type == "falcon":
        p = "transformer.h.{i}."
        new_decoder = bool((hf_cfg or {}).get("new_decoder_architecture"))

        def split_fused(a: torch.Tensor):
            lead = tuple(a.shape[:-1])
            if new_decoder:
                # grouped per kv head: [hkv, (g q heads, k, v), hd]
                g = hq // hkv
                a = a.reshape(lead + (hkv, g + 2, hd))
                return (a[..., :g, :].reshape(lead + (hq * hd,)),
                        a[..., g, :].reshape(lead + (hkv * hd,)),
                        a[..., g + 1, :].reshape(lead + (hkv * hd,)))
            if hq == hkv:
                # falcon-rw: per-head interleaved [heads, (q, k, v), hd]
                a = a.reshape(lead + (hq, 3, hd))
                return tuple(a[..., j, :].reshape(lead + (hq * hd,)) for j in range(3))
            if hkv != 1:
                raise NotImplementedError(
                    f"falcon fused-qkv split: multi_query layout expects num_kv_heads == 1, "
                    f"got {hkv} (a grouped checkpoint must set new_decoder_architecture)")
            a = a.reshape(lead + (hq + 2, hd))
            return (a[..., :hq, :].reshape(lead + (hq * hd,)),
                    a[..., hq, :].reshape(lead + (hd,)),
                    a[..., hq + 1, :].reshape(lead + (hd,)))

        wq, wk, wv = split_fused(stack(p + "self_attention.query_key_value.weight"))
        layers = {"attn": {"wq": wq, "wk": wk, "wv": wv,
                           "wo": stack(p + "self_attention.dense.weight")},
                  "attn_norm": ln(p + "input_layernorm"),
                  "mlp": {"w_up": stack(p + "mlp.dense_h_to_4h.weight"),
                          "w_down": stack(p + "mlp.dense_4h_to_h.weight")}}
        if cfg.qkv_bias:
            bq, bk, bv = split_fused(stack(p + "self_attention.query_key_value.bias", False))
            layers["attn"].update({"bq": bq, "bk": bk, "bv": bv})
        if cfg.attn_out_bias:
            layers["attn"]["bo"] = stack(p + "self_attention.dense.bias", False)
        if cfg.mlp_bias:
            layers["mlp"]["b_up"] = stack(p + "mlp.dense_h_to_4h.bias", False)
            layers["mlp"]["b_down"] = stack(p + "mlp.dense_4h_to_h.bias", False)
        if not cfg.parallel_block:
            layers["mlp_norm"] = ln(p + "post_attention_layernorm")
        return {"embed": {"embedding": take("transformer.word_embeddings.weight")},
                "layers": layers, "final_norm": ln1("transformer.ln_f")}
    if model_type == "gptj":
        p = "transformer.h.{i}."
        rot = cfg.rotary_dim or hd
        return {
            "embed": {"embedding": take("transformer.wte.weight")},
            "layers": {
                "attn": {"wq": _interleaved_to_half(stack(p + "attn.q_proj.weight"), hq, hd, rot),
                         "wk": _interleaved_to_half(stack(p + "attn.k_proj.weight"), hkv, hd,
                                                    rot),
                         "wv": stack(p + "attn.v_proj.weight"),
                         "wo": stack(p + "attn.out_proj.weight")},
                "attn_norm": ln(p + "ln_1"),
                "mlp": {"w_up": stack(p + "mlp.fc_in.weight"),
                        "b_up": stack(p + "mlp.fc_in.bias", False),
                        "w_down": stack(p + "mlp.fc_out.weight"),
                        "b_down": stack(p + "mlp.fc_out.bias", False)},
            },
            "final_norm": ln1("transformer.ln_f"),
        }
    if model_type == "phi":
        p = "model.layers.{i}."
        return {
            "embed": {"embedding": take("model.embed_tokens.weight")},
            "layers": {
                "attn": {"wq": stack(p + "self_attn.q_proj.weight"),
                         "wk": stack(p + "self_attn.k_proj.weight"),
                         "wv": stack(p + "self_attn.v_proj.weight"),
                         "wo": stack(p + "self_attn.dense.weight"),
                         "bq": stack(p + "self_attn.q_proj.bias", False),
                         "bk": stack(p + "self_attn.k_proj.bias", False),
                         "bv": stack(p + "self_attn.v_proj.bias", False),
                         "bo": stack(p + "self_attn.dense.bias", False)},
                "attn_norm": ln(p + "input_layernorm"),
                "mlp": {"w_up": stack(p + "mlp.fc1.weight"), "b_up": stack(p + "mlp.fc1.bias", False),
                        "w_down": stack(p + "mlp.fc2.weight"),
                        "b_down": stack(p + "mlp.fc2.bias", False)},
            },
            "final_norm": ln1("model.final_layernorm"),
        }
    raise KeyError(model_type)


_FAMILY_LOADERS = ("gpt2", "opt", "bloom", "falcon", "gptj", "phi")


def _llama_params(t: _Store, cfg: TransformerConfig) -> Params:
    L = cfg.num_layers
    p = "model.layers.{i}."

    def stack(fmt, transpose=True):
        return t.stack(fmt, L, transpose)

    attn = {"wq": stack(p + "self_attn.q_proj.weight"), "wk": stack(p + "self_attn.k_proj.weight"),
            "wv": stack(p + "self_attn.v_proj.weight"), "wo": stack(p + "self_attn.o_proj.weight")}
    if cfg.qkv_bias:
        attn.update(bq=stack(p + "self_attn.q_proj.bias", False),
                    bk=stack(p + "self_attn.k_proj.bias", False),
                    bv=stack(p + "self_attn.v_proj.bias", False))
    layers = {"attn": attn,
              "attn_norm": {"scale": stack(p + "input_layernorm.weight", False)},
              "mlp_norm": {"scale": stack(p + "post_attention_layernorm.weight", False)}}
    if cfg.moe_num_experts > 0:
        # mixtral's experts: w1 = gate, w3 = up, w2 = down
        moe, E = p + "block_sparse_moe.", cfg.moe_num_experts
        layers["moe"] = {"router": stack(moe + "gate.weight"),
                         "w_gate": t.stack(moe + "experts.{e}.w1.weight", L, E=E),
                         "w_up": t.stack(moe + "experts.{e}.w3.weight", L, E=E),
                         "w_down": t.stack(moe + "experts.{e}.w2.weight", L, E=E)}
    else:
        layers["mlp"] = {"w_gate": stack(p + "mlp.gate_proj.weight"),
                         "w_up": stack(p + "mlp.up_proj.weight"),
                         "w_down": stack(p + "mlp.down_proj.weight")}
    return {"embed": {"embedding": t.take("model.embed_tokens.weight")}, "layers": layers,
            "final_norm": {"scale": t.take("model.norm.weight")}}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype).contiguous()


def load_hf_checkpoint(model_dir: str, cfg: Optional[TransformerConfig] = None,
                       dtype: torch.dtype = torch.float32,
                       device=None) -> Tuple[Params, TransformerConfig]:
    """safetensors checkpoint -> ``(params, config)``, streamed onto
    ``device`` (CUDA unless the caller names another) one HF tensor at a
    time.  ``cfg`` overrides the config derived from ``config.json`` (it
    must agree on shapes); the parameters come back in ``dtype`` (fp32 by
    default: the engine keeps fp32 masters)."""
    from ..ops.kernels import resolve_device

    device = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as fh:
        hf_cfg = json.load(fh)
    if cfg is None:
        cfg = config_from_hf(hf_cfg)
    t = _Store(model_dir, device)
    model_type = hf_cfg.get("model_type")
    family = model_type in _FAMILY_LOADERS
    params = (_family_params(t, cfg, model_type, hf_cfg) if family
              else _llama_params(t, cfg))
    if not cfg.tie_embeddings:
        if "lm_head.weight" in t:
            params["lm_head"] = {"kernel": t.take("lm_head.weight").T}
            if family and cfg.head_bias and "lm_head.bias" in t:
                params["lm_head"]["bias"] = t.take("lm_head.bias")
        else:  # the checkpoint ties even if its config did not say so
            cfg = cfg.replace(tie_embeddings=True)
    t.left.discard("lm_head.weight")  # a tied duplicate
    if family:
        t.left.discard("lm_head.bias")
    leftovers = sorted(k for k in t.left if "rotary_emb" not in k and not (
        family and (".attn.bias" in k or ".attn.masked_bias" in k)))
    if leftovers:
        log_dist(f"hf import: {len(leftovers)} unmapped tensors, e.g. {leftovers[:4]}")
    params = _cast(params, dtype)
    log_dist(f"hf import[{model_type}]: streamed {len(t.where) - len(t.left)} tensors from "
             f"{model_dir} onto {device}")
    return params, cfg


def _export_specs(params: Params, cfg: TransformerConfig):
    """(HF name, param leaf getter, transpose) in JAX's export order."""
    lw = params["layers"]
    out = [("model.embed_tokens.weight", lambda: params["embed"]["embedding"], False),
           ("model.norm.weight", lambda: params["final_norm"]["scale"], False)]
    if "lm_head" in params:
        out.append(("lm_head.weight", lambda: params["lm_head"]["kernel"], True))
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}"

        def leaf(*path, i=i, e=None):
            if e is not None:
                return lambda: lw[path[0]][path[1]][i, e]
            return lambda: lw[path[0]][path[1]][i]

        out += [(f"{pre}.self_attn.q_proj.weight", leaf("attn", "wq"), True),
                (f"{pre}.self_attn.k_proj.weight", leaf("attn", "wk"), True),
                (f"{pre}.self_attn.v_proj.weight", leaf("attn", "wv"), True),
                (f"{pre}.self_attn.o_proj.weight", leaf("attn", "wo"), True)]
        if cfg.qkv_bias:
            out += [(f"{pre}.self_attn.q_proj.bias", leaf("attn", "bq"), False),
                    (f"{pre}.self_attn.k_proj.bias", leaf("attn", "bk"), False),
                    (f"{pre}.self_attn.v_proj.bias", leaf("attn", "bv"), False)]
        out += [(f"{pre}.input_layernorm.weight", leaf("attn_norm", "scale"), False),
                (f"{pre}.post_attention_layernorm.weight", leaf("mlp_norm", "scale"), False)]
        if cfg.moe_num_experts > 0:
            moe = f"{pre}.block_sparse_moe"
            out.append((f"{moe}.gate.weight", leaf("moe", "router"), True))
            for e in range(cfg.moe_num_experts):
                out += [(f"{moe}.experts.{e}.w1.weight", leaf("moe", "w_gate", e=e), True),
                        (f"{moe}.experts.{e}.w3.weight", leaf("moe", "w_up", e=e), True),
                        (f"{moe}.experts.{e}.w2.weight", leaf("moe", "w_down", e=e), True)]
        else:
            out += [(f"{pre}.mlp.gate_proj.weight", leaf("mlp", "w_gate"), True),
                    (f"{pre}.mlp.up_proj.weight", leaf("mlp", "w_up"), True),
                    (f"{pre}.mlp.down_proj.weight", leaf("mlp", "w_down"), True)]
    return out


def export_hf_checkpoint(params: Params, cfg: TransformerConfig, out_dir: str) -> int:
    """The parameter tree -> HF-layout ``model.safetensors`` (float32, one
    tensor on the host at a time) and ``config.json``, as JAX writes them
    for the llama / qwen2 / mixtral families.  Returns the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    specs = _export_specs(params, cfg)
    get = {name: (fn, tr) for name, fn, tr in specs}

    def shape(name):
        fn, tr = get[name]
        s = tuple(fn().shape)
        return s[::-1] if tr else s

    def produce(name):
        fn, tr = get[name]
        a = fn().detach().to(torch.float32)
        return a.T.contiguous() if tr else a.contiguous()

    n = write_safetensors(os.path.join(out_dir, "model.safetensors"),
                          [(name, torch.float32, shape(name)) for name, _, _ in specs], produce)
    model_type = ("mixtral" if cfg.moe_num_experts > 0
                  else "qwen2" if cfg.qkv_bias else "llama")
    hf_cfg = {
        "model_type": model_type,
        "architectures": [{"mixtral": "MixtralForCausalLM", "qwen2": "Qwen2ForCausalLM",
                           "llama": "LlamaForCausalLM"}[model_type]],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.hd, "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": "float32",
    }
    if cfg.moe_num_experts > 0:
        hf_cfg["num_local_experts"] = cfg.moe_num_experts
        hf_cfg["num_experts_per_tok"] = cfg.moe_top_k
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(hf_cfg, fh, indent=2)
    log_dist(f"hf export: wrote {len(specs)} tensors to {out_dir}")
    return n
