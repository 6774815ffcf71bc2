"""The port's Hugging Face import / export
(``deepspeed_tpu_torch/checkpoint/hf_import.py``, ``safetensors_io.py``)
against the JAX package's, on the CPU.

- every family: a state dict with HF names and shapes is built here from a
  seed, written with the ``safetensors`` package, and read by both
  packages' ``load_hf_checkpoint``: the trees are equal bit for bit and
  ``config_from_hf`` agrees field by field (dtype by name), mixtral's too;
- JAX ``export_hf_checkpoint`` -> the port's loader equals JAX's loader,
  and the reverse; the port's export file is byte-identical to JAX's;
- the port's own safetensors reader and writer agree byte for byte with
  the package (every dtype, metadata, empty and scalar tensors, bf16);
- ``initialize(model=<hf dir>)`` trains from the imported weights.
Nothing is downloaded.
"""
import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import hf_import as jhf
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import hf_import as thf
from deepspeed_tpu_torch.checkpoint import safetensors_io as sio
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset

st_numpy = pytest.importorskip("safetensors.numpy")
st_torch = pytest.importorskip("safetensors.torch")

V, P, L = 96, 32, 2
FAMILIES = {
    "llama": dict(model_type="llama", vocab_size=V, hidden_size=32, intermediate_size=48,
                  num_hidden_layers=L, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=P, rms_norm_eps=1e-6, rope_theta=10000.0),
    "mistral": dict(model_type="mistral", vocab_size=V, hidden_size=32, intermediate_size=48,
                    num_hidden_layers=L, num_attention_heads=4, num_key_value_heads=1,
                    max_position_embeddings=P, tie_word_embeddings=True),
    "qwen2": dict(model_type="qwen2", vocab_size=V, hidden_size=32, intermediate_size=48,
                  num_hidden_layers=L, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=P, rope_theta=1e6),
    "gpt2": dict(model_type="gpt2", vocab_size=V, n_embd=32, n_head=4, n_layer=L,
                 n_positions=P, layer_norm_epsilon=1e-5),
    "opt": dict(model_type="opt", vocab_size=V, hidden_size=32, ffn_dim=64,
                num_hidden_layers=L, num_attention_heads=4, max_position_embeddings=P),
    "bloom": dict(model_type="bloom", vocab_size=V, hidden_size=32, n_layer=L, n_head=4),
    "falcon_mq": dict(model_type="falcon", vocab_size=V, hidden_size=32, num_attention_heads=4,
                      num_hidden_layers=L, multi_query=True, parallel_attn=True, bias=False),
    "falcon_rw": dict(model_type="falcon", vocab_size=V, hidden_size=32, num_attention_heads=4,
                      num_hidden_layers=L, multi_query=False, parallel_attn=False, bias=True,
                      alibi=True),
    "falcon_new": dict(model_type="falcon", vocab_size=V, hidden_size=32,
                       num_attention_heads=4, num_kv_heads=2, num_hidden_layers=L,
                       new_decoder_architecture=True, parallel_attn=True),
    "gptj": dict(model_type="gptj", vocab_size=V, n_embd=32, n_head=4, n_layer=L,
                 rotary_dim=4, n_positions=P),
    "phi": dict(model_type="phi", vocab_size=V, hidden_size=32, intermediate_size=64,
                num_hidden_layers=L, num_attention_heads=4, partial_rotary_factor=0.5),
}


def _hf_shapes(hf):
    """HF tensor names and shapes of a family's checkpoint (torch Linear
    ``[out, in]``; gpt2's Conv1D ``[in, out]``)."""
    mt = hf["model_type"]
    d = hf.get("hidden_size", hf.get("n_embd"))
    hq = hf.get("num_attention_heads", hf.get("n_head"))
    hd = d // hq
    out = {}

    def ln(name):
        out[name + ".weight"] = (d,)
        out[name + ".bias"] = (d,)

    def lin(name, o, i, bias=True):
        out[name + ".weight"] = (o, i)
        if bias:
            out[name + ".bias"] = (o,)

    if mt in ("llama", "mistral", "qwen2"):
        hkv = hf["num_key_value_heads"]
        f = hf["intermediate_size"]
        out["model.embed_tokens.weight"] = (V, d)
        out["model.norm.weight"] = (d,)
        if not hf.get("tie_word_embeddings"):
            out["lm_head.weight"] = (V, d)
        for i in range(L):
            p = f"model.layers.{i}."
            bias = mt == "qwen2"
            lin(p + "self_attn.q_proj", hq * hd, d, bias)
            lin(p + "self_attn.k_proj", hkv * hd, d, bias)
            lin(p + "self_attn.v_proj", hkv * hd, d, bias)
            lin(p + "self_attn.o_proj", d, hq * hd, False)
            out[p + "input_layernorm.weight"] = (d,)
            out[p + "post_attention_layernorm.weight"] = (d,)
            lin(p + "mlp.gate_proj", f, d, False)
            lin(p + "mlp.up_proj", f, d, False)
            lin(p + "mlp.down_proj", d, f, False)
            out[p + "self_attn.rotary_emb.inv_freq"] = (hd // 2,)  # ignored
    elif mt == "gpt2":
        out["transformer.wte.weight"] = (V, d)
        out["transformer.wpe.weight"] = (P, d)
        ln("transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            ln(p + "ln_2")
            out[p + "attn.c_attn.weight"] = (d, 3 * d)
            out[p + "attn.c_attn.bias"] = (3 * d,)
            out[p + "attn.c_proj.weight"] = (d, d)
            out[p + "attn.c_proj.bias"] = (d,)
            out[p + "mlp.c_fc.weight"] = (d, 4 * d)
            out[p + "mlp.c_fc.bias"] = (4 * d,)
            out[p + "mlp.c_proj.weight"] = (4 * d, d)
            out[p + "mlp.c_proj.bias"] = (d,)
            out[p + "attn.bias"] = (1, 1, P, P)  # the causal-mask buffer, ignored
    elif mt == "opt":
        f = hf["ffn_dim"]
        out["model.decoder.embed_tokens.weight"] = (V, d)
        out["model.decoder.embed_positions.weight"] = (P + 2, d)
        ln("model.decoder.final_layer_norm")
        for i in range(L):
            p = f"model.decoder.layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(p + "self_attn." + n, d, d)
            ln(p + "self_attn_layer_norm")
            ln(p + "final_layer_norm")
            lin(p + "fc1", f, d)
            lin(p + "fc2", d, f)
    elif mt == "bloom":
        out["transformer.word_embeddings.weight"] = (V, d)
        ln("transformer.word_embeddings_layernorm")
        ln("transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "input_layernorm")
            ln(p + "post_attention_layernorm")
            lin(p + "self_attention.query_key_value", 3 * d, d)
            lin(p + "self_attention.dense", d, d)
            lin(p + "mlp.dense_h_to_4h", 4 * d, d)
            lin(p + "mlp.dense_4h_to_h", d, 4 * d)
    elif mt == "falcon":
        bias = bool(hf.get("bias"))
        if hf.get("new_decoder_architecture"):
            fused = (hq + 2 * hf["num_kv_heads"]) * hd
        elif hf.get("multi_query"):
            fused = (hq + 2) * hd
        else:
            fused = 3 * d
        out["transformer.word_embeddings.weight"] = (V, d)
        out["lm_head.weight"] = (V, d)
        ln("transformer.ln_f")
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "input_layernorm")
            if not hf.get("parallel_attn", True):
                ln(p + "post_attention_layernorm")
            lin(p + "self_attention.query_key_value", fused, d, bias)
            lin(p + "self_attention.dense", d, hq * hd, bias)
            lin(p + "mlp.dense_h_to_4h", 4 * d, d, bias)
            lin(p + "mlp.dense_4h_to_h", d, 4 * d, bias)
    elif mt == "gptj":
        out["transformer.wte.weight"] = (V, d)
        ln("transformer.ln_f")
        lin("lm_head", V, d)
        for i in range(L):
            p = f"transformer.h.{i}."
            ln(p + "ln_1")
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(p + "attn." + n, d, d, False)
            lin(p + "mlp.fc_in", 4 * d, d)
            lin(p + "mlp.fc_out", d, 4 * d)
            out[p + "attn.masked_bias"] = ()  # ignored
    elif mt == "phi":
        f = hf["intermediate_size"]
        out["model.embed_tokens.weight"] = (V, d)
        ln("model.final_layernorm")
        lin("lm_head", V, d)
        for i in range(L):
            p = f"model.layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "dense"):
                lin(p + "self_attn." + n, d, d)
            ln(p + "input_layernorm")
            lin(p + "mlp.fc1", f, d)
            lin(p + "mlp.fc2", d, f)
    return out


def _write_family(tmp_path, name, bf16=False):
    hf = FAMILIES[name]
    rng = np.random.default_rng(sorted(FAMILIES).index(name))
    d = str(tmp_path / name)
    os.makedirs(d)
    tensors = {k: rng.standard_normal(s).astype(np.float32) for k, s in _hf_shapes(hf).items()}
    if bf16:
        st_torch.save_file({k: torch.from_numpy(v).to(torch.bfloat16)
                            for k, v in tensors.items()}, os.path.join(d, "model.safetensors"))
    else:  # two shards, as large checkpoints come
        keys = sorted(tensors)
        st_numpy.save_file({k: tensors[k] for k in keys[::2]},
                           os.path.join(d, "model-00001-of-00002.safetensors"))
        st_numpy.save_file({k: tensors[k] for k in keys[1::2]},
                           os.path.join(d, "model-00002-of-00002.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as fh:
        json.dump(hf, fh)
    return d


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _same_config(tcfg, jcfg):
    want = dataclasses.asdict(jcfg)
    for f in dataclasses.fields(tcfg):
        if f.name in want:
            got, w = getattr(tcfg, f.name), want[f.name]
            if f.name == "dtype":
                got, w = str(got).replace("torch.", ""), jnp.dtype(w).name
            assert got == w, (f.name, got, w)


def _same_trees(ttree, jtree):
    ft, fj = _flat(ttree), _flat(jax.tree_util.tree_map(np.asarray, jtree))
    assert set(ft) == set(fj)
    for k in fj:
        a = ft[k].detach().cpu()
        assert a.dtype == torch.float32 and a.is_contiguous(), k
        np.testing.assert_array_equal(a.numpy(), fj[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_import_equals_jax(tmp_path, name):
    d = _write_family(tmp_path, name)
    tparams, tcfg = thf.load_hf_checkpoint(d, device="cpu")
    jparams, jcfg = jhf.load_hf_checkpoint(d)
    _same_config(tcfg, jcfg)
    _same_trees(tparams, jparams)
    with open(os.path.join(d, "config.json")) as fh:
        _same_config(thf.config_from_hf(json.load(fh)), jhf.config_from_hf(FAMILIES[name]))


@pytest.mark.parametrize("name", ["llama", "gptj", "falcon_new"])
def test_bf16_checkpoint_imports_exactly(tmp_path, name):
    d = _write_family(tmp_path, name, bf16=True)
    tparams, _ = thf.load_hf_checkpoint(d, device="cpu")
    jparams, _ = jhf.load_hf_checkpoint(d)
    _same_trees(tparams, jparams)
    bf, _ = thf.load_hf_checkpoint(d, device="cpu", dtype=torch.bfloat16)
    for k, v in _flat(bf).items():  # the fp32 of bf16 values rounds back exactly
        assert v.dtype == torch.bfloat16 and torch.equal(v.float(), _flat(tparams)[k]), k


def test_mixtral_raises_item_7():
    """Mixtral imports now (``tests/test_torch_moe.py`` holds its tensors
    against JAX): its config maps as JAX maps it.  Its experts train across
    ranks (``tests/test_torch_expert.py``); what stays item 7
    is serving them across an expert axis."""
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh

    for hf in (dict(FAMILIES["llama"], model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2),
               dict(FAMILIES["llama"], num_local_experts=2)):
        _same_config(thf.config_from_hf(hf), jhf.config_from_hf(hf))
    with pytest.raises(NotImplementedError, match="item 7"):
        initialize_mesh(devices=["cpu"] * 2, expert=2)


@pytest.mark.parametrize("preset", ["tiny", "tiny_qwen_like"])
def test_export_round_trips_across_packages(tmp_path, preset):
    over = dict(qkv_bias=True) if preset == "tiny_qwen_like" else {}
    jcfg = j_preset("tiny", dtype=jnp.float32, **over)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(1), jcfg))
    tcfg = get_preset("tiny", dtype=torch.float32, **over)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jhf.export_hf_checkpoint(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, jdir)
    thf.export_hf_checkpoint(tp, tcfg, tdir)
    assert filecmp.cmp(os.path.join(jdir, "model.safetensors"),
                       os.path.join(tdir, "model.safetensors"), shallow=False)
    assert json.load(open(os.path.join(jdir, "config.json"))) == \
        json.load(open(os.path.join(tdir, "config.json")))
    for src in (jdir, tdir):  # JAX export -> both loaders, and the reverse
        tparams, tcfg2 = thf.load_hf_checkpoint(src, device="cpu")
        jparams, jcfg2 = jhf.load_hf_checkpoint(src)
        _same_trees(tparams, jparams)
        _same_config(tcfg2, jcfg2)
        _same_trees(tparams, jp)  # and equal to the tree exported


def test_safetensors_io_is_byte_identical_to_the_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "w.f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "w.bf16": torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)).bfloat16(),
        "f16": torch.from_numpy(rng.standard_normal(7).astype(np.float16)),
        "f64": torch.tensor([1.5, -2.0], dtype=torch.float64),
        "i64": torch.arange(5), "i32": torch.arange(3, dtype=torch.int32),
        "i16": torch.tensor([-3, 4], dtype=torch.int16), "i8": torch.tensor([-1], dtype=torch.int8),
        "u8": torch.tensor([1, 2, 255], dtype=torch.uint8),
        "bool": torch.tensor([True, False]), "scalar": torch.tensor(3.25),
        "empty": torch.zeros(0, 4), "a.first": torch.ones(2, 2),
    }
    # (metadata of one key: the package writes a larger map in hash order)
    for md in (None, {"format": "pt"}):
        ref, mine = str(tmp_path / "ref.st"), str(tmp_path / "mine.st")
        st_torch.save_file(tensors, ref, metadata=md)
        sio.write_safetensors(mine, [(k, v.dtype, tuple(v.shape)) for k, v in tensors.items()],
                              tensors.__getitem__, metadata=md)
        assert filecmp.cmp(ref, mine, shallow=False)
        reader = sio.SafetensorsReader(ref)
        got, want = {k: reader.get(k) for k in reader.keys()}, st_torch.load_file(ref)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert sio.SafetensorsReader(ref).metadata == md


def test_initialize_from_a_hf_directory_trains(tmp_path):
    """``initialize(model=<dir>)`` streams the weights onto the device: the
    masters equal the imported tree, the model's config comes from
    ``config.json``, and the engine trains."""
    d = _write_family(tmp_path, "qwen2")
    engine, _, _, _ = tds.initialize(
        model=d, config={"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False}},
        device="cpu")
    want, cfg = thf.load_hf_checkpoint(d, device="cpu")
    assert engine.model.cfg == cfg and cfg.qkv_bias
    for k, v in _flat(want).items():
        assert torch.equal(_flat(engine.params)[k].detach(), v), k
    batch = {"input_ids": np.random.default_rng(0).integers(0, V, (1, 2, 9)).astype(np.int64)}
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[2] < losses[0]
