"""The hybrid engine (``deepspeed_tpu_torch/runtime/hybrid_engine.py``)
against the JAX package's, on the CPU in fp32 on ``tiny``: the contracts of
JAX's three hybrid tests (``tests/test_hybrid_autotp.py``), each with the
port's tokens equal to JAX's — generate, train, generate (the generations
follow the weights without a new serving engine); ``generate_batch`` equal
to one ``generate`` a prompt; and LoRA merged before generate.  Greedy
decoding, so the comparison is of token ids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.linear import LoRACausalLM as JLoRA
from deepspeed_tpu.linear import LoRAConfig as JLoRAConfig
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime.hybrid_engine import DeepSpeedHybridEngine as JHybrid

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.linear import LoRACausalLM, LoRAConfig, lora_params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

CONFIG = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "adamw", "params": {"lr": 5e-3}}, "bf16": {"enabled": False},
          "steps_per_print": 1000}
HYBRID = dict(max_seqs=4, num_blocks=64, block_size=8)


def _pair(lora: bool):
    jcfg = j_preset("tiny", max_seq_len=64, dtype=jnp.float32)
    tcfg = get_preset("tiny", max_seq_len=64, dtype=torch.float32)
    if lora:
        jmodel = JLoRA(jt.CausalLM(jcfg), JLoRAConfig(lora_r=4, base_dtype=jnp.float32))
        tree = jmodel.init_params(jax.random.PRNGKey(0))
        model = LoRACausalLM(tt.CausalLM(tcfg), LoRAConfig(lora_r=4, base_dtype=torch.float32))
        params = lora_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    else:
        jmodel = jt.CausalLM(jcfg)
        tree = jt.init_params(jax.random.PRNGKey(0), jcfg)
        model = tt.CausalLM(tcfg)
        params = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), tcfg,
                                      device="cpu")
    jengine, _, _, _ = jds.initialize(model=jmodel, params=tree, config=CONFIG,
                                      mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    engine, _, _, _ = tds.initialize(model=model, params=params, config=CONFIG, device="cpu")
    return JHybrid(jengine, **HYBRID), DeepSpeedHybridEngine(engine, **HYBRID)


def _greedy(n):
    return JSampling(max_new_tokens=n, temperature=0.0), SamplingParams(max_new_tokens=n,
                                                                        temperature=0.0)


def test_train_generate_loop_follows_the_weights_as_jax():
    jh, th = _pair(lora=False)
    rng = np.random.default_rng(0)
    prompt = list(map(int, rng.integers(1, 250, 9)))
    js, ts = _greedy(6)
    out0 = th.generate(prompt, ts)
    assert out0 == jh.generate(prompt, js) and len(out0) == 6
    batch = {"input_ids": rng.integers(0, 256, (2, 65)).astype(np.int32)}
    for _ in range(5):
        jh.train_batch(batch)
        th.train_batch(batch)  # delegation
    serving = {id(t) for t in th._inference.params["layers"]["attn"].values()}
    out1 = th.generate(prompt, ts)
    assert out1 == jh.generate(prompt, js)
    assert out1 != out0  # the weights moved and the generations follow
    assert th.generate(prompt, ts) == out1  # deterministic at fixed weights
    # refresh wrote into the serving tensors: the same tensors, new values
    assert {id(t) for t in th._inference.params["layers"]["attn"].values()} == serving
    np.testing.assert_array_equal(th._inference.params["layers"]["attn"]["wq"].numpy(),
                                  th.engine.params["layers"]["attn"]["wq"].detach().numpy())
    assert th._inference.params["layers"]["attn"]["wq"].data_ptr() != \
        th.engine.params["layers"]["attn"]["wq"].data_ptr()  # a copy, not the masters


def test_generate_batch_matches_single_and_jax():
    jh, th = _pair(lora=False)
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, 250, n))) for n in (5, 9, 13)]
    js, ts = _greedy(5)
    batched = th.generate_batch(prompts, ts)
    assert batched == jh.generate_batch(prompts, js)
    assert batched == [th.generate(p, ts) for p in prompts]


def test_lora_is_merged_before_generate_as_jax():
    jh, th = _pair(lora=True)
    rng = np.random.default_rng(2)
    prompt = list(map(int, rng.integers(1, 250, 7)))
    js, ts = _greedy(4)
    before = th.generate(prompt, ts)
    assert before == jh.generate(prompt, js)
    batch = {"input_ids": rng.integers(0, 256, (2, 65)).astype(np.int32)}
    for _ in range(4):
        jh.train_batch(batch)
        th.train_batch(batch)
    after = th.generate(prompt, ts)
    assert after == jh.generate(prompt, js) and len(after) == 4
    merged = th.model.export_merged(th.engine.params)
    np.testing.assert_array_equal(th._inference.params["layers"]["mlp"]["w_up"].numpy(),
                                  merged["layers"]["mlp"]["w_up"].numpy())
    assert not torch.equal(merged["layers"]["mlp"]["w_up"],
                           th.engine.params["base"]["layers"]["mlp"]["w_up"])


def test_initialize_returns_the_hybrid_engine_with_its_clamp():
    tcfg = get_preset("tiny", max_seq_len=64, dtype=torch.float32)
    cfg = dict(CONFIG, hybrid_engine={"enabled": True, "max_out_tokens": 3})
    engine, same, _, sched = tds.initialize(model=tt.CausalLM(tcfg), config=cfg, device="cpu")
    assert isinstance(engine, DeepSpeedHybridEngine) and same is engine
    assert sched is engine.lr_scheduler  # delegated
    out = engine.generate([3, 4, 5], SamplingParams(max_new_tokens=10, temperature=0.0))
    assert len(out) == 3
    with pytest.raises(ConfigError, match="inference_tp_size"):
        tds.initialize(model=tt.CausalLM(tcfg), device="cpu",
                       config=dict(CONFIG, hybrid_engine={"enabled": True,
                                                          "inference_tp_size": 2}))
    with pytest.raises(ValueError, match="model adapter"):
        DeepSpeedHybridEngine(tds.initialize(loss_fn=lambda p, b, r: p["w"].sum(),
                                             params={"w": torch.ones(2)}, config=CONFIG,
                                             device="cpu")[0])


def _payload_bytes(tree):
    """A copy of every leaf of a (mixed) serving tree as raw bytes, by path."""
    from deepspeed_tpu_torch.ops.quantizer import ServingQuant, ServingQuantFP6

    out = {}

    def walk(node, path):
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                walk(v, p)
            elif isinstance(v, ServingQuant):
                out[p + ".q"], out[p + ".s"] = v.q.view(torch.uint8).numpy(), v.s.numpy()
            elif isinstance(v, ServingQuantFP6):
                out[p + ".packed"], out[p + ".s"] = v.packed.numpy(), v.s.numpy()
            else:
                out[p] = v.numpy()

    walk(tree, "")
    return {p: a.copy() for p, a in out.items()}


@pytest.mark.parametrize("fmt", ["int8", "fp8", "fp6"])
def test_quantized_refresh_requantizes_in_place(fmt):
    """generate -> train_batch -> generate through a quantized hybrid engine
    (the refresh raised ``AttributeError`` on the payloads before): the
    second generate's tokens equal a fresh quantized engine's built from the
    trained weights, every payload byte equals a fresh
    ``quantize_serving_params`` of them, and the payload tensors are the
    ones the first generate read (a captured burst graph keeps them)."""
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.ops.quantizer import quantize_serving_params

    tcfg = get_preset("tiny", max_seq_len=64, dtype=torch.float32)
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), config=CONFIG, device="cpu")
    th = DeepSpeedHybridEngine(engine, quantize_weights=fmt, **HYBRID)
    rng = np.random.default_rng(3)
    prompt = list(map(int, rng.integers(1, 250, 9)))
    _, ts = _greedy(6)
    before = th.generate(prompt, ts)
    wq = th._inference.params["layers"]["attn"]["wq"]
    ptrs = [t.data_ptr() for t in (wq.s, wq.q if fmt != "fp6" else wq.packed)]
    old = _payload_bytes(th._inference.params)
    batch = {"input_ids": rng.integers(0, 256, (2, 65)).astype(np.int32)}
    for _ in range(3):
        th.train_batch(batch)
    after = th.generate(prompt, ts)
    trained = th._serving_params()
    fresh = InferenceEngineV2(params=trained, cfg=th._infer_cfg, device="cpu",
                              quantize_weights=fmt, **HYBRID)
    assert after == fresh.generate(prompt, ts) and len(after) == 6
    got, want = _payload_bytes(th._inference.params), _payload_bytes(
        quantize_serving_params(trained, fmt))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    assert any(not np.array_equal(old[p], got[p]) for p in got)  # the weights moved
    wq = th._inference.params["layers"]["attn"]["wq"]
    assert [t.data_ptr() for t in (wq.s, wq.q if fmt != "fp6" else wq.packed)] == ptrs
    assert before != after or fmt == "fp6"
