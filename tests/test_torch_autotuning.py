"""The port's offline autotuner (``deepspeed_tpu_torch/autotuning``) against
the JAX package's, on the CPU.

- the search spaces: every grid (serving, long-context serving, training)
  and every canonical key equal JAX's, in order;
- the roofline: ``serving_feasible``, ``predict_serve_cost``,
  ``train_memory_bytes`` and ``predict_train_cost`` equal JAX's over the
  whole grids when both get the same constants; the port's defaults are
  the H100's; ``calibrate`` takes nothing from the repo's TPU artifacts
  (``BENCH_r0*.json`` / ``MULTICHIP_r0*.json``) and reads records that
  name an NVIDIA card;
- the search: seeded searches over stub runners (halving, incumbents,
  trial caps, failing candidates, latency) give JAX's leaderboard;
- the trial runners on tiny engines: a serve trial measures and leaves no
  leak; candidates the port refuses (``tp`` / ``serve_replicas`` > 1, a
  ZeRO++ key, a mesh) record the refusal's text and the search goes on;
  a kernel fault in a trial raises out of the search, an out-of-memory is
  the candidate's verdict; ``autotune_model``'s winner round-trips
  ``parse_config``.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.autotuning import roofline as jroof
from deepspeed_tpu.autotuning import space as jspace
from deepspeed_tpu.autotuning.autotuner import Autotuner as JAutotuner
from deepspeed_tpu.autotuning.autotuner import leaderboard as jleaderboard
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu_torch.autotuning import roofline, space
from deepspeed_tpu_torch.autotuning.autotuner import (Autotuner, autotune_model,
                                                      autotune_serving, leaderboard,
                                                      write_leaderboard)
from deepspeed_tpu_torch.autotuning.trial import ServeTrialRunner, ServeWorkload, TrainTrialRunner
from deepspeed_tpu_torch.config.config import parse_config
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import CausalLM, init_params
from deepspeed_tpu_torch.ops.kernels import KernelError
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_BASE = {"max_seqs": 8, "num_blocks": 96, "block_size": 32, "enable_prefix_caching": True}
H100 = dict(compute_flops=251.4e12, hbm_gbps=2850.0, ici_gbps=450.0, hbm_bytes=80e9,
            host_tick_s=15.2e-3, ici_hop_s=0.0)
V5E = {f.name: f.default for f in dataclasses.fields(jroof.RooflineConstants)
       if f.name != "sources"}


def _spaces(mod):
    return {
        "serving": mod.serving_space(),
        "serving_longctx": mod.serving_space(longctx=True),
        "serving_narrow": mod.serving_space(tp=(1,), serve_replicas=(1,), quant=(None, "int8"),
                                            prefill_chunk=(None, 128), decode_megastep=(1, 4),
                                            seq_shards=(1,)),
        "training": mod.training_space(),
        "training_meshes": mod.training_space(mesh_candidates=({}, {"fsdp": 2}, {"fsdp": 4}),
                                              zero_quant=(False, True)),
    }


@pytest.mark.parametrize("name", ["serving", "serving_longctx", "serving_narrow", "training",
                                  "training_meshes"])
def test_space_grids_and_keys_equal_jax(name):
    got, want = _spaces(space)[name], _spaces(jspace)[name]
    assert [(k.name, k.values) for k in got.knobs] == [(k.name, k.values) for k in want.knobs]
    assert got.raw_size == want.raw_size
    g, w = got.candidates(), want.candidates()
    assert g == w and len(g) > 1
    assert [space.candidate_key(c) for c in g] == [jspace.candidate_key(c) for c in w]


@pytest.mark.parametrize("consts", ["h100", "v5e", "tiny_hbm"])
@pytest.mark.parametrize("preset", ["tiny", "llama3_proxy_410m", "llama3_8b"])
def test_roofline_equals_jax_under_the_same_constants(preset, consts):
    kw = {"h100": H100, "v5e": V5E, "tiny_hbm": dict(H100, hbm_bytes=2e9)}[consts]
    tc, jc = roofline.RooflineConstants(**kw), jroof.RooflineConstants(**kw)
    tcfg, jcfg = get_preset(preset), j_preset(preset)
    assert tcfg.param_count == jcfg.param_count
    for cand in space.serving_space(longctx=True).grid():
        for n_dev in (1, 4, 8):
            assert roofline.serving_feasible(cand, tcfg, SERVE_BASE, n_dev, tc) == \
                jroof.serving_feasible(cand, jcfg, SERVE_BASE, n_dev, jc)
        assert roofline.predict_serve_cost(cand, tcfg, SERVE_BASE, tc) == \
            jroof.predict_serve_cost(cand, jcfg, SERVE_BASE, jc)
    for cand in _spaces(space)["training_meshes"].grid():
        assert roofline.train_memory_bytes(cand, tcfg, 2048) == \
            jroof.train_memory_bytes(cand, jcfg, 2048)
        assert roofline.training_feasible(cand, tcfg, 2048, 4, tc) == \
            jroof.training_feasible(cand, jcfg, 2048, 4, jc)
        assert roofline.predict_train_cost(cand, tcfg, 2048, tc) == \
            jroof.predict_train_cost(cand, jcfg, 2048, jc)


def test_roofline_defaults_are_the_h100s():
    c = roofline.RooflineConstants()
    assert {k: getattr(c, k) for k in H100} == H100 and c.sources == ()
    cfg = get_preset("tiny")
    cost = lambda cand: roofline.predict_serve_cost(cand, cfg, {"max_seqs": 8})  # noqa: E731
    assert cost({"decode_megastep": 4}) < cost({"decode_megastep": 1})
    ok, why = roofline.serving_feasible({"tp": 1, "serve_replicas": 1, "decode_megastep": 0},
                                        cfg, {"max_seqs": 4, "num_blocks": 64, "block_size": 8}, 8)
    assert not ok and "decode_megastep" in why


def test_calibrate_skips_tpu_artifacts_and_reads_card_records(tmp_path):
    # the repo's own artifacts are TPU runs: nothing calibrates from them
    assert os.path.exists(os.path.join(REPO, "BENCH_r01.json"))
    assert roofline.RooflineConstants.calibrate(REPO) == roofline.RooflineConstants()
    for f in ("BENCH_r01.json", "MULTICHIP_r01.json"):  # copied beside card records
        with open(os.path.join(REPO, f)) as src:
            (tmp_path / f).write_text(src.read())
    gpu = "NVIDIA H100 80GB HBM3, 700.00 W"
    lines = [
        "build output that is not JSON",
        json.dumps({"phase": "train", "tokens_per_s": 66_000.0, "flops_per_token": 4e9,
                    "params": 430_752_768, "gpu": gpu}),
        json.dumps({"phase": "timings", "gpu": gpu, "fused_adamw": {
            "ms": 4.0, "bound_ms": 3.4, "bound_by": "bytes"}, "quant": {"x": {
                "ms": 1.0, "bound_ms": 0.5, "bound_by": "bytes"}, "y": {
                "ms": 1.0, "bound_ms": 0.9, "bound_by": "operations"}}}),
        json.dumps({"phase": "train", "tokens_per_s": 1e9, "params": 1e9,
                    "gpu": "TPU v5 lite"}),  # not an NVIDIA card: skipped
    ]
    (tmp_path / "smoke.log").write_text("\n".join(lines) + "\n")
    (tmp_path / "broken.json").write_text("{not json")
    c = roofline.RooflineConstants.calibrate(str(tmp_path))
    assert c.compute_flops == pytest.approx(66_000.0 * 4e9)
    assert c.hbm_gbps == pytest.approx(3.35e12 * 3.4 / 4.0 / 1e9)
    assert c.sources == ("smoke.log",)
    assert c.host_tick_s == H100["host_tick_s"]  # uninformed: the default


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------
def _line_space(mod, n=8):
    return mod.SearchSpace(knobs=[mod.Knob("x", tuple(range(n)))])


def _stub(seed, fail=()):
    rng = np.random.default_rng(seed)
    noise = {x: float(rng.normal(0, 5)) for x in range(8)}

    def runner(c, budget):
        if c["x"] in fail:
            raise NotImplementedError(f"candidate x={c['x']} is not ported yet (ROADMAP queue 1 "
                                      "item 7)")
        return 50.0 + c["x"] + noise[c["x"]] * budget, {"budget": budget}
    return runner


SEARCHES = {
    "seeded": dict(cost_model=lambda c: 1.0 / (1 + c["x"]), rungs=(0.5, 1.0), top_k=4, seed=3),
    "halving": dict(rungs=(0.25, 0.5, 1.0), eta=2, top_k=4, incumbent={"x": 0}),
    "tight_budget": dict(cost_model=lambda c: 1.0 / (1 + c["x"]), rungs=(1.0,), top_k=3,
                         max_trials=3, incumbent={"x": 0}),
    "capped": dict(rungs=(0.5, 1.0), top_k=8, max_trials=5),
    "latency": dict(metric="latency", rungs=(0.5, 1.0), top_k=4, eta=2),
    "pruned_and_refused": dict(feasibility=lambda c: (False, "pruned:structural: odd")
                               if c["x"] in (1, 3) else (True, "ok"), rungs=(1.0,), top_k=8),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_seeded_search_gives_jax_leaderboard(name, tmp_path):
    kw = SEARCHES[name]
    fail = (2, 5) if name == "pruned_and_refused" else ()
    runs = {}
    for pkg, (A, mod, board) in {"port": (Autotuner, space, leaderboard),
                                 "jax": (JAutotuner, jspace, jleaderboard)}.items():
        t = A(_line_space(mod), _stub(kw.get("seed", 0), fail), **kw)
        w, trials = t.search()
        runs[pkg] = (w.candidate if w else None, board(trials, {"search": name}),
                     t.pruned_fraction)
    assert runs["port"] == runs["jax"]
    path = tmp_path / "board.json"
    t = Autotuner(_line_space(space), _stub(kw.get("seed", 0), fail), **kw)
    _, trials = t.search()
    assert json.loads(json.dumps(write_leaderboard(str(path), trials, {"search": name}))) == \
        json.loads(path.read_text())
    if fail:
        errs = [r["verdict"] for r in runs["port"][1]["trials"] if r["verdict"].startswith("error")]
        assert len(errs) == 2 and all("item 7" in e for e in errs)


# ---------------------------------------------------------------------------
# the trial runners on the port's engines (tiny, CPU)
# ---------------------------------------------------------------------------
def test_serve_search_measures_and_records_refusals():
    """``autotune_serving`` on a tiny engine over buildable rows plus
    ``serve_replicas`` 2 (let through by a 2-device declaration): every
    buildable row measures leak-free, every refused row's verdict carries
    the port's refusal text, and the winner rebuilds and serves."""
    cfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    base = dict(max_seqs=4, num_blocks=64, block_size=8, prefill_buckets=[16, 32, 64],
                max_seq_len=256, enable_prefix_caching=True)
    sp = space.serving_space(tp=(1,), serve_replicas=(1, 2), quant=(None,),
                             prefill_chunk=(None, 16), kv_watermark=(0.0625,), spec=(False,),
                             quant_comm=("none",), decode_megastep=(1, 4), seq_shards=(1,))
    wl = ServeWorkload(n_req=4, sys_len=24, sfx_len=8, max_new=6)
    w, trials, tuner = autotune_serving(params, cfg, workload=wl, base=base, space=sp,
                                        rungs=(1.0,), top_k=8, device="cpu", n_devices=2)
    refused = [t for t in trials if t.candidate["serve_replicas"] == 2]
    measured = [t for t in trials if t.measured]
    assert len(refused) == 4 and len(measured) == 4
    assert all(t.verdict == "error:NotImplementedError: serve_engine.serve_replicas=2 is not "
               "ported yet (ROADMAP queue 1 item 7)" for t in refused)
    assert all(t.metrics["finished"] == wl.n_req for t in measured)
    assert w is not None and w.candidate["serve_replicas"] == 1
    runner = ServeTrialRunner(params, cfg, wl, base=base, device="cpu")
    score, metrics = runner(w.candidate)  # the winner rebuilds and serves, leak-free
    assert score > 0 and metrics["finished"] == wl.n_req
    assert tuner.consts == roofline.RooflineConstants()


FAULTS = {
    "kernel_error": lambda: KernelError("CUDA kernel flash_fwd failed to launch: cudaError 719"),
    "out_of_memory": lambda: torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                                         "allocate 2.00 GiB"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_serve_search_raises_kernel_faults_and_records_out_of_memory(fault, monkeypatch):
    """A kernel or CUDA fault in a trial's prefill launch raises out of
    ``autotune_serving`` (``ops.kernels.surfaces``: it is no candidate's
    verdict); an out-of-memory stays the candidate's ``error:*`` verdict
    and the search goes on."""
    from deepspeed_tpu_torch.inference import model_runner

    cfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    base = dict(max_seqs=4, num_blocks=64, block_size=8, prefill_buckets=[16, 32, 64],
                max_seq_len=256, enable_prefix_caching=True)
    sp = space.serving_space(tp=(1,), serve_replicas=(1,), quant=(None,),
                             prefill_chunk=(None,), kv_watermark=(0.0625,), spec=(False,),
                             quant_comm=("none",), decode_megastep=(1, 4), seq_shards=(1,))
    wl = ServeWorkload(n_req=4, sys_len=24, sfx_len=8, max_new=6)

    def launch(*a, **k):
        raise FAULTS[fault]()

    monkeypatch.setattr(model_runner, "flash_attention", launch)
    kw = dict(workload=wl, base=base, space=sp, rungs=(1.0,), top_k=8, device="cpu")
    if fault == "kernel_error":
        with pytest.raises(KernelError, match="flash_fwd failed to launch"):
            autotune_serving(params, cfg, **kw)
        return
    w, trials, _ = autotune_serving(params, cfg, **kw)
    assert w is None and len(trials) == 2
    assert all(t.verdict.startswith("error:OutOfMemoryError: CUDA out of memory")
               for t in trials)


def test_train_search_records_refusals_and_winner_roundtrips():
    """``autotune_model`` on ``tiny``: a mesh row of 2 ranks is pruned on
    one device (its verdict carries the text), the search goes on, the
    ZeRO++ rows and the one-rank mesh rows measure (they were refused
    until the distributed layers; they run as on JAX's one-device mesh),
    and the winner config round-trips ``parse_config``."""
    cfg, trials = autotune_model(
        "tiny", seq_len=32, base_config={"optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                                         "bf16": {"enabled": False}},
        micro_batches=(1, 2), remat_policies=("none",), zero_stages=(1, 3),
        zero_quant=(False, True), mesh_candidates=({}, {"fsdp": 1}, {"fsdp": 2}), steps=1,
        top_k=24, device="cpu")
    assert cfg is not None
    zq = [t for t in trials if t.candidate["zero_quant"] and not t.candidate["mesh"]]
    one = [t for t in trials if t.candidate["mesh"] == {"fsdp": 1}]
    two = [t.verdict for t in trials if t.candidate["mesh"] == {"fsdp": 2}]
    assert zq and one and all(t.measured for t in zq + one)
    assert two and all(v.startswith("pruned:structural: mesh extent 2") for v in two)
    assert any(t.measured for t in trials)
    assert parse_config(cfg).train_micro_batch_size_per_gpu == \
        cfg["train_micro_batch_size_per_gpu"]
    assert cfg["autotuning"]["calibration_sources"] == []


def test_train_trial_runner_config_equals_jax():
    from deepspeed_tpu.autotuning.trial import TrainTrialRunner as JTrainTrialRunner

    base = {"optimizer": {"type": "adamw"}, "zero_optimization": {"stage": 1}}
    for cand in _spaces(space)["training"].grid():
        got = TrainTrialRunner(lambda r: None, base, 32).config_for(cand)
        want = JTrainTrialRunner(lambda r: None, base, 32).config_for(cand)
        assert got == want
    model = CausalLM(get_preset("tiny", dtype=torch.float32))
    runner = TrainTrialRunner(lambda r: model, {"bf16": {"enabled": False}}, 16, steps=1,
                              device="cpu")
    score, metrics = runner({"micro_batch": 1, "zero_stage": 0, "remat": "none"})
    assert score > 0 and np.isfinite(metrics["loss"])
