"""The port's checkpoints (``deepspeed_tpu_torch/checkpoint/engine.py``,
``saving.py``) on the CPU, on ``tiny`` in fp32.

- save, load into a fresh engine, continue: the losses, masters, moments
  and counters are bitwise those of the run that was never interrupted,
  with the sync and the async engine, saved mid-``train_on_loader`` with
  batches parked in the prefetcher (the data position is the drained one);
- against the JAX package: both engines take the same steps on the same
  data, save, and a fresh engine of each loads and continues; the losses
  and ``export_fp32_state_dict`` agree within ``test_torch_training.py``'s
  engine tolerance, and ``meta.json``'s keys and values equal JAX's apart
  from ``shard_checksums``;
- the counterparts of JAX ``tests/test_checkpoint.py``: the latest tag, a
  missing checkpoint, an atomic save with checksums, a crash at each of
  the three ``checkpoint_crash`` stages (each leaves the previous tag
  loadable), ``latest`` published last, the fallback over a corrupt shard
  (an explicit tag raises), an async save whose ``latest`` appears only at
  its commit;
- the reference's load options and the files' layout (one raw file per
  leaf, a manifest, no pickle).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint.saving import export_fp32_state_dict as j_export
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import saving
from deepspeed_tpu_torch.checkpoint.engine import AsyncCheckpointEngine, SyncCheckpointEngine
from deepspeed_tpu_torch.inference import faults
from deepspeed_tpu_torch.inference.faults import CheckpointWriteCrash, FaultInjector
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)  # test_torch_training.py's
CONF = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"weight_decay": 0.1}},
    "scheduler": {"type": "WarmupCosineLR",
                  "params": {"total_num_steps": 8, "warmup_num_steps": 2, "lr": 3e-3}},
    "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000, "seed": 3,
}


class TokDataset:
    def __init__(self, n=40, seq=17, vocab=256, seed=0):
        self.x = np.random.default_rng(seed).integers(0, vocab, (n, seq)).astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"input_ids": self.x[i]}


@pytest.fixture(scope="module")
def jparams():
    jcfg = j_preset("tiny", dtype=jnp.float32)
    return jcfg, jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))


def _engine(jp, **over):
    tcfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    params = tt.params_from_numpy(jp, tcfg, device="cpu")
    engine, _, loader, _ = tds.initialize(model=tt.CausalLM(tcfg), params=params,
                                          config={**CONF, **over}, device="cpu",
                                          training_data=TokDataset())
    return engine, loader


def _jax_engine(jcfg, jp):
    engine, _, loader, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp), config=CONF,
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1), training_data=TokDataset())
    return engine, loader


def _state_bytes(engine):
    """Every leaf of the training state, and the counters, as bytes."""
    out = {k: v.detach().reshape(-1).view(torch.uint8).numpy().tobytes()
           for k, v in saving.train_state(engine).items()}
    out["counters"] = (engine.global_steps, engine.skipped_steps,
                       engine.lr_scheduler.state_dict()["last_step"])
    return out


@pytest.mark.parametrize("extra", [{}, {"checkpoint": {"async_save": True}}],
                         ids=["sync", "async"])
def test_resume_mid_loader_is_bitwise_the_uninterrupted_run(jparams, tmp_path, extra):
    """Save after one step with batches parked in the prefetcher; a fresh
    engine loads and takes the next steps: losses and state to the bit."""
    _, jp = jparams
    ref, ref_loader = _engine(jp)
    want = [float(x) for x in ref.train_on_loader(ref_loader, num_steps=3)]
    a, loader_a = _engine(jp, **extra)
    gen = a.train_on_loader(loader_a)
    got = [float(next(gen))]
    assert a._active_prefetcher.qsize() > 0 or loader_a.state_dict()["consumed_samples"] > 4
    a.save_checkpoint(str(tmp_path), tag="mid")
    at_save = _state_bytes(a)
    ce = a._ckpt_engine
    assert isinstance(ce, AsyncCheckpointEngine if extra else SyncCheckpointEngine)
    if extra:
        assert ce.pending and saving.get_latest_tag(str(tmp_path)) is None
        next(gen)  # the next step runs while the write is pending
        assert saving.get_latest_tag(str(tmp_path)) is None
        a.wait_pending_checkpoint()
    gen.close()
    assert saving.get_latest_tag(str(tmp_path)) == "mid"
    meta = json.load(open(tmp_path / "mid" / "meta.json"))
    assert meta["data_sampler"] == {"consumed_samples": 4, "seed": 3}
    b, loader_b = _engine(jp, **extra)
    path, client = b.load_checkpoint(str(tmp_path))
    assert path.endswith("mid") and client == {}
    assert _state_bytes(b) == at_save
    assert loader_b.state_dict() == {"consumed_samples": 4, "seed": 3}
    got += [float(x) for x in b.train_on_loader(loader_b, num_steps=2)]
    assert got == want
    assert _state_bytes(b) == _state_bytes(ref)


@pytest.mark.parametrize("conf,kind", [({}, SyncCheckpointEngine),
                                       ({"checkpoint": {"async_save": True}},
                                        AsyncCheckpointEngine),
                                       ({"nebula": {"enabled": True}}, AsyncCheckpointEngine)])
def test_config_selects_the_checkpoint_engine(jparams, tmp_path, conf, kind):
    """``checkpoint.async_save`` or ``nebula.enabled`` selects the async
    engine (JAX ``get_checkpoint_engine``), made once per engine."""
    _, jp = jparams
    e, _ = _engine(jp, **conf)
    e.save_checkpoint(str(tmp_path), tag="t")
    assert type(e._ckpt_engine) is kind
    e.wait_pending_checkpoint()
    ce = e._ckpt_engine
    e.load_checkpoint(str(tmp_path))
    assert e._ckpt_engine is ce and saving.get_latest_tag(str(tmp_path)) == "t"


def test_checkpoint_against_the_jax_engine(jparams, tmp_path):
    """Both packages take 2 steps on the same loader, save, and a fresh
    engine of each loads and takes 2 more: losses and the fp32 export agree
    within the engine tolerance; meta.json equals JAX's but for the
    checksums."""
    jcfg, jp = jparams
    runs = {}
    for pkg in ("jax", "port"):
        make = (lambda: _jax_engine(jcfg, jp)) if pkg == "jax" else (lambda: _engine(jp))
        e, loader = make()
        it = iter(loader)
        losses = [float(e.train_batch(next(it))) for _ in range(2)]
        e.save_checkpoint(str(tmp_path / pkg), tag="t2", client_state={"epoch": 0, "k": [1]})
        e2, loader2 = make()
        path, client = e2.load_checkpoint(str(tmp_path / pkg))
        assert client == {"epoch": 0, "k": [1]}
        it2 = iter(loader2)
        losses += [float(e2.train_batch(next(it2))) for _ in range(2)]
        export = (j_export(e2) if pkg == "jax" else
                  {k: v.numpy() for k, v in _flat(saving.export_fp32_state_dict(e2)).items()})
        meta = json.load(open(os.path.join(path, "meta.json")))
        runs[pkg] = (losses, _flat(export) if pkg == "jax" else export, meta)
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], **ENGINE_TOL)
    assert set(runs["port"][1]) == set(runs["jax"][1])
    for k, v in runs["jax"][1].items():
        assert runs["port"][1][k].dtype == np.float32
        np.testing.assert_allclose(runs["port"][1][k], np.asarray(v), err_msg=k, **ENGINE_TOL)
    jmeta, tmeta = runs["jax"][2], runs["port"][2]
    jmeta.pop("shard_checksums")
    tmeta.pop("shard_checksums")
    assert tmeta == jmeta


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _trained(jp, steps=2, **over):
    e, loader = _engine(jp, **over)
    it = iter(loader)
    for _ in range(steps):
        e.train_batch(next(it))
    return e, it


def test_latest_tag_and_missing_checkpoint(jparams, tmp_path):
    _, jp = jparams
    e, _ = _engine(jp)
    assert e.load_checkpoint(str(tmp_path)) == (None, {})
    e.save_checkpoint(str(tmp_path))  # default tag global_step0
    assert saving.get_latest_tag(str(tmp_path)) == "global_step0"
    path, _ = e.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step0")
    e.save_checkpoint(str(tmp_path), tag="quiet", save_latest=False)
    assert saving.get_latest_tag(str(tmp_path)) == "global_step0"


def test_save_is_atomic_with_checksums_and_raw_leaves(jparams, tmp_path):
    _, jp = jparams
    e, _ = _trained(jp)
    e.save_checkpoint(str(tmp_path), tag="t1")
    assert not os.path.isdir(tmp_path / "t1.tmp")
    meta = json.load(open(tmp_path / "t1" / "meta.json"))
    assert sorted(meta) == sorted(["global_steps", "skipped_steps", "lr_scheduler",
                                   "client_state", "zero_stage", "dp_world_size",
                                   "data_sampler", "shard_checksums"])
    assert saving._tree_checksums(str(tmp_path / "t1")) == meta["shard_checksums"]
    assert saving.verify_tag(str(tmp_path), "t1") is None
    manifest = json.load(open(tmp_path / "t1" / "state" / "manifest.json"))
    state = saving.train_state(e)
    assert set(manifest) == set(state)
    for name, t in state.items():
        raw = open(tmp_path / "t1" / "state" / name, "rb").read()
        assert raw == t.detach().reshape(-1).view(torch.uint8).numpy().tobytes(), name
        assert manifest[name]["shape"] == list(t.shape)
    assert "params/layers/attn/wq" in state and "opt_state/mu/layers/attn/wq" in state
    assert {"step", "opt_state/count", "loss_scale/scale", "rng"} <= set(state)


@pytest.mark.parametrize("stage_index,stage", enumerate(
    ["after_shards", "before_rename", "before_latest"]))
def test_crash_at_each_stage_leaves_the_previous_tag_loadable(jparams, tmp_path,
                                                              stage_index, stage):
    _, jp = jparams
    e, it = _trained(jp)
    e.save_checkpoint(str(tmp_path), tag="good")
    good = _state_bytes(e)
    e.train_batch(next(it))
    with faults.scope(FaultInjector().arm("checkpoint_crash", after=stage_index, times=1)):
        with pytest.raises(CheckpointWriteCrash) as err:
            e.save_checkpoint(str(tmp_path), tag="torn")
    assert err.value.ctx["stage"] == stage
    assert saving.get_latest_tag(str(tmp_path)) == "good"  # never repointed
    # before the rename the torn save is only a .tmp leftover; after it the
    # tag is complete but unpublished
    assert os.path.isdir(tmp_path / "torn") == (stage == "before_latest")
    assert os.path.isdir(tmp_path / "torn.tmp") == (stage != "before_latest")
    e2, _ = _engine(jp)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("good") and _state_bytes(e2) == good
    e.save_checkpoint(str(tmp_path), tag="torn")  # a retry cleans up and publishes
    assert saving.get_latest_tag(str(tmp_path)) == "torn"
    assert not os.path.isdir(tmp_path / "torn.tmp")


def test_resave_of_a_tag_swaps_it_whole(jparams, tmp_path):
    _, jp = jparams
    e, it = _trained(jp)
    e.save_checkpoint(str(tmp_path), tag="same")
    e.train_batch(next(it))
    e.save_checkpoint(str(tmp_path), tag="same")
    assert sorted(os.listdir(tmp_path)) == ["latest", "same"]
    e2, _ = _engine(jp)
    e2.load_checkpoint(str(tmp_path))
    assert _state_bytes(e2) == _state_bytes(e)


def test_corrupt_shard_falls_back_to_the_previous_tag(jparams, tmp_path):
    _, jp = jparams
    e, it = _trained(jp)
    e.save_checkpoint(str(tmp_path), tag="older")
    older = _state_bytes(e)
    e.train_batch(next(it))
    e.save_checkpoint(str(tmp_path), tag="newer")
    victim = tmp_path / "newer" / "state" / "params" / "embed" / "embedding"
    raw = bytearray(victim.read_bytes())
    raw[:16] = bytes(255 - b for b in raw[:16])
    victim.write_bytes(bytes(raw))
    assert "checksum mismatch" in saving.verify_tag(str(tmp_path), "newer")
    e2, _ = _engine(jp)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("older") and _state_bytes(e2) == older
    e3, _ = _engine(jp)
    with pytest.raises(RuntimeError, match="failed verification"):
        e3.load_checkpoint(str(tmp_path), tag="newer")


def test_load_options(jparams, tmp_path):
    """``load_optimizer_states=False`` / ``load_module_only`` keep the fresh
    engine's moments; ``load_lr_scheduler_states=False`` its scheduler;
    ``custom_load_fn`` is refused; a leaf of another shape raises."""
    _, jp = jparams
    e, _ = _trained(jp)
    e.save_checkpoint(str(tmp_path), tag="t")
    saved = _state_bytes(e)
    for kw in (dict(load_optimizer_states=False), dict(load_module_only=True)):
        f, _ = _engine(jp)
        fresh = _state_bytes(f)
        f.load_checkpoint(str(tmp_path), **kw)
        got = _state_bytes(f)
        for k in saved:
            if k.startswith("opt_state/"):
                assert got[k] == fresh[k], k
            elif k.startswith("params/"):
                assert got[k] == saved[k], k
        assert (f.lr_scheduler.state_dict() == e.lr_scheduler.state_dict()) == (
            "load_module_only" not in kw)
    f, _ = _engine(jp)
    with pytest.raises(NotImplementedError, match="custom_load_fn"):
        f.load_checkpoint(str(tmp_path), custom_load_fn=lambda *a: None)
    manifest = tmp_path / "t" / "state" / "manifest.json"
    m = json.loads(manifest.read_text())
    m["step"]["shape"] = [2]
    manifest.write_text(json.dumps(m))
    meta_p = tmp_path / "t" / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["shard_checksums"] = saving._tree_checksums(str(tmp_path / "t"))
    meta_p.write_text(json.dumps(meta))
    f, _ = _engine(jp)
    with pytest.raises(ValueError, match="leaf 'step'"):
        f.load_checkpoint(str(tmp_path), tag="t")


def test_async_commit_publishes_latest_and_repeating_loader_drains(jparams, tmp_path):
    """JAX ``test_checkpoint.py:216``: an async save's ``latest`` appears only
    after its commit; a second save commits the first before starting.  The
    drained position is recorded through a ``RepeatingLoader`` wrapper."""
    _, jp = jparams
    e, loader = _engine(jp, checkpoint={"async_save": True})
    gen = e.train_on_loader(RepeatingLoader(loader))
    for _ in range(2):
        next(gen)
    e.save_checkpoint(str(tmp_path), tag="a")
    assert saving.get_latest_tag(str(tmp_path)) is None
    next(gen)
    e.save_checkpoint(str(tmp_path), tag="b")  # commits "a" first
    assert saving.get_latest_tag(str(tmp_path)) == "a"
    e.wait_pending_checkpoint()
    gen.close()
    assert saving.get_latest_tag(str(tmp_path)) == "b"
    metas = [json.load(open(tmp_path / t / "meta.json")) for t in ("a", "b")]
    assert [m["data_sampler"]["consumed_samples"] for m in metas] == [8, 12]
    assert [m["global_steps"] for m in metas] == [2, 3]
