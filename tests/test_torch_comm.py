"""``comm/`` over ``torch.distributed``: the collectives, the comms logger,
the quantized collectives of ``comm/qcomm.py``, the compressed all-reduce
of the 1-bit optimizers and the sparse embedding gradient, on a world of
2 gloo ranks on the CPU (one spawned world runs every case), against
plain numpy for the collectives and against the JAX package's functions
under ``shard_map`` on 2 of the forced CPU devices for the rest.

The payloads are byte-equal: ``qcomm._q_chunks`` (int8 and e4m3, the
plain rows of K6a / K6c on the CPU) against JAX's on the same buffer, bit
for bit.  The collectives' results are equal to JAX's to 1e-6 relative and
2.4e-7 absolute, two ulps at the inputs' magnitude of 1: dequantized
values and fp32 sums of two of them, and the residuals ``x - q * s``, which
XLA computes as one fused multiply-add (3 of 1,040 residual entries move
by one ulp).  The 1-bit all-reduce and its two error
buffers likewise, on inputs with no momentum within rounding of 0.  The
launcher test starts 2 CPU ranks through ``launcher/runner.py
--num_gpus 2`` that train as one job.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from deepspeed_tpu.comm import compressed as jc
from deepspeed_tpu.comm import qcomm as jq
from deepspeed_tpu.ops.sparse_grads import embedding_lookup as j_lookup
from deepspeed_tpu.parallel.sharding import shard_map_compat

import torch_world as W
from deepspeed_tpu_torch.comm import qcomm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = dict(rtol=1e-6, atol=2.4e-7)
FMTS = ("int8", "fp8", "none")


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    m = f(2, 1000)
    m[np.abs(m) < 1e-3] = 0.5  # no momentum within rounding of 0
    return {"a": f(2, 300), "b": f(2, 1040), "e": 0.01 * f(2, 1040), "a2a_w": f(2, 1040),
            "m": m, "we": 0.01 * f(2, 1000), "se": 0.01 * f(2, 500),
            "table": np.broadcast_to(f(16, 8), (2, 16, 8)).copy(),
            "ids": rng.integers(0, 16, (2, 6)), "g": f(2, 6, 8)}


def _jax_side(x):
    """Each quantity on the 2-device mesh, rank by rank (leading axis)."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))

    def body(a, b, e, w, m, we, se, table, ids, g):
        a, b, e, w, m, we, se, table, ids, g = (t[0] for t in (a, b, e, w, m, we, se, table,
                                                               ids, g))
        out = {}
        for fmt in FMTS:
            out[f"ag_{fmt}"] = jq.q_all_gather(a, "data", fmt, tiled=True)
            out[f"rs_{fmt}"], out[f"rs_err_{fmt}"] = jq.q_reduce_scatter(
                b, "data", fmt, mean=True, error=e)
            out[f"ar_{fmt}"] = jq.q_all_reduce(b, "data", fmt)
            out[f"a2a_{fmt}"] = jq.q_all_to_all(b, "data", fmt)
        out["psum_tiled"] = jq.q_psum_tiled(b.reshape(4, -1), "data", "int8", tiles=3)
        out["ring"] = jq.ring_permute(a, "data")
        out["a2a_grad"] = jax.grad(lambda v: (jq.q_all_to_all(v, "data", "int8") * w).sum())(b)
        out["a2a_grad_none"] = jax.grad(
            lambda v: (jq.q_all_to_all(v, "data", "none") * w).sum())(b)
        out["c_mean"], out["c_werr"], out["c_serr"] = jc.compressed_allreduce(m, we, se, "data")
        out["sparse_grad"] = jax.grad(
            lambda t: (j_lookup(t, ids, axis_name="data") * g).sum())(table)
        return {k: v[None] for k, v in out.items()}

    args = [jnp.asarray(x[k]) for k in ("a", "b", "e", "a2a_w", "m", "we", "se", "table", "ids",
                                         "g")]
    fn = shard_map_compat(body, mesh, in_specs=(JP("data"),) * len(args), out_specs=JP("data"))
    return {k: np.asarray(v, dtype=np.float32) for k, v in jax.jit(fn)(*args).items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm_world")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    ranks = W.spawn(2, [dict(name="prim", kind="fn", fn="primitives"),
                        dict(name="q", kind="fn", fn="qcomm", inputs=str(tmp / "inputs.npz"))],
                    tmp)
    return {"ranks": ranks, "x": x, "jax": _jax_side(x)}


def test_collectives_equal_their_numpy_meaning(world):
    xs = [np.arange(8, dtype=np.float32) + 100 * r for r in range(2)]
    for r in range(2):
        got = world["ranks"][r]["prim"]
        np.testing.assert_array_equal(got["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(got["mean"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(got["max"], xs[1])
        np.testing.assert_array_equal(got["min"], xs[0])
        np.testing.assert_array_equal(got["rs"], (xs[0] + xs[1])[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["rs1"], (xs[0] + xs[1]).reshape(2, 4)[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["ag"], np.concatenate([xs[0][:3], xs[1][:3]]))
        np.testing.assert_array_equal(got["ag_stack"], np.stack([xs[0][:3], xs[1][:3]]))
        np.testing.assert_array_equal(got["ag1"], np.concatenate([x.reshape(2, 4) for x in xs], 1))
        np.testing.assert_array_equal(got["a2a"], np.concatenate([x[4 * r:4 * r + 4] for x in xs]))
        np.testing.assert_array_equal(got["a2a_t"],
                                      np.concatenate([x.reshape(2, 4)[r:r + 1] for x in xs], 1))
        np.testing.assert_array_equal(got["bcast"], xs[1])
        np.testing.assert_array_equal(got["next"], xs[1 - r][:2])
        np.testing.assert_array_equal(got["prev"], xs[1 - r][:2])
        assert got["axis_rank"] == r and got["ranks"] == (r, 2, r)


def test_the_comms_logger_counts_each_op_and_its_bytes(world):
    logged = world["ranks"][0]["prim"]["logged"]
    assert logged["all_reduce@data"] == (4, 4 * 32)
    assert logged["reduce_scatter@data"] == (2, 64)
    assert logged["all_gather@data"] == (3, 12 + 12 + 32)
    assert logged["all_to_all@data"] == (2, 64)
    assert logged["broadcast@data"] == (1, 32)
    assert logged["ppermute@data"] == (2, 16)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_payloads_are_byte_equal_to_jax(fmt):
    flat = np.concatenate([_inputs()["b"][0], np.zeros(256 * 5 - 1040, np.float32)])
    flat[:256] *= 1e-6  # a chunk of tiny values; the amax clamp
    flat[256:512] = 0.0  # an all-zero chunk
    jqv, jsv = jax.jit(lambda v: jq._q_chunks(v, fmt, 256))(jnp.asarray(flat))
    tqv, tsv = qcomm._q_chunks(torch.from_numpy(flat), fmt, 256)
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))
    want = np.asarray(jqv).view(np.uint8)
    got = tqv.view(torch.uint8).numpy() if fmt == "fp8" else tqv.numpy().view(np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [f"{op}_{fmt}" for op in ("ag", "rs", "rs_err", "ar", "a2a")
                                  for fmt in FMTS] + ["psum_tiled", "ring", "a2a_grad",
                                                      "a2a_grad_none"])
def test_quantized_collectives_equal_jax(world, name):
    for r in range(2):
        np.testing.assert_allclose(world["ranks"][r]["q"][name], world["jax"][name][r],
                                   err_msg=f"rank {r}", **RTOL)


@pytest.mark.parametrize("name", ["c_mean", "c_werr", "c_serr"])
def test_compressed_allreduce_and_its_errors_equal_jax(world, name):
    for r in range(2):
        np.testing.assert_allclose(world["ranks"][r]["q"][name], world["jax"][name][r],
                                   err_msg=f"rank {r}", **RTOL)


def test_sparse_embedding_gradient_gathers_rows_over_the_axis(world):
    for r in range(2):
        np.testing.assert_allclose(world["ranks"][r]["q"]["sparse_grad"],
                                   world["jax"]["sparse_grad"][r], **RTOL)


def test_reducing_in_int8_is_refused():
    with pytest.raises(qcomm.QCommOverflowError):
        qcomm.q_reduce_scatter(torch.zeros(4), "data", "int8", accum="int8", world=2)


LAUNCHED = textwrap.dedent("""
    import json, os, sys, torch
    import deepspeed_tpu_torch as tds
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(8, 16, generator=g) * 0.3, "w2": torch.randn(16, 4, generator=g) * 0.3}
    def loss_fn(p, b, rng):
        return ((torch.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2).mean()
    engine, *_ = tds.initialize(loss_fn=loss_fn, params=params, device="cpu", config={
        "train_micro_batch_size_per_gpu": 4 // int(os.environ["WORLD_SIZE"]),
        "bf16": {"enabled": False},
        "zero_optimization": {"stage": 2},
        "optimizer": {"type": "adamw", "params": {"lr": 0.05}}, "steps_per_print": 1000})
    x, y = torch.randn(4, 8, generator=g), torch.randn(4, 4, generator=g)
    losses = [float(engine.train_batch({"x": x, "y": y})) for _ in range(3)]
    w = engine.master_tree()["w1"].sum().item()
    out = dict(rank=int(os.environ["RANK"]), local=int(os.environ["LOCAL_RANK"]),
               world=engine.dp_world_size, losses=losses, w=w)
    open(os.path.join(sys.argv[1], "r%d.json" % out["rank"]), "w").write(json.dumps(out))
""")


def test_the_launcher_starts_one_rank_a_device_that_train_as_one_job(tmp_path):
    """``--num_gpus 2``: two processes with their own ``RANK`` /
    ``LOCAL_RANK`` join one world (gloo here) and take one global batch of
    4 rows, 2 each: their losses equal one process's on the whole batch."""
    script = tmp_path / "train.py"
    script.write_text(LAUNCHED)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    rc = subprocess.call([sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
                          "--num_gpus", "2", str(script), str(tmp_path)], env=env, timeout=120)
    assert rc == 0
    runs = [json.loads((tmp_path / f"r{r}.json").read_text()) for r in (0, 1)]
    assert [(o["rank"], o["local"], o["world"]) for o in runs] == [(0, 0, 2), (1, 1, 2)]
    assert runs[0]["losses"] == runs[1]["losses"] and runs[0]["w"] == runs[1]["w"]
    (tmp_path / "one").mkdir()
    one = subprocess.run([sys.executable, str(script), str(tmp_path / "one")], env=dict(
        env, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(_free_port())), timeout=120, capture_output=True)
    assert one.returncode == 0, one.stderr[-2000:]
    solo = json.loads((tmp_path / "one" / "r0.json").read_text())
    np.testing.assert_allclose(runs[0]["losses"], solo["losses"], rtol=1e-5)


def test_the_launcher_takes_local_devices_by_count_or_slots():
    from deepspeed_tpu_torch.launcher.runner import local_devices

    assert local_devices(3) == [0, 1, 2]
    assert local_devices(None, "localhost:0,2") == [0, 2]
    assert local_devices(None) is None
    for bad in ("host-a:0,1", "localhost:0@host-b:1"):
        with pytest.raises(ValueError, match="this host"):
            local_devices(None, bad)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
