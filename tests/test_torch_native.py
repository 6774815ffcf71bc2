"""The port's native host ops against the JAX package's: the builder, the
host AdamW / Lion (same C++ and flags: bit-equal), the async I/O engine
and the tensor swapper (the same raw files), mirroring
``tests/test_native.py``.  ``g++`` is present here, so the host sources
build and run in tier 1."""
import os
import shutil

import numpy as np
import pytest
import torch

from deepspeed_tpu.nvme.aio import AsyncIOEngine as JAsyncIOEngine
from deepspeed_tpu.nvme.swap import TensorSwapper as JTensorSwapper
from deepspeed_tpu.ops import op_builder as j_op_builder
from deepspeed_tpu.ops.host_adam import HostAdamW as JHostAdamW
from deepspeed_tpu.ops.host_adam import HostLion as JHostLion
from deepspeed_tpu_torch.nvme import AsyncIOEngine, TensorSwapper
from deepspeed_tpu_torch.nvme.bench import run_bench
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.host_adam import HostAdamW, HostLion
from deepspeed_tpu_torch.ops.kernels.fused_adam import fused_adamw_flat

K8_TOL = 1e-6  # host AdamW against K8's plain version, of max |p|: fp32 rounding order


def test_op_report_names_jax_ops():
    rep = op_builder.op_report()
    assert set(rep) == set(j_op_builder.ALL_OPS) == set(op_builder.ALL_OPS)
    for info in rep.values():
        assert set(info) == {"compatible", "built"} and info["compatible"]


def test_builds_from_the_ports_own_sources_with_jax_flags():
    b = op_builder.HostAdamBuilder()
    assert all(p.startswith(op_builder.CSRC) for p in b.absolute_sources())
    assert op_builder.FLAGS == ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                                "-march=native", "-fopenmp"]
    path = b.build()
    assert path.startswith(op_builder.BUILD_ROOT) and os.path.exists(path)
    # the arithmetic is JAX's: the port's copy differs only in its header comment
    jsrc = open(os.path.join(os.path.dirname(j_op_builder.__file__), "..", "..", "csrc",
                             "adam", "host_adam.cpp")).read()
    tsrc = open(b.absolute_sources()[0]).read()
    assert jsrc[jsrc.index("#include <cmath>"):] == tsrc[tsrc.index("#include <cmath>"):]


def test_failed_build_raises_with_the_compilers_log(tmp_path):
    src = tmp_path / "host"
    src.mkdir()
    broken = open(os.path.join(op_builder.CSRC, "host", "host_adam.cpp")).read()
    (src / "host_adam.cpp").write_text(broken.replace("const float g = grad[i];",
                                                      "const float g = grad[i]", 1))
    b = op_builder.HostAdamBuilder(src_root=str(tmp_path), build_root=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match=r"(?s)build of op 'host_adam' failed.*error"):
        b.load()
    assert b.is_compatible()  # g++ is there: the report says so, the build still raises


def test_missing_compiler_raises(tmp_path, monkeypatch):
    b = op_builder.AsyncIOBuilder(build_root=str(tmp_path / "b"))
    monkeypatch.setattr(op_builder.shutil, "which", lambda name: None)
    assert not b.is_compatible()
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        b.load()


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("grad_type", ["fp32", "bf16"])
def test_host_adamw_bit_equal_to_jax(wd, grad_type):
    rng = np.random.default_rng(0)
    n = 4097  # odd: the vector loop's tail
    p0 = rng.normal(size=n).astype(np.float32)
    grads = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    jp, jm, jv = p0.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    ja, ta = JHostAdamW(lr=1e-2, weight_decay=wd), HostAdamW(lr=1e-2, weight_decay=wd)
    for g in grads:
        if grad_type == "bf16":
            gt = torch.from_numpy(g).bfloat16()
            ja.step(jp, gt.view(torch.int16).numpy().view(np.uint16), jm, jv)
            ta.step(tp, gt, tm, tv)  # the bits, no upcast copy
        else:
            ja.step(jp, g, jm, jv)
            ta.step(tp, torch.from_numpy(g), tm, tv)
    assert ta.step_count == ja.step_count == len(grads)
    for a, b in ((jp, tp), (jm, tm), (jv, tv)):
        np.testing.assert_array_equal(a, b.numpy())


def test_host_lion_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    n = 1031
    p = rng.normal(size=n).astype(np.float32)
    jp, jm = p.copy(), np.zeros(n, np.float32)
    tp, tm = torch.from_numpy(p.copy()), torch.zeros(n)
    for _ in range(3):
        g = rng.normal(size=n).astype(np.float32)
        JHostLion(lr=1e-2, weight_decay=0.1).step(jp, g, jm)
        HostLion(lr=1e-2, weight_decay=0.1).step(tp, torch.from_numpy(g), tm)
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(jm, tm.numpy())


@pytest.mark.parametrize("grad_type", ["fp32", "bf16"])
def test_host_adamw_against_k8_plain(grad_type):
    """The NVMe tier's host update against the card's (K8's plain version):
    the same rule, fp32 either way, within K8_TOL of max |p| (the host
    kernel's 1 - b is rounded in fp32 arithmetic, K8's from double)."""
    rng = np.random.default_rng(3)
    n = 8191
    p0 = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    hp, hm, hv = p0.clone(), torch.zeros(n), torch.zeros(n)
    kp, km, kv = p0.clone(), torch.zeros(n), torch.zeros(n)
    ha = HostAdamW(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)
    for t in range(1, 6):
        g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        if grad_type == "bf16":
            g = g.bfloat16()
        ha.step(hp, g, hm, hv)
        fused_adamw_flat(kp, g.float(), km, kv, 1e-3, t, 0.9, 0.999, 1e-8, 0.1)
    err = float((hp - kp).abs().max()) / float(kp.abs().max())
    assert err <= K8_TOL, err


def test_host_adam_refuses_bad_buffers():
    ha = HostAdamW()
    p, m, v = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous"):
        ha.step(torch.zeros(8, 2)[:, 0], torch.zeros(8), m, v)
    with pytest.raises(TypeError):
        ha.step(p, torch.zeros(8, dtype=torch.float16), m, v)
    with pytest.raises(ValueError, match="elements"):
        ha.step(p, torch.zeros(7), m, v)


def test_aio_write_read_roundtrip(tmp_path):
    eng = AsyncIOEngine(num_threads=4)
    data = torch.randint(0, 255, (1 << 20,), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    p = str(tmp_path / "x.bin")
    eng.write(p, data)
    assert torch.equal(eng.read(p, torch.uint8, data.shape), data)
    eng.close()


def test_aio_async_many_ops_keep_buffers_alive(tmp_path):
    eng = AsyncIOEngine(num_threads=8)
    for i in range(16):  # the engine holds each buffer until its op is waited on
        eng.submit_write(str(tmp_path / f"f{i}.bin"), torch.full((1 << 16,), i, dtype=torch.uint8))
    assert len(eng._inflight) == 16
    eng.wait_all()
    assert not eng._inflight
    reads = [torch.empty(1 << 16, dtype=torch.uint8) for _ in range(16)]
    ops = [eng.submit_read(str(tmp_path / f"f{i}.bin"), b) for i, b in enumerate(reads)]
    for op in ops:
        eng.wait(op)
    assert all(bool((b == i).all()) for i, b in enumerate(reads))
    eng.close()


def test_aio_missing_file_errors(tmp_path):
    eng = AsyncIOEngine(num_threads=1)
    op = eng.submit_read(str(tmp_path / "nope.bin"), torch.empty(128, dtype=torch.uint8))
    with pytest.raises(IOError):
        eng.wait(op)
    eng.submit_read(str(tmp_path / "nope.bin"), torch.empty(128, dtype=torch.uint8))
    with pytest.raises(IOError):
        eng.wait_all()
    eng.close()


def test_tensor_swapper_roundtrip(tmp_path):
    sw = TensorSwapper(str(tmp_path / "swap"))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    sw.swap_out("layer0", a)
    sw.swap_out("layer1", b, blocking=True)
    sw.prefetch("layer0")
    assert torch.equal(sw.swap_in("layer0"), a)
    assert torch.equal(sw.swap_in("layer1"), b)
    sw.release("layer0")
    with pytest.raises(KeyError):
        sw.swap_in("layer0")
    sw.close()


def test_swap_files_cross_packages(tmp_path):
    """A JAX TensorSwapper's files read back through the port's engine, and
    the port's through JAX's: raw C-order bytes under ``<name>.swp``."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(16, 24)).astype(np.float32)
    jsw = JTensorSwapper(str(tmp_path / "j"))
    jsw.swap_out("w", a, blocking=True)
    got = AsyncIOEngine().read(str(tmp_path / "j" / "w.swp"), torch.float32, a.shape)
    np.testing.assert_array_equal(got.numpy(), a)
    tsw = TensorSwapper(str(tmp_path / "t"))
    tsw.swap_out("w", torch.from_numpy(a) * 2, blocking=True)
    back = JAsyncIOEngine().read(str(tmp_path / "t" / "w.swp"), np.float32, a.shape)
    np.testing.assert_array_equal(back, a * 2)
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
    jsw.close()
    tsw.close()


def test_bench_reports_rates(tmp_path):
    out = run_bench(str(tmp_path / "io"), size_mb=4, threads=4, ops=4)
    assert out["write_GBps"] > 0 and out["read_GBps"] > 0
    assert not os.listdir(tmp_path / "io")  # the bench removes its files
    shutil.rmtree(tmp_path / "io")
