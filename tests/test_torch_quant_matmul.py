"""The dequant-matmul kernels' plain versions (K4 ``quant_matmul`` for int8
and e4m3 weights, K5 ``quant_matmul_fp6``) against the JAX Pallas kernels
run in interpret mode (``quant_matmul.set_interpret(True)``, restored
afterwards), on the same quantized payloads: JAX quantizes, the port takes
the bytes through ``params_from_numpy``'s payload copy.

Tolerances, as relative max error (max |port - jax| / max |jax|): fp32
activations 1e-5 (the same fp32 products summed in another order); bf16
activations 2e-2 (the JAX tests' own limit: one bf16 rounding of the
output).  The Pallas fp6 kernel needs K % 512 == 0; at K = 256 the port's
K5 is held against the JAX decode-then-matmul body with the kernel's fp32
epilogue.  The port's kernels take any shape; a CPU tensor never launches
one.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as JQ
from deepspeed_tpu.ops.pallas import quant_matmul as jqm
from deepspeed_tpu_torch.models.transformer import _payload
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops import quantizer as TQ
from deepspeed_tpu_torch.ops.kernels import quant_matmul as tqm
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

SHAPES = [(256, 384), (512, 256), (1024, 256)]
F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _interpret():
    jqm.set_interpret(True)
    yield
    jqm.set_interpret(False)


def _rel(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


def _inputs(k, n, seed, with_bias, x_shape=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape or (4, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    return x, w, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_fp6(x, q6, b):
    """The Pallas K5 where it runs (K % 512 == 0), else the JAX decode-
    then-matmul body with the kernel's epilogue (scale, then bias, in fp32)."""
    if jqm.supports_fp6(x, q6.packed, q6.in_dim):
        return jqm.quant_matmul_fp6(x, q6.packed, q6.s, q6.in_dim, bias=b)
    deq = JQ._fp6_decode(JQ._fp6_unpack(q6.packed, q6.in_dim), jnp.float32)
    y = (x.astype(jnp.float32) @ deq) * q6.s
    return (y if b is None else y + b).astype(x.dtype)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_k4_plain_matches_pallas_fp32(fmt, k, n, with_bias):
    x, w, b = _inputs(k, n, k + n, with_bias)
    qw = JQ.quantize_serving_weight(jnp.asarray(w), fmt)
    jb = None if b is None else jnp.asarray(b)
    assert jqm.supports_int8(jnp.asarray(x), qw.q)
    ref = jqm.quant_matmul(jnp.asarray(x), qw.q, qw.s, bias=jb)
    K.reset_launches()
    got = tqm.quant_matmul(torch.from_numpy(x), _payload(qw.q), _payload(qw.s), _t(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert _rel(got, ref) < F32_TOL
    assert sum(K.LAUNCHES.values()) == 0  # a CPU tensor runs the plain version


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_k5_plain_matches_pallas_fp32(k, n, with_bias):
    x, w, b = _inputs(k, n, 7 * k + n, with_bias)
    q6 = JQ.quantize_serving_weight_fp6(jnp.asarray(w))
    ref = _jax_fp6(jnp.asarray(x), q6, None if b is None else jnp.asarray(b))
    got = tqm.quant_matmul_fp6(torch.from_numpy(x), _payload(q6.packed), _payload(q6.s),
                               q6.in_dim, _t(b))
    assert _rel(got, ref) < F32_TOL


@pytest.mark.parametrize("fmt", ["int8", "fp8", "fp6"])
@pytest.mark.parametrize("x_shape", [(5, 1024), (2, 3, 1024), (1024,)])
def test_bf16_activations_2d_3d_and_odd_rows(fmt, x_shape):
    """bf16 x, an M that is not a multiple of 8 (decode batch 5), 3-D
    activations (prefill packs) and a single row: shape and type kept."""
    k, n = 1024, 256
    x, w, _ = _inputs(k, n, 3, False, x_shape)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if fmt == "fp6":
        q6 = JQ.quantize_serving_weight_fp6(jnp.asarray(w))
        ref = _jax_fp6(jx, q6, None)
        got = tqm.quant_matmul_fp6(tx, _payload(q6.packed), _payload(q6.s), k)
    else:
        qw = JQ.quantize_serving_weight(jnp.asarray(w), fmt)
        ref = jqm.quant_matmul(jx, qw.q, qw.s)
        got = tqm.quant_matmul(tx, _payload(qw.q), _payload(qw.s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    assert _rel(got, ref) < BF16_TOL


def test_bias_rides_the_fp32_epilogue():
    """The kernels add the bias in fp32 before the one rounding (the Pallas
    epilogue), not after rounding as the JAX jnp body does: with bf16
    activations the two differ, and the port agrees with the kernel."""
    k, n = 512, 256
    x, w, b = _inputs(k, n, 11, True)
    b = (b * 300.0).astype(np.float32)  # large bias: the rounding order shows
    jx = jnp.asarray(x, jnp.bfloat16)
    qw = JQ.quantize_serving_weight(jnp.asarray(w), "int8")
    kern = np.asarray(jqm.quant_matmul(jx, qw.q, qw.s, bias=jnp.asarray(b)), np.float32)
    body = np.asarray(jqm.ref_quant_matmul(jx, qw.q, qw.s, jnp.asarray(b)), np.float32)
    got = tqm.quant_matmul(torch.from_numpy(x).to(torch.bfloat16), _payload(qw.q),
                           _payload(qw.s), torch.from_numpy(b)).float().numpy()
    # at most one bf16 ulp (2^-7 relative) where the fp32 sums round apart
    assert np.abs(got - kern).max() <= np.abs(kern).max() * 2 ** -7
    assert np.abs(got - kern).mean() < 0.1 * np.abs(body - kern).mean()


def test_serving_mm_dispatches_quantized_weights():
    """``serving_mm`` sends a ServingQuant to K4 and a ServingQuantFP6 to K5
    and keeps a plain tensor on ``torch.matmul``; all agree with the JAX
    ``serving_mm`` (kernels interpreted)."""
    k, n = 512, 256
    x, w, b = _inputs(k, n, 5, True)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    for jq in (JQ.quantize_serving_weight(jw, "int8"), JQ.quantize_serving_weight(jw, "fp8")):
        tq = TQ.ServingQuant(_payload(jq.q), _payload(jq.s))
        assert _rel(TQ.serving_mm(tx, tq, tb), JQ.serving_mm(jx, jq, jb)) < F32_TOL
    j6 = JQ.quantize_serving_weight_fp6(jw)
    t6 = TQ.ServingQuantFP6(_payload(j6.packed), _payload(j6.s), j6.in_dim)
    assert _rel(TQ.serving_mm(tx, t6, tb), JQ.serving_mm(jx, j6, jb)) < F32_TOL
    assert _rel(TQ.serving_mm(tx, tw, tb), JQ.serving_mm(jx, jw, jb)) < F32_TOL


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """The CUDA wrappers' checks run before any device work: a 3-D
    (stacked) weight, an fp32 activation, a wrong in_dim."""
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tqm.quant_matmul_kernel(x, torch.zeros(2, 64, 32, dtype=torch.int8), torch.ones(32))
    with pytest.raises(TypeError):
        tqm.quant_matmul_kernel(x.float(), torch.zeros(64, 32, dtype=torch.int8), torch.ones(32))
    with pytest.raises(ValueError):
        tqm.quant_matmul_fp6_kernel(x, torch.zeros(3, 16, 32, dtype=torch.uint8),
                                    torch.ones(32), 60)
    assert sum(K.LAUNCHES[n] for n in K.LAUNCHES if n.startswith("quant_matmul")) == 0


# the 8B serving matmuls (K, N): wq / wo, wk / wv, w_up / w_gate, w_down, the head
_SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("m,n,steps,expect", [
    (16, 1024, 64, (16, 4)),      # decode wk / wv: 8 tiles, split 16 ways
    (16, 14336, 64, (2, 32)),     # decode w_up: 112 tiles, 224 CTAs resident at once
    (16, 128256, 64, (1, 64)),    # the head fills the card alone
    (512, 4096, 224, (2, 112)),   # prefill w_down: 64 tiles of 256 tokens, split 2 ways
    (5, 100, 3, (1, 3)),          # too short to split
    # decode at batch 1: the tiles of batch 16
    *[(1, n, -(-k // 64), e) for (k, n), e in zip(
        _SHAPES_8B, [(8, 8), (16, 4), (2, 32), (8, 28), (1, 64)])],
    # prefill of 2048 rows: 256-token tiles, only wk / wv split
    *[(2048, n, -(-k // 64), e) for (k, n), e in zip(
        _SHAPES_8B, [(1, 64), (2, 32), (1, 64), (1, 224), (1, 64)])],
])
def test_split_k_choice(m, n, steps, expect):
    splits, per = tqm.split_k(m, n, steps, 132)
    assert (splits, per) == expect
    assert (splits - 1) * per < steps <= splits * per  # no empty split


@pytest.mark.parametrize("m,expect", [
    (1, 16), (16, 16),                 # decode: the n16 product
    (17, 64), (64, 64), (65, 128), (100, 128), (128, 128),
    (129, 256), (300, 256), (512, 256), (2048, 256),
])
def test_token_tile_choice(m, expect):
    bt = tqm.token_tile(m)
    assert bt == expect and bt in tqm.TOKEN_TILES


def test_token_tiles_match_the_kernel_dispatch():
    """The wrapper's tile table is the kernel's: ``token_tile`` picks only
    tiles that ``dispatch_bt`` launches, and ``split_k`` counts the CTAs an
    SM that ``Plan::MIN_CTAS`` (the launch bound) holds at each."""
    src = (Path(tqm.__file__).parents[2] / "csrc" / "quant_matmul.cu").read_text()
    body = src[src.index("cudaError_t dispatch_bt("):]
    body = body[:body.index("default:")]
    cases = [int(a) for a, b in re.findall(r"case (\d+): return launch<FMT, (\d+)>", body)
             if a == b]
    assert sorted(cases) == sorted(tqm.TOKEN_TILES)
    (edge,) = re.findall(r"MIN_CTAS = BT <= (\d+) \? 2 : 1;", src)
    assert tqm.TOKEN_TILES == {bt: 2 if bt <= int(edge) else 1 for bt in cases}


@pytest.mark.parametrize("fmt,m,k,n,xvec,wvec", [
    ("int8", 16, 4096, 14336, 1, 1),    # decode w_up: 16-token tiles, K split 2 ways
    ("fp8", 512, 14336, 4096, 1, 1),    # prefill w_down: 256-token tiles, split 2 ways
    ("fp6", 300, 4096, 1024, 1, 1),     # a ragged 256-token tile, wk / wv split 8 ways
    ("int8", 5, 4100, 1000, 0, 0),      # unaligned x and weight rows: through registers
    ("fp6", 17, 1028, 1024, 0, 1),      # fp6 quarters of 257 columns: x through registers
])
def test_kernel_wrapper_passes_the_plan_to_the_launch(monkeypatch, fmt, m, k, n, xvec, wvec):
    """The wrapper's C call, checked without a card: the argument count of
    ``dst_quant_matmul`` (the token tile is its own argument), the shapes,
    the planned (token tile, splits, K-steps per split), a workspace exactly
    when K is split, and the cp.async flags."""
    calls = []
    monkeypatch.setattr(tqm, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(tqm, "_sm_count", lambda dev: 132)
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    s = torch.ones(n)
    if fmt == "fp6":
        y = tqm.quant_matmul_fp6_kernel(x, torch.zeros(3, k // 4, n, dtype=torch.uint8), s, k)
        steps = -(-(k // 4) // 16)
    else:
        dtype = torch.int8 if fmt == "int8" else torch.float8_e4m3fn
        y = tqm.quant_matmul_kernel(x, torch.zeros(k, n, dtype=dtype), s)
        steps = -(-k // 64)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    (name, args), = calls
    assert name == {"int8": "quant_matmul_int8", "fp8": "quant_matmul_fp8",
                    "fp6": "quant_matmul_fp6"}[fmt]
    assert len(args) + 1 == len(K._ARGTYPES[name][1])  # + the stream
    ws = args[5].value
    m_, n_, k_, code, bt, splits, per, xv, wv = args[6:]
    splits_exp, per_exp = tqm.split_k(m, n, steps, 132)
    assert (m_, n_, k_, code) == (m, n, k, {"int8": 0, "fp8": 1, "fp6": 2}[fmt])
    assert (bt, splits, per) == (tqm.token_tile(m), splits_exp, per_exp)
    assert (ws is None) == (splits == 1)
    assert (xv, wv) == (xvec, wvec)
