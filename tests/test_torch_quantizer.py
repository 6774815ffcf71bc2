"""The quantizer API (``ops/quantizer.py``: ``quantize_int8``,
``dequantize``, ``quantize_fp8``, ``fake_quantize_int8``) and its row
kernels' plain versions (K6a/b/c, ``ops/kernels/quant_kernel.py``) against
the JAX package with its Pallas kernels in interpret mode
(``quant_kernel.set_interpret(True)``, restored afterwards).

Exact: the q bytes are identical, the scales equal bit for bit, and so is
the dequantized tensor, for int8, e4m3fn and e5m2, fp32 and bf16 inputs,
groups of the trailing dimension or a smaller group size, a zero row, and
a group size that does not divide (the single-group fallback, which
warns); on rows with an inf, a NaN or a subnormal amax too, where e5m2's
NaN codes are compared as NaN (ml_dtypes and torch encode them apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import quantizer as JQ
from deepspeed_tpu.ops.pallas import quant_kernel as jqk
from deepspeed_tpu_torch.models.transformer import _payload
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops import quantizer as TQ
from deepspeed_tpu_torch.ops.kernels import quant_kernel as tqk

FORMATS = {"int8": None, "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
           "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


@pytest.fixture(autouse=True)
def _interpret():
    jqk.set_interpret(True)
    yield
    jqk.set_interpret(False)


def _x(shape, seed, zero_row=True):
    x = (np.random.default_rng(seed).normal(size=shape) * 3.0).astype(np.float32)
    if zero_row:
        x.reshape(-1, shape[-1])[1] = 0.0
    return x


def _bytes(t):
    t = t if isinstance(t, torch.Tensor) else _payload(t)
    return t.contiguous().view(torch.uint8).numpy() if t.element_size() == 1 else t.numpy()


def _quantize_both(fmt, x, group_size, x_dtype):
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32)
    tx = torch.from_numpy(x).to(x_dtype)
    if fmt == "int8":
        return JQ.quantize_int8(jx, group_size), TQ.quantize_int8(tx, group_size)
    jd, td = FORMATS[fmt]
    return JQ.quantize_fp8(jx, jd, group_size), TQ.quantize_fp8(tx, td, group_size)


def _same(jq, tq):
    np.testing.assert_array_equal(_bytes(tq.data), _bytes(jq.data))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.group_size == jq.group_size and tq.data.shape == jq.data.shape


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,group_size", [((64, 256), None), ((4, 8, 96), 32),
                                              ((16, 128), 256)])
def test_quantize_and_dequantize_match_jax_bytes(fmt, x_dtype, shape, group_size):
    x = _x(shape, sum(shape))
    jq, tq = _quantize_both(fmt, x, group_size, x_dtype)
    _same(jq, tq)
    for out in (None, jnp.float32):
        jd = np.asarray(JQ.dequantize(jq, out), np.float32)
        td = TQ.dequantize(tq, None if out is None else torch.float32)
        assert td.dtype == (x_dtype if out is None else torch.float32)
        np.testing.assert_array_equal(td.float().numpy(), jd)
    assert sum(K.LAUNCHES.values()) == 0  # CPU tensors run the plain versions


def test_fake_quantize_int8_matches_jax():
    x = _x((32, 200), 3)
    got = TQ.fake_quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JQ.fake_quantize_int8(jnp.asarray(x))))
    assert float((got - torch.from_numpy(x)).abs().max()) > 0  # it did quantize


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_group_size_that_does_not_divide_falls_back_to_one_group(fmt):
    x = _x((10, 30), 4, zero_row=False)
    with pytest.warns(UserWarning, match="SINGLE quantization group"):
        jq, tq = _quantize_both(fmt, x, 7, torch.float32)
    _same(jq, tq)
    assert tq.group_size == 300 and tq.scales.shape == (1,)


def test_row_kernels_plain_versions_match_pallas_directly():
    """K6a/b/c themselves on a [G, N] tensor with a zero row."""
    x = _x((24, 384), 5)
    jq, js = jqk.quantize_int8(jnp.asarray(x))
    tq, ts = tqk.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1]) == np.float32(1e-12) / np.float32(127.0)  # the zero row's scale
    jd = jqk.dequantize_int8(jq, js, out_dtype=jnp.bfloat16)
    td = tqk.dequantize(tq, ts, torch.bfloat16)
    np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd, np.float32))
    for jd8, td8 in (FORMATS["e4m3"], FORMATS["e5m2"]):
        jq8, js8 = jqk.quantize_fp8(jnp.asarray(x), dtype=jd8)
        tq8, ts8 = tqk.quantize_fp8(torch.from_numpy(x), td8)
        np.testing.assert_array_equal(_bytes(tq8), _bytes(jq8))
        np.testing.assert_array_equal(ts8.numpy(), np.asarray(js8))


def test_rows_with_inf_nan_and_subnormals_match_pallas():
    """The row semantics the CUDA kernel is held to on the card (its plain
    version) against the Pallas kernels on rows with an inf, a NaN, both,
    and a subnormal amax: a NaN anywhere makes the scale NaN (max
    propagates it), x / s is then NaN, which int8 takes to 0 and fp8 to
    NaN; an inf makes the scale inf and every finite x / s a signed 0.
    int8 and e4m3 bytes are identical; e5m2 NaN codes are NaN in both
    packages but ml_dtypes writes them 0x7e / 0xfe where torch writes 0x7f
    / 0xff, so e5m2 is compared as NaN positions plus the finite bytes."""
    x = _x((8, 256), 11)
    x[2, 5] = np.inf
    x[3, 7] = np.nan
    x[4, 3], x[4, 4] = -np.inf, np.nan
    x[5] *= 1e-39
    jq, js = jqk.quantize_int8(jnp.asarray(x))
    tq, ts = tqk.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))  # NaN equals NaN here
    assert np.isnan(ts.numpy()[[3, 4]]).all() and np.isinf(ts.numpy()[2])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jq8, js8 = jqk.quantize_fp8(jnp.asarray(x), dtype=jnp.float8_e4m3fn)
    tq8, ts8 = tqk.quantize_fp8(torch.from_numpy(x), torch.float8_e4m3fn)
    np.testing.assert_array_equal(_bytes(tq8), _bytes(jq8))
    np.testing.assert_array_equal(ts8.numpy(), np.asarray(js8))
    jq8, js8 = jqk.quantize_fp8(jnp.asarray(x), dtype=jnp.float8_e5m2)
    tq8, ts8 = tqk.quantize_fp8(torch.from_numpy(x), torch.float8_e5m2)
    jf, tf = np.asarray(jq8, np.float32), tq8.float().numpy()
    np.testing.assert_array_equal(np.isnan(tf), np.isnan(jf))
    finite = ~np.isnan(jf)
    np.testing.assert_array_equal(_bytes(tq8)[finite], _bytes(jq8)[finite])
    np.testing.assert_array_equal(ts8.numpy(), np.asarray(js8))


def test_row_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tqk.quantize_kernel(torch.zeros(4, 8, 2), torch.int8)
    with pytest.raises(TypeError):
        tqk.quantize_kernel(torch.zeros(4, 8, dtype=torch.float64), torch.int8)
    with pytest.raises(TypeError):
        tqk.quantize_fp8(torch.zeros(4, 8), torch.int8)
    with pytest.raises(TypeError):
        tqk.dequantize_kernel(torch.zeros(4, 8), torch.ones(4))
