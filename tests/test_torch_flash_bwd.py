"""The flash attention backward (K1b) of the port against the JAX package,
on the CPU.

(a) The plain versions ``flash_attention_fwd_plain`` (its lse) and
    ``flash_attention_bwd_plain`` (dq, dk, dv by the FA2 formulas) against
    JAX's Pallas kernels run in interpret mode: ``flash_kernel._fwd``'s lse
    and ``jax.vjp`` of ``pallas_flash_attention``, on the same numpy inputs.
(b) The custom ops (``dstpu::flash_fwd`` and its autograd formula's
    ``dstpu::flash_bwd``: on a CPU tensor they run those plain versions)
    against torch autograd through the plain body
    ``dot_product_attention``: GQA, segments and the soft cap.

Tolerance, fp32 everywhere: atol 1e-4, rtol 1e-3.  Gradients sum up to s
products of unit-scale values in different orders (blocked online passes in
JAX, dense einsums here), and the backward chains four such products, so
results move by a few hundred ulps of values of order 1-10.

The CUDA kernels run on the card only: ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` hold them against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_kernel as jflash
from deepspeed_tpu_torch.ops.attention import dot_product_attention, get_attention_impl
from deepspeed_tpu_torch.ops.kernels import flash_attention as F1
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ATOL, RTOL = 1e-4, 1e-3

# (s, hq, hkv, hd, segments, soft cap): every head layout and head_dim at
# both lengths, with segments and the cap spread over the cases
CASES = []
for i, (s, (hq, hkv), hd) in enumerate(
        (s, h, d) for s in (128, 256) for h in ((2, 2), (4, 2), (8, 2)) for d in (64, 128)):
    CASES.append((s, hq, hkv, hd, i % 2 == 1, 3.0 if i % 4 >= 2 else None))
# head_dim 256 (the largest JAX's gate admits) and a large query group: the
# shapes K1's tensor-core kernels took on besides 64 / 128 and groups of 8
CASES += [(128, 4, 2, 256, True, 3.0), (128, 2, 1, 256, False, None),
          (128, 16, 1, 64, True, None), (128, 16, 1, 128, False, 2.0)]


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[:, : s // 3] = 1
    seg[:, s // 3: s - 17] = 2
    seg[1:, s // 2:] = 3  # the second row packs differently
    return seg


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.fixture
def jax_interpret():
    jflash.set_interpret(True)
    jflash.set_block_sizes(64, 64)
    try:
        yield
    finally:
        jflash.set_interpret(False)
        jflash.set_block_sizes()


@pytest.mark.parametrize("s,hq,hkv,hd,use_seg,cap", CASES)
def test_plain_lse_and_backward_match_jax_kernels(jax_interpret, s, hq, hkv, hd, use_seg, cap):
    b = 2
    q, k, v, do = (_np((b, s, h, hd), i) for i, h in enumerate((hq, hkv, hkv, hq)))
    seg = _segments(b, s) if use_seg else None
    scale = hd ** -0.5

    def hm(x):  # [b, s, h, d] -> head-major [b*h, s, d]
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, s, hd)

    jseg = jnp.asarray(seg)[:, :, None] if use_seg else None
    _, jlse = jflash._fwd(hm(q), hm(k), hm(v), jseg, jseg, scale, cap)
    out, vjp = jax.vjp(lambda a, b_, c: jflash.pallas_flash_attention(
        a, b_, c, segment_ids=None if seg is None else jnp.asarray(seg), logits_soft_cap=cap),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))

    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tseg = torch.from_numpy(seg) if use_seg else None
    o, lse = F1.flash_attention_fwd_plain(t[0], t[1], t[2], tseg, scale, cap)
    _close(o, out)
    _close(lse, np.asarray(jlse).reshape(b, hq, s))
    dq, dk, dv = F1.flash_attention_bwd_plain(t[0], t[1], t[2], tseg, o, lse, t[3], scale, cap)
    _close(dq, jdq)
    _close(dk, jdk)
    _close(dv, jdv)


@pytest.mark.parametrize("hq,hkv,use_seg,cap", [(4, 2, False, None), (8, 2, True, 2.0),
                                                (4, 4, True, None), (6, 2, False, 5.0)])
def test_autograd_function_matches_autograd_of_plain_body(hq, hkv, use_seg, cap):
    # an s that is no multiple of any tile; a head dim the kernels take (the
    # entry pads any other, test_entry_pads_other_head_dims)
    b, s, d = 2, 45, 64
    inputs = [torch.from_numpy(_np((b, s, h, d), 10 + i)).requires_grad_(True)
              for i, h in enumerate((hq, hkv, hkv))]
    seg = torch.from_numpy(_segments(b, s)) if use_seg else None
    do = torch.from_numpy(_np((b, s, hq, d), 20))
    want = dot_product_attention(*inputs, segment_ids=seg, logits_soft_cap=cap)
    want_g = torch.autograd.grad(want, inputs, do)
    got = F1.flash_attention(*inputs, segment_ids=seg, logits_soft_cap=cap)
    assert "dstpu_flash_fwd" in type(got.grad_fn).__name__  # the op's autograd node
    got_g = torch.autograd.grad(got, inputs, do)
    _close(got.detach(), want.detach())
    for g, w in zip(got_g, want_g):
        _close(g, w)


@pytest.mark.parametrize("d", [16, 80, 96])
def test_entry_pads_other_head_dims(d):
    """A head dim below 256 that the kernels do not take runs the Function
    at the next one they do (zeros appended, the real head dim's scale, o
    sliced back; dq / dk / dv sliced through the pad), equal to the plain
    body's autograd at the real head dim; above 256 the entry refuses."""
    b, s, hq, hkv = 2, 45, 4, 2
    inputs = [torch.from_numpy(_np((b, s, h, d), 30 + i)).requires_grad_(True)
              for i, h in enumerate((hq, hkv, hkv))]
    do = torch.from_numpy(_np((b, s, hq, d), 40))
    seg = torch.from_numpy(_segments(b, s))
    want = dot_product_attention(*inputs, segment_ids=seg, logits_soft_cap=5.0)
    want_g = torch.autograd.grad(want, inputs, do)
    got = F1.flash_attention(*inputs, segment_ids=seg, logits_soft_cap=5.0)
    assert got.shape == want.shape
    fn = got.grad_fn.next_functions[0][0]  # the slice back to d, over the op
    assert "dstpu_flash_fwd" in type(fn).__name__
    assert fn.saved_tensors[0].shape[-1] == F1.padded_head_dim(d) == (64 if d < 64 else 128)
    got_g = torch.autograd.grad(got, inputs, do)
    _close(got.detach(), want.detach())
    for g, w in zip(got_g, want_g):
        assert g.shape == w.shape
        _close(g, w)
    wide = [torch.nn.functional.pad(x.detach(), (0, 320 - d)).requires_grad_(True)
            for x in inputs]
    with pytest.raises(NotImplementedError, match="head_dim 320"):
        F1.flash_attention(*wide)


def test_without_grad_or_noncausal_the_cpu_takes_the_plain_body():
    q, k, v = (torch.from_numpy(_np((1, 9, 2, 8), i)) for i in range(3))
    want = dot_product_attention(q, k, v)
    assert torch.equal(F1.flash_attention(q, k, v), want)
    nc = F1.flash_attention(q, k, v, causal=False)
    assert torch.equal(nc, dot_product_attention(q, k, v, causal=False))
    off = F1.flash_attention(q, k, v, q_offset=3)
    assert torch.equal(off, dot_product_attention(q, k, v, q_offset=3))


def test_get_attention_impl_names():
    assert get_attention_impl("reference") is dot_product_attention
    assert get_attention_impl("math") is dot_product_attention
    assert get_attention_impl("flash") is F1.flash_attention
    assert get_attention_impl("auto", "cpu") is dot_product_attention
    assert get_attention_impl("auto", "cuda") is F1.flash_attention
    with pytest.raises(ValueError, match="unknown attention impl"):
        get_attention_impl("sdpa")
