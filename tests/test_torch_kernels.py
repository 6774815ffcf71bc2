"""The port's attention kernel modules (deepspeed_tpu_torch/ops/kernels)
against the JAX package, on the CPU.

On a CPU tensor each module runs its plain PyTorch version; these tests hold
that version against the JAX Pallas kernel run in interpret mode (flash,
paged decode) and against the JAX dense bodies, on the same numpy inputs.
The JAX packed-context Pallas kernel does not run on this JAX (``pl.load``),
so its dense body and its flash-partial body are the oracles there.

Tolerance, fp32 everywhere: atol 1e-5, rtol 1e-4 — the two frameworks sum
the same products in different orders (einsum vs blocked online softmax),
which moves fp32 results by a few ulps of values of order 1.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions, and so does ``tests/test_torch_gpu.py``
where a card is present.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.ops.attention import dot_product_attention as j_dpa
from deepspeed_tpu.ops.pallas import flash_kernel as jflash
from deepspeed_tpu.ops.pallas import paged_attention as jpk
from deepspeed_tpu_torch.inference import paged as tpaged
from deepspeed_tpu_torch.ops import kernels as K
from deepspeed_tpu_torch.ops.kernels.ctx_attention import paged_attention_packed_ctx
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_attention_decode
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ATOL, RTOL = 1e-5, 1e-4

# (hq, hkv, hd): the tiny preset's heads, and a narrow hd-128 GQA-4:1 shape
SHAPES = [(4, 2, 16), (4, 1, 128)]
# K2 / K3 also at the shapes their tensor-core kernels take on the card:
# head_dim 256, a query group of 16, and one above 16 (32 heads on one kv head)
PAGED_SHAPES = SHAPES + [(4, 2, 256), (16, 1, 64), (32, 1, 64)]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


@pytest.fixture
def jax_interpret():
    jflash.set_interpret(True)
    jflash.set_block_sizes(64, 64)
    jpk.set_interpret(True)
    try:
        yield
    finally:
        jflash.set_interpret(False)
        jflash.set_block_sizes()
        jpk.set_interpret(False)


# ---------------------------------------------------------------------------
# K1f: flash forward
# ---------------------------------------------------------------------------
def _seg(s, lens):
    seg = np.zeros((1, s), np.int32)
    cur = 0
    for i, n in enumerate(lens):
        seg[0, cur:cur + n] = i + 1
        cur += n
    return seg


@pytest.mark.parametrize("hq,hkv,hd", SHAPES)
@pytest.mark.parametrize("segments", [None, (40, 50, 20)])
def test_flash_plain_matches_jax_kernel(jax_interpret, hq, hkv, hd, segments):
    s = 128
    q, k, v = (_np((1, s, h, hd), i, 0.5) for i, h in enumerate((hq, hkv, hkv)))
    seg = _seg(s, segments) if segments else None  # rows past the last segment: pad 0
    want = jflash.pallas_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        segment_ids=None if seg is None else jnp.asarray(seg))
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                segment_ids=None if seg is None else jnp.asarray(seg))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True,
                          segment_ids=None if seg is None else torch.from_numpy(seg))
    _close(got, want)
    _close(got, ref)


def test_flash_plain_soft_cap_matches_jax():
    s, hq, hkv, hd = 64, 4, 2, 16
    q, k, v = (_np((1, s, h, hd), 10 + i, 2.0) for i, h in enumerate((hq, hkv, hkv)))
    seg = _seg(s, (30, 30))
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                segment_ids=jnp.asarray(seg), logits_soft_cap=3.0)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          segment_ids=torch.from_numpy(seg), logits_soft_cap=3.0)
    _close(got, ref)


# ---------------------------------------------------------------------------
# K2: paged decode
# ---------------------------------------------------------------------------
def _decode_inputs(hq, hkv, hd, B=5, nb=32, bs=16, P=6, lens=(5, 16, 33, 90, 1)):
    q = _np((B, hq, hd), 1)
    ck, cv = _np((nb, bs, hkv, hd), 2), _np((nb, bs, hkv, hd), 3)
    table = np.full((B, P), -1, np.int32)
    nxt = 3
    for b in range(B - 1):  # the last slot is idle: len 1, an all -1 row
        for i in range(-(-lens[b] // bs)):
            table[b, i] = nxt % nb
            nxt += 5
    return q, ck, cv, table, np.asarray(lens, np.int32)


@pytest.mark.parametrize("hq,hkv,hd", PAGED_SHAPES)
@pytest.mark.parametrize("cap", [None, 2.0])
def test_decode_plain_matches_jax(jax_interpret, hq, hkv, hd, cap):
    q, ck, cv, table, lens = _decode_inputs(hq, hkv, hd)
    j = [jnp.asarray(x) for x in (q, ck, cv, table, lens)]
    got = paged_attention_decode(*(torch.from_numpy(x) for x in (q, ck, cv, table, lens)),
                                 logits_soft_cap=cap)
    assert torch.isfinite(got).all()
    _close(got, jpaged._paged_attention_decode_dense(*j, logits_soft_cap=cap))
    if cap is None:  # the TPU kernel refuses the soft cap
        _close(got, jpk.paged_attention_decode_kernel(*j))


# ---------------------------------------------------------------------------
# K3: packed context
# ---------------------------------------------------------------------------
def _ctx_inputs(hq, hkv, hd, bad_inside=False, nb=24, bs=16, N=4, P=5):
    """Three segments page-aligned in a 96-row pack with pad rows between,
    mid-page context lengths, -1 / out-of-range table tails."""
    spans = [(0, 20, 2, 37), (32, 16, 0, 16), (48, 30, 3, 50)]  # start, n, row, ctx
    t = 96
    seg = np.zeros(t, np.int32)
    tables = np.full((N, P), -1, np.int32)
    lens = np.zeros(N, np.int32)
    nxt = 1
    for start, n, row, ctx in spans:
        seg[start:start + n] = row + 1
        pages = -(-ctx // bs)
        tables[row, :pages] = np.arange(nxt, nxt + pages)
        nxt += pages
        lens[row] = ctx
        if pages < P:
            tables[row, pages] = nb + 3  # past ctx_len: never read
    if bad_inside:  # ids inside ctx_len that the kernel must skip
        tables[3, 1] = -1
        tables[0, 0] = nb + 7
    q = _np((t, hq, hd), 4)
    k, v = _np((t, hkv, hd), 5), _np((t, hkv, hd), 6)
    ck, cv = _np((nb, bs, hkv, hd), 7), _np((nb, bs, hkv, hd), 8)
    return q, k, v, seg, ck, cv, tables, lens


@pytest.mark.parametrize("hq,hkv,hd", PAGED_SHAPES)
def test_ctx_plain_matches_jax_dense(hq, hkv, hd):
    args = _ctx_inputs(hq, hkv, hd)
    got = paged_attention_packed_ctx(*(torch.from_numpy(x) for x in args)).numpy()
    want = np.asarray(jpaged._paged_attention_packed_ctx_dense(
        *(jnp.asarray(x) for x in args)))
    live = args[3] > 0
    _close(got[live], want[live])
    assert (got[~live] == 0).all()  # pad rows come back exactly 0


@pytest.mark.parametrize("hq,hkv,hd", PAGED_SHAPES)
def test_ctx_plain_skips_bad_ids_like_the_kernel(hq, hkv, hd):
    """Table ids outside [0, nb) inside ctx_len are skipped (the TPU
    kernel's rule, ctx_attention.py:197-198); the JAX flash-partial body
    applies the same rule, so it is the oracle here."""
    args = _ctx_inputs(hq, hkv, hd, bad_inside=True)
    got = paged_attention_packed_ctx(*(torch.from_numpy(x) for x in args)).numpy()
    acc, _m, l = jpaged._packed_ctx_partial(*(jnp.asarray(x) for x in args),
                                            include_pack=True)
    want = np.asarray(acc / l[..., None])
    live = args[3] > 0
    _close(got[live], want[live])


# ---------------------------------------------------------------------------
# paged pool writes (in place in the port, functional in JAX): exact copies
# ---------------------------------------------------------------------------
def test_pool_writes_match_jax():
    nb, bs, hkv, hd = 12, 4, 2, 8
    pool = _np((nb, bs, hkv, hd), 20)
    prompt = _np((3 * bs, hkv, hd), 21)
    blocks = np.array([5, 2, -1], np.int32)  # the last page is padding: dropped
    want = jpaged.write_prefill_kv(jnp.asarray(pool), jnp.asarray(prompt),
                                   jnp.asarray(blocks), 7)
    got = torch.from_numpy(pool.copy())
    tpaged.write_prefill_kv(got, torch.from_numpy(prompt), blocks, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    new = _np((4, hkv, hd), 22)
    table = np.array([[5, 2, -1], [7, -1, -1], [1, 3, 9], [-1, -1, -1]], np.int32)
    positions = np.array([6, 2, 11, 0], np.int32)
    active = np.array([True, True, False, True])  # slot 2 idle; slot 3 has no page
    want = jpaged.write_decode_kv(want, jnp.asarray(new), jnp.asarray(table),
                                  jnp.asarray(positions), jnp.asarray(active))
    tpaged.write_decode_kv(got, torch.from_numpy(new), table, positions, active)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_path():
    K.reset_launches()
    q, ck, cv, table, lens = (torch.from_numpy(x) for x in _decode_inputs(4, 2, 16))
    paged_attention_decode(q, ck, cv, table, lens)
    flash_attention(torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_attention_decode_kernel

    q, ck, cv, table, lens = (torch.from_numpy(x) for x in _decode_inputs(4, 2, 128))
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention_decode_kernel(q.bfloat16(), ck.bfloat16(), cv.bfloat16(), table, lens)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(K, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(K.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(K, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()


def test_paged_rejects_meshes():
    q, ck, cv, table, lens = (torch.from_numpy(x) for x in _decode_inputs(4, 2, 16))
    with pytest.raises(NotImplementedError):
        tpaged.paged_attention_decode(q, ck, cv, table, lens, dp=2)

