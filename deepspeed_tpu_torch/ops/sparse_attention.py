"""Block-sparse attention: sparsity layouts and the dispatch — counterpart
of ``deepspeed_tpu/ops/sparse_attention.py``.

A layout class turns a sequence length into a block-level mask
``[n_blocks, n_blocks]`` (numpy bool); the five classes are copies of the
JAX package's (``Dense``, ``Fixed``, ``BigBird`` with its numpy seed,
``BSLongformer``, ``Variable``), frozen so that a model config holding one
is hashable and each layout is built once per sequence length.

``block_sparse_attention`` dispatches as JAX does: a decode-shaped call
(``sq != sk`` or ``q_offset != 0``) runs dense attention; a layout whose
block is a viable kernel block (``sparse_supports``) and whose every causal
row has an active block runs the compute-skipping K7 kernels
(``ops/kernels/sparse_attention.py``: CUDA on a CUDA tensor, their plain
versions on a CPU one); any other layout runs the masked dense body.  The
layout decides; there is no ``try`` around a kernel.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .attention import dot_product_attention
from .kernels.sparse_attention import block_sparse_flash_attention, element_mask, sparse_supports


@dataclass(frozen=True)
class SparsityConfig:
    """Base: the block size and the pattern.  All heads share one layout."""

    block: int = 64

    def make_layout(self, seq_len: int) -> np.ndarray:
        """[n_blocks, n_blocks] bool — override per pattern."""
        raise NotImplementedError

    def _n(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} % block {self.block} != 0")
        return seq_len // self.block


@dataclass(frozen=True)
class DenseSparsityConfig(SparsityConfig):
    """All blocks attend."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        return np.ones((n, n), bool)


@dataclass(frozen=True)
class FixedSparsityConfig(SparsityConfig):
    """Local windows of ``num_local_blocks`` and, in each window, its last
    ``num_global_blocks`` blocks attended by every row."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        for i in range(n):
            w0 = (i // self.num_local_blocks) * self.num_local_blocks
            layout[i, w0 : w0 + self.num_local_blocks] = True
        for w0 in range(0, n, self.num_local_blocks):
            g0 = min(w0 + self.num_local_blocks, n) - self.num_global_blocks
            for g in range(max(g0, 0), min(w0 + self.num_local_blocks, n)):
                layout[:, g] = True
        return layout


@dataclass(frozen=True)
class BigBirdSparsityConfig(SparsityConfig):
    """Random, sliding-window and global blocks; the random blocks come from
    ``numpy.random.default_rng(seed)``, as in JAX."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[i, max(0, i - half) : min(n, i + half + 1)] = True
        g = min(self.num_global_blocks, n)
        layout[:g, :] = True
        layout[:, :g] = True
        rng = np.random.default_rng(self.seed)
        for i in range(n):
            for r in rng.choice(n, size=min(self.num_random_blocks, n), replace=False):
                layout[i, r] = True
        return layout


@dataclass(frozen=True)
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window and designated global blocks."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[i, max(0, i - half) : min(n, i + half + 1)] = True
        for g in self.global_block_indices:
            if g < n:
                layout[g, :] = True
                layout[:, g] = True
        return layout


@dataclass(frozen=True)
class VariableSparsityConfig(SparsityConfig):
    """Consecutive local windows of the given sizes (the last size repeats)
    and global blocks."""

    local_window_blocks: tuple = (4,)
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = self._n(seq_len)
        layout = np.zeros((n, n), bool)
        i = 0
        widx = 0
        while i < n:
            w = self.local_window_blocks[min(widx, len(self.local_window_blocks) - 1)]
            layout[i : i + w, i : i + w] = True
            i += w
            widx += 1
        g = min(self.num_global_blocks, n)
        layout[:g, :] = True
        layout[:, :g] = True
        return layout


@functools.lru_cache(maxsize=64)
def _layout(config: SparsityConfig, seq_len: int) -> np.ndarray:
    """``config.make_layout(seq_len)``, built once (read-only)."""
    layout = config.make_layout(seq_len)
    layout.setflags(write=False)
    return layout


def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    config: SparsityConfig,
    causal: bool = True,
    q_offset: int = 0,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """[b, s, h, d] attention restricted to the config's block layout
    (JAX ``block_sparse_attention``)."""
    s = q.shape[1]
    if s != k.shape[1] or not (isinstance(q_offset, int) and q_offset == 0):
        return dot_product_attention(
            q, k, v, causal=causal, q_offset=q_offset, scale=scale,
            segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            logits_soft_cap=logits_soft_cap)
    layout = _layout(config, s)
    if sparse_supports(q, k, v, config.block, causal, q_offset, segment_ids):
        out = block_sparse_flash_attention(
            q, k, v, layout, config.block, causal=causal, scale=scale,
            segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
            logits_soft_cap=logits_soft_cap)
        if out is not None:
            return out
    return dot_product_attention(
        q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, logits_soft_cap=logits_soft_cap,
        attn_mask=element_mask(layout, config.block).to(q.device))
