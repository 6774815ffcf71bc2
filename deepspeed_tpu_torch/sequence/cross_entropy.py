"""Chunked cross-entropy — counterpart of ``deepspeed_tpu/sequence/
cross_entropy.py:53 chunked_cross_entropy``.

The loss from the final hidden states without materialising the full
``[b, s, vocab]`` logits: a loop over sequence chunks, each under
``torch.utils.checkpoint``, so that no more than one chunk's ``[b, chunk,
vocab]`` fp32 logits is ever live, in the forward or the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_nll(h, head_kernel, labels, head_bias, ignore_index):
    """(sum of NLL, count of labelled tokens) of one chunk, fp32."""
    logits = (h @ head_kernel).float()
    if head_bias is not None:
        logits = logits + head_bias.float()
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels), labels)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    mask = (labels != ignore_index).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head_kernel: torch.Tensor,
                          labels: torch.Tensor, chunk_size: int = 1024,
                          ignore_index: int = -100, head_bias=None) -> torch.Tensor:
    """hidden [b, s, d], head_kernel [d, v], labels [b, s] -> the token-mean
    NLL.  A sequence that is not a multiple of ``chunk_size`` is padded with
    ignored labels (as JAX does at ``:69-75``)."""
    b, s, _ = hidden.shape
    if s % chunk_size:
        pad = chunk_size - s % chunk_size
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
        s += pad
    nll_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk_size):
        nll, n = checkpoint(_chunk_nll, hidden[:, c0:c0 + chunk_size], head_kernel,
                            labels[:, c0:c0 + chunk_size], head_bias, ignore_index,
                            use_reentrant=False)
        nll_sum = nll_sum + nll
        count = count + n
    return nll_sum / count.clamp(min=1.0)
