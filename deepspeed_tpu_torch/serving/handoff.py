"""Paged-KV handoff: migrate a prefilled sequence between engine workers —
the port of ``deepspeed_tpu/serving/handoff.py``.

The prefill/decode disaggregation wire: a long prompt prefills on a
prefill-role worker, then at first token the router moves it — this module
packs the sequence's written KV pages into a host payload
(:func:`extract_request`: one gather on the device and one host copy for
the whole pool tree), optionally int8 / fp8 through ``comm.qcomm``'s
per-chunk-scale codec (torch on CPU tensors, bytes equal to JAX's), and
scatters it into freshly owned pages on the destination worker
(:func:`inject_request`, which writes the destination's pool tensors in
place).

Only block-granular state crosses: the extract covers
``ceil(seen_tokens / block_size)`` pages (the partial tail page ships whole
— its rows past ``seen_tokens`` are garbage both sides mask by length), and
the destination publishes an exact migrated prefix into its own cache so
later shared-prefix arrivals hit locally.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..comm import qcomm


@dataclass
class KVHandoff:
    """One migratable sequence: tokens + its written KV pages on the wire.

    ``payloads`` holds ``(quantized, scales, shape, dtype)`` per pool leaf
    in the order of JAX's ``tree_leaves`` over ``(k_layers, v_layers)``:
    every layer's K, then every layer's V; ``scales`` is None for the exact
    ``fmt='none'`` passthrough.  ``wire_bytes`` is the payload + scales
    byte count a cross-process transport would ship."""

    uid: int
    tokens: List[int]  # prompt + the first sampled token
    n_ctx: int  # tokens whose KV the payload carries (positions [0, n_ctx))
    n_pages: int
    fmt: str
    payloads: List[Tuple[torch.Tensor, Optional[torch.Tensor], tuple, torch.dtype]]
    wire_bytes: int


def extract_request(engine, uid: int, fmt: str = "none") -> KVHandoff:
    """Pack ``uid``'s written KV (positions ``[0, seen_tokens)``) from
    ``engine`` into a :class:`KVHandoff`.  The sequence stays live on the
    source — extraction is a read, so a failed adoption downstream simply
    keeps decoding where it was."""
    seq = engine.mgr.seqs[uid]
    bs = engine.block_size
    n_ctx = seq.seen_tokens
    n_pages = -(-n_ctx // bs)
    if n_pages == 0:
        raise ValueError(f"uid {uid} has no written KV to extract")
    k_pages, v_pages = engine.extract_kv_blocks(seq.blocks[:n_pages])
    payloads = []
    wire = 0
    for leaf in (*k_pages, *v_pages):
        q, s = qcomm.quantize_payload(leaf, fmt)
        payloads.append((q, s, tuple(leaf.shape), leaf.dtype))
        wire += qcomm.payload_wire_bytes(leaf.numel(), fmt,
                                         none_bytes_per_el=leaf.element_size())
    return KVHandoff(uid=uid, tokens=[int(t) for t in seq.tokens], n_ctx=n_ctx,
                     n_pages=n_pages, fmt=fmt, payloads=payloads, wire_bytes=wire)


def inject_request(engine, ho: KVHandoff) -> None:
    """Scatter ``ho``'s pages into ``engine``'s pool for the ALREADY
    adopted sequence (``scheduler.adopt_prefilled`` allocated fresh
    exclusive pages and set ``seen_tokens``), then — for EXACT payloads
    only — publish the migrated prefix into the destination's prefix
    cache.  Quantized (int8 / fp8) pages stay private to the migrated
    sequence: the cache's content keys promise exact KV."""
    seq = engine.mgr.seqs[ho.uid]
    bs = engine.block_size
    if -(-ho.n_ctx // bs) != ho.n_pages:
        raise ValueError(
            f"handoff block size mismatch: payload packed {ho.n_pages} "
            f"pages for {ho.n_ctx} tokens, destination block_size={bs}")
    decoded = [qcomm.dequantize_payload(q, s, shape, dtype, ho.fmt)
               for q, s, shape, dtype in ho.payloads]
    L = len(decoded) // 2
    engine.inject_kv_blocks(seq.blocks[:ho.n_pages], (tuple(decoded[:L]), tuple(decoded[L:])))
    if ho.fmt == "none":
        engine.mgr.update_hashes(seq)
    else:
        # placeholder (unkeyed) chain entries for the injected full pages:
        # the engine's decode ticks call update_hashes, which would
        # otherwise publish these lossy pages; with the chain's head
        # unkeyed, no later block of this sequence registers either
        seq.hashes = [None] * (ho.n_ctx // bs)
