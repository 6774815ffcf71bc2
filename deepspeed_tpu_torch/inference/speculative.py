"""Prompt-lookup drafting for speculative decoding — counterpart of
``deepspeed_tpu/inference/speculative.py``.

A decode forward reads every weight once per tick.  Speculation drafts
``k`` candidate tokens, scores all ``k + 1`` positions in one target forward
(``model_runner.verify_packed_ctx``) and keeps the longest prefix the target
distribution accepts (``sampling.spec_verify_sample``), so one weight read
can emit several tokens.  Greedy speculation is token-identical to plain
greedy decode.

The drafter reads the candidate continuation out of the sequence's own
token history (n-gram self-speculation): no second model, deterministic,
and run on the host between device ticks.  It drafts where traffic repeats
itself (copying prompt spans, repetition loops) and proposes nothing on an
incompressible stream, where the engine's per-sequence throttle falls back
to plain decode.

Host-side and stateless: ``propose`` is a pure function of the token list,
so preemption, prefix-cache swaps and uid reuse need no invalidation here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def propose(tokens: Sequence[int], min_match: int, max_draft: int,
            lookup_window: int = 1024) -> List[int]:
    """Draft up to ``max_draft`` tokens by prompt lookup.

    Finds the most recent earlier occurrence of the final ``min_match``-gram
    inside the last ``lookup_window`` tokens and proposes the continuation
    that followed it.  When the continuation runs into the tail (the
    sequence is periodic with a period under ``min_match + max_draft``), it
    cycles the period, so a period-1 loop still yields a full draft.
    Returns ``[]`` when the history is too short or no n-gram recurs."""
    return propose_detail(tokens, min_match, max_draft, lookup_window)[0]


def propose_detail(tokens: Sequence[int], min_match: int, max_draft: int,
                   lookup_window: int = 1024) -> Tuple[List[int], int]:
    """``propose`` plus the drafter diagnostic the telemetry records:
    ``(drafts, match_start)``, ``match_start`` the index of the matched
    n-gram's first token (-1 when nothing was proposed).  The tail-to-match
    distance ``(len(tokens) - min_match) - match_start`` is ~0 in a local
    repetition loop and large on a prompt-copy workload."""
    n = len(tokens)
    if max_draft <= 0 or min_match <= 0 or n < min_match + 1:
        return [], -1
    suffix = tuple(tokens[-min_match:])
    lo = max(0, n - lookup_window)
    # newest first; the suffix itself starts at n - min_match
    for i in range(n - min_match - 1, lo - 1, -1):
        if tuple(tokens[i:i + min_match]) != suffix:
            continue
        start = i + min_match
        period = (n - min_match) - i  # distance match -> tail
        out: List[int] = []
        for j in range(max_draft):
            idx = start + j
            while idx >= n:  # past the end: cycle the period
                idx -= period
            out.append(int(tokens[idx]))
        return out, i
    return [], -1
