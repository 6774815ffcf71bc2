"""Hybrid engine: train and generate on one set of weights — counterpart of
``deepspeed_tpu/runtime/hybrid_engine.py`` (the reference's
``runtime/hybrid_engine.py:30 DeepSpeedHybridEngine``, its LoRA fuse
around generate, ``:132-146``).

``generate`` / ``generate_batch`` serve the live training weights through a
persistent ``inference.engine_v2.InferenceEngineV2``: the parameters cast
to the serving type, the LoRA adapters merged first for a
``linear.LoRACausalLM`` (JAX's ``cast_tree``).  When the training step
count has moved since the last generate, ``refresh`` writes the new weights
into the serving engine's own tensors, in place.  The serving engine
captures its decode-burst tick as a CUDA graph over those tensors
(``decode_megastep``); a new tree would leave the graphs replaying the old
addresses, so the tensors are never replaced, only overwritten, and every
captured graph then reads the new weights.  A pipelined NVMe walk is
joined first (``flush_nvme_pipeline``), as in JAX.  Activation
quantization is a training-time forward; the serving config has
``act_quant_bits=None``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..inference.engine_v2 import InferenceEngineV2
from ..inference.sampling import SamplingParams
from ..utils.logging import log_dist


class DeepSpeedHybridEngine:
    """A training engine (``initialize`` of a ``models.CausalLM`` or a
    ``linear.LoRACausalLM``) with a generate path over its live weights.
    Every training method delegates to it."""

    def __init__(self, engine, max_seqs: int = 8, num_blocks: int = 256, block_size: int = 32,
                 max_seq_len: Optional[int] = None, max_out_tokens: Optional[int] = None,
                 **inference_kw):
        self.max_out_tokens = max_out_tokens
        model = getattr(engine, "model", None)
        if model is None or not hasattr(model, "cfg"):
            raise ValueError(
                "DeepSpeedHybridEngine needs an engine built from a model adapter "
                "(deepspeed_tpu_torch.models CausalLM / linear.LoRACausalLM)")
        self.engine = engine
        self.model = model
        self._lora = hasattr(model, "merge")  # the LoRACausalLM contract
        self._infer_cfg = model.cfg.replace(act_quant_bits=None)
        inference_kw.setdefault("device", engine.device)
        self._inference = InferenceEngineV2(
            params=self._serving_params(), cfg=self._infer_cfg, max_seqs=max_seqs,
            num_blocks=num_blocks, block_size=block_size, max_seq_len=max_seq_len,
            **inference_kw)
        self._params_step = int(engine.global_steps)
        log_dist("hybrid engine ready: train + generate (paged serving) on shared weights")

    # -- the weight bridge -----------------------------------------------------
    @torch.no_grad()
    def _merged(self):
        """The live training parameters with the adapters merged (the
        reference's fuse_lora before generate)."""
        flush = getattr(self.engine, "flush_nvme_pipeline", None)
        if flush is not None:
            flush()  # a pipelined NVMe walk: serve the post-update weights
        params = self.engine.params
        return self.model.merge(params) if self._lora else params

    def _serving_params(self):
        """A fresh serving tree: every floating leaf cast to the serving
        type on the engine's device (a copy, never the masters)."""
        dtype, device = self._infer_cfg.dtype, self.engine.device

        def cast(node):
            if isinstance(node, dict):
                return {k: cast(v) for k, v in node.items()}
            if node.is_floating_point():
                return node.detach().to(device=device, dtype=dtype, copy=True)
            return node.detach().to(device=device, copy=True)

        return cast(self._merged())

    @torch.no_grad()
    def refresh(self) -> None:
        """Write the current training weights into the serving engine's
        tensors in place (called by ``generate`` when the step count moved):
        the captured burst graphs keep their addresses and read the new
        values."""

        def write(dst, src):
            for k, v in src.items():
                if isinstance(v, dict):
                    write(dst[k], v)
                else:
                    dst[k].copy_(v.detach())

        write(self._inference.params, self._merged())
        self._params_step = int(self.engine.global_steps)

    # -- generate ----------------------------------------------------------------
    def _clamp(self, sampling: SamplingParams) -> SamplingParams:
        if self.max_out_tokens is not None and sampling.max_new_tokens > self.max_out_tokens:
            return dataclasses.replace(sampling, max_new_tokens=self.max_out_tokens)
        return sampling

    def _sync(self) -> None:
        if int(self.engine.global_steps) != self._params_step:
            self.refresh()

    def generate(self, prompt_tokens: Sequence[int],
                 sampling: SamplingParams = SamplingParams()) -> List[int]:
        """One prompt through the serving engine's scheduler."""
        self._sync()
        return self._inference.generate(prompt_tokens, self._clamp(sampling))

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       sampling: SamplingParams = SamplingParams()) -> List[List[int]]:
        """A batched rollout: one packed prefill, then shared decode ticks
        until every sequence has its ``max_new_tokens`` (JAX's loop)."""
        self._sync()
        sampling = self._clamp(sampling)
        inf = self._inference
        base = max(inf.mgr.seqs, default=0) + 1  # never collide with live uids
        uids = list(range(base, base + len(prompts)))
        inf.put(uids, prompts, sampling)
        lens = {u: len(p) for u, p in zip(uids, prompts)}
        while True:
            for u in uids:
                seq = inf.mgr.seqs[u]
                if seq.cur_len - lens[u] >= sampling.max_new_tokens:
                    # a finished rollout stops taking decode work
                    seq.done = True
            if all(inf.mgr.seqs[u].done for u in uids):
                break
            if not inf.step(sampling):
                break
        results = []
        for u in uids:
            toks = inf.mgr.seqs[u].tokens[lens[u]:]
            if sampling.stop_token is not None and toks and toks[-1] == sampling.stop_token:
                toks = toks[:-1]
            results.append(toks[:sampling.max_new_tokens])
        inf.flush(uids)
        return results

    # -- training delegation ---------------------------------------------------
    def train_batch(self, batch):
        return self.engine.train_batch(batch)

    def __getattr__(self, name):
        if name == "engine":  # not set yet: no delegation
            raise AttributeError(name)
        return getattr(self.engine, name)
