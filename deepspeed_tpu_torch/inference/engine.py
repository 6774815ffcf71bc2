"""The dense v1 inference engine — counterpart of ``deepspeed_tpu/inference/
engine.py`` (``InferenceEngine``, ``init_inference``; the reference's
``deepspeed.init_inference``).

Batch generation over a dense per-sequence KV cache
(``models.transformer.init_kv_cache``): one prefill of the equal-length
prompts at cache index 0, then one decode step per new token at the next
index, through ``models.transformer.forward(cache=, cache_index=)``.  It
serves every family the model code has, the ones the paged v2 engine
refuses included (ALiBi: bloom; the parallel block: falcon, gpt-j, phi) and
MoE models (the experts dropless).  The attention takes JAX's static
choice: the flash kernel where JAX's ``supports()`` holds (a prefill that
fills the whole cache), the plain body everywhere else
(``transformer.CACHE_ATTENTION`` counts both).

``mesh`` a ``ProcessGrid`` with a ``model`` axis (JAX ``:33-49``: the
parameters on the model's TP rules) serves over the ranks of a
``torch.distributed`` world: each rank keeps its shard of the tree
(``parallel.tensor_parallel.TensorParallel``, the training layout), runs
``forward(par=...)`` (the Megatron collectives; the dense cache holds its
kv heads) and gathers the logits' vocab shards, so every rank samples the
same tokens with the same generator.  A mesh of several devices in one
process is ROADMAP queue 1 item 7 and raises.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..models.transformer import CausalLM, forward, init_kv_cache, lm_logits, tp_head
from ..ops.kernels import resolve_device
from .sampling import SamplingParams, sample


def _cast(tree, dtype, device):
    """Floating leaves in the model's compute type, on ``device``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


class InferenceEngine:
    """Batch generation with a dense per-sequence KV cache."""

    def __init__(self, model, params, max_seq_len: Optional[int] = None, seed: int = 0,
                 device=None, mesh=None):
        self.model = model
        self.cfg = model.cfg
        self.device = resolve_device(device)
        self.max_seq_len = max_seq_len or self.cfg.max_seq_len
        self.tp = None  # the model axis of a tensor-parallel engine
        self.par = None  # its collectives (``parallel.context``)
        if mesh is not None:
            from ..parallel.context import ParallelContext
            from ..parallel.tensor_parallel import TensorParallel

            if self.cfg.moe_num_experts > 0:
                raise NotImplementedError("MoE layers served over a model axis are not "
                                          "ported yet (ROADMAP queue 1 item 7)")
            self.tp = TensorParallel(mesh, self.cfg)
            self.par = ParallelContext(mesh, tp=self.tp)
            params = self.tp.shard_tree(params)
        self.params = _cast(params, self.cfg.dtype, self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache):
        """Prompts [b, s] at cache index 0 -> (last logits [b, v] fp32, cache)."""
        hidden, cache, _ = forward(self.params, tokens, self.cfg, cache=cache, cache_index=0,
                                   return_hidden=True, par=self.par)
        return self._logits(hidden[:, -1]), cache

    @torch.no_grad()
    def decode(self, tok: torch.Tensor, cache, pos: int):
        """One token per row [b, 1] at cache index ``pos`` -> (logits [b, v]
        fp32, cache)."""
        hidden, cache, _ = forward(self.params, tok, self.cfg, cache=cache, cache_index=pos,
                                   return_hidden=True, par=self.par)
        return self._logits(hidden[:, -1]), cache

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return lm_logits(self.params, self.cfg, h).float()
        return self.tp.gather_vocab(tp_head(self.params, self.cfg, h, self.par).float())

    def generate(self, tokens, sampling: SamplingParams = SamplingParams()) -> np.ndarray:
        """Prompts [b, s] (equal lengths) -> [b, n] generated ids, n =
        ``max_new_tokens`` or fewer where ``max_seq_len`` ends the cache
        first (greedy when temperature == 0)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(self.device)
        b, s = tokens.shape
        total = min(self.max_seq_len, s + sampling.max_new_tokens)
        cache = init_kv_cache(self.cfg, b, total, device=self.device, tp=self.tp)
        logits, cache = self.prefill(tokens, cache)
        outs = []
        pos = s
        for _ in range(sampling.max_new_tokens):
            nxt = sample(logits, sampling, self._gen)
            outs.append(nxt)
            if pos >= total:
                break
            logits, cache = self.decode(nxt[:, None].long(), cache, pos)
            pos += 1
        return torch.stack(outs, dim=1).cpu().numpy()


def init_inference(model, params: Any = None, mesh=None, seed: int = 0, device=None,
                   **kw) -> InferenceEngine:
    """``deepspeed.init_inference`` (JAX ``init_inference``): a
    ``models.transformer.CausalLM`` (``params=None`` initialises its
    parameters from ``seed``), or the path of a Hugging Face checkpoint
    directory, streamed onto the device through
    ``checkpoint.load_hf_checkpoint``.  ``device`` is CUDA unless the
    caller names another; ``kw`` goes to ``InferenceEngine``
    (``max_seq_len``).  ``mesh``: a ``ProcessGrid`` whose ``model`` axis
    the engine serves over (its device the engine's)."""
    from ..parallel.topology import ProcessGrid

    if isinstance(mesh, ProcessGrid):
        if any(mesh.axis_size(a) > 1 for a in ("data", "fsdp", "sub")):
            raise NotImplementedError("init_inference over a batch axis is not ported yet "
                                      "(ROADMAP queue 1 item 7)")
        kw["mesh"] = mesh
        device = mesh.device if device is None else device
    elif mesh is not None:
        devices = getattr(mesh, "devices", [None])
        if len(devices) > 1:
            raise NotImplementedError(
                "init_inference over a mesh of more than one device (tensor-parallel "
                "serving) is not ported yet (ROADMAP queue 1 item 7)")
        if device is None and devices[0] is not None:
            device = devices[0]
    device = resolve_device(device)
    if isinstance(model, str):
        import json
        import os

        from ..checkpoint.hf_import import config_from_hf, load_hf_checkpoint

        with open(os.path.join(model, "config.json")) as fh:
            cfg = config_from_hf(json.load(fh))
        loaded, cfg = load_hf_checkpoint(model, cfg, dtype=cfg.dtype, device=device)
        model = CausalLM(cfg)
        params = loaded if params is None else params
    if params is None:
        params = model.init_params(seed=seed, device=device)
    return InferenceEngine(model, params, seed=seed, device=device, **kw)
