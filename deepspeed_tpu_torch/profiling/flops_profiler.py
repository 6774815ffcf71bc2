"""Flops profiler: the per-module FLOPs / MACs / params tree and the count
of one executed step — counterpart of ``deepspeed_tpu/profiling/
flops_profiler.py`` (the reference's ``profiling/flops_profiler/
profiler.py:30 FlopsProfiler``, engine hook at ``runtime/engine.py:1955``).

Two sources, as in JAX:

- **Analytic tree** (``model_tree``): the model's config fixes every
  matmul's shape, so the per-module FLOPs / params tree is closed-form —
  JAX's numbers node by node.
- **The executed step** (``executed_analysis``, ``analyze_train_step``).
  JAX reads XLA's cost and memory analysis of the compiled step; PyTorch
  has none, so here one step is counted as it runs: ``AtenFlops`` counts
  the aten operations with ``FlopCounterMode``'s formulas (remat's
  recompute included), the attention kernels count their own operations
  inside
  ``ops.kernels.count_kernel_flops`` (a ``ctypes`` launch is invisible to
  the mode: K1f 4 hd a causal pair and query head, K1b 10 hd, K7 over the
  layout's active pairs), and the peak is ``torch.cuda.max_memory_allocated``
  over the step.  Keys: ``flops`` (aten + kernels), ``aten_flops``,
  ``kernel_flops`` (by kernel), ``peak_bytes`` (on a CUDA device only).
  JAX's ``bytes_accessed``, ``temp_size_in_bytes``,
  ``argument_size_in_bytes``, ``output_size_in_bytes`` and
  ``generated_code_size_in_bytes`` have no counterpart in an eager step
  and are not filled.  Counting observes: the step's results are the same
  bits as with counting off.  (``FlopCounterMode`` itself does not: it
  decomposes every operation outside its formula table into smaller ones,
  and a decomposed SiLU backward rounds differently.)

The reference's public surface is kept: ``FlopsProfiler`` with
``start_profile`` / ``stop_profile`` / ``end_profile``, the
``get_total_*`` getters, ``print_model_profile``, and
``get_model_profile(model, ...)`` (profiler.py:870).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.kernels import count_kernel_flops
from ..utils.logging import log_dist


# ---------------------------------------------------------------------------
# human-readable units (reference: profiler.py flops_to_string etc.)
# ---------------------------------------------------------------------------
def number_to_string(num: float, units: Optional[str] = None, precision: int = 2) -> str:
    scale = {"T": 1e12, "G": 1e9, "M": 1e6, "K": 1e3, "": 1.0}
    if units is None:
        for units in ("T", "G", "M", "K", ""):
            if abs(num) >= scale[units]:
                break
    return f"{num / scale[units]:.{precision}f} {units}"


def flops_to_string(flops: float, units=None, precision=2) -> str:
    return number_to_string(flops, units, precision) + "FLOPS"


def macs_to_string(macs: float, units=None, precision=2) -> str:
    return number_to_string(macs, units, precision) + "MACs"


def params_to_string(n: float, units=None, precision=2) -> str:
    return number_to_string(n, units, precision)


def duration_to_string(sec: float, precision=2) -> str:
    if sec >= 1:
        return f"{sec:.{precision}f} s"
    if sec >= 1e-3:
        return f"{sec * 1e3:.{precision}f} ms"
    return f"{sec * 1e6:.{precision}f} us"


# ---------------------------------------------------------------------------
# analytic per-module tree
# ---------------------------------------------------------------------------
@dataclass
class ModuleProfile:
    """One node of the per-module report tree (reference prints nn.Module
    names; ours are the logical blocks of models/transformer.py)."""

    name: str
    params: int = 0
    macs: int = 0  # multiply-accumulates (fwd)
    children: List["ModuleProfile"] = field(default_factory=list)

    @property
    def flops(self) -> int:  # fwd FLOPs
        return 2 * self.macs

    def total_params(self) -> int:
        return self.params + sum(c.total_params() for c in self.children)

    def total_macs(self) -> int:
        return self.macs + sum(c.total_macs() for c in self.children)


def model_tree(cfg, batch: int, seq_len: int) -> ModuleProfile:
    """Closed-form per-module MACs/params for a ``TransformerConfig``.

    Matmul MACs only (norm/rope/softmax elementwise work is <1% and the
    reference's hook counters likewise report MACs of dense ops).
    """
    d, f, L, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    b, s = batch, seq_len
    tok = b * s

    attn = ModuleProfile("attn", children=[
        ModuleProfile("wq", params=d * hq * hd, macs=tok * d * hq * hd),
        ModuleProfile("wk", params=d * hkv * hd, macs=tok * d * hkv * hd),
        ModuleProfile("wv", params=d * hkv * hd, macs=tok * d * hkv * hd),
        # causal scores/weighted-sum do s^2/2 useful positions
        ModuleProfile("qk_scores", macs=b * hq * s * s // 2 * hd),
        ModuleProfile("attn_v", macs=b * hq * s * s // 2 * hd),
        ModuleProfile("wo", params=hq * hd * d, macs=tok * hq * hd * d),
    ])
    if cfg.qkv_bias:
        attn.params += hq * hd + 2 * hkv * hd
    if cfg.moe_num_experts > 0:
        E, k = cfg.moe_num_experts, cfg.moe_top_k
        n_mats = 3 if cfg.gated_mlp else 2
        mlp = ModuleProfile("moe", children=[
            ModuleProfile("router", params=d * E, macs=tok * d * E),
            ModuleProfile(
                f"experts(top{k} of {E})",
                params=E * n_mats * d * f,
                macs=k * tok * n_mats * d * f,
            ),
        ])
    else:
        n_mats = 3 if cfg.gated_mlp else 2
        mlp = ModuleProfile("mlp", params=n_mats * d * f, macs=tok * n_mats * d * f)
    norm_p = d * (2 if cfg.norm == "layernorm" else 1)  # scale (+bias for LN)
    layer = ModuleProfile("decoder_layer", children=[
        ModuleProfile("attn_norm", params=norm_p),
        attn,
        ModuleProfile("mlp_norm", params=norm_p),
        mlp,
    ])
    # one layer node replicated L times (scan shares the trace)
    layers = ModuleProfile(f"layers (x{L})", children=[layer])
    layers.params = (L - 1) * layer.total_params()
    layers.macs = (L - 1) * layer.total_macs()

    head_params = 0 if cfg.tie_embeddings else d * v
    root = ModuleProfile("CausalLM", children=[
        ModuleProfile("embed", params=v * d),
        layers,
        ModuleProfile("final_norm", params=norm_p),
        ModuleProfile("lm_head", params=head_params, macs=tok * d * v),
    ])
    if cfg.position == "learned":
        root.children.insert(1, ModuleProfile("pos_embed", params=cfg.max_seq_len * d))
    return root


# ---------------------------------------------------------------------------
# the executed step
# ---------------------------------------------------------------------------
class AtenFlops(TorchDispatchMode):
    """Sums ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.
    flop_registry``: the matmuls, convolutions and attention ops) over the
    aten operations that run, each run as it is called."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.flops = 0
        self._formulas = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


@contextmanager
def executed_analysis(device=None):
    """Count what runs inside the block: yields a dict that holds, after the
    block, ``flops`` (the aten count plus the kernels' own), ``aten_flops``
    (``AtenFlops``), ``kernel_flops`` (kernel -> operations) and, on a CUDA
    ``device``, ``peak_bytes`` (the allocator's peak over the block; the
    peak statistics are reset on entry)."""
    out: Dict[str, Any] = {}
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    mode = AtenFlops()
    with count_kernel_flops() as kflops, mode:
        yield out
    out["kernel_flops"] = dict(kflops)
    out["aten_flops"] = mode.flops
    out["flops"] = out["aten_flops"] + sum(kflops.values())
    if cuda:
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))


def analyze_train_step(engine, batch) -> dict:
    """Take one ``engine.train_batch(batch)`` step under
    ``executed_analysis`` and return its counts (JAX compiles the step
    without running it; here the step runs and the engine advances)."""
    with executed_analysis(engine.device) as out:
        engine.train_batch(batch)
    return out


# ---------------------------------------------------------------------------
# the profiler object (reference API surface)
# ---------------------------------------------------------------------------
def _first_leaf(tree):
    if isinstance(tree, dict):
        tree = next(iter(tree.values()), None)
    elif isinstance(tree, (list, tuple)):
        tree = tree[0] if tree else None
    if isinstance(tree, (dict, list, tuple)):
        return _first_leaf(tree)
    return tree


class FlopsProfiler:
    """Reference-shaped profiler (profiler.py:30) for engine / model objects.

    Two modes, as in the reference:
      - engine-integrated: config ``flops_profiler.enabled`` and
        ``profile_step``; the engine counts that step as it runs it and
        calls ``engine_step_hook``;
      - standalone: ``p = FlopsProfiler(model); p.start_profile()``; run;
        then ``p.stop_profile(); p.print_model_profile(); p.end_profile()``.
    """

    def __init__(self, model=None, engine=None):
        self.model = model if model is not None else getattr(engine, "model", None)
        self.engine = engine
        self.started = False
        self._t0 = 0.0
        self._duration = 0.0
        self._batch = 1
        self._seq = None
        self._tree: Optional[ModuleProfile] = None
        self._executed: dict = {}

    # -- lifecycle ---------------------------------------------------------
    def start_profile(self, ignore_list=None) -> None:
        self.started = True
        self._t0 = time.perf_counter()

    def stop_profile(self) -> None:
        if self.started:
            self._duration = time.perf_counter() - self._t0
        self.started = False

    def reset_profile(self) -> None:
        self._duration = 0.0
        self._tree = None

    def end_profile(self) -> None:
        self.reset_profile()

    # -- shapes ------------------------------------------------------------
    def observe_batch(self, batch) -> None:
        """Record the batch and sequence size of a train batch (a tree of
        ``[gas, micro, seq + 1]`` or ``[batch, seq + 1]`` token arrays)."""
        x = _first_leaf(batch)
        if x is None:
            return
        if x.ndim >= 3:  # [gas, micro, seq]: the step runs gas * micro samples
            self._batch, self._seq = int(x.shape[0] * x.shape[1]), int(x.shape[2]) - 1
        elif x.ndim == 2:
            self._batch, self._seq = int(x.shape[0]), int(x.shape[1]) - 1

    def _ensure_tree(self) -> Optional[ModuleProfile]:
        if self._tree is None and self.model is not None:
            cfg = getattr(self.model, "cfg", None)
            if cfg is not None:
                seq = self._seq or cfg.max_seq_len
                self._tree = model_tree(cfg, self._batch, seq)
        return self._tree

    # -- totals (reference getters) ---------------------------------------
    def get_total_flops(self, as_string: bool = False):
        """Forward FLOPs of the analytic tree (2 x MACs)."""
        tree = self._ensure_tree()
        flops = 2 * tree.total_macs() if tree else 0
        return flops_to_string(flops) if as_string else flops

    def get_total_macs(self, as_string: bool = False):
        tree = self._ensure_tree()
        macs = tree.total_macs() if tree else 0
        return macs_to_string(macs) if as_string else macs

    def get_total_params(self, as_string: bool = False):
        tree = self._ensure_tree()
        n = tree.total_params() if tree else 0
        return params_to_string(n) if as_string else n

    def get_total_duration(self, as_string: bool = False):
        return duration_to_string(self._duration) if as_string else self._duration

    def get_executed(self) -> dict:
        """The counts of the profiled step (``executed_analysis``'s keys);
        empty in standalone use."""
        return dict(self._executed)

    # -- report ------------------------------------------------------------
    def print_model_profile(self, profile_step: int = 1, module_depth: int = -1,
                            top_modules: int = 1, detailed: bool = True,
                            output_file: Optional[str] = None) -> str:
        tree = self._ensure_tree()
        lines: List[str] = []
        lines.append("-" * 72)
        lines.append("DeepSpeed-TPU Flops Profiler")
        lines.append("-" * 72)
        lines.append(f"profile step: {profile_step}")
        if tree is not None:
            total_macs = tree.total_macs()
            total_params = tree.total_params()
            lines.append(f"params:               {params_to_string(total_params)}")
            lines.append(f"fwd MACs:             {macs_to_string(total_macs)}")
            lines.append(f"fwd FLOPs:            {flops_to_string(2 * total_macs)}")
            lines.append(f"train FLOPs (fwd+bwd): {flops_to_string(6 * total_macs)}")
            if self._duration:
                lines.append(f"step latency:         {duration_to_string(self._duration)}")
                lines.append("train FLOPS achieved: "
                             f"{flops_to_string(6 * total_macs / self._duration)}")
        ex = self._executed
        if "flops" in ex:
            lines.append(f"executed FLOPs:       {number_to_string(ex['flops'])} "
                         f"(aten {number_to_string(ex['aten_flops'])}, kernels "
                         f"{number_to_string(sum(ex['kernel_flops'].values()))})")
            for name, n in sorted(ex["kernel_flops"].items()):
                lines.append(f"  kernel {name}: {number_to_string(n)}")
            if self._duration:
                lines.append("executed FLOPS:       "
                             f"{flops_to_string(ex['flops'] / self._duration)}")
        if "peak_bytes" in ex:
            lines.append(f"peak memory:          {number_to_string(ex['peak_bytes'])}B")
        if detailed and tree is not None:
            lines.append("")
            lines.append("per-module breakdown (fwd MACs):")
            total = max(tree.total_macs(), 1)

            def walk(node: ModuleProfile, depth: int):
                if module_depth >= 0 and depth > module_depth:
                    return
                pct = 100.0 * node.total_macs() / total
                lines.append(
                    f"{'  ' * depth}{node.name}: "
                    f"params={params_to_string(node.total_params())}, "
                    f"macs={macs_to_string(node.total_macs())} ({pct:.1f}%)")
                for c in node.children:
                    walk(c, depth + 1)

            walk(tree, 0)
        lines.append("-" * 72)
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as fh:
                fh.write(report + "\n")
        else:
            log_dist("\n" + report)
        return report

    # -- engine hook -------------------------------------------------------
    def engine_step_hook(self, engine, batch, executed: Optional[dict] = None) -> None:
        """Called by the engine after ``profile_step`` (reference
        engine.py:1938-1955) with the counts of that step as it ran."""
        self.observe_batch(batch)
        self._executed = dict(executed or {})
        fcfg = engine.config.flops_profiler
        self.print_model_profile(profile_step=fcfg.profile_step,
                                 module_depth=fcfg.module_depth,
                                 detailed=fcfg.detailed, output_file=fcfg.output_file)


def get_model_profile(model, batch: int = 1, seq_len: Optional[int] = None,
                      as_string: bool = True, print_profile: bool = True):
    """Standalone profile of a model (reference profiler.py:870
    ``get_model_profile``): returns (flops, macs, params)."""
    p = FlopsProfiler(model=model)
    p._batch = batch
    if seq_len is not None:
        p._seq = seq_len
    if print_profile:
        p.print_model_profile()
    return (p.get_total_flops(as_string), p.get_total_macs(as_string),
            p.get_total_params(as_string))
