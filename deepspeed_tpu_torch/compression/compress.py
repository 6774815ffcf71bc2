"""Compression: QAT weight quantization, activation quantization, pruning
(unstructured and row / head / channel), layer reduction and knowledge
distillation — counterpart of ``deepspeed_tpu/compression/compress.py``,
driven by the reference's ``compression_training`` schema.

As in JAX, compression is a transform over the parameter tree, not module
surgery: the engine applies ``CompressionManager.transform(params, step)``
to the compute-type parameters of every micro-batch, after the cast from
the fp32 masters and before the loss.  Each technique is a straight-through
estimator: the forward sees the transformed value, the gradient passes as
the identity (``x + (t - x).detach()``, JAX's ``x + stop_gradient(t -
x)``, evaluated in the leaf's type, so under bf16 the forward value is
``bf16(x + bf16(t - x))`` exactly as in JAX, which is not always ``t``).

``step`` is the engine's device step counter (JAX's ``state.step``: the
updates applied before this one), a device tensor: the schedule offset and
the bit ramp are evaluated on the device, with no host read a step.

The numbers follow JAX's op for op, in fp32:

- ``fake_quantize``: ``scale = amax / qmax`` (a division, not a multiply by
  a reciprocal), round half to even, clip to ``[-qmax - 1, qmax]``; the
  asymmetric form is JAX's affine min / max.  ``groups`` reshapes the
  *whole* leaf, so a stacked ``[L, ...]`` layer weight with
  ``quantize_groups`` 1 has one scale over all its layers, as in JAX.
  ``rounding: "stochastic"`` is read nowhere by JAX's transform: it always
  rounds to nearest, and so does this one;
- ``magnitude_prune_mask``: the keep threshold is the ``k``-th smallest
  ``|w|`` with ``k = int32(fp32(n) * (1 - fp32(ratio)))`` clipped to ``[0,
  n - 1]`` (fp32, as JAX computes it: float64 moves ``k`` for large
  stacks), read off a full sort as in JAX (``torch.kthvalue`` gives the
  same value, but on the card it selects over one slice with one block:
  183 ms against the sort's 1.23 ms for a 25,165,824-element leaf on an
  NVIDIA H100 80GB HBM3 at 700 W, ``chip_smoke.py``'s ``compress_train``);
  ``>=`` keeps ties;
- ``structured_keep_mask``: a rank (a stable argsort of a stable argsort)
  of the negated unit scores, so exactly ``k = max(1, round(width *
  ratio))`` units survive ties.

Leaves are visited in JAX's order (``jax.tree_util`` sorts dict keys), by
the flat paths JAX's ``path_str`` writes (``layers/mlp/w_up``), so the sums
of unit scores over twin modules (``w_gate`` then ``w_up``) add in JAX's
order.  A leaf given as the sequence of its layers' tensors (an offloaded
engine's compute copy, ``runtime/offload.py``) is stacked first.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging import log_dist


def _ste(x: torch.Tensor, transformed: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the forward is ``x + (t - x)`` in ``x``'s
    type, the gradient the identity."""
    with torch.no_grad():
        delta = transformed - x.detach()
    return x + delta


# ---------------------------------------------------------------------------
# the fake-quant / prune math
# ---------------------------------------------------------------------------
def fake_quantize(x: torch.Tensor, bits, symmetric: bool = True,
                  groups: int = 1) -> torch.Tensor:
    """Group-wise fake quantization (JAX ``fake_quantize``), rounding to
    nearest; ``bits`` may be a device tensor (the bit ramp)."""
    orig_shape, orig_dtype = x.shape, x.dtype
    xf = x.float().reshape(groups, -1)
    qmax = torch.pow(2.0, torch.as_tensor(bits, dtype=torch.float32, device=x.device) - 1.0) - 1.0
    if symmetric:
        scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / qmax, 1e-12)
        q = torch.clamp(torch.round(xf / scale), -qmax - 1.0, qmax)
        out = q * scale
    else:
        levels = 2.0 * qmax + 1.0
        lo = xf.amin(dim=-1, keepdim=True)
        hi = xf.amax(dim=-1, keepdim=True)
        scale = torch.clamp_min((hi - lo) / levels, 1e-12)
        q = torch.round((xf - lo) / scale)
        out = torch.clamp(q, torch.zeros_like(levels), levels) * scale + lo
    return out.reshape(orig_shape).to(orig_dtype)


def prune_keep_index(n: int, dense_ratio: float) -> int:
    """JAX's ``k``: ``int32(fp32(n) * (1 - fp32(dense_ratio)))`` clipped to
    ``[0, n - 1]``."""
    k = np.float32(n) * (np.float32(1.0) - np.float32(dense_ratio))
    return int(min(max(int(k.astype(np.int32)), 0), n - 1))


def magnitude_prune_mask(x: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Keep the largest-``|w|`` ``dense_ratio`` fraction (the reference's
    ``l1`` method): 1 where ``|w|`` is at least the ``k``-th smallest, in
    ``x``'s type."""
    a = x.float().abs()
    k = prune_keep_index(a.numel(), dense_ratio)
    threshold = torch.sort(a.reshape(-1)).values[k]
    return (a >= threshold).to(x.dtype)


def structured_keep_mask(scores: torch.Tensor, dense_ratio: float) -> torch.Tensor:
    """Boolean keep-mask over the last axis of ``scores``: the top
    ``dense_ratio`` fraction of units by score, exactly ``k`` of them."""
    width = scores.shape[-1]
    k = max(1, int(round(width * float(dense_ratio))))
    order = torch.argsort(torch.argsort(-scores, dim=-1, stable=True), dim=-1, stable=True)
    return order < k


def quantize_activation(x: torch.Tensor, bits: int = 8, symmetric: bool = True,
                        static_range: Optional[float] = None) -> torch.Tensor:
    """Activation fake-quant with an STE (the reference's
    ``activation_quantization``): ``dynamic`` range is the tensor's amax,
    ``static`` a given range."""
    if static_range is not None:
        qmax = 2.0 ** (bits - 1) - 1.0
        scale = static_range / qmax
        fq = torch.clamp(torch.round(x.float() / scale), -qmax - 1, qmax) * scale
        return _ste(x, fq.to(x.dtype))
    with torch.no_grad():
        fq = fake_quantize(x.detach(), bits, symmetric=symmetric)
    return _ste(x, fq)


# ---------------------------------------------------------------------------
# the tree as JAX flattens it
# ---------------------------------------------------------------------------
def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in JAX's leaf order (sorted keys), paths as JAX's
    ``path_str`` writes them; a sequence leaf (one tensor a layer) is
    stacked."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_with_paths(v, path))
        elif isinstance(v, (list, tuple)):
            out[path] = torch.stack(list(v))
        else:
            out[path] = v
    return out


def unflatten_with_paths(ref_tree, flat: Dict[str, Any], prefix: str = ""):
    """``ref_tree``'s structure with the leaves of ``flat``."""
    out = {}
    for k, v in ref_tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = unflatten_with_paths(v, flat, path) if isinstance(v, dict) else flat[path]
    return out


# ---------------------------------------------------------------------------
# the config (the reference's schema)
# ---------------------------------------------------------------------------
@dataclass
class TechniqueGroup:
    name: str
    modules: List[str]  # regexes over the leaves' paths
    params: Dict[str, Any]
    related_modules: List[str] = field(default_factory=list)  # input-axis twins


@dataclass
class Technique:
    enabled: bool = False
    shared: Dict[str, Any] = field(default_factory=dict)
    groups: List[TechniqueGroup] = field(default_factory=list)

    @classmethod
    def parse(cls, block: Optional[Dict]) -> "Technique":
        if not block:
            return cls()
        shared = dict(block.get("shared_parameters", {}))
        groups = []
        for name, g in (block.get("different_groups", {}) or {}).items():
            related = g.get("related_modules") or []
            # the reference nests related_modules as a list of lists
            if related and isinstance(related[0], (list, tuple)):
                related = [rx for sub in related for rx in sub]
            groups.append(TechniqueGroup(name=name, modules=list(g.get("modules", [".*"])),
                                         params=dict(g.get("params", {})),
                                         related_modules=list(related)))
        return cls(enabled=bool(shared.get("enabled", False)), shared=shared, groups=groups)

    def group_for(self, path: str) -> Optional[TechniqueGroup]:
        for g in self.groups:
            if any(re.search(rx, path) for rx in g.modules):
                return g
        return None


def _step_tensor(step, device) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(device)
    return torch.tensor(int(step), dtype=torch.int32, device=device)


class CompressionManager:
    """The parsed techniques; ``transform`` runs in every micro-batch."""

    def __init__(self, config_dict: Dict):
        cd = config_dict or {}
        self.weight_quant = Technique.parse(cd.get("weight_quantization"))
        self.act_quant = Technique.parse(cd.get("activation_quantization"))
        self.pruning = Technique.parse(cd.get("sparse_pruning"))
        # structured techniques (the reference's row / head / channel pruning)
        self.row_pruning = Technique.parse(cd.get("row_pruning"))
        self.head_pruning = Technique.parse(cd.get("head_pruning"))
        self.channel_pruning = Technique.parse(cd.get("channel_pruning"))
        self.layer_reduction = dict(cd.get("layer_reduction") or {})
        if self.pruning.enabled:
            method = self.pruning.shared.get("method", "l1")
            if method not in ("l1", "topk"):
                raise ValueError(
                    f"sparse_pruning method '{method}' unsupported (l1|topk; "
                    "snip_momentum needs the reference's neural_compressor)")
        if self.head_pruning.enabled and "num_heads" not in self.head_pruning.shared:
            raise ValueError("head_pruning.shared_parameters.num_heads is required "
                             "(reference constants.py:168)")

    @property
    def _structured(self) -> List[Tuple[str, Technique]]:
        return [("row", self.row_pruning), ("head", self.head_pruning),
                ("channel", self.channel_pruning)]

    @property
    def any_weight_transform(self) -> bool:
        return ((self.weight_quant.enabled and bool(self.weight_quant.groups))
                or (self.pruning.enabled and bool(self.pruning.groups))
                or any(t.enabled and bool(t.groups) for _, t in self._structured))

    # -- structured masks ----------------------------------------------------
    def _structured_masks(self, kind: str, tech: Technique, flat: Dict[str, torch.Tensor]):
        """Per group, one keep-mask over the units (the L1 of every matched
        leaf over its non-unit axes, a leading layer axis kept, heads summed
        for ``head``): ``{path: (mask, axis, units)}`` for the matched
        modules (their last axis) and the related ones (their input axis)."""
        num_heads = int(tech.shared.get("num_heads", 0)) if kind == "head" else 0
        out: Dict[str, Tuple[torch.Tensor, int, int]] = {}
        for g in tech.groups:
            matched = [(p, leaf) for p, leaf in flat.items()
                       if leaf.dim() >= 2 and any(re.search(rx, p) for rx in g.modules)]
            if not matched:
                continue
            dense_ratio = float(g.params.get("dense_ratio", 0.5))
            scores = None
            for p, leaf in matched:
                unit_dim = leaf.dim() - 1
                width = leaf.shape[unit_dim]
                # 'channel' targets conv kernels [h, w, cin, cout]: no layer axis
                keep_layer_dim = kind != "channel" and leaf.dim() >= 3
                reduce_dims = tuple(d for d in range(leaf.dim())
                                    if d != unit_dim and not (d == 0 and keep_layer_dim))
                s = leaf.detach().float().abs().sum(dim=reduce_dims)  # [L?, width]
                if kind == "head":
                    if width % num_heads:
                        raise ValueError(f"head_pruning: width {width} of '{p}' not "
                                         f"divisible by num_heads {num_heads}")
                    s = s.reshape(s.shape[:-1] + (num_heads, width // num_heads)).sum(-1)
                scores = s if scores is None else scores + s
            units = scores.shape[-1]
            mask = structured_keep_mask(scores, dense_ratio)  # [L?, units]
            for p, leaf in matched:
                out[p] = (mask, leaf.dim() - 1, units)
            for p, leaf in flat.items():
                if leaf.dim() >= 2 and any(re.search(rx, p) for rx in g.related_modules):
                    # a related module reads the pruned units on its input
                    # axis (second to last in the [..., in, out] layout)
                    out[p] = (mask, leaf.dim() - 2, units)
        return out

    @staticmethod
    def _unit_mask(leaf: torch.Tensor, mask_info) -> torch.Tensor:
        """The keep-mask of ``mask_info`` broadcast over ``leaf``."""
        mask, axis, units = mask_info
        width = leaf.shape[axis]
        m = torch.repeat_interleave(mask, width // units, dim=-1)  # [L?, width]
        shape = [1] * leaf.dim()
        shape[axis] = width
        if m.dim() == 2:  # stacked layers: a leading L axis
            return m.reshape([leaf.shape[0]] + shape[1:])
        return m.reshape(shape)

    def _apply_structured(self, leaf, mask_info, step, offset):
        pruned = leaf * self._unit_mask(leaf, mask_info).to(leaf.dtype)
        return _ste(leaf, torch.where(step >= offset, pruned, leaf))

    # -- the transform ------------------------------------------------------------
    def transform(self, params, step):
        """QAT fake-quant and pruning masks on the matching leaves; ``step``
        (a device int tensor, or an int) drives the offsets and the bit
        ramp on the device."""
        if not self.any_weight_transform:
            return params
        flat = flatten_with_paths(params)
        device = next(iter(flat.values())).device
        step = _step_tensor(step, device)
        structured = []
        for kind, tech in self._structured:
            if tech.enabled and tech.groups:
                structured.append((self._structured_masks(kind, tech, flat),
                                   int(tech.shared.get("schedule_offset", 0))))
        out = {}
        for path, leaf in flat.items():
            new = leaf
            if self.weight_quant.enabled and leaf.dim() >= 2:
                g = self.weight_quant.group_for(path)
                if g is not None:
                    new = self._apply_wq(new, g, step)
            if self.pruning.enabled and leaf.dim() >= 2:
                g = self.pruning.group_for(path)
                if g is not None:
                    new = self._apply_prune(new, g, step)
            for masks, offset in structured:
                if path in masks:
                    new = self._apply_structured(new, masks[path], step, offset)
            out[path] = new
        return unflatten_with_paths(params, out)

    def wq_bits(self, g: TechniqueGroup, step: torch.Tensor) -> torch.Tensor:
        """The group's bit width at ``step`` (fp32 device scalar): the
        reference's ramp drops one bit a ``quantization_period`` after the
        offset, from ``start_bits`` down to ``target_bits``."""
        offset = int(self.weight_quant.shared.get("schedule_offset", 0))
        start_bits = float(g.params.get("start_bits", 8))
        target_bits = float(g.params.get("target_bits", start_bits))
        period = float(g.params.get("quantization_period", 0) or 0)
        if period > 0 and target_bits < start_bits:
            steps_in = torch.clamp_min(step.float() - offset, 0.0)
            drops = torch.floor(steps_in / period)
            return torch.clamp(start_bits - drops, target_bits, start_bits)
        return torch.tensor(target_bits, dtype=torch.float32, device=step.device)

    def _apply_wq(self, leaf, g: TechniqueGroup, step):
        shared = self.weight_quant.shared
        offset = int(shared.get("schedule_offset", 0))
        symmetric = shared.get("quantization_type", "symmetric") == "symmetric"
        groups = int(shared.get("quantize_groups", 1))
        with torch.no_grad():
            fq = fake_quantize(leaf.detach(), self.wq_bits(g, step), symmetric=symmetric,
                               groups=groups)
            target = torch.where(step >= offset, fq, leaf.detach())
        return _ste(leaf, target)

    def _apply_prune(self, leaf, g: TechniqueGroup, step):
        offset = int(self.pruning.shared.get("schedule_offset", 0))
        dense_ratio = float(g.params.get("dense_ratio", 0.5))
        with torch.no_grad():
            x = leaf.detach()
            target = torch.where(step >= offset, x * magnitude_prune_mask(x, dense_ratio), x)
        return _ste(leaf, target)

    # -- export ------------------------------------------------------------------
    @torch.no_grad()
    def export_params(self, params, step: Optional[int] = None):
        """The final compression hard-applied to a tree (the reference's
        fix-compression path): the transform at ``step`` (default 10^9)."""
        return self.transform(params, 10**9 if step is None else step)

    @torch.no_grad()
    def redundancy_clean(self, params):
        """Shrink the tree: the units that row / head / channel pruning
        removes leave the matched modules' output axis and the related
        modules' input axis (the reference's ``redundancy_clean``).  QAT and
        unstructured pruning are hard-applied first (``export_params``).
        Returns ``(clean_params, info)``; each layer keeps the same unit
        count, so stacked layers stay rectangular."""
        params = self.export_params(params)
        flat = flatten_with_paths(params)
        info: Dict[str, Any] = {}
        for kind, tech in self._structured:
            if not (tech.enabled and tech.groups):
                continue
            for path, (mask, axis, units) in self._structured_masks(kind, tech, flat).items():
                leaf = flat[path]
                per_unit = leaf.shape[axis] // units
                if mask.dim() == 1:
                    keep = torch.nonzero(torch.repeat_interleave(mask, per_unit))[:, 0]
                    flat[path] = leaf.index_select(axis, keep)
                else:  # per-layer kept indices, the same count in every row
                    rows = []
                    for li in range(mask.shape[0]):
                        keep = torch.nonzero(torch.repeat_interleave(mask[li], per_unit))[:, 0]
                        rows.append(leaf[li].index_select(axis - 1, keep))
                    flat[path] = torch.stack(rows)
                info.setdefault(kind, {})[path] = {"kept_units": int(mask.sum(-1).min()),
                                                   "of": units}
        return unflatten_with_paths(params, flat), info


# ---------------------------------------------------------------------------
# layer reduction + knowledge distillation
# ---------------------------------------------------------------------------
def layer_reduction_init(teacher_params, layer_reduction: Dict[str, Any]):
    """A student tree from a teacher's: the stacked leaves under
    ``module_name_prefix`` (leading axis = layer) taken at
    ``teacher_layer``, every other leaf shared as it is."""
    ids = list(layer_reduction.get("teacher_layer", []))
    keep = layer_reduction.get("keep_number_layer", len(ids))
    if not ids:
        raise ValueError("layer_reduction.teacher_layer is required")
    if keep != len(ids):
        raise ValueError(f"keep_number_layer {keep} != len(teacher_layer) {len(ids)}")
    prefix = layer_reduction.get("module_name_prefix", "layers")
    flat = flatten_with_paths(teacher_params)
    out = {}
    for path, leaf in flat.items():
        if path.startswith(prefix + "/") or path == prefix:
            idx = torch.tensor(ids, dtype=torch.long, device=leaf.device)
            out[path] = leaf.detach().index_select(0, idx)
        else:
            out[path] = leaf
    return unflatten_with_paths(teacher_params, out)


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """Soft-target KL distillation term, fp32."""
    t = float(temperature)
    s = F.log_softmax(student_logits.float() / t, dim=-1)
    p = F.softmax(teacher_logits.float() / t, dim=-1)
    return -(t * t) * torch.mean(torch.sum(p * s, dim=-1))


def make_kd_loss_fn(student_model, teacher_model, teacher_params, alpha: float = 0.5,
                    temperature: float = 2.0):
    """Engine-ready ``loss_fn(params, batch, rng)`` distilling the teacher
    into the student: ``(1 - alpha) * task + alpha * kd``.  One student
    forward a step (the task cross-entropy is read off the same logits the
    KD term takes); the teacher runs under ``torch.no_grad()``, so its
    logits carry no graph.  The teacher's floating leaves are cast once to
    its config's type (PyTorch does not promote a matmul's operands as XLA
    does; in fp32 this changes nothing).  The progressive-layer-drop mask of
    the batch applies to the student; the teacher runs every layer."""
    from ..models.transformer import cross_entropy_loss, forward
    from ..runtime.precision import cast_floating

    with torch.no_grad():
        t_params = cast_floating(teacher_params, teacher_model.cfg.dtype)

    def loss_fn(params, batch, rng=None):
        inputs, labels, segment_ids, layer_keep = student_model.prepare_batch(batch, rng)
        s_cfg = student_model.cfg
        s_logits, _, s_aux = forward(params, inputs, s_cfg, segment_ids=segment_ids,
                                     with_aux=True, layer_keep=layer_keep)
        task = cross_entropy_loss(s_logits, labels)
        if s_cfg.moe_num_experts > 0:
            task = task + s_cfg.moe_aux_loss_coef * s_aux / max(s_cfg.num_layers, 1)
        with torch.no_grad():
            t_logits = forward(t_params, inputs, teacher_model.cfg, segment_ids=segment_ids)
        kd = kd_loss(s_logits, t_logits, temperature)
        return (1.0 - alpha) * task + alpha * kd

    return loss_fn


def act_quant_bits(technique: Technique) -> int:
    """The activation bits wired into the model (``activation_quantization``
    parsed): the first group's ``bits``, 8 without a group, as JAX reads
    them."""
    groups = technique.groups
    return int(groups[0].params.get("bits", 8)) if groups else 8


def init_compression(engine_or_params, deepspeed_config: Dict, teacher_model=None, mpu=None):
    """The reference's entry (``compress.py:100``).  With an engine: installs
    the manager into its step (``engine._compression``) and the activation
    bits into its model's config; returns the engine.  With a bare tree:
    returns ``(params, manager)`` for manual ``manager.transform``."""
    cd = deepspeed_config.get("compression_training", deepspeed_config) or {}
    manager = CompressionManager(cd)
    target = engine_or_params
    if not hasattr(target, "_micro_loss"):  # a parameter tree
        return target, manager
    if manager.any_weight_transform:
        target._compression = manager
    if manager.act_quant.enabled:
        # activations live inside the model's forward: wire the bits into
        # its config (as initialize() does)
        model = getattr(target, "model", None)
        cfg = getattr(model, "cfg", None)
        if cfg is None or not hasattr(cfg, "act_quant_bits"):
            raise ValueError(
                "activation_quantization needs a model adapter exposing "
                ".cfg.act_quant_bits (deepspeed_tpu_torch.models CausalLM); for custom "
                "loss_fns apply deepspeed_tpu_torch.compression.quantize_activation in the "
                "model")
        model.cfg = cfg.replace(act_quant_bits=act_quant_bits(manager.act_quant))
    log_dist(f"compression initialized: wq={manager.weight_quant.enabled} "
             f"aq={manager.act_quant.enabled} prune={manager.pruning.enabled}")
    return target
