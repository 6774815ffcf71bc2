"""ZeRO++: the quantized weight gather (qwZ), the quantized gradient
reduce (qgZ) with LoCo's error feedback — counterpart of
``deepspeed_tpu/runtime/zeropp.py`` (:46 ``_quant_a2a_reduce``, :60
``_gather_leaf_fn``, :143 ``make_micro_value_and_grad``, :281
``init_loco_state``; the reference's ``runtime/zero/config.py:294-315``
and ``runtime/comm/coalesced_collectives.py:31``).

At ZeRO stage 3 (``runtime/zero.py``) each group's gather and
reduce-scatter go through here when the keys are on:

- qwZ (``zero_quantized_weights``): the slice travels as int8 with one
  fp32 scale a 256-element chunk and is dequantized into the compute type
  on arrival (``qcomm.q_all_gather``; K6a / K6b on CUDA);
- qgZ (``zero_quantized_gradients``): the group's gradient splits into one
  piece a destination, each quantized to int8, all-to-all, dequantized and
  summed in fp32 (``qcomm.q_reduce_scatter``);
- LoCo (``zeropp_loco_param``, ``{"err_beta": 0.8, "reset_T": 1024}``):
  each rank keeps an fp32 error buffer of every gathered group's whole
  gradient; ``comp = g + err`` is what it quantizes, and ``err <- beta *
  (comp - dequant(quant(comp)))``; the buffers reset every ``reset_T``
  steps.

hpZ and MiCS are the ``sub`` axis's partitions in ``runtime/zero.py``.  As
in JAX, the quantized paths do not combine with them (``ConfigError``),
the ranks' losses are averaged alike (JAX's ``shard_map`` body pmeans the
ranks' means), and LoCo needs qgZ, bf16 and no ``data`` axis.  Unlike JAX,
which runs the plain step when the shard group has one rank, a world of
one quantizes too (a group of one is a group: the card's world-1 run goes
through the kernels).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..comm import qcomm
from ..config.config import ConfigError
from ..parallel.topology import DATA_AXIS


def quant_a2a_reduce(g: torch.Tensor, axis_name, world: int, mesh=None):
    """qgZ's core (JAX ``_quant_a2a_reduce``): this rank's full partial
    ``g`` -> (its reduced piece, the quantization residual of ``g``)."""
    return qcomm.q_reduce_scatter(g, axis_name, "int8", error=torch.zeros_like(g),
                                  world=world, mesh=mesh)


class ZeroPP:
    """qwZ / qgZ / LoCo for one engine (``ZeroShard.quant``)."""

    def __init__(self, weights: bool, grads: bool, loco: Optional[dict], grid):
        self.weights, self.grads, self.grid = bool(weights), bool(grads), grid
        self.loco_beta = float(loco.get("err_beta", 0.8)) if loco is not None else None
        self.loco_reset_T = int(loco.get("reset_T", 1024)) if loco is not None else None
        self.err: Dict[str, torch.Tensor] = {}

    @classmethod
    def from_config(cls, config, grid, device) -> Optional["ZeroPP"]:
        """None below stage 3 (JAX applies ZeRO++ to the stage-3 gathers
        only); the checks of JAX's engine (:233-264) otherwise."""
        z = config.zero_optimization
        if z.stage < 3:
            return None
        if grid.spec.sub > 1:
            raise ConfigError(
                "zero_quantized_weights/gradients cannot combine with "
                "zero_hpz_partition_size/mics_shard_size yet (the int8 "
                "collective path shards on the plain fsdp axis)")
        loco = z.zeropp_loco_param
        if loco is not None:
            if config.fp16.enabled or z.offload_optimizer is not None \
                    or z.offload_param is not None:
                raise ConfigError(
                    "zeropp_loco_param requires bf16 and no optimizer/param offload — the "
                    "error-feedback buffer does not track dynamic loss scales")
            if not z.zero_quantized_gradients or grid.spec.sizes[DATA_AXIS] > 1:
                raise ValueError(
                    "zeropp_loco_param requires zero_quantized_gradients and a pure "
                    "fsdp DP layout (data axis 1) — the error buffer is per-fsdp-rank")
        return cls(z.zero_quantized_weights, z.zero_quantized_gradients, loco, grid)

    def attach(self, zs) -> None:
        """LoCo's buffers (JAX ``init_loco_state``): one a gathered group,
        its whole padded gradient, on this rank."""
        if self.loco_beta is None:
            return
        for g in zs.groups:
            if g.kind == "gathered":
                self.err[g.name] = torch.zeros(g.padded, dtype=torch.float32, device=zs.device)

    def begin_step(self, step: int) -> None:
        """LoCo's reset: the buffers zeroed every ``reset_T`` steps (the
        reference's ``loco_idx > reset_T``; JAX zeroes at ``step % T ==
        0``)."""
        if self.loco_beta is not None and step % self.loco_reset_T == 0:
            for e in self.err.values():
                e.zero_()

    def gather(self, src: torch.Tensor, levels, dtype) -> torch.Tensor:
        """qwZ: the slice over the group's levels, int8 on the wire."""
        (axes,) = levels
        return qcomm.q_all_gather(src, axes, "int8", tiled=True, out_dtype=dtype,
                                  mesh=self.grid)

    def reduce(self, g, grad_full: torch.Tensor, levels) -> torch.Tensor:
        """qgZ: the whole group's fp32 gradient -> this rank's piece of the
        sum, int8 on the wire; with LoCo compensated by the group's error
        buffer, which takes the new residual."""
        (axes,) = levels
        w = self.grid.axis_size(axes)
        if self.loco_beta is None:  # no residual to keep: none computed
            return qcomm.q_reduce_scatter(grad_full, axes, "int8", world=w, mesh=self.grid)
        err = self.err[g.name]
        out, residual = quant_a2a_reduce(grad_full + err, axes, w, mesh=self.grid)
        err.copy_(self.loco_beta * residual)
        return out
