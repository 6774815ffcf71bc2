"""1-bit Adam / 0/1 Adam / 1-bit Lamb — counterpart of
``deepspeed_tpu/runtime/onebit.py`` (the reference's
``runtime/fp16/onebit/adam.py:14 OnebitAdam``, ``zoadam.py``,
``onebit/lamb.py``), at ZeRO stage 0 across the ranks of a process grid.

Before ``freeze_step`` the ranks' gradients are averaged exactly and the
update is Adam's; from it on the variance is frozen and each rank's
momentum ``b1 m + (1 - b1) g`` (its own gradient) is averaged through the
error-feedback sign-compressed all-reduce (``comm/compressed.py``).  The
bias corrections stop at ``freeze_step`` (JAX's, so the warmup is dense
Adam and the step size is continuous across the freeze); the decoupled
weight decay applies to every leaf and 1-bit Lamb scales each leaf's
update by its trust ratio, clipped to [0.01, 10].  The step is JAX's
``sharded_body`` (:141-216) leaf for leaf; the gradient norm reported is
that of the averaged gradient in the warmup and of the averaged momentum
after it (no dense collective in the compressed phase).
"""
from __future__ import annotations

import torch

from ..comm import comm
from ..comm.compressed import compressed_allreduce, error_buffer_sizes
from ..config.config import ConfigError
from ..parallel.topology import BATCH_AXES, DATA_AXIS
from .precision import global_grad_norm

ONEBIT = ("onebitadam", "zerooneadam", "onebitlamb")


def is_onebit(name: str) -> bool:
    return name.lower().replace("_", "") in ONEBIT


def check_supported(config) -> None:
    if config.zero_optimization.stage > 0:
        raise ConfigError(
            "1-bit optimizers require zero stage 0 (compressed momentum is "
            "replicated; reference onebit/adam.py has the same constraint)")
    if config.fp16.enabled:
        raise ConfigError("1-bit optimizers: use bf16 (no dynamic loss scaling)")


def dp_axes(grid):
    """JAX ``_dp_axes``: the batch axes larger than one (``data`` if none
    is)."""
    return tuple(a for a in BATCH_AXES if grid.spec.sizes.get(a, 1) > 1) or (DATA_AXIS,)


class OnebitStep:
    """The 1-bit family's state over the engine's flat masters (``state``:
    ``m``, ``v``, this rank's ``worker_error`` and ``server_error``) and its
    step (``apply``)."""

    def __init__(self, config, grid, flat: torch.Tensor):
        op = dict(config.optimizer.params or {})
        self.lamb = config.optimizer.type.lower().replace("_", "") == "onebitlamb"
        self.b1, self.b2 = tuple(op.get("betas", (0.9, 0.999)))
        self.eps = float(op.get("eps", 1e-8))
        self.wd = float(op.get("weight_decay", 0.0))
        self.freeze_step = int(op.get("freeze_step", 100))
        self.grid = grid
        self.axes = dp_axes(grid)
        self.world = grid.axis_size(self.axes)
        n = flat.numel()
        padded, chunk = error_buffer_sizes(n, self.world)
        z = lambda k: torch.zeros(k, dtype=torch.float32, device=flat.device)  # noqa: E731
        self.state = {"m": z(n), "v": z(n), "worker_error": z(padded), "server_error": z(chunk)}

    @torch.no_grad()
    def apply(self, engine, divisor):
        """One update from the engine's gradient buffer (this rank's
        gradient weighted ``1 / W`` by the engine's loss, summed over the
        micro-batches); returns ``(grad_norm, lr, skipped)``."""
        st, b1, b2 = self.state, self.b1, self.b2
        step = engine.global_steps  # the applied updates (no fp16 skips here)
        grad = engine._masters.grad
        g = grad * (self.world / divisor)  # this rank's mean gradient
        if step < self.freeze_step:
            avg = comm.all_reduce(g.clone(), self.axes, mesh=self.grid) / self.world
            st["m"].mul_(b1).add_((1.0 - b1) * avg)
            st["v"].mul_(b2).add_((1.0 - b2) * avg * avg)
            gnorm = global_grad_norm([avg])
        else:
            m_local = b1 * st["m"] + (1.0 - b1) * g
            m_avg, errw, errs = compressed_allreduce(m_local, st["worker_error"],
                                                     st["server_error"], self.axes,
                                                     mesh=self.grid)
            st["m"].copy_(m_avg)
            st["worker_error"].copy_(errw)
            st["server_error"].copy_(errs)
            # the engine's norm: squares summed, which holds on the CPU
            # (vector_norm there drifts on many entries of one magnitude)
            gnorm = global_grad_norm([m_avg])
        t = float(min(step, self.freeze_step) + 1)
        upd = -(st["m"] / (1.0 - b1 ** t)) / (torch.sqrt(st["v"] / (1.0 - b2 ** t)) + self.eps)
        lr = torch.as_tensor(engine.lr_schedule_fn(engine.device_step), dtype=torch.float32,
                             device=grad.device)
        off = 0
        for p in engine._params_list:
            k = p.numel()
            u = upd[off:off + k].view(p.shape) - self.wd * p
            if self.lamb:
                pn, un = global_grad_norm([p]), global_grad_norm([u])
                trust = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
                u = u * trust.clamp(0.01, 10.0)
            p.add_(lr * u)
            off += k
        grad.zero_()
        engine.device_step += 1
        return gnorm, lr, torch.zeros((), dtype=torch.bool, device=grad.device)
