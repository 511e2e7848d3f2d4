"""Mixed-precision training (bf16 AMP).

API-shaped after the reference's later fluid.contrib.mixed_precision
(decorate(optimizer)), redesigned TPU-first: instead of rewriting the graph
with cast ops and a loss-scaling loop (fp16 needs both), the returned
optimizer simply switches the owning Program to the bfloat16 lowering policy
(core/amp.py) when minimize() is called. bf16 has float32's exponent range,
so loss scaling is a no-op; the knobs are accepted for API compatibility.

Master weights and optimizer state stay float32 in the Scope, compute runs
bf16 on the MXU, numerically sensitive ops (losses, norms, big reductions,
the optimizer update) run f32 — see core/amp.py for the exact policy.
"""

from __future__ import annotations

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    """Wraps an Optimizer; minimize() enables the bf16 policy on the loss's
    Program and then delegates. Loss-scaling attributes exist for parity
    with fp16-style APIs but do not affect bf16 math."""

    def __init__(self, optimizer, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False):
        self._optimizer = optimizer
        self._loss_scaling = float(init_loss_scaling)
        self._use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)

    @property
    def loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.block.program.set_amp(True)
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        loss.block.program.set_amp(True)
        return self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)

    def __getattr__(self, name):
        if name == "_optimizer":  # not yet set (e.g. during unpickling)
            raise AttributeError(name)
        return getattr(self._optimizer, name)


def decorate(optimizer, init_loss_scaling=1.0,
             use_dynamic_loss_scaling=False):
    """Wrap `optimizer` for bf16 mixed-precision training:

        opt = fluid.contrib.mixed_precision.decorate(fluid.optimizer.Adam(1e-3))
        opt.minimize(loss)   # program now lowers with the bf16 policy
    """
    return OptimizerWithMixedPrecision(
        optimizer, init_loss_scaling, use_dynamic_loss_scaling)
