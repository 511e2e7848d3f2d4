"""Part of paddle_tpu/ops/misc_ops.py: ``lstm_unit``, ``is_empty`` and
``print_op``, the ops of the sequence and control-flow slice. The
module's other ops (``selu``, ``pool3d``, ``spectral_norm``, the
detection and sampling helpers, ...) are not ported yet; they wait on
ROADMAP A12.
"""

from __future__ import annotations

import torch

from ..core.registry import register_grad_lowering, register_op


@register_op("lstm_unit", diff_inputs=["X", "C_prev"])
def _lstm_unit(ctx, ins, attrs):
    """One cell step from pre-projected gates [B, 4D] (order i, f, c, o)
    with ``forget_bias``."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    fb = float(attrs.get("forget_bias", 0.0))
    i, f, c, o = torch.chunk(x, 4, dim=-1)
    new_c = c_prev * torch.sigmoid(f + fb) + torch.sigmoid(i) * torch.tanh(c)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return {"C": [new_c], "H": [new_h]}


@register_op("is_empty", no_grad=True)
def _is_empty(ctx, ins, attrs):
    """Whether X has no elements: known from its static shape, so no
    host read."""
    x = ins["X"][0]
    return {"Out": [torch.full((1,), x.numel() == 0, dtype=torch.bool,
                               device=x.device)]}


@register_op("print_op", diff_inputs=["X"], host_sync=True)
def _print_op(ctx, ins, attrs):
    """The Print layer: the value is read on the host and printed as the
    step runs (the JAX package prints from inside its compiled step with
    ``jax.debug.print``). The read is a host sync, so a step holding it
    runs uncaptured (core/executor.py)."""
    x = ins["X"][0]
    msg = attrs.get("message") or ""
    name = attrs.get("name") or ""
    print(msg + " " + name + " = " + str(x.detach().cpu().numpy()))
    return {"Out": [x]}


@register_grad_lowering("print_op")
def _print_op_grad(ctx, ins, attrs):
    """The identity's grad, without a second print (the generic grad
    would run the forward again under ``torch.func.vjp``, whose wrapped
    tensors have no host copy)."""
    g = (ins.get("Out@GRAD") or [None])[0]
    x = ins["X"][0]
    if g is None:
        g = torch.zeros_like(x)
    elif g.dtype != x.dtype or g.shape != x.shape:
        g = torch.broadcast_to(g.to(x.dtype), x.shape)
    return {"X@GRAD": [g]}
