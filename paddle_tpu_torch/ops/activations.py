"""Activation ops: counterparts of paddle_tpu/ops/activations.py (one
registration per activation; each is a one-line torch expression of
the JAX package's formula), and ``prelu`` with its learned slope."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _act(name, fn):
    @register_op(name)
    def _op(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}

    return _op


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_act("relu", lambda x, a: torch.relu(x))
_act("sigmoid", lambda x, a: torch.sigmoid(x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("sqrt", lambda x, a: torch.sqrt(x))
_act("rsqrt", lambda x, a: torch.rsqrt(x))
_act("abs", lambda x, a: torch.abs(x))
_act("exp", lambda x, a: torch.exp(x))
_act("log", lambda x, a: torch.log(x))
_act("square", lambda x, a: x * x)
_act("reciprocal", lambda x, a: 1.0 / x)
_act("softplus", lambda x, a: _softplus(x))
_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_act("ceil", lambda x, a: torch.ceil(x))
_act("floor", lambda x, a: torch.floor(x))
_act("round", lambda x, a: torch.round(x))
_act("cos", lambda x, a: torch.cos(x))
_act("sin", lambda x, a: torch.sin(x))
_act("gelu", lambda x, a: F.gelu(
    x, approximate="tanh" if a.get("approximate", False) else "none"))
_act("relu6", lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)))
_act("leaky_relu", lambda x, a: F.leaky_relu(x, a.get("alpha", 0.02)))
_act("elu", lambda x, a: F.elu(x, a.get("alpha", 1.0)))
_act("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159)
     * torch.tanh(a.get("scale_a", 0.67) * x))
_act("hard_sigmoid", lambda x, a: torch.clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_act("hard_swish", lambda x, a: x * torch.clamp(
    x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_act("brelu", lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                       a.get("t_max", 24.0)))
_act("soft_relu", lambda x, a: torch.log1p(torch.exp(torch.clamp(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_act("logsigmoid", lambda x, a: F.logsigmoid(x))
_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_act("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, torch.zeros_like(x)))
_act("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)))
_act("mish", lambda x, a: x * torch.tanh(_softplus(x)))
_act("silu", lambda x, a: F.silu(x))


@register_op("prelu", diff_inputs=["X", "Alpha"])
def _prelu(ctx, ins, attrs):
    """x where x >= 0, else alpha * x. Alpha broadcasts against x: [1]
    (mode ``all``), [C] or [1, C, 1, 1] (``channel``; a [C] alpha is
    laid along axis 1), x's shape but the batch (``element``)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if attrs.get("mode", "all") == "channel" and alpha.ndim == 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    return {"Out": [torch.where(x >= 0, x, alpha * x)]}
