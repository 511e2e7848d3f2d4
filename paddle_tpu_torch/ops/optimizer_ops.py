"""Optimizer update ops: ``adam`` (with AdamW's decoupled weight decay),
``sgd`` and ``momentum``.

Counterparts of paddle_tpu/ops/optimizer_ops.py, with the same formulas.
Each update is written functionally: it returns new tensors for the
param and its accumulators and updates nothing in place, so the scope's
tensors stay valid until the executor writes the new ones back (a scope
snapshot taken before a step is still the state before it). The other
optimizer ops of the JAX package (adamax, adagrad, decayed_adagrad,
adadelta, rmsprop, ftrl, lamb, lars_momentum, average_accumulates) are
not ported yet: a Program that uses one builds, and running it raises
"no registered lowering".
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _p(ins, slot):
    v = ins.get(slot)
    return v[0] if v else None


def _scalar(t, like):
    return t.reshape(()).to(like.dtype)


@register_op("sgd", no_grad=True)
def _sgd(ctx, ins, attrs):
    p, g, lr = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "LearningRate")
    return {"ParamOut": [p - _scalar(lr, p) * g]}


@register_op("momentum", no_grad=True)
def _momentum(ctx, ins, attrs):
    p, g, v = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity")
    lr = _scalar(_p(ins, "LearningRate"), p)
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("adam", no_grad=True)
def _adam(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p, b2p = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    lr = _scalar(_p(ins, "LearningRate"), p)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    b1p_ = _scalar(b1p, p)
    b2p_ = _scalar(b2p, p)
    lr_t = lr * torch.sqrt(1 - b2p_ * b2) / (1 - b1p_ * b1)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    # AdamW decoupled weight decay (optimizer.AdamW): scaled by the
    # schedule lr (not the bias-corrected lr_t), applied outside the
    # moment math, never through the gradients
    wd = attrs.get("weight_decay", 0.0)
    if wd:
        p_new = p_new - lr * wd * p
    return {
        "ParamOut": [p_new],
        "Moment1Out": [m_new],
        "Moment2Out": [v_new],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }
