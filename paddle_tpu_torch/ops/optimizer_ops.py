"""Optimizer update ops: ``sgd``, ``momentum``, ``lars_momentum``,
``adam`` (with AdamW's decoupled weight decay), ``adamax``, ``adagrad``,
``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``, ``lamb`` and
ModelAverage's ``average_accumulates``.

Counterparts of paddle_tpu/ops/optimizer_ops.py, with the same formulas,
slots and attrs, and the same departures from Fluid (``lamb`` is not in
Fluid at all; ``average_accumulates`` rolls its sums after the add).
Each update is written functionally: it returns new tensors for the
param and its accumulators and updates nothing in place, so the scope's
tensors stay valid until the executor writes the new ones back (a scope
snapshot taken before a step is still the state before it). No update
reads a value back to the host: the norms of ``lars_momentum`` and
``lamb`` and the counters of ``average_accumulates`` stay on the device,
so each runs inside a captured step.
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


@register_op("lars_momentum", no_grad=True)
def _lars_momentum(ctx, ins, attrs):
    """Layer-wise adaptive rate scaling (lars_momentum_op.cc)."""
    p, g, v = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Velocity")
    lr = _scalar(_p(ins, "LearningRate"), p)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 1e-3)
    decay = attrs.get("lars_weight_decay", 5e-4)
    eps = 1e-9
    p_norm = torch.sqrt(torch.sum(p * p))
    g_norm = torch.sqrt(torch.sum(g * g))
    local_lr = lr * coeff * p_norm / (eps + g_norm + decay * p_norm)
    v_new = mu * v + local_lr * (g + decay * p)
    return {"ParamOut": [p - v_new], "VelocityOut": [v_new]}


@register_op("adamax", no_grad=True)
def _adamax(ctx, ins, attrs):
    """Writes no Beta1PowOut: the ``Adamax`` optimizer advances the
    power with a ``scale`` op of its own, as the JAX package does."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m, inf = _p(ins, "Moment"), _p(ins, "InfNorm")
    b1p = _scalar(_p(ins, "Beta1Pow"), p)
    lr = _scalar(_p(ins, "LearningRate"), p)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    p_new = p - (lr / (1 - b1p)) * (m_new / (inf_new + eps))
    return {"ParamOut": [p_new], "MomentOut": [m_new], "InfNormOut": [inf_new]}


@register_op("adagrad", no_grad=True)
def _adagrad(ctx, ins, attrs):
    p, g, mom = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Moment")
    lr = _scalar(_p(ins, "LearningRate"), p)
    eps = attrs.get("epsilon", 1e-6)
    mom_new = mom + g * g
    p_new = p - lr * g / (torch.sqrt(mom_new) + eps)
    return {"ParamOut": [p_new], "MomentOut": [mom_new]}


@register_op("decayed_adagrad", no_grad=True)
def _decayed_adagrad(ctx, ins, attrs):
    p, g, mom = _p(ins, "Param"), _p(ins, "Grad"), _p(ins, "Moment")
    lr = _scalar(_p(ins, "LearningRate"), p)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_new = decay * mom + (1 - decay) * g * g
    return {"ParamOut": [p - lr * g / (torch.sqrt(mom_new) + eps)],
            "MomentOut": [mom_new]}


@register_op("adadelta", no_grad=True)
def _adadelta(ctx, ins, attrs):
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    avg_sq, avg_upd = _p(ins, "AvgSquaredGrad"), _p(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    avg_sq_new = rho * avg_sq + (1 - rho) * g * g
    upd = -torch.sqrt((avg_upd + eps) / (avg_sq_new + eps)) * g
    avg_upd_new = rho * avg_upd + (1 - rho) * upd * upd
    return {
        "ParamOut": [p + upd],
        "AvgSquaredGradOut": [avg_sq_new],
        "AvgSquaredUpdateOut": [avg_upd_new],
    }


@register_op("rmsprop", no_grad=True)
def _rmsprop(ctx, ins, attrs):
    """``centered`` keeps a mean of the grads too; not centered, a given
    MeanGrad passes through to MeanGradOut unchanged."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    ms, mom = _p(ins, "MeanSquare"), _p(ins, "Moment")
    mg = _p(ins, "MeanGrad")
    lr = _scalar(_p(ins, "LearningRate"), p)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    outs = {}
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g
        mom_new = mu * mom + lr * g / torch.sqrt(ms_new - mg_new * mg_new
                                                 + eps)
        outs["MeanGradOut"] = [mg_new]
    else:
        mom_new = mu * mom + lr * g / torch.sqrt(ms_new + eps)
        if mg is not None:
            outs["MeanGradOut"] = [mg]
    outs.update({"ParamOut": [p - mom_new], "MeanSquareOut": [ms_new],
                 "MomentOut": [mom_new]})
    return outs


@register_op("ftrl", no_grad=True)
def _ftrl(ctx, ins, attrs):
    """Where |LinearAccum| <= l1 the param is zero, chosen by a select
    (``jnp.where``'s), never by dividing a zero."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    sq, lin = _p(ins, "SquaredAccumulator"), _p(ins, "LinearAccumulator")
    lr = _scalar(_p(ins, "LearningRate"), p)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    new_lin = lin + g - sigma * p
    if power == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        denom = torch.pow(new_sq, -power) / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p_new = torch.where(torch.abs(new_lin) > l1, pre / denom,
                        torch.zeros_like(p))
    return {
        "ParamOut": [p_new],
        "SquaredAccumOut": [new_sq],
        "LinearAccumOut": [new_lin],
    }


@register_op("lamb", no_grad=True)
def _lamb(ctx, ins, attrs):
    """LAMB (You et al., 2020; not in Fluid: the JAX package's extension
    for BERT). The bias correction takes the incoming powers times the
    betas, and the trust ratio ``|p| / |r|`` falls back to 1 where
    either norm is zero, by a select on the device (no host sync)."""
    p, g = _p(ins, "Param"), _p(ins, "Grad")
    m, v = _p(ins, "Moment1"), _p(ins, "Moment2")
    b1p, b2p = _p(ins, "Beta1Pow"), _p(ins, "Beta2Pow")
    lr = _scalar(_p(ins, "LearningRate"), p)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    mhat = m_new / (1 - _scalar(b1p, p) * b1)
    vhat = v_new / (1 - _scalar(b2p, p) * b2)
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(p * p))
    r_norm = torch.sqrt(torch.sum(r * r))
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    return {
        "ParamOut": [p - lr * ratio * r],
        "Moment1Out": [m_new],
        "Moment2Out": [v_new],
        "Beta1PowOut": [b1p * b1],
        "Beta2PowOut": [b2p * b2],
    }


@register_op("average_accumulates", no_grad=True)
def _average_accumulates(ctx, ins, attrs):
    """ModelAverage's accumulator update (average_accumulates_op.h): per
    step sum_1 += param; every 16384 updates sum_1 rolls into sum_2 (a
    precision guard); when the accumulate count reaches
    min(max_average_window, num_updates * average_window), truncated,
    and at least min_average_window, the sums roll into sum_3 and the
    count restarts.

    The JAX package's deliberate divergence from Fluid is kept: the
    rolls use the post-add sums, so the current step's param is never
    dropped. The counters are int tensors of shape [1] (int32 on the
    device, as every int64 var); every branch is a select, so the update
    runs inside a captured step."""
    p = ins["param"][0].to(torch.float32)
    s1 = ins["in_sum_1"][0]
    s2 = ins["in_sum_2"][0]
    s3 = ins["in_sum_3"][0]
    na = ins["in_num_accumulates"][0]
    ona = ins["in_old_num_accumulates"][0]
    nu = ins["in_num_updates"][0]
    rate = float(attrs.get("average_window", 0.0))
    max_w = int(attrs.get("max_average_window", 10000))
    min_w = int(attrs.get("min_average_window", 10000))
    k_max = 16384

    nu = nu + 1
    na = na + 1
    s1 = s1 + p
    roll = (nu % k_max) == 0
    s2 = torch.where(roll, s2 + s1, s2)
    s1 = torch.where(roll, torch.zeros_like(s1), s1)
    window = torch.minimum(torch.full_like(nu, max_w),
                           (nu.to(torch.float32) * rate).to(nu.dtype))
    trigger = (na >= min_w) & (na >= window)
    s3 = torch.where(trigger, s1 + s2, s3)
    s1 = torch.where(trigger, torch.zeros_like(s1), s1)
    s2 = torch.where(trigger, torch.zeros_like(s2), s2)
    ona = torch.where(trigger, na, ona)
    na = torch.where(trigger, torch.zeros_like(na), na)
    return {"out_sum_1": [s1], "out_sum_2": [s2], "out_sum_3": [s3],
            "out_num_accumulates": [na], "out_old_num_accumulates": [ona],
            "out_num_updates": [nu]}
