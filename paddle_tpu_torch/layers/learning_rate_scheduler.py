"""LR schedules as in-graph ops (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py). Each returns an lr
Variable recomputed from a persistable step counter every step, inside the
same XLA computation as the optimizer update."""

from __future__ import annotations

import functools
import math

from ..core.program import default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper
from .nn import elementwise_div, elementwise_max, elementwise_min, scale
from .ops import sqrt
from .tensor import cast, fill_constant

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "cosine_decay",
    "linear_lr_warmup",
    "append_LARS",
]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _optimize_role(fn):
    """LR-schedule ops carry the optimize role: under gradient accumulation
    the schedule (and its step counter) must advance once per applied step,
    not once per microbatch (core/executor._accum_step)."""

    @functools.wraps(fn)
    def wrap(*args, **kwargs):
        with default_main_program().op_role_guard("optimize"):
            return fn(*args, **kwargs)

    return wrap


def _decay_step_counter(begin=0):
    helper = LayerHelper("global_step_counter")
    counter = helper.create_global_variable(
        name=_COUNTER_NAME, shape=[1], dtype="float32",
        initializer=Constant(float(begin)),
    )
    helper.block.append_op(
        type="increment", inputs={"X": [counter]}, outputs={"Out": [counter]},
        attrs={"step": 1.0},
    )
    return counter


@_optimize_role
def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _decay_step_counter(1)
    helper = LayerHelper("noam_decay")
    lr = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    a = scale(_rpow(step, -0.5), learning_rate * d_model ** -0.5)
    b = scale(step, learning_rate * d_model ** -0.5 * warmup_steps ** -1.5)
    helper.append_op(type="elementwise_min", inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [lr]}, attrs={"axis": -1})
    lr.shape = (1,)
    return lr


def _rpow(var, p):
    helper = LayerHelper("pow")
    out = helper.create_variable_for_type_inference(var.dtype, stop_gradient=True)
    helper.append_op(type="pow", inputs={"X": [var]}, outputs={"Out": [out]},
                     attrs={"factor": p})
    out.shape = var.shape
    return out


@_optimize_role
def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = scale(step, 1.0 / decay_steps)
    if staircase:
        helper = LayerHelper("floor")
        f = helper.create_variable_for_type_inference("float32", stop_gradient=True)
        helper.append_op(type="floor", inputs={"X": [div]}, outputs={"Out": [f]})
        f.shape = div.shape
        div = f
    return scale(_exp_of(scale(div, math.log(decay_rate))), learning_rate)


def _exp_of(v):
    helper = LayerHelper("exp")
    out = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    helper.append_op(type="exp", inputs={"X": [v]}, outputs={"Out": [out]})
    out.shape = v.shape
    return out


@_optimize_role
def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    return exponential_decay(learning_rate, decay_steps, math.exp(-decay_rate), staircase)


@_optimize_role
def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _decay_step_counter()
    div = scale(step, 1.0 / decay_steps)
    denom = scale(div, decay_rate, 1.0)
    helper = LayerHelper("reciprocal")
    out = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    helper.append_op(type="reciprocal", inputs={"X": [denom]}, outputs={"Out": [out]})
    out.shape = denom.shape
    return scale(out, learning_rate)


@_optimize_role
def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4, power=1.0,
                     cycle=False):
    step = _decay_step_counter()
    capped = elementwise_min(step, fill_constant([1], "float32", float(decay_steps)))
    frac = scale(capped, 1.0 / decay_steps)
    one_minus = scale(frac, -1.0, 1.0)
    poly = _rpow(one_minus, power)
    return scale(poly, learning_rate - end_learning_rate, end_learning_rate)


@_optimize_role
def piecewise_decay(boundaries, values):
    """Step-function schedule via nested where ops."""
    from .nn import less_than, where

    step = _decay_step_counter()
    lr = fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = less_than(step, fill_constant([1], "float32", float(b)))
        lr = where(cond, fill_constant([1], "float32", v), lr)
    return lr


@_optimize_role
def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _decay_step_counter()
    frac = scale(step, 1.0 / (step_each_epoch * epochs))
    helper = LayerHelper("cos")
    c = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    arg = scale(frac, math.pi)
    helper.append_op(type="cos", inputs={"X": [arg]}, outputs={"Out": [c]})
    c.shape = arg.shape
    return scale(scale(c, 0.5, 0.5), learning_rate)


@_optimize_role
def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from .nn import less_than, where

    step = _decay_step_counter()
    warm = scale(step, (end_lr - start_lr) / warmup_steps, start_lr)
    if not hasattr(learning_rate, "name"):
        learning_rate = fill_constant([1], "float32", float(learning_rate))
    cond = less_than(step, fill_constant([1], "float32", float(warmup_steps)))
    return where(cond, warm, learning_rate)


def append_LARS(params_grads, learning_rate, weight_decay):
    """reference learning_rate_scheduler.py append_LARS: per-parameter
    local learning rate  lr * ||w|| / (||g|| + wd * ||w||)."""
    from . import nn as _nn
    from .tensor import fill_constant

    def _norm(v):
        return _nn.sqrt(_nn.reduce_sum(_nn.square(v)))

    decayed = []
    for param, grad in params_grads:
        w_norm = _norm(param)
        g_norm = _norm(grad)
        local = learning_rate * w_norm / (
            g_norm + weight_decay * w_norm)
        decayed.append(local)
    return decayed
