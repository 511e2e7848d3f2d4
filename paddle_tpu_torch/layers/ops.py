"""Autogenerated-style activation / unary layer wrappers.

A copy of paddle_tpu/layers/ops.py: one layer per unary op type, each
appending its op to the current Program.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softplus",
    "softsign", "relu", "gelu", "sqrt", "rsqrt", "abs", "ceil", "floor",
    "cos", "sin", "round", "reciprocal", "square", "log", "relu6",
    "hard_sigmoid", "swish", "silu", "mish", "hard_swish", "stanh",
    "hard_shrink", "thresholded_relu", "brelu", "soft_relu", "leaky_relu",
    "elu",
]

__all__ = list(_UNARY) + ["pow"]


def _make(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        # layer kwargs like alpha/threshold pass straight through as attrs
        helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                         attrs=attrs)
        out.shape = x.shape
        return out

    layer.__name__ = op_type
    return layer


for _name in _UNARY:
    globals()[_name] = _make(_name)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    out.shape = x.shape
    return out
