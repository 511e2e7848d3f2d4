"""Weight-decay regularizers (reference: python/paddle/fluid/regularizer.py).
Applied by appending grad-adjustment ops before the optimizer op."""

from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype, stop_gradient=True)
        block.append_op("scale", {"X": [param]}, {"Out": [decay]},
                        {"scale": self._coeff, "__op_role__": "optimize"})
        out = helper.create_variable_for_type_inference(param.dtype, stop_gradient=True)
        block.append_op("sum", {"X": [grad, decay]}, {"Out": [out]},
                        {"__op_role__": "optimize"})
        return out


class L1Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype, stop_gradient=True)
        block.append_op("sign", {"X": [param]}, {"Out": [sign]},
                        {"__op_role__": "optimize"})
        decay = helper.create_variable_for_type_inference(param.dtype, stop_gradient=True)
        block.append_op("scale", {"X": [sign]}, {"Out": [decay]},
                        {"scale": self._coeff, "__op_role__": "optimize"})
        out = helper.create_variable_for_type_inference(param.dtype, stop_gradient=True)
        block.append_op("sum", {"X": [grad, decay]}, {"Out": [out]},
                        {"__op_role__": "optimize"})
        return out


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None or g is None:
            out.append((p, g))
            continue
        block = p.block
        out.append((p, block.var(reg(p, g, block).name)))
    return out
