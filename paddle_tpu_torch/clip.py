"""Gradient clipping (reference: python/paddle/fluid/clip.py —
ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip)."""

from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "ErrorClipByValue",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]

_global_clip = None


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            helper = LayerHelper("clip_grad")
            c = helper.create_variable_for_type_inference(g.dtype, stop_gradient=True)
            p.block.append_op("clip", {"X": [g]}, {"Out": [c]},
                              {"min": self.min, "max": self.max,
                               "__op_role__": "optimize"})
            out.append((p, c))
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            helper = LayerHelper("clip_grad_norm")
            c = helper.create_variable_for_type_inference(g.dtype, stop_gradient=True)
            p.block.append_op("clip_by_norm", {"X": [g]}, {"Out": [c]},
                              {"max_norm": self.clip_norm,
                               "__op_role__": "optimize"})
            out.append((p, c))
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        from .layers import elementwise_div, elementwise_max, elementwise_mul
        from .layers.ops import sqrt
        from .layers.tensor import fill_constant, sums

        live = [(p, g) for p, g in params_grads if g is not None]
        if not live:
            return params_grads
        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for _, g in live:
            sq = helper.create_variable_for_type_inference(g.dtype, stop_gradient=True)
            g.block.append_op("squared_l2_norm", {"X": [g]}, {"Out": [sq]},
                              {"__op_role__": "optimize"})
            sq.shape = ()
            sq_norms.append(sq)
        total = sums(sq_norms)
        global_norm = sqrt(total)
        clip_var = fill_constant([], "float32", self.clip_norm)
        denom = elementwise_max(global_norm, clip_var)
        ratio = elementwise_div(clip_var, denom)
        out = []
        it = iter(live)
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            next(it)
            c = helper.create_variable_for_type_inference(g.dtype, stop_gradient=True)
            p.block.append_op("elementwise_mul", {"X": [g], "Y": [ratio]},
                              {"Out": [c]}, {"axis": -1, "__op_role__": "optimize"})
            out.append((p, c))
        return out


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    # per-param attr wins; else the global clip
    if _global_clip is not None:
        return _global_clip._process(params_grads)
    clip_groups = {}
    plain = []
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None)
        if attr is None:
            plain.append((p, g))
        else:
            clip_groups.setdefault(id(attr), (attr, []))[1].append((p, g))
    out = list(plain)
    for attr, group in clip_groups.values():
        out.extend(attr._process(group))
    return out
