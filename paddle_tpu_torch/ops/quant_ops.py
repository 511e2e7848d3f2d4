"""Quantization-simulation ops and the int8 post-training pair.

The port of paddle_tpu/ops/quant_ops.py (Fluid's fake_quantize_op.cc and
fake_dequantize_op.cc). The ``fake_*`` ops simulate int8 inference
during float training: quantize-round-dequantize in the graph, with a
straight-through gradient (identity on X), which the JAX package
registers with ``register_grad_lowering`` and the port ports explicitly
(ROADMAP's mechanical-gradients rule).
``quantize_channel_abs_max`` / ``dequantize_channel_abs_max`` carry REAL
int8 storage: they are what ``core/passes/quantize_pass.py``
(``PADDLE_TPU_OPTIMIZE_QUANT=1``) inserts before each eligible weight's
consumers, with per-channel scales baked as an ``assign_value``.

``torch.round`` rounds half to even, as ``jnp.round`` does, so both
packages land on the same grid.
"""

from __future__ import annotations

import torch

from ..core.registry import register_grad_lowering, register_op


def _qrange(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def _quant_dequant(x, scale, qmax):
    scale = torch.clamp(scale, min=1e-8)
    y = torch.clamp(torch.round(x / scale * qmax), -qmax, qmax)
    return y * scale / qmax


def _abs_max(x):
    return torch.amax(torch.abs(x))


@register_op("fake_quantize_abs_max", diff_inputs=["X"])
def _fake_quantize_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    qmax = _qrange(int(attrs.get("bit_length", 8)))
    if attrs.get("is_test", False) and ins.get("InScale") \
            and ins["InScale"][0] is not None:
        # frozen inference: use the collected scale, don't recompute
        scale = ins["InScale"][0].reshape(())
    else:
        scale = _abs_max(x)
    return {"Out": [_quant_dequant(x, scale, qmax)],
            "OutScale": [scale.reshape(1)]}


def _straight_through(ins, *absent):
    """dX = dOut (zeros where no output grad arrives); the other inputs
    take no grad."""
    g = (ins.get("Out@GRAD") or [None])[0]
    x = ins["X"][0]
    if g is None:
        g = torch.zeros_like(x)
    out = {"X@GRAD": [g]}
    for slot in absent:
        out[slot + "@GRAD"] = [None]
    return out


@register_grad_lowering("fake_quantize_abs_max")
def _fq_abs_max_grad(ctx, ins, attrs):
    # straight-through estimator: dX = dOut
    return _straight_through(ins)


@register_op("fake_quantize_moving_average_abs_max", diff_inputs=["X"])
def _fake_quantize_ma_abs_max(ctx, ins, attrs):
    """Activation quantization with a debiased moving-average scale
    (fake_quantize_op.cc MovingAverageAbsMax: accum' = rate*accum + cur,
    state' = rate*state + 1, scale = accum'/state')."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0]
    qmax = _qrange(int(attrs.get("bit_length", 8)))
    rate = float(attrs.get("moving_rate", 0.9))
    cur = _abs_max(x)
    if attrs.get("is_test", False):
        scale = in_scale.reshape(())
        return {"Out": [_quant_dequant(x, scale, qmax)],
                "OutScale": [in_scale.reshape(1)]}
    accum = ins["InAccum"][0] if ins.get("InAccum") else in_scale
    state = ins["InState"][0] if ins.get("InState") else None
    if state is not None:
        new_accum = rate * accum.reshape(()) + cur
        new_state = rate * state.reshape(()) + 1.0
        scale = new_accum / new_state
        return {"Out": [_quant_dequant(x, scale, qmax)],
                "OutScale": [scale.reshape(1)],
                "OutAccum": [new_accum.reshape(1)],
                "OutState": [new_state.reshape(1)]}
    scale = rate * in_scale.reshape(()) + (1.0 - rate) * cur
    return {"Out": [_quant_dequant(x, scale, qmax)],
            "OutScale": [scale.reshape(1)]}


@register_grad_lowering("fake_quantize_moving_average_abs_max")
def _fq_ma_grad(ctx, ins, attrs):
    return _straight_through(ins, "InScale", "InAccum", "InState")


@register_op("fake_quantize_range_abs_max", diff_inputs=["X"])
def _fake_quantize_range_abs_max(ctx, ins, attrs):
    """Window-max variant (fake_quantize_op.cc RangeAbsMax): scale = max
    of current and running scale (simplified window)."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0]
    qmax = _qrange(int(attrs.get("bit_length", 8)))
    cur = _abs_max(x)
    if attrs.get("is_test", False):
        scale = in_scale.reshape(())
    else:
        scale = torch.maximum(in_scale.reshape(()), cur)
    return {"Out": [_quant_dequant(x, scale, qmax)],
            "OutScale": [scale.reshape(1)]}


@register_grad_lowering("fake_quantize_range_abs_max")
def _fq_range_grad(ctx, ins, attrs):
    return _straight_through(ins, "InScale")


@register_op("fake_dequantize_max_abs", diff_inputs=["X"])
def _fake_dequantize_max_abs(ctx, ins, attrs):
    x = ins["X"][0]
    scale = ins["Scale"][0]
    max_range = float(attrs.get("max_range", 127.0))
    return {"Out": [x * scale.reshape(()) / max_range]}


# --------------------------------------------------------- real int8 PTQ
# Unlike the fake_quantize family above (quantize-round-dequantize in
# float storage), these two ops carry REAL int8 storage through the
# program: what the quantize pass (core/passes/quantize_pass.py)
# inserts. Scales are per-channel and provided as an input (the pass
# bakes them as an assign_value literal derived from the range
# analysis), so the translation validator can check the baked values
# against the scope weights.


def _channel_shape(x, axis: int):
    bshape = [1] * x.dim()
    bshape[axis] = -1
    return bshape


@register_op("quantize_channel_abs_max", no_grad=True)
def _quantize_channel_abs_max(ctx, ins, attrs):
    """Symmetric per-channel int8 quantization with provided scales:
    Out[int8] = clip(round(X / scale * qmax), -qmax, qmax)."""
    x = ins["X"][0]
    scale = ins["InScale"][0]
    axis = int(attrs.get("axis", 0))
    qmax = _qrange(int(attrs.get("bit_length", 8)))
    s = torch.clamp(scale.reshape(_channel_shape(x, axis)), min=1e-8)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    return {"Out": [q.to(torch.int8)]}


@register_op("dequantize_channel_abs_max", no_grad=True)
def _dequantize_channel_abs_max(ctx, ins, attrs):
    """Per-channel dequantize: Out[f32] = X * scale / qmax (the exact
    inverse of quantize_channel_abs_max's grid)."""
    x = ins["X"][0]
    scale = ins["Scales"][0]
    axis = int(attrs.get("axis", 0))
    qmax = _qrange(int(attrs.get("bit_length", 8)))
    s = scale.reshape(_channel_shape(x, axis)).to(torch.float32)
    return {"Out": [x.to(torch.float32) * s / qmax]}
