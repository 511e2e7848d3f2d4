"""The image-resize and per-channel affine ops that layers/loss.py
builds: ``bilinear_interp``, ``nearest_interp`` and ``affine_channel``.

Counterparts of three of paddle_tpu/ops/detection_ops.py's ops (the
detection ops themselves are not ported yet). The interpolations use
the JAX package's own source-index formulas, NCHW: ``align_corners``
(default True) maps the corners onto each other, dst * (src - 1) /
(dst - 1) per axis (an axis of one output keeps the other formula);
without it bilinear takes max((dst + 0.5) * src / dst - 0.5, 0), and
nearest rounds half to even with align, floors dst * src / dst
without. ``F.interpolate`` rounds and clamps otherwise, so it is not
used. ``_interp_sizes`` is the JAX package's, unchanged
(tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _interp_sizes(x, attrs):
    out_h = int(attrs.get("out_h", 0))
    out_w = int(attrs.get("out_w", 0))
    scale = attrs.get("scale", 0)
    if (out_h <= 0 or out_w <= 0) and scale:
        out_h = int(x.shape[2] * scale)
        out_w = int(x.shape[3] * scale)
    return out_h, out_w


@register_op("bilinear_interp", diff_inputs=["X"])
def _bilinear_interp(ctx, ins, attrs):
    x = ins["X"][0]
    out_h, out_w = _interp_sizes(x, attrs)
    align = bool(attrs.get("align_corners", True))
    H, W = x.shape[2], x.shape[3]

    def src_idx(src_len, dst_len):
        dst = torch.arange(dst_len, dtype=x.dtype, device=x.device)
        if align and dst_len > 1:
            return dst * (src_len - 1) / (dst_len - 1)
        return torch.clamp((dst + 0.5) * (src_len / dst_len) - 0.5, min=0)

    hy, wx = src_idx(H, out_h), src_idx(W, out_w)
    h0 = torch.floor(hy).to(torch.int64).clamp(0, H - 1)
    w0 = torch.floor(wx).to(torch.int64).clamp(0, W - 1)
    h1 = torch.clamp(h0 + 1, max=H - 1)
    w1 = torch.clamp(w0 + 1, max=W - 1)
    dh = (hy - h0.to(x.dtype))[None, None, :, None]
    dw = (wx - w0.to(x.dtype))[None, None, None, :]
    rows0, rows1 = x[:, :, h0], x[:, :, h1]
    out = (rows0[:, :, :, w0] * (1 - dh) * (1 - dw)
           + rows0[:, :, :, w1] * (1 - dh) * dw
           + rows1[:, :, :, w0] * dh * (1 - dw)
           + rows1[:, :, :, w1] * dh * dw)
    return {"Out": [out]}


@register_op("nearest_interp", diff_inputs=["X"])
def _nearest_interp(ctx, ins, attrs):
    x = ins["X"][0]
    out_h, out_w = _interp_sizes(x, attrs)
    align = bool(attrs.get("align_corners", True))

    def idx(src_len, dst_len):
        dst = torch.arange(dst_len, device=x.device)
        if align and dst_len > 1:  # per axis, as in the JAX package
            return torch.round(dst * (src_len - 1) / (dst_len - 1)).to(
                torch.int64)
        return torch.floor(dst * src_len / dst_len).to(torch.int64)

    hs, ws = idx(x.shape[2], out_h), idx(x.shape[3], out_w)
    return {"Out": [x[:, :, hs][:, :, :, ws]]}


@register_op("affine_channel", diff_inputs=["X", "Scale", "Bias"])
def _affine_channel(ctx, ins, attrs):
    """Per-channel x * scale + bias (NCHW)."""
    x = ins["X"][0]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return {"Out": [x * ins["Scale"][0].reshape(shape)
                    + ins["Bias"][0].reshape(shape)]}
