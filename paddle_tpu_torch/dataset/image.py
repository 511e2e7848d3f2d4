"""Image transform utilities (reference: python/paddle/dataset/image.py).

The reference wraps cv2; the package does not depend on cv2, so the same API is
implemented in pure numpy (bilinear resize, crops, flip, HWC<->CHW,
simple_transform). Images are HWC uint8/float arrays like the
reference's cv2 output.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform",
]


def _bilinear_resize(im, out_h, out_w):
    h, w = im.shape[:2]
    if (h, w) == (out_h, out_w):
        return im.copy()
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    dy = np.clip(ys - y0, 0, 1)[:, None]
    dx = np.clip(xs - x0, 0, 1)[None, :]
    if im.ndim == 3:
        dy = dy[..., None]
        dx = dx[..., None]
    f = im.astype(np.float32)
    out = (f[y0][:, x0] * (1 - dy) * (1 - dx)
           + f[y0][:, x1] * (1 - dy) * dx
           + f[y1][:, x0] * dy * (1 - dx)
           + f[y1][:, x1] * dy * dx)
    return out.astype(im.dtype) if np.issubdtype(im.dtype, np.integer) \
        else out


def resize_short(im, size):
    """Scale so the SHORT side equals `size` (reference image.py:197)."""
    h, w = im.shape[:2]
    if h < w:
        return _bilinear_resize(im, size, int(round(w * size / h)))
    return _bilinear_resize(im, int(round(h * size / w)), size)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference image.py:225)."""
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = (h - size) // 2
    w0 = (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    h0 = int(rng.randint(0, h - size + 1))
    w0 = int(rng.randint(0, w - size + 1))
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None, rng=None):
    """resize_short -> crop(+flip when training) -> CHW float32 -> -mean
    (reference image.py:327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        rng2 = rng or np.random
        if rng2.randint(2) == 1:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    im = to_chw(np.ascontiguousarray(im)).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean if mean.ndim >= 3 else mean[:, None, None]
    return im
