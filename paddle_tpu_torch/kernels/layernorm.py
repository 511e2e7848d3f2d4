"""Fused layernorm+residual: the transformer's per-layer hot path.

The port of paddle_tpu/kernels/layernorm.py. Every pre-norm block ends
``x = x + h`` and the next block normalizes that sum; the fused kernel
reads x and h once and emits the new residual stream ``s = x + h``, its
layer norm and the per-row f32 mean and variance the program's backward
ops read.

Two hand-written Hopper kernels (``csrc/layernorm_residual.cu``), each
replacing a Pallas TPU kernel of the JAX package:

- ``layernorm_residual_fwd`` (K4) replaces ``_fwd_kernel`` /
  ``_forward_pallas``: one warp per row, the row in registers, a two-pass
  f32 mean and variance by warp shuffles; f32 or bf16 rows. Bound by
  bytes: 50.36 MB at [4096, 768] f32, 0.0150 ms at 3.35 TB/s.
  ``layernorm_residual_fwd_amp`` is its AMP instantiation, the function
  a bf16-AMP Program computes where the JAX package replays a bf16
  ``elementwise_add`` and an f32 ``layer_norm``: x and r each f32 or
  bf16, rounded to bf16 in registers, s = their sum rounded once to
  bf16, the statistics and y in f32 from that s with f32 scale and
  bias. 31.5 MB at [4096, 768] with bf16 x and r, 0.0094 ms.
- ``layernorm_residual_bwd`` (K5) replaces ``_bwd_kernel`` /
  ``_backward_pallas``: dx per row, and dscale / dbias from per-CTA
  partial rows added in a second pass in a fixed order (the TPU kernel
  adds into one revisited block along its sequential grid), so a
  backward is bitwise repeatable. About 50.4 MB, 0.0150 ms. A
  persistent grid of CTAs of 8 warps (as many per SM as stay resident,
  2 to 4), each CTA a contiguous block of rows; a row in registers as
  groups of 4 contiguous columns (16-byte loads at f32, 8-byte at
  bf16), one warp per row up to D = 1024, the whole CTA per row up to
  8192, a streaming kernel that reads each row twice above;
  per-row-group dscale / dbias sums in shared memory.

On CPU tensors each wrapper computes its plain version
(``composed_layernorm_residual``, ``layernorm_residual_bwd_reference``);
on CUDA tensors it launches its kernel or raises. Each counts its
launches in ``<wrapper>.launches``. K4 and its AMP instantiation are one
operator, ``paddle_tpu_torch::layernorm_residual_fwd``
(``torch.library.custom_op``, dispatched by device, with a fake
implementation that gives the outputs' shapes and dtypes), so
``torch.export`` records one node per launch where it cannot trace a
``data_ptr``. ``layernorm_residual`` (what the
fused op launches on the card) is differentiable through ``_LnRes``, a
``torch.autograd.Function`` whose backward is K5 plus the mean /
variance cotangent terms, as ``_ln_res_bwd`` in the JAX package. The
forward has one launch configuration for rows of up to 2048 columns (8
rows, one per warp, per CTA) and one for wider rows (one CTA of 256
threads per row); the backward's grid is ``bwd_launch``.

Parity vs the plain versions: forward atol 1e-5 and backward 5e-5 at
float32 (the reduction order inside a row differs), 2e-2 at bfloat16;
the AMP forward's s bitwise and y, mean and var 1e-5.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build
from .common import (ceil_div, check_launch, check_tensor, on_device,
                     sm_count)

__all__ = ["bwd_launch", "composed_layernorm_residual", "layernorm_residual",
           "layernorm_residual_bwd", "layernorm_residual_bwd_reference",
           "layernorm_residual_fwd", "layernorm_residual_fwd_amp"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 2048                  # the widest row a warp holds (forward)
_ROWS = 8                      # forward: rows (warps) per CTA
_WIDE_THREADS = 256            # threads of a CTA for rows wider than _MAX_D


def composed_layernorm_residual(x, r, scale, bias, *, eps=1e-5, amp=False):
    """The plain version of K4: (y, s, mean [N, 1] f32, var [N, 1] f32)
    with the kernel's arithmetic — s = x + r in f32 (stored in x's
    dtype), the two-pass f32 mean and variance of the f32 s, y from the
    f32 s. With ``amp``, the AMP instantiation's: AMP's casts, s = the
    bf16 sum of x and r cast to bf16 (one rounding of their f32 sum),
    then the statistics and y (f32) of the f32 s."""
    if amp:
        s = x.to(torch.bfloat16) + r.to(torch.bfloat16)
        sf = s.float()
    else:
        sf = x.float() + r.float()
    mean = sf.mean(dim=-1, keepdim=True)
    var = ((sf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (sf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float().reshape(1, -1) + bias.float().reshape(1, -1)
    if amp:
        return y, s, mean, var
    return y.to(x.dtype), sf.to(x.dtype), mean, var


def layernorm_residual_bwd_reference(s, mean, var, scale, gy, gres, eps):
    """The plain version of K5: (dx in s's dtype, dscale f32 [D],
    dbias f32 [D]) from the saved s, mean, var [N, 1] and the cotangents
    of y and s."""
    sf = s.float()
    rstd = torch.rsqrt(var + eps)
    xhat = (sf - mean) * rstd
    g = gy.float()
    gyh = g * scale.float().reshape(1, -1)
    mg = gyh.mean(dim=-1, keepdim=True)
    mgx = (gyh * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (gyh - mg - xhat * mgx) + gres.float()
    return dx.to(s.dtype), (g * xhat).sum(dim=0), g.sum(dim=0)


def _lib():
    lib = build.load("layernorm_residual")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.layernorm_residual_fwd.argtypes = [p] * 8 + [i, i, i, f, i, p]
        lib.layernorm_residual_fwd.restype = i
        lib.layernorm_residual_fwd_amp.argtypes = [p] * 8 + [i] * 4 + [
            f, i, p]
        lib.layernorm_residual_fwd_amp.restype = i
        lib.layernorm_residual_bwd.argtypes = [p] * 11 + [i, i, i, f, i, p]
        lib.layernorm_residual_bwd_grid.argtypes = [i, i, i, i, p, p]
        lib.layernorm_residual_bwd_grid.restype = i
        lib.layernorm_residual_bwd.restype = i
        lib._typed = True
    return lib


def _check_rows(what, tensors, vectors):
    """Checks common to both devices: [N, D] rows and [D] vectors of one
    supported dtype, contiguous, on one device."""
    first = tensors[0][1]
    dev, dt = first.device, first.dtype
    for name, t in tensors:
        check_tensor("%s %s" % (what, name), t, _DTYPES, 2, dev)
        if t.dtype != dt or t.shape != first.shape:
            raise ValueError("%s: %s is %s %s, expected %s %s"
                             % (what, name, t.dtype, tuple(t.shape), dt,
                                tuple(first.shape)))
    for name, t in vectors:
        check_tensor("%s %s" % (what, name), t, (dt,), 1, dev)
        if t.shape[0] != first.shape[1]:
            raise ValueError("%s: %s has %d elements, rows have %d"
                             % (what, name, t.shape[0], first.shape[1]))


def _check_kernel_width(what, d):
    if d < 1:
        raise ValueError("%s kernel takes rows of at least 1 column, got %d"
                         % (what, d))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def bwd_launch(lib, n, d, dtype, device):
    """K5's row kernel for [n, d] rows on ``device``, as the library
    lays it out: (CTAs, threads per CTA, dynamic shared memory bytes)."""
    threads, smem = ctypes.c_int(), ctypes.c_int()
    with on_device(device):
        ctas = lib.layernorm_residual_bwd_grid(
            n, d, _DTYPES[dtype], sm_count(device), ctypes.byref(threads),
            ctypes.byref(smem))
    return ctas, threads.value, smem.value


def _fwd_launch(n, d):
    """K4's grid and block for [n, d] rows (either instantiation): one
    warp per row and 8 warps per CTA up to D = 2048, one CTA per row
    above."""
    _check_kernel_width("layernorm_residual_fwd", d)
    if d <= _MAX_D:
        grid, block = (max(1, ceil_div(n, _ROWS)), 1, 1), (32 * _ROWS, 1, 1)
    else:
        grid, block = (max(1, n), 1, 1), (_WIDE_THREADS, 1, 1)
    check_launch("layernorm_residual_fwd", grid, block, 0)
    return grid, block


def _fwd_outputs(x, dtype_y, dtype_s):
    """Empty (y, s, mean [N, 1] f32, var [N, 1] f32) on x's device."""
    n, d = x.shape
    y = torch.empty((n, d), dtype=dtype_y, device=x.device)
    s = torch.empty((n, d), dtype=dtype_s, device=x.device)
    mean = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    return y, s, mean, torch.empty_like(mean)


def _check_amp_rows(what, x, r, scale, bias):
    dev = x.device
    for name, t in (("x", x), ("r", r)):
        check_tensor("%s %s" % (what, name), t, _DTYPES, 2, dev)
    if r.shape != x.shape:
        raise ValueError("%s: r is %s, x is %s" % (what, tuple(r.shape),
                                                  tuple(x.shape)))
    for name, t in (("scale", scale), ("bias", bias)):
        check_tensor("%s %s" % (what, name), t, (torch.float32,), 1, dev)
        if t.shape[0] != x.shape[1]:
            raise ValueError("%s: %s has %d elements, rows have %d"
                             % (what, name, t.shape[0], x.shape[1]))


@torch.library.custom_op("paddle_tpu_torch::layernorm_residual_fwd",
                         mutates_args=())
def _fwd_op(x: torch.Tensor, r: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, eps: float, amp: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """K4 (``amp=False``) or its AMP instantiation as one operator, so
    that ``torch.export`` records a node for it (a fake tensor has no
    ``data_ptr``). Dispatched by device: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if amp:
        _check_amp_rows("layernorm_residual_fwd_amp", x, r, scale, bias)
        return composed_layernorm_residual(x, r, scale, bias, eps=eps,
                                           amp=True)
    _check_rows("layernorm_residual_fwd", [("x", x), ("r", r)],
                [("scale", scale), ("bias", bias)])
    return composed_layernorm_residual(x, r, scale, bias, eps=eps)


@_fwd_op.register_fake
def _fwd_fake(x, r, scale, bias, eps, amp):
    if amp:
        _check_amp_rows("layernorm_residual_fwd_amp", x, r, scale, bias)
        return _fwd_outputs(x, torch.float32, torch.bfloat16)
    _check_rows("layernorm_residual_fwd", [("x", x), ("r", r)],
                [("scale", scale), ("bias", bias)])
    return _fwd_outputs(x, x.dtype, x.dtype)


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(x, r, scale, bias, eps, amp):
    what = ("layernorm_residual_fwd_amp" if amp
            else "layernorm_residual_fwd")
    if amp:
        _check_amp_rows(what, x, r, scale, bias)
        out = _fwd_outputs(x, torch.float32, torch.bfloat16)
    else:
        _check_rows(what, [("x", x), ("r", r)],
                    [("scale", scale), ("bias", bias)])
        out = _fwd_outputs(x, x.dtype, x.dtype)
    n, d = x.shape
    grid, block = _fwd_launch(n, d)
    if n == 0:
        return out
    y, s, mean, var = out
    lib = _lib()
    ptrs = (x.data_ptr(), r.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), s.data_ptr(), mean.data_ptr(), var.data_ptr(), n,
            d)
    with on_device(x.device):
        if amp:
            err = lib.layernorm_residual_fwd_amp(
                *ptrs, _DTYPES[x.dtype], _DTYPES[r.dtype], float(eps),
                _ROWS, _stream(x.device))
        else:
            err = lib.layernorm_residual_fwd(
                *ptrs, _DTYPES[x.dtype], float(eps), _ROWS,
                _stream(x.device))
    if err:
        raise RuntimeError("%s launch failed with cudaError %d (grid %s, "
                           "block %s)" % (what, err, grid, block))
    if amp:
        layernorm_residual_fwd_amp.launches += 1
    else:
        layernorm_residual_fwd.launches += 1
    return out


def layernorm_residual_fwd(x, r, scale, bias, eps=1e-5):
    """K4: (y, s, mean [N, 1] f32, var [N, 1] f32) for rows x, r [N, D]
    (f32 or bf16, contiguous) and scale, bias [D] of the same dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    warp per row and 8 warps per CTA up to D = 2048, one CTA per row
    above) or raise. The operator ``paddle_tpu_torch::
    layernorm_residual_fwd``."""
    return _fwd_op(x, r, scale, bias, float(eps), False)


layernorm_residual_fwd.launches = 0


def layernorm_residual_fwd_amp(x, r, scale, bias, eps=1e-5):
    """K4's AMP instantiation: (y f32, s bf16, mean [N, 1] f32, var
    [N, 1] f32) for rows x, r [N, D] (each f32 or bf16, contiguous) and
    scale, bias [D] f32: s = bf16(bf16(x) + bf16(r)), y the f32 layer
    norm of s. CPU tensors take the plain version
    (``composed_layernorm_residual(..., amp=True)``); CUDA tensors launch
    the kernel, with K4's launch configuration, or raise. The operator
    ``paddle_tpu_torch::layernorm_residual_fwd`` with ``amp``."""
    return _fwd_op(x, r, scale, bias, float(eps), True)


layernorm_residual_fwd_amp.launches = 0


def layernorm_residual_bwd(s, mean, var, scale, gy, gres, eps=1e-5):
    """K5: (dx in s's dtype, dscale f32 [D], dbias f32 [D]) from the
    saved rows s [N, D], mean and var [N, 1] f32, scale [D] and the
    cotangents gy (of y) and gres (of s), all [N, D] in s's dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel (dx
    and per-CTA partial sums over a persistent grid, ``bwd_launch``,
    then a fixed-order column reduction) or raise."""
    what = "layernorm_residual_bwd"
    _check_rows(what, [("s", s), ("gy", gy), ("gres", gres)],
                [("scale", scale)])
    n, d = s.shape
    for name, t in (("mean", mean), ("var", var)):
        check_tensor("%s %s" % (what, name), t, (torch.float32,), 2,
                     s.device)
        if tuple(t.shape) != (n, 1):
            raise ValueError("%s: %s has shape %s, expected %s"
                             % (what, name, tuple(t.shape), (n, 1)))
    if s.device.type == "cpu":
        return layernorm_residual_bwd_reference(s, mean, var, scale, gy,
                                                gres, eps)
    _check_kernel_width(what, d)
    lib = _lib()
    ctas, threads, smem = bwd_launch(lib, max(n, 1), d, s.dtype, s.device)
    grid, block = (ctas, 1, 1), (threads, 1, 1)
    check_launch(what, grid, block, smem)
    dx = torch.empty_like(s)
    part = torch.empty((2, ctas, d), dtype=torch.float32, device=s.device)
    dscale = torch.empty(d, dtype=torch.float32, device=s.device)
    dbias = torch.empty_like(dscale)
    if n == 0:
        return dx, dscale.zero_(), dbias.zero_()
    with on_device(s.device):
        err = lib.layernorm_residual_bwd(
            s.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
            gy.data_ptr(), gres.data_ptr(), dx.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), n, d, _DTYPES[s.dtype], float(eps), ctas,
            _stream(s.device))
    if err:
        raise RuntimeError("layernorm_residual_bwd launch failed with "
                           "cudaError %d (grid %s, block %s)"
                           % (err, grid, block))
    layernorm_residual_bwd.launches += 1
    return dx, dscale, dbias


layernorm_residual_bwd.launches = 0


class _LnRes(torch.autograd.Function):
    """K4 forward, K5 backward: the counterpart of the JAX package's
    ``_ln_res`` custom_vjp."""

    @staticmethod
    def forward(ctx, x, r, scale, bias, eps):
        y, s, mean, var = layernorm_residual_fwd(x, r, scale, bias, eps)
        ctx.save_for_backward(s, mean, var, scale)
        ctx.eps = eps
        return y, s, mean, var

    @staticmethod
    def backward(ctx, gy, gres, gmean, gvar):
        s, mean, var, scale = ctx.saved_tensors
        zeros = lambda g, like: torch.zeros_like(like) if g is None else g
        gy, gres = zeros(gy, s), zeros(gres, s)
        dx, dsc, db = layernorm_residual_bwd(
            s, mean, var, scale, gy.to(s.dtype).contiguous(),
            gres.to(s.dtype).contiguous(), ctx.eps)
        # mean/variance cotangents (zero for program use, exact for
        # direct callers): d mean/d s_j = 1/D, d var/d s_j
        # = 2 (s_j - mean)/D
        if gmean is not None or gvar is not None:
            d = s.shape[-1]
            extra = torch.zeros_like(mean)
            if gmean is not None:
                extra = extra + gmean.float() / d
            if gvar is not None:
                extra = extra + gvar.float() * 2.0 * (s.float() - mean) / d
            dx = (dx.float() + extra).to(s.dtype)
        return dx, dx, dsc.to(scale.dtype), db.to(scale.dtype), None


def layernorm_residual(x, r, scale, bias, *, eps=1e-5):
    """Fused residual-add + layer norm over 2-D rows ``[N, D]``:
    returns ``(y, s, mean, var)`` where ``s = x + r`` is the new
    residual stream, ``y = layer_norm(s) * scale + bias``, and
    ``mean``/``var`` are the per-row f32 statistics ``[N, 1]``. K4
    forward, differentiable through K5 (see the module docstring for the
    tolerances)."""
    return _LnRes.apply(x, r, scale, bias, float(eps))
