"""Fused attention: the ``fused_attention`` op and its grad, the
flash-vs-composed dispatch, and the bindings of the hand-written flash
kernels (forward, dK/dV and dQ).

Counterpart of paddle_tpu/ops/attention.py. Layout: q, k, v
[B, H, S, D]; the additive f32 bias broadcasts over [B|1, H|1, Sq|1, Sk]
(-1e9 at masked positions).

Three kernel wrappers, each replacing a Pallas TPU kernel of the JAX
package with a CUDA C++ kernel for Hopper (sm_90a):

- ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``) replaces
  ``_fwd_kernel`` / ``_forward_pallas``: out and the per-row logsumexp.
  At f32 it does 4*B*H*Sq*Sk*D FLOPs of plain f32 FMAs against the
  card's 67 TFLOP/s of non-tensor-core f32, so it is compute-bound
  (about 96 us at [8, 12, 512, 64]); at bf16 the tensor-core rate puts
  the bound on the bytes moved. One CTA of 128 threads per (b*h, 64-row
  query tile); k and v tiles of 64 keys staged in shared memory as f32;
  the online-softmax state in f32 registers.
- ``flash_attention_dkv`` (``csrc/flash_attention_bwd.cu``) replaces
  ``_dkv_kernel``: dK and dV (and, for a trainable bias, the raw score
  grad), one CTA per (b*h, 64-key tile) sweeping the query tiles;
  8*B*H*P*D FLOPs (P visible (query, key) pairs).
- ``flash_attention_dq`` (same source) replaces ``_dq_kernel``: dQ, one
  CTA per (b*h, 64-query tile) sweeping the key tiles; 6*B*H*P*D FLOPs.

All three use f32 FMAs (tensor cores, TMA and warp specialization are
later work), skip tiles wholly above the causal diagonal, bounds-check
the ragged Sq / Sk edges instead of padding, and read the bias through
its strides (0 on broadcast dims) without materializing it. The
backward kernels use no atomics: every output element is written by one
CTA, so a backward is bitwise repeatable. delta = rowsum(dO * O) (minus
the lse cotangent) is computed outside the kernels, as in the JAX
package.

On CPU tensors each wrapper computes its plain version
(``composed_attention_with_lse``, ``flash_attention_dkv_reference``,
``flash_attention_dq_reference``); on CUDA tensors it launches its
kernel or raises. Each counts its launches in ``<wrapper>.launches``.

``flash_attention`` and ``flash_attention_with_lse`` go through
``torch.autograd.Function``s (``_fa_maskbias``, ``_fa_trainbias``,
``_fa_with_lse``) whose backward is the two backward kernels, so
``torch.func`` transforms and ``.backward()`` reach them.

Fully masked rows (every key at -1e9): the plain version and the kernel
spread the weight uniformly over the real keys. The JAX kernel pads a
ragged Sk with -1e9 keys and spreads it over the padded keys too; the
two agree wherever a row has one unmasked key.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..core.registry import register_grad_lowering, register_op
from ..kernels import build
from ..kernels.common import ceil_div, check_launch, check_tensor

__all__ = ["causal_bias_block", "composed_attention",
           "composed_attention_with_lse", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_dkv", "flash_attention_dkv_reference",
           "flash_attention_dq", "flash_attention_dq_reference",
           "flash_attention_fwd", "flash_attention_with_lse",
           "flash_effective", "flash_min_seq", "fused_attention_enabled"]

_MASK = -1e9  # additive mask value, as in the JAX package
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_enabled() -> bool:
    """The PADDLE_TPU_FUSED_ATTENTION knob (default on): whether models
    build the ``fused_attention`` op or compose attention from layers."""
    return os.environ.get("PADDLE_TPU_FUSED_ATTENTION", "1") != "0"


def flash_min_seq() -> int:
    """Sequence-length threshold of the flash-vs-composed dispatch:
    PADDLE_TPU_FLASH_MIN_SEQ, else 256, parsed at call time."""
    raw = os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ", "256")
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            "PADDLE_TPU_FLASH_MIN_SEQ must be a decimal integer "
            "(sequence length); got %r" % (raw,)) from None


def flash_effective(seq_len: int, kv_len: int = None) -> bool:
    """Whether ``flash_attention`` runs the flash kernel at these lengths:
    max(Sq, Sk) >= ``flash_min_seq()``. The JAX package's precedence
    without its tuned-winner tier (the kernel tier is not ported yet): an
    explicit PADDLE_TPU_FLASH_MIN_SEQ wins, else the static 256."""
    sk = int(kv_len) if kv_len is not None else int(seq_len)
    return max(int(seq_len), sk) >= flash_min_seq()


def composed_attention_with_lse(q, k, v, bias=None, scale=1.0,
                                causal=False):
    """The plain version of the flash kernel: (out [B,H,Sq,D] in q's
    dtype, lse [B,H,Sq] f32). Scores and softmax in f32; the
    probabilities are cast to v's dtype before the second product, as in
    the JAX package's ``composed_attention``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _MASK)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


def causal_bias_block(s, dtype=torch.float32, device=None):
    """[1, 1, s, s] additive causal bias: ``_MASK`` strictly above the
    diagonal, 0 elsewhere (the JAX package's ``causal_bias_block``)."""
    r = torch.arange(s, device=device)
    above = r[None, :] > r[:, None]
    return torch.where(above, _MASK, 0.0).to(dtype)[None, None]


def composed_attention(q, k, v, bias=None, scale=1.0, causal=False):
    """Unfused attention (the math the reference composes from
    matmul/softmax layers): the dispatch target below the flash
    threshold."""
    return composed_attention_with_lse(q, k, v, bias, scale, causal)[0]


def _check_inputs(q, k, v, bias, causal, what="flash_attention_fwd"):
    """Checks common to both devices: dtypes, ranks, matching shapes,
    contiguity, one device."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(what + " " + name, t, _KERNEL_DTYPES, 4, dev)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("%s: q, k, v dtypes differ (%s, %s, %s)"
                         % (what, q.dtype, k.dtype, v.dtype))
    B, H, Sq, D = q.shape
    if k.shape != v.shape or tuple(k.shape[:2]) != (B, H) or k.shape[3] != D:
        raise ValueError("%s: k %s / v %s do not match q %s"
                         % (what, tuple(k.shape), tuple(v.shape),
                            tuple(q.shape)))
    Sk = k.shape[2]
    if causal and Sq != Sk:
        raise ValueError("causal flash attention requires Sq == Sk "
                         "(self-attention); got %d/%d" % (Sq, Sk))
    if bias is not None:
        check_tensor(what + " bias", bias, (torch.float32,), 4, dev,
                     contiguous=False)
        for got, full in zip(bias.shape, (B, H, Sq, Sk)):
            if got not in (1, full):
                raise ValueError("%s: bias %s does not broadcast to %s"
                                 % (what, tuple(bias.shape),
                                    (B, H, Sq, Sk)))


def check_kernel_launch(q, k, v, bias=None, causal=False):
    """Everything the CUDA kernel requires of its inputs beyond
    ``_check_inputs``: a supported head dim and a legal launch. Returns
    (grid, block, shared-memory bytes)."""
    _check_inputs(q, k, v, bias, causal)
    B, H, Sq, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError("flash_attention_fwd kernel supports head dim %s, "
                         "got %d" % (_KERNEL_HEAD_DIMS, D))
    rows, threads, smem = _kernel_config(D)
    grid = (ceil_div(Sq, rows), B * H, 1)
    check_launch("flash_attention_fwd", grid, (threads, 1, 1), smem)
    return grid, (threads, 1, 1), smem


def _kernel_config(D):
    lib = _lib()
    rows, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = lib.flash_attention_fwd_config(D, ctypes.byref(rows),
                                         ctypes.byref(threads),
                                         ctypes.byref(smem))
    if err:
        raise ValueError("flash_attention_fwd has no configuration for "
                         "head dim %d" % D)
    return rows.value, threads.value, smem.value


def _lib():
    lib = build.load("flash_attention_fwd")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_attention_fwd.argtypes = [
            p, p, p, p, i64, i64, i64, i64, p, p,
            i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd_config.argtypes = [
            i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attention_fwd_config.restype = i
        lib._typed = True
    return lib


def _bias_strides(bias):
    """The bias' element strides, 0 on each broadcast dim."""
    return tuple(0 if n == 1 else st
                 for n, st in zip(bias.shape, bias.stride()))


def flash_attention_fwd(q, k, v, bias=None, scale=1.0, causal=False):
    """Flash attention forward: (out [B,H,Sq,D] in q's dtype, lse [B,H,Sq]
    f32). q, k, v contiguous f32 or bf16; bias f32, broadcastable to
    [B, H, Sq, Sk], any strides. CPU tensors take the plain version; CUDA
    tensors launch the kernel (head dim 64 or 128) or raise."""
    if q.device.type == "cpu":
        _check_inputs(q, k, v, bias, causal)
        return composed_attention_with_lse(q, k, v, bias, scale, causal)
    grid, block, smem = check_kernel_launch(q, k, v, bias, causal)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if bias is None:
        bias_ptr, strides = None, (0, 0, 0, 0)
    else:
        bias_ptr = bias.data_ptr()
        strides = _bias_strides(bias)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
            out.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D,
            _KERNEL_DTYPES[q.dtype], float(scale), int(bool(causal)), stream)
    if err:
        raise RuntimeError(
            "flash_attention_fwd launch failed with cudaError %d (grid %s, "
            "block %s, %d bytes of shared memory)" % (err, grid, block, smem))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


# -------------------------------------------------------------- backward
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        common = [p, p, p, p, i64, i64, i64, i64, p, p, p]
        lib.flash_attention_dkv.argtypes = common + [
            p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_dkv.restype = i
        lib.flash_attention_dq.argtypes = common + [
            p, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_dq.restype = i
        lib.flash_attention_bwd_config.argtypes = [
            i, i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attention_bwd_config.restype = i
        lib._typed = True
    return lib


_BWD_KERNELS = {"flash_attention_dkv": 0, "flash_attention_dq": 1}


def _check_bwd_inputs(what, q, k, v, bias, g, lse, delta, causal):
    _check_inputs(q, k, v, bias, causal, what)
    check_tensor(what + " g", g, (q.dtype,), 4, q.device)
    if g.shape != q.shape:
        raise ValueError("%s: g %s does not match q %s"
                         % (what, tuple(g.shape), tuple(q.shape)))
    for name, t in (("lse", lse), ("delta", delta)):
        check_tensor("%s %s" % (what, name), t, (torch.float32,), 3,
                     q.device)
        if t.shape != q.shape[:3]:
            raise ValueError("%s: %s %s, expected %s"
                             % (what, name, tuple(t.shape),
                                tuple(q.shape[:3])))


def check_bwd_kernel_launch(what, q, k, v, bias, g, lse, delta,
                            causal=False):
    """Everything the backward kernel ``what`` requires of its inputs: a
    supported head dim, vector-aligned q / k / v / g (the kernel reads
    them four elements at a time) and a legal launch. Returns (grid,
    block, shared-memory bytes)."""
    _check_bwd_inputs(what, q, k, v, bias, g, lse, delta, causal)
    B, H, Sq, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError("%s kernel supports head dim %s, got %d"
                         % (what, _KERNEL_HEAD_DIMS, D))
    align = 4 * q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t.data_ptr() % align:
            raise ValueError("%s: %s is not %d-byte aligned"
                             % (what, name, align))
    lib = _bwd_lib()
    rows, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.flash_attention_bwd_config(_BWD_KERNELS[what], D,
                                      ctypes.byref(rows),
                                      ctypes.byref(threads),
                                      ctypes.byref(smem)):
        raise ValueError("%s has no configuration for head dim %d"
                         % (what, D))
    sweep = k.shape[2] if what == "flash_attention_dkv" else Sq
    grid = (ceil_div(sweep, rows.value), B * H, 1)
    check_launch(what, grid, (threads.value, 1, 1), smem.value)
    return grid, (threads.value, 1, 1), smem.value


def _bwd_probs(q, k, v, bias, g, lse, delta, scale, causal):
    """The plain backward's shared part, f32 [B, H, Sq, Sk]: the
    recomputed probabilities p = exp(s - lse) and dp - delta."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _MASK)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return p, dp - delta.unsqueeze(-1)


def _dkv_from(p, dpd, q, k, v, g, scale):
    """dK, dV (in k's and v's dtype) and the raw score grad, f32. The
    products take p and ds in the input dtype, as the TPU kernel does."""
    ds_raw = p * dpd
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float())
    dk = torch.matmul((ds_raw * scale).to(q.dtype).float().transpose(-1, -2),
                      q.float())
    return dk.to(k.dtype), dv.to(v.dtype), ds_raw


def _dq_from(p, dpd, q, k, scale):
    ds = (p * dpd * scale).to(k.dtype).float()
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, bias, g, lse, delta, scale,
                                  causal=False, want_db=False):
    """The plain version of the dK/dV kernel: (dk, dv, ds or None)."""
    p, dpd = _bwd_probs(q, k, v, bias, g, lse, delta, scale, causal)
    dk, dv, ds = _dkv_from(p, dpd, q, k, v, g, scale)
    return dk, dv, (ds if want_db else None)


def flash_attention_dq_reference(q, k, v, bias, g, lse, delta, scale,
                                 causal=False):
    """The plain version of the dQ kernel."""
    p, dpd = _bwd_probs(q, k, v, bias, g, lse, delta, scale, causal)
    return _dq_from(p, dpd, q, k, scale)


def _bwd_launch_args(q, k, v, bias, g, lse, delta):
    B, H, Sq, D = q.shape
    if bias is None:
        bias_ptr, strides = None, (0, 0, 0, 0)
    else:
        bias_ptr, strides = bias.data_ptr(), _bias_strides(bias)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
            g.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    return head, [B, H, Sq, k.shape[2], D, _KERNEL_DTYPES[q.dtype]]


def _launched(what, err, grid, block, smem):
    if err:
        raise RuntimeError(
            "%s launch failed with cudaError %d (grid %s, block %s, %d bytes "
            "of shared memory)" % (what, err, grid, block, smem))


def flash_attention_dkv(q, k, v, bias, g, lse, delta, scale, causal=False,
                        want_db=False):
    """Flash attention dK/dV: (dk, dv in the input dtype, ds or None).
    ``lse`` is the forward's, ``delta`` = rowsum(dO * O) (minus the lse
    cotangent), both f32 [B, H, Sq]; with ``want_db`` also the raw score
    grad p * (dp - delta), f32 [B, H, Sq, Sk]. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    what = "flash_attention_dkv"
    if q.device.type == "cpu":
        _check_bwd_inputs(what, q, k, v, bias, g, lse, delta, causal)
        return flash_attention_dkv_reference(q, k, v, bias, g, lse, delta,
                                             scale, causal, want_db)
    grid, block, smem = check_bwd_kernel_launch(what, q, k, v, bias, g, lse,
                                                delta, causal)
    B, H, Sq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ds = torch.empty((B, H, Sq, k.shape[2]), dtype=torch.float32,
                     device=q.device) if want_db else None
    head, dims = _bwd_launch_args(q, k, v, bias, g, lse, delta)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_dkv(
            *head, dk.data_ptr(), dv.data_ptr(),
            None if ds is None else ds.data_ptr(), *dims, float(scale),
            int(bool(causal)), stream)
    _launched(what, err, grid, block, smem)
    flash_attention_dkv.launches += 1
    return dk, dv, ds


flash_attention_dkv.launches = 0


def flash_attention_dq(q, k, v, bias, g, lse, delta, scale, causal=False):
    """Flash attention dQ in the input dtype, from the same inputs as
    ``flash_attention_dkv``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    what = "flash_attention_dq"
    if q.device.type == "cpu":
        _check_bwd_inputs(what, q, k, v, bias, g, lse, delta, causal)
        return flash_attention_dq_reference(q, k, v, bias, g, lse, delta,
                                            scale, causal)
    grid, block, smem = check_bwd_kernel_launch(what, q, k, v, bias, g, lse,
                                                delta, causal)
    dq = torch.empty_like(q)
    head, dims = _bwd_launch_args(q, k, v, bias, g, lse, delta)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_dq(*head, dq.data_ptr(), *dims,
                                     float(scale), int(bool(causal)), stream)
    _launched(what, err, grid, block, smem)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def _delta(g, o, g_lse):
    """rowsum(dO * O) in f32, shifted by -g_lse (an lse cotangent adds
    p * g_lse to ds, which is a -g_lse shift of delta)."""
    delta = torch.sum(g.float() * o.float(), dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def flash_attention_bwd(q, k, v, bias, o, lse, g, scale, causal=False,
                        want_db=False, g_lse=None):
    """The flash backward, counterpart of the JAX package's
    ``_backward_pallas``: (dq, dk, dv, ds). delta is computed here; the
    dK/dV kernel then the dQ kernel run on it. ``ds`` is the raw score
    grad, f32 [B, H, Sq, Sk], with ``want_db``, else None."""
    g = g.contiguous()
    delta = _delta(g, o, g_lse)
    dk, dv, ds = flash_attention_dkv(q, k, v, bias, g, lse, delta, scale,
                                     causal, want_db)
    dq = flash_attention_dq(q, k, v, bias, g, lse, delta, scale, causal)
    return dq, dk, dv, ds


def flash_attention_bwd_reference(q, k, v, bias, o, lse, g, scale,
                                  causal=False, want_db=False, g_lse=None):
    """The plain version of ``flash_attention_bwd``: the same formulas,
    with p = exp(s - lse) recomputed once for both halves."""
    p, dpd = _bwd_probs(q, k, v, bias, g, lse, _delta(g, o, g_lse), scale,
                        causal)
    dk, dv, ds = _dkv_from(p, dpd, q, k, v, g, scale)
    return _dq_from(p, dpd, q, k, scale), dk, dv, (ds if want_db else None)


def _reduce_to_bias_shape(ds, bias_shape):
    """Sum the full [B,H,Sq,Sk] score grad down to a broadcastable bias."""
    axes = tuple(i for i, (d, b) in enumerate(zip(ds.shape, bias_shape))
                 if b == 1 and d != 1)
    if axes:
        ds = torch.sum(ds, dim=axes, keepdim=True)
    return ds


# ------------------------------------------------- autograd.Functions
class _FaWithLse(torch.autograd.Function):
    """(out, lse) of the flash forward; both differentiable, the bias a
    constant. The counterpart of the JAX package's ``_fa_with_lse``."""

    @staticmethod
    def forward(q, k, v, bias, scale, causal):
        return flash_attention_fwd(q, k, v, bias, scale, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, scale, causal = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, _ = flash_attention_bwd(
            q, k, v, bias, o, lse, g_out.to(q.dtype), ctx.scale, ctx.causal,
            g_lse=g_lse)
        return dq, dk, dv, None, None, None


class _FaMaskBias(_FaWithLse):
    """out of the flash forward with a constant bias (the lse comes out
    but takes no cotangent): the JAX package's ``_fa_maskbias``."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        _FaWithLse.setup_context(ctx, inputs, output)
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, _ = flash_attention_bwd(q, k, v, bias, o, lse, g_out,
                                            ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


class _FaTrainBias(torch.autograd.Function):
    """out of the flash forward with a trainable bias: the dK/dV kernel
    also writes the raw score grad, reduced to the bias' shape (the JAX
    package's ``_fa_trainbias``)."""

    @staticmethod
    def forward(q, k, v, bias, scale):
        return flash_attention_fwd(q, k, v, bias, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, scale = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, ds = flash_attention_bwd(q, k, v, bias, o, lse, g_out,
                                             ctx.scale, want_db=True)
        db = _reduce_to_bias_shape(ds, bias.shape).to(bias.dtype)
        return dq, dk, dv, db, None


def _fa_maskbias(q, k, v, bias, scale, causal=False):
    return _FaMaskBias.apply(q, k, v, bias, scale, causal)[0]


def _fa_trainbias(q, k, v, bias, scale):
    return _FaTrainBias.apply(q, k, v, bias, scale)[0]


def _fa_with_lse(q, k, v, bias, scale, causal=False):
    return _FaWithLse.apply(q, k, v, bias, scale, causal)


def flash_attention_with_lse(q, k, v, bias=None, scale=1.0, causal=False):
    """Fused attention returning (out [B,H,S,D], lse [B,H,S] row
    log-sum-exps), both differentiable (the lse cotangent folds into the
    backward's delta shift); the bias is a constant mask."""
    bias = None if bias is None else bias.detach()
    return _fa_with_lse(q, k, v, bias, scale, causal)


def flash_attention(q, k, v, bias=None, scale=1.0, bias_grad=False,
                    causal=False):
    """Fused attention: the flash kernels at max(Sq, Sk) >=
    ``flash_min_seq()``, the composed math below it. ``bias`` is a
    constant additive mask by default (detached); ``bias_grad=True``
    gives the true bias cotangent, at the cost of an O(Sq*Sk) score-grad
    buffer in the backward. ``causal=True`` masks in-kernel and skips
    tiles above the diagonal (Sq == Sk); with ``bias_grad`` the
    triangular mask is folded into the bias instead, as in the JAX
    package."""
    if causal and bias_grad:
        if bias is None:
            bias_grad = False  # nothing trainable: plain causal path
        else:
            S, Sk = q.shape[2], k.shape[2]
            if S != Sk:
                raise ValueError(
                    "causal flash attention requires Sq == Sk "
                    "(self-attention); got Sq=%d Sk=%d" % (S, Sk))
            bias = bias + causal_bias_block(S, bias.dtype, bias.device)
            causal = False
    if not flash_effective(q.shape[2], k.shape[2]):
        cbias = bias if (bias is None or bias_grad) else bias.detach()
        return composed_attention(q, k, v, cbias, scale, causal)
    if bias is None:
        return _fa_maskbias(q, k, v, None, scale, causal)
    if bias_grad:
        return _fa_trainbias(q, k, v, bias, scale)
    return _fa_maskbias(q, k, v, bias.detach(), scale, causal)


def _attention_inputs(ins):
    if ins.get("SegmentIds"):
        raise NotImplementedError(
            "fused_attention with SegmentIds (packed sequences) is not "
            "ported yet")
    # the heads come out of transpose2 as strided views; the kernels read
    # contiguous [B, H, S, D]
    q, k, v = (ins[s][0].contiguous() for s in ("Q", "K", "V"))
    bias = (ins.get("Bias") or [None])[0]
    if bias is not None:
        bias = bias.float()  # mask bias adds in f32 in-kernel
    return q, k, v, bias


@register_op("fused_attention", diff_inputs=["Q", "K", "V"], uses_rng=True)
def _fused_attention(ctx, ins, attrs):
    q, k, v, bias = _attention_inputs(ins)
    scale = attrs.get("scale", 1.0)
    dropout = attrs.get("dropout", 0.0)
    out = flash_attention(q, k, v, bias, scale,
                          causal=bool(attrs.get("causal", False)))
    if dropout and not ctx.is_test:
        # dropout on the output, mask saved for the grad op (as in the
        # JAX package)
        keep = 1.0 - dropout
        gen = ctx.next_rng()
        mask = (torch.rand(out.shape, generator=gen, device=out.device)
                < keep).to(out.dtype) / keep
        return {"Out": [out * mask], "Mask": [mask]}
    # no dropout: the mask is all ones; a broadcast view costs no memory
    ones = torch.ones((), dtype=out.dtype, device=out.device)
    return {"Out": [out], "Mask": [ones.expand(out.shape)]}


@register_grad_lowering("fused_attention")
def _fused_attention_grad(ctx, ins, attrs):
    """The saved dropout mask applied to the output grad, then the
    backward of the path the forward took: at or above the flash
    threshold the flash forward kernel recomputes (out, lse) and the
    dK/dV and dQ kernels run on them; below it, the vjp of the composed
    attention. The bias is a constant mask: it takes no grad."""
    q, k, v, bias = _attention_inputs(ins)
    g = ins["Out@GRAD"][0]
    mask = (ins.get("Mask") or [None])[0]
    if mask is not None:
        g = g * mask
    g = g.to(q.dtype).contiguous()
    scale = attrs.get("scale", 1.0)
    causal = bool(attrs.get("causal", False))
    if flash_effective(q.shape[2], k.shape[2]):
        out, lse = flash_attention_fwd(q, k, v, bias, scale, causal)
        dq, dk, dv, _ = flash_attention_bwd(q, k, v, bias, out, lse, g,
                                            scale, causal)
    else:
        _, vjp = torch.func.vjp(
            lambda a, b, c: composed_attention(a, b, c, bias, scale, causal),
            q, k, v)
        dq, dk, dv = vjp(g)
    return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}
