"""Fused attention: the ``fused_attention`` op and its grad, the
flash-vs-composed dispatch, and the bindings of the hand-written flash
kernels (forward, dK/dV and dQ).

Counterpart of paddle_tpu/ops/attention.py. Layout: q, k, v
[B, H, S, D]; the additive f32 bias broadcasts over [B|1, H|1, Sq|1, Sk]
(-1e9 at masked positions).

Three kernel wrappers, each replacing a Pallas TPU kernel of the JAX
package with a CUDA C++ kernel for Hopper (sm_90a):

- ``flash_attention_fwd`` (``csrc/flash_attention_fwd.cu``) replaces
  ``_fwd_kernel`` / ``_forward_pallas``: out and the per-row logsumexp,
  4*B*H*Sq*Sk*D FLOPs. One CTA per (b*h, query tile) sweeping the key
  tiles with an online softmax in f32.
- ``flash_attention_dkv`` (``csrc/flash_attention_bwd.cu``) replaces
  ``_dkv_kernel``: dK and dV (and, for a trainable bias, the raw score
  grad), one CTA per (b*h, 64-key tile) sweeping the query tiles;
  8*B*H*P*D FLOPs (P visible (query, key) pairs).
- ``flash_attention_dq`` (same source) replaces ``_dq_kernel``: dQ, one
  CTA per (b*h, 64-query tile) sweeping the key tiles; 6*B*H*P*D FLOPs.

All three run bf16 on the tensor cores (``mma.sync``, with P, and in the
backward dS, rounded to bf16 in registers before their products, as in
the JAX package) and f32 as exact f32 FMAs (the main path runs with TF32
off); all copy the swept tiles into shared memory by 16-byte
``cp.async`` (bf16 into a two-stage ring), so q / k / v / g must be
16-byte aligned. The launch geometry (rows and threads per CTA, shared
memory) differs by dtype and head dim. All three skip tiles wholly above
the causal diagonal, bounds-check the ragged Sq / Sk edges instead of
padding, and read the bias through its strides (0 on broadcast dims)
without materializing it, once per tile. The backward kernels use no
atomics: every output element is written by one CTA, so a backward is
bitwise repeatable. delta = rowsum(dO * O) (minus the lse cotangent) is
computed outside the kernels, as in the JAX package.

On CPU tensors each wrapper computes its plain version
(``composed_attention_with_lse``, ``flash_attention_dkv_reference``,
``flash_attention_dq_reference``); on CUDA tensors it launches its
kernel or raises. Each counts its launches in ``<wrapper>.launches``.
The forward is the operator ``paddle_tpu_torch::flash_attention_fwd``
(``torch.library.custom_op``, dispatched by device, with a fake
implementation for the outputs' shapes), so ``torch.export`` records one
node per launch where it cannot trace a ``data_ptr``; the backward
kernels run only in training, which no artifact freezes.

``flash_attention`` and ``flash_attention_with_lse`` go through
``torch.autograd.Function``s (``_fa_maskbias``, ``_fa_trainbias``,
``_fa_with_lse``) whose backward is the two backward kernels, so
``torch.func`` transforms and ``.backward()`` reach them.

Under a ``ParallelEngine`` mesh whose ``seq`` axis divides S, a
``fused_attention`` with a key-mask bias rides ring attention
(parallel/ring_attention.py): each ring step's pairs from every position
go to the forward kernel in one launch, with their lse, and the grad
re-runs the ring under autograd, so the backward kernels take the lse
cotangent. Its packed segment ids ride the ring as id vectors.

Fully masked rows (every key at -1e9): the plain version and the kernel
spread the weight uniformly over the real keys. The JAX kernel pads a
ragged Sk with -1e9 keys and spreads it over the padded keys too; the
two agree wherever a row has one unmasked key.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import torch

from ..core.lowering import rand_rows
from ..core.registry import register_grad_lowering, register_op
from ..kernels import build
from ..kernels.common import ceil_div, check_launch, check_tensor, on_device
from ..kernels.registry import register_kernel

__all__ = ["causal_bias_block", "composed_attention",
           "composed_attention_with_lse", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_occupancy",
           "flash_attention_bwd_reference",
           "flash_attention_dkv", "flash_attention_dkv_reference",
           "flash_attention_dq", "flash_attention_dq_reference",
           "flash_attention_fwd", "flash_attention_fwd_occupancy",
           "flash_attention_with_lse",
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
    """Whether ``flash_attention`` runs the flash kernel at these
    lengths. The JAX package's three-tier precedence:

    1. an explicit ``PADDLE_TPU_FLASH_MIN_SEQ`` wins;
    2. else a tuned kernel-tier entry for ``("attention", (Sq, Sk))``
       decides (``"cuda"`` runs the kernel): the winner of
       ``kernels.tune.tune("attention", (Sq, Sk))`` on the card;
    3. else the static threshold, max(Sq, Sk) >= 256."""
    sq = int(seq_len)
    sk = int(kv_len) if kv_len is not None else sq
    if os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ") is not None:
        return max(sq, sk) >= flash_min_seq()
    from .. import kernels

    choice = kernels.tuned_choice("attention", (sq, sk))
    if choice is not None:
        return choice == "cuda"
    return max(sq, sk) >= flash_min_seq()


def composed_attention_with_lse(q, k, v, bias=None, scale=1.0,
                                causal=False):
    """The plain version of the flash kernel: (out [B,H,Sq,D] in q's
    dtype, lse [B,H,Sq] f32). Scores and softmax in f32; the
    probabilities are cast to v's dtype before the second product, as in
    the JAX package's ``composed_attention``. The probabilities are
    normalized by their sum, not by exp(lse): in a row whose every key
    carries the -1e9 mask, lse rounds to -1e9 (the ulp of 1e9 is 64) and
    exp(s - lse) would give each key weight 1 instead of 1/Sk."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _MASK)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
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
    ``_check_inputs``: a supported head dim, 16-byte-aligned q / k / v
    (the kernel copies them into shared memory 16 bytes at a time, at
    either dtype) and a legal launch for the dtype's geometry. Returns
    (grid, block, shared-memory bytes)."""
    _check_inputs(q, k, v, bias, causal)
    B, H, Sq, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError("flash_attention_fwd kernel supports head dim %s, "
                         "got %d" % (_KERNEL_HEAD_DIMS, D))
    _check_aligned("flash_attention_fwd", (("q", q), ("k", k), ("v", v)))
    rows, threads, smem = _kernel_config(D, q.dtype)
    grid = (ceil_div(Sq, rows), B * H, 1)
    check_launch("flash_attention_fwd", grid, (threads, 1, 1), smem)
    return grid, (threads, 1, 1), smem


_ALIGN = 16  # bytes: the kernels copy q / k / v / g by 16-byte cp.async
# bias kinds of the occupancy queries: none, a key-pad row, a full tile
_BIAS_KINDS = {None: 0, "row": 1, "full": 2}


def _check_aligned(what, named):
    for name, t in named:
        if t.data_ptr() % _ALIGN:
            raise ValueError("%s: %s is not %d-byte aligned"
                             % (what, name, _ALIGN))


@functools.lru_cache(maxsize=None)
def _kernel_config(D, dtype):
    """(query rows per CTA, threads per CTA, the most shared memory a
    launch takes) of the forward kernel at head dim D and dtype, asked of
    the built library once per key."""
    rows, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().flash_attention_fwd_config(
        D, _KERNEL_DTYPES[dtype], ctypes.byref(rows), ctypes.byref(threads),
        ctypes.byref(smem))
    if err:
        raise ValueError("flash_attention_fwd has no configuration for "
                         "head dim %d at %s" % (D, dtype))
    return rows.value, threads.value, smem.value


def flash_attention_fwd_occupancy(head_dim, dtype, bias=None):
    """(CTAs per SM, shared-memory bytes per CTA) the card grants the
    forward kernel at ``head_dim`` and ``dtype``, with no bias
    (``bias=None``), one broadcast over the query rows (``"row"``, a
    key-pad mask) or a full one (``"full"``). Needs the card."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = _lib().flash_attention_fwd_occupancy(
        head_dim, _KERNEL_DTYPES[dtype], _BIAS_KINDS[bias],
        ctypes.byref(blocks), ctypes.byref(smem))
    if err:
        raise RuntimeError("flash_attention_fwd occupancy query failed with "
                           "cudaError %d" % err)
    return blocks.value, smem.value


def _lib():
    lib = build.load("flash_attention_fwd")
    if not getattr(lib, "_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_attention_fwd.argtypes = [
            p, p, p, p, i64, i64, i64, i64, p, p,
            i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd_config.argtypes = [
            i, i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attention_fwd_config.restype = i
        lib.flash_attention_fwd_occupancy.argtypes = [
            i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attention_fwd_occupancy.restype = i
        lib._typed = True
    return lib


def _bias_strides(bias):
    """The bias' element strides, 0 on each broadcast dim."""
    return tuple(0 if n == 1 else st
                 for n, st in zip(bias.shape, bias.stride()))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], scale: float, causal: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as one operator, so that ``torch.export`` records a node for it
    (a fake tensor has no ``data_ptr``). Dispatched by device: the plain
    version on CPU tensors, the kernel on CUDA tensors."""
    _check_inputs(q, k, v, bias, causal)
    return composed_attention_with_lse(q, k, v, bias, scale, causal)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, bias, scale, causal):
    _check_inputs(q, k, v, bias, causal)
    return torch.empty_like(q), q.new_empty(q.shape[:3],
                                            dtype=torch.float32)


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, bias, scale, causal):
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
    flash_attention_fwd.bf16_launches += q.dtype == torch.bfloat16
    return out, lse


def flash_attention_fwd(q, k, v, bias=None, scale=1.0, causal=False):
    """Flash attention forward: (out [B,H,Sq,D] in q's dtype, lse [B,H,Sq]
    f32). q, k, v contiguous f32 or bf16; bias f32, broadcastable to
    [B, H, Sq, Sk], any strides. CPU tensors take the plain version; CUDA
    tensors launch the kernel (head dim 64 or 128) or raise. The operator
    ``paddle_tpu_torch::flash_attention_fwd``."""
    return _fwd_op(q, k, v, bias, float(scale), bool(causal))


flash_attention_fwd.launches = 0
flash_attention_fwd.bf16_launches = 0  # of them, the bf16 instantiation's


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
            i, i, i, ctypes.POINTER(i), ctypes.POINTER(i),
            ctypes.POINTER(i)]
        lib.flash_attention_bwd_config.restype = i
        lib.flash_attention_bwd_occupancy.argtypes = [
            i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.flash_attention_bwd_occupancy.restype = i
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
    supported head dim, 16-byte-aligned q / k / v / g (the kernels copy
    them into shared memory 16 bytes at a time, at either dtype) and a
    legal launch for the dtype's geometry. Returns (grid, block,
    shared-memory bytes)."""
    _check_bwd_inputs(what, q, k, v, bias, g, lse, delta, causal)
    B, H, Sq, D = q.shape
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError("%s kernel supports head dim %s, got %d"
                         % (what, _KERNEL_HEAD_DIMS, D))
    _check_aligned(what, (("q", q), ("k", k), ("v", v), ("g", g)))
    rows, threads, smem = _bwd_config(what, D, q.dtype)
    sweep = k.shape[2] if what == "flash_attention_dkv" else Sq
    grid = (ceil_div(sweep, rows), B * H, 1)
    check_launch(what, grid, (threads, 1, 1), smem)
    return grid, (threads, 1, 1), smem


@functools.lru_cache(maxsize=None)
def _bwd_config(what, D, dtype):
    """(rows per CTA, threads per CTA, the most shared memory a launch
    takes) of the backward kernel ``what`` at head dim D and dtype, asked
    of the built library once per key."""
    rows, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if _bwd_lib().flash_attention_bwd_config(
            _BWD_KERNELS[what], D, _KERNEL_DTYPES[dtype], ctypes.byref(rows),
            ctypes.byref(threads), ctypes.byref(smem)):
        raise ValueError("%s has no configuration for head dim %d at %s"
                         % (what, D, dtype))
    return rows.value, threads.value, smem.value


def flash_attention_bwd_occupancy(what, head_dim, dtype, bias=None):
    """(CTAs per SM, shared-memory bytes per CTA) the card grants the
    backward kernel ``what`` at ``head_dim`` and ``dtype``, with no bias
    (``bias=None``), one broadcast over the query rows (``"row"``, a
    key-pad mask) or a full one (``"full"``). Needs the card."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = _bwd_lib().flash_attention_bwd_occupancy(
        _BWD_KERNELS[what], head_dim, _KERNEL_DTYPES[dtype],
        _BIAS_KINDS[bias], ctypes.byref(blocks), ctypes.byref(smem))
    if err:
        raise RuntimeError("%s occupancy query failed with cudaError %d"
                           % (what, err))
    return blocks.value, smem.value


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
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_dkv(
            *head, dk.data_ptr(), dv.data_ptr(),
            None if ds is None else ds.data_ptr(), *dims, float(scale),
            int(bool(causal)), stream)
    _launched(what, err, grid, block, smem)
    flash_attention_dkv.launches += 1
    flash_attention_dkv.bf16_launches += q.dtype == torch.bfloat16
    return dk, dv, ds


flash_attention_dkv.launches = 0
flash_attention_dkv.bf16_launches = 0  # of them, the bf16 instantiation's


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
    with on_device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_dq(*head, dq.data_ptr(), *dims,
                                     float(scale), int(bool(causal)), stream)
    _launched(what, err, grid, block, smem)
    flash_attention_dq.launches += 1
    flash_attention_dq.bf16_launches += q.dtype == torch.bfloat16
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.bf16_launches = 0  # of them, the bf16 instantiation's


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


# The kernel tier's ``attention`` entry: the tuner (kernels/tune.py)
# measures the flash kernel against the composed path per (Sq, Sk) and
# persists the winner that ``flash_effective`` serves as tier 2. Batch,
# heads and head dim are fixed at representative values, as in the JAX
# package. The kernel has one launch configuration, so the flash side
# has one candidate, ``()``.
_TUNE_B, _TUNE_H, _TUNE_D = 2, 4, 64


def _attention_composed(q, k, v, *, scale=1.0, causal=False):
    return composed_attention(q, k, v, None, scale, causal)


def _attn_check(cfg, sig):
    """The candidate and lengths the kernel can take. Its grid and shared
    memory come from the built kernel (``_kernel_config``), so
    ``check_kernel_launch`` checks them when the measurement launches."""
    if tuple(cfg) != ():
        raise ValueError("the flash kernel has one launch configuration, "
                         "(); got %s" % (cfg,))
    if min(int(s) for s in sig) < 1:
        raise ValueError("attention lengths must be positive, got %s"
                         % (sig,))


def _attn_make_inputs(sig, rs):
    mk = lambda s: torch.from_numpy(  # noqa: E731
        rs.randn(_TUNE_B, _TUNE_H, int(s), _TUNE_D).astype("float32"))
    return (mk(sig[0]), mk(sig[1]), mk(sig[1]))


@register_kernel(
    "attention",
    fallback=_attention_composed,
    signature=lambda args: (int(args[0].shape[2]), int(args[1].shape[2])),
    candidates=lambda sig: [()],
    check=_attn_check,
    make_inputs=_attn_make_inputs,
    tol="atol 2e-5 fwd / 5e-5 bwd at float32",
)
def _attention_cuda(cfg, q, k, v, *, scale=1.0, causal=False):
    """Flash attention through the forward kernel: the tuner's
    measurement of the flash side. The tuned entry's flash-vs-composed
    choice is what ``flash_effective`` consumes (precedence tier 2)."""
    return _fa_maskbias(q, k, v, None, scale, causal)


def seg_mask(q_seg, k_seg):
    """[B, Sq] and [B, Sk] packed segment ids -> the [B, 1, Sq, Sk]
    additive block-diagonal mask: a key is visible iff it shares the
    query's segment id and is a real token (id > 0; ``pack_sequences``
    keeps 0 for padding). The port's copy of the JAX package's rule
    (paddle_tpu/parallel/ring_attention.py ``_seg_mask``)."""
    keep = (q_seg[:, :, None] == k_seg[:, None, :]) & (k_seg[:, None, :] > 0)
    return torch.where(keep, 0.0, _MASK)[:, None].to(torch.float32)


def _attention_inputs(ins):
    # the heads come out of transpose2 as strided views; the kernels read
    # contiguous [B, H, S, D]
    q, k, v = (ins[s][0].contiguous() for s in ("Q", "K", "V"))
    bias = (ins.get("Bias") or [None])[0]
    if bias is not None:
        bias = bias.float()  # mask bias adds in f32 in-kernel
    seg = (ins.get("SegmentIds") or [None])[0]
    return q, k, v, bias, seg


def _fold_seg(bias, seg):
    """Off the ring, the packed rows' ids fold into a full [B, 1, S, S]
    mask, as the JAX package folds them off an sp mesh."""
    if seg is None:
        return bias
    sm = seg_mask(seg, seg)
    return sm if bias is None else bias + sm


def _ring_positions(ctx, q, k, bias) -> int:
    """The positions of the ring that ``fused_attention`` rides under the
    context's mesh, or 0. The JAX package's rule
    (``_maybe_shard_mapped_flash``): self-attention rides the ring where
    the mesh's ``seq`` axis has more than one position and divides S,
    and the bias is a key mask [B|1, 1, 1, S]; elsewhere the op computes
    its global attention (heads over ``model`` and batch over ``data``
    positions share the device: one launch)."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is None or mesh.size <= 1:
        return 0
    s_ax = ctx.seq_axis
    S = q.shape[2]
    n = mesh.shape.get(s_ax, 1)
    if n > 1 and q.shape == k.shape and S % n == 0 and (
            bias is None or (bias.shape[1] == 1 and bias.shape[2] == 1
                             and bias.shape[3] == S)):
        return n
    return 0


def _ring(ctx, n, q, k, v, bias, seg, scale, causal):
    """The global attention through the ring over the ``seq`` axis' n
    positions (parallel/ring_attention.py): q, k, v split into their
    blocks (views), every step's pairs in one K1 launch on the card."""
    from ..parallel.ring_attention import ring_attention

    split = lambda x, dim: list(x.chunk(n, dim=dim))  # noqa: E731
    out = ring_attention(
        split(q, 2), split(k, 2), split(v, 2), scale, ctx.seq_axis,
        causal=causal, kv_bias=None if bias is None else split(bias, 3),
        use_flash=True, seg=None if seg is None else split(seg, 1))
    return torch.cat(out, dim=2)


@register_op("fused_attention", diff_inputs=["Q", "K", "V"], uses_rng=True)
def _fused_attention(ctx, ins, attrs):
    q, k, v, bias, seg = _attention_inputs(ins)
    scale = attrs.get("scale", 1.0)
    dropout = attrs.get("dropout", 0.0)
    causal = bool(attrs.get("causal", False))
    n = _ring_positions(ctx, q, k, bias)
    if n:
        out = _ring(ctx, n, q, k, v, bias, seg, scale, causal)
    else:
        out = flash_attention(q, k, v, _fold_seg(bias, seg), scale,
                              causal=causal)
    if dropout and not ctx.is_test:
        # dropout on the output, mask saved for the grad op (as in the
        # JAX package)
        keep = 1.0 - dropout
        gen = ctx.next_rng()
        mask = (rand_rows(ctx, out.shape, gen, out.device, "Q")
                < keep).to(out.dtype) / keep
        return {"Out": [out * mask], "Mask": [mask]}
    # no dropout: the mask is all ones; a broadcast view costs no memory
    ones = torch.ones((), dtype=out.dtype, device=out.device)
    return {"Out": [out], "Mask": [ones.expand(out.shape)]}


@register_grad_lowering("fused_attention")
def _fused_attention_grad(ctx, ins, attrs):
    """The saved dropout mask applied to the output grad, then the
    backward of the path the forward took: on the ring, autograd through
    a re-run of it (each step's K1 launch backs into a K2 and a K3
    launch, the lse cotangent folded into delta); off it, at or above the
    flash threshold the flash forward kernel recomputes (out, lse) and
    the dK/dV and dQ kernels run on them; below it, the vjp of the
    composed attention. The bias is a constant mask: it takes no grad."""
    q, k, v, bias, seg = _attention_inputs(ins)
    g = ins["Out@GRAD"][0]
    mask = (ins.get("Mask") or [None])[0]
    if mask is not None:
        g = g * mask
    g = g.to(q.dtype).contiguous()
    scale = attrs.get("scale", 1.0)
    causal = bool(attrs.get("causal", False))
    n = _ring_positions(ctx, q, k, bias)
    if n:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = _ring(ctx, n, *leaves, bias, seg, scale, causal)
        dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return {"Q@GRAD": [dq], "K@GRAD": [dk], "V@GRAD": [dv]}
    bias = _fold_seg(bias, seg)
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
