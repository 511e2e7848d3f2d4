"""Fused optimizer update: one launch per group of params.

The port of paddle_tpu/kernels/optimizer_update.py. The fusion pass
(core/passes/kernel_fuse.py) bundles a consecutive run of
same-hyperparameter ``adam`` / ``sgd`` ops into one
``fused_optimizer_update`` op; on the card its lowering
(ops/fused_ops.py) runs the whole group through one kernel:

- ``adam_group`` (K6, ``csrc/optimizer_update.cu``) replaces
  ``_adam_kernel`` / ``_sweep`` / ``sweep_group``;
- ``sgd_group`` (K7, same source) replaces ``_sgd_kernel``.

The JAX package concatenates every param, grad and moment into one
stream, broadcasts the per-param scalars into two more streams and
splits the outputs back. The port does a multi-tensor apply instead: a
table of per-param pointers, sizes, first tiles and alignment flags
(``ADAM_FIELDS`` / ``SGD_FIELDS``) is uploaded from pinned memory with a
stream-ordered copy (under a CUDA graph the executor's plan builds it
once, at capture, and keeps it on the device: ``upload``); a persistent
grid (as many CTAs of 256 threads per
SM as the card keeps resident) gives each CTA one contiguous run of
2048-element tiles, streamed with 16-byte loads and stores (a scalar
loop, in the same launch, for an entry whose streams are not all
16-byte aligned and for the last 1-3 elements of a size not divisible
by 4); the bias-corrected rate, the
decay rate and the new beta powers are computed on the device from the
param's own ``LearningRate`` / ``Beta1Pow`` / ``Beta2Pow`` tensors (no
``.item()``, no host sync). Outputs are new tensors, except with
``in_place=True``: the executor asks for that under a CUDA graph, where
the scope's params and moments are donated (core/cuda_graph.py), and the
kernel then writes each param and moment over its input (every element
is read, then written, by one thread; the beta powers, which other CTAs
read, still go to new tensors). Each new output slot is one new buffer,
viewed per param at offsets padded to 32 elements (128 bytes,
``padded_offsets``), so the next step's inputs, which are these views,
take the vector path. Each wrapper adds the entries that took it to
``<wrapper>.vector_entries``. Bound by bytes: 7 (Adam) or 3 (SGD)
four-byte streams per element, 1.111 / 0.476 ms for BERT-base's
132,919,866 f32 params at 3.35 TB/s. Params, moments and scalars are
f32; a grad is f32 or bf16 (a bf16-AMP step's grads, as they come: the
kernel widens a bf16 grad in registers, which is exact, so an update
on a bf16 grad is bitwise the update on that grad widened to f32). A
bf16 grad streams 2 bytes an element and takes the vector path where
it is 8-byte aligned; ``<wrapper>.bf16_grad_entries`` counts such
entries. Any other dtype raises on the card.

On CPU tensors each wrapper computes its plain version
(``adam_group_reference``, ``sgd_group_reference``: the per-param
arithmetic of ops/optimizer_ops.py); on CUDA tensors it launches its
kernel or raises. Each counts its launches in ``<wrapper>.launches``.
Parity vs the plain versions: atol 2e-6 at float32 (the same
expression; FMA contraction moves elements by an ulp or two).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .common import check_launch, check_tensor, on_device, sm_count

__all__ = ["ADAM_FIELDS", "IN_PLACE_SLOTS", "OPT_IN_SLOTS", "OPT_OUT_SLOTS",
           "SGD_FIELDS", "adam_group", "adam_group_reference",
           "padded_offsets", "pinned_upload", "sgd_group",
           "sgd_group_reference", "table_rows", "vector_entries"]

# THE slot tables for fused_optimizer_update: the fusion pass
# (core/passes/kernel_fuse.py) assembles the fused op's ins/outs from
# these and the lowering (ops/fused_ops.py) consumes them — one shared
# definition, so a slot added for one side cannot silently miss the
# other (the core.program.op_effects lesson applied here)
OPT_IN_SLOTS = {
    "adam": ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
             "Beta2Pow", "LearningRate"),
    "sgd": ("Param", "Grad", "LearningRate"),
}
OPT_OUT_SLOTS = {
    "adam": ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut"),
    "sgd": ("ParamOut",),
}

# the (input, output) slots an in-place update writes over
IN_PLACE_SLOTS = {
    "adam": (("Param", "ParamOut"), ("Moment1", "Moment1Out"),
             ("Moment2", "Moment2Out")),
    "sgd": (("Param", "ParamOut"),),
}

# the columns of the kernels' per-param tables, in the order of the
# AdamEntry / SgdEntry structs of csrc/optimizer_update.cu
ADAM_FIELDS = ("Param", "Grad", "Moment1", "Moment2", "LearningRate",
               "Beta1Pow", "Beta2Pow", "ParamOut", "Moment1Out",
               "Moment2Out", "Beta1PowOut", "Beta2PowOut", "n",
               "first_tile", "vector", "grad_bf16")
SGD_FIELDS = ("Param", "Grad", "LearningRate", "ParamOut", "n",
              "first_tile", "vector", "grad_bf16")
# the element streams whose alignment decides an entry's path
_STREAMS = {"adam": ("Param", "Grad", "Moment1", "Moment2", "ParamOut",
                     "Moment1Out", "Moment2Out"),
            "sgd": ("Param", "Grad", "ParamOut")}

# the launch configuration of csrc/optimizer_update.cu (kThreads,
# kTile), checked against the built library when it loads
_THREADS = 256
_TILE = 2048        # elements per tile
_VECTOR_BYTES = 16  # one float4
_BF16_VECTOR_BYTES = 8  # four bf16 grads
_PAD = 32           # elements: each output view starts on 128 bytes


def _hyper(hyper):
    return (hyper.get("beta1", 0.9), hyper.get("beta2", 0.999),
            hyper.get("epsilon", 1e-8), hyper.get("weight_decay", 0.0))


def adam_group_reference(ins, hyper):
    """The plain version of K6: every param's ``adam`` update, in the
    arithmetic of the op lowering (ops/optimizer_ops.py), as a slot dict
    of per-param lists. A bf16 grad is widened to the param's f32
    first, as AMP's f32 cast of the ``adam`` op's inputs does."""
    b1, b2, eps, wd = _hyper(hyper)
    out = {s: [] for s in OPT_OUT_SLOTS["adam"]}
    for p, g, m, v, b1p, b2p, lr in zip(*(ins[s] for s in
                                          OPT_IN_SLOTS["adam"])):
        g = g.to(p.dtype)
        lr_ = lr.reshape(()).to(p.dtype)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        lr_t = lr_ * torch.sqrt(1 - b2p.reshape(()).to(p.dtype) * b2) / (
            1 - b1p.reshape(()).to(p.dtype) * b1)
        p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
        if wd:
            p_new = p_new - lr_ * wd * p
        for slot, val in zip(OPT_OUT_SLOTS["adam"],
                             (p_new, m_new, v_new, b1p * b1, b2p * b2)):
            out[slot].append(val)
    return out


def sgd_group_reference(ins):
    """The plain version of K7: every param's ``sgd`` update (a bf16
    grad widened to the param's f32 first)."""
    return {"ParamOut": [p - lr.reshape(()).to(p.dtype) * g.to(p.dtype)
                         for p, g, lr in zip(ins["Param"], ins["Grad"],
                                             ins["LearningRate"])]}


def _lib():
    lib = build.load("optimizer_update")
    if not getattr(lib, "_typed", False):
        p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
        lib.adam_group.argtypes = [p, i, i64, i] + [f] * 6 + [p]
        lib.adam_group.restype = i
        lib.sgd_group.argtypes = [p, i, i64, i, p]
        lib.sgd_group.restype = i
        lib.optimizer_group_grid.argtypes = [i, i64, i]
        lib.optimizer_group_grid.restype = i
        built = (lib.optimizer_group_threads(), lib.optimizer_group_tile())
        if built != (_THREADS, _TILE):
            raise RuntimeError("csrc/optimizer_update.cu was built with "
                               "(threads, tile) = %s, the wrapper lays out "
                               "%s" % (built, (_THREADS, _TILE)))
        lib._typed = True
    return lib


_SCALAR_SLOTS = ("LearningRate", "Beta1Pow", "Beta2Pow")
_GRAD_DTYPES = (torch.float32, torch.bfloat16)


def _check_group(what, kind, ins):
    """Every slot holds one tensor per param; params and moments f32,
    grads f32 or bf16, contiguous, of the param's size; scalars one f32
    element; all on one device."""
    ps = ins["Param"]
    if not ps:
        raise ValueError("%s: empty group" % what)
    dev = ps[0].device
    sizes = [p.numel() for p in ps]
    for slot in OPT_IN_SLOTS[kind]:
        ts = ins[slot]
        if len(ts) != len(ps):
            raise ValueError("%s: %d %s tensors for %d params"
                             % (what, len(ts), slot, len(ps)))
        want = [1] * len(ps) if slot in _SCALAR_SLOTS else sizes
        dtypes = _GRAD_DTYPES if slot == "Grad" else (torch.float32,)
        for i, (t, n) in enumerate(zip(ts, want)):
            if t.dtype not in dtypes or t.device != dev or \
                    not t.is_contiguous():
                check_tensor("%s %s[%d]" % (what, slot, i), t, dtypes,
                             t.ndim, dev)
            if t.numel() != n:
                raise ValueError("%s: %s[%d] has %d elements, expected %d"
                                 % (what, slot, i, t.numel(), n))
    return sizes


def padded_offsets(sizes):
    """Each param's offset in a flat output buffer, in elements, and the
    buffer's length: offsets rounded up to multiples of 32 elements (128
    bytes), so every view starts 16-byte aligned (at most 31 elements of
    padding per param)."""
    padded = -(-np.asarray(sizes, np.int64) // _PAD) * _PAD
    offs = np.concatenate([[0], np.cumsum(padded)[:-1]]).astype(np.int64)
    return offs, int(padded.sum())


def _outputs(flat_rows, like, sizes):
    """Per-param views of the rows of one new flat buffer, each shaped
    like its param, at ``padded_offsets``: one allocation per output
    slot, not one per param."""
    offs, _ = padded_offsets(sizes)
    gaps = np.diff(np.append(offs, offs[-1] + sizes[-1])) - sizes
    # one split into [size, gap, size, gap, ...], the gaps dropped
    pieces = [int(v) for pair in zip(sizes, gaps) for v in pair]
    outs = []
    for row in flat_rows:
        views = torch.split(row[:sum(pieces)], pieces)[::2]
        outs.append([v.view(p.shape) for v, p in zip(views, like)])
    return outs


def vector_entries(kind, columns, grad_bf16=None):
    """Which entries take the kernel's vector path: a boolean per param,
    true where every element stream's address (``columns``: slot name ->
    per-param addresses, the slots of ``_STREAMS[kind]``) is a multiple
    of 16 bytes, but the grad's of 8 where ``grad_bf16`` (a boolean per
    param, default all False) marks a bf16 grad."""
    addrs = np.stack([np.asarray(columns[s], np.int64)
                      for s in _STREAMS[kind] if s != "Grad"])
    grad = np.asarray(columns["Grad"], np.int64)
    bf16 = (np.zeros(grad.shape, bool) if grad_bf16 is None
            else np.asarray(grad_bf16, bool))
    grad_ok = grad % np.where(bf16, _BF16_VECTOR_BYTES, _VECTOR_BYTES) == 0
    return (np.bitwise_or.reduce(addrs, axis=0) % _VECTOR_BYTES == 0) & \
        grad_ok


def table_rows(kind, columns, sizes, grad_bf16=None):
    """The per-param table (one int64 row per param: the pointer columns
    in ``*_FIELDS`` order, its size, its first tile, its vector flag,
    its grad's bf16 flag), the total tile count and the number of vector
    entries. Each param gets at least one tile (the CTA that owns it
    writes the beta powers)."""
    fields = ADAM_FIELDS if kind == "adam" else SGD_FIELDS
    n = np.asarray(sizes, np.int64)
    tiles = np.maximum(1, -(-n // _TILE))
    first = np.concatenate([[0], np.cumsum(tiles)[:-1]])
    bf16 = (np.zeros(n.shape, bool) if grad_bf16 is None
            else np.asarray(grad_bf16, bool))
    vec = vector_entries(kind, columns, bf16)
    arr = np.stack([np.asarray(columns[f], np.int64) for f in fields[:-4]]
                   + [n, first, vec.astype(np.int64), bf16.astype(np.int64)],
                   axis=1)
    return arr, int(tiles.sum()), int(vec.sum())


def pinned_upload(arr, dev):
    """A host table on ``dev``, uploaded from pinned memory with a copy
    ordered on the current stream: the host does not wait for the
    card."""
    return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)


def _table(kind, columns, sizes, grad_bf16, dev, upload):
    """``table_rows`` on ``dev``, placed there by ``upload(arr, dev)``
    (default ``pinned_upload``)."""
    arr, tiles, vec = table_rows(kind, columns, sizes, grad_bf16)
    table = (upload or pinned_upload)(arr, dev)
    return table, tiles, vec


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _bf16_flags(grads):
    return np.array([g.dtype == torch.bfloat16 for g in grads], bool)


def _flat_ptrs(flat_row, sizes):
    """Pointers of the per-param views of one flat f32 row."""
    return flat_row.data_ptr() + 4 * padded_offsets(sizes)[0]


def _launch(what, table, count, tiles, *args):
    """Launch ``what`` (``adam_group`` or ``sgd_group``) over the table:
    the grid is as many CTAs per SM as the card keeps resident (the
    library asks the card), at most one per tile."""
    dev = table.device
    sms = sm_count(dev)
    lib = _lib()
    with on_device(dev):
        grid = lib.optimizer_group_grid(0 if what == "adam_group" else 1,
                                        tiles, sms)
        check_launch(what, (grid, 1, 1), (_THREADS, 1, 1), 0)
        err = getattr(lib, what)(table.data_ptr(), count, tiles, sms, *args,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("%s launch failed with cudaError %d (%d CTAs of "
                           "%d threads)" % (what, err, grid, _THREADS))


def adam_group(ins, hyper, in_place=False, upload=None):
    """K6: the Adam update of every param of a group (slot dict of
    per-param lists, as the fused op's inputs) in one launch; returns
    the output slot dict (``ParamOut``, ``Moment1Out``, ``Moment2Out``,
    ``Beta1PowOut``, ``Beta2PowOut``): new tensors, each output slot's
    per-param views of one new buffer, but with ``in_place`` the params
    and moments are the input tensors, updated where they lie.
    ``upload(arr, dev)`` places the pointer table on the card (default
    ``pinned_upload``). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    sizes = _check_group("adam_group", "adam", ins)
    ps = ins["Param"]
    if ps[0].device.type == "cpu":
        return adam_group_reference(ins, hyper)
    b1, b2, eps, wd = _hyper(hyper)
    dev, k = ps[0].device, len(ps)
    pows = torch.empty((2, k), dtype=torch.float32, device=dev)
    b1_out, b2_out = ([t.view(b.shape) for t, b in zip(row.split(1), ins[s])]
                      for row, s in zip(pows, ("Beta1Pow", "Beta2Pow")))
    columns = {s: _ptrs(ins[s]) for s in ADAM_FIELDS[:7]}
    if in_place:
        p_out, m_out, v_out = (ins[s] for s in ("Param", "Moment1",
                                                "Moment2"))
        columns.update(zip(ADAM_FIELDS[7:10], (
            columns[s] for s in ("Param", "Moment1", "Moment2"))))
    else:
        flat = torch.empty((3, padded_offsets(sizes)[1]),
                           dtype=torch.float32, device=dev)
        p_out, m_out, v_out = _outputs(flat, ps, sizes)
        columns.update(zip(ADAM_FIELDS[7:10],
                           (_flat_ptrs(row, sizes) for row in flat)))
    columns.update(zip(ADAM_FIELDS[10:12], (
        row.data_ptr() + 4 * np.arange(k, dtype=np.int64) for row in pows)))
    bf16 = _bf16_flags(ins["Grad"])
    table, tiles, vec = _table("adam", columns, sizes, bf16, dev, upload)
    _launch("adam_group", table, k, tiles, b1, b2, 1 - b1, 1 - b2, eps,
            wd)
    adam_group.launches += 1
    adam_group.vector_entries += vec
    adam_group.bf16_grad_entries += int(bf16.sum())
    return {"ParamOut": p_out, "Moment1Out": m_out, "Moment2Out": v_out,
            "Beta1PowOut": b1_out, "Beta2PowOut": b2_out}


adam_group.launches = 0
adam_group.vector_entries = 0
adam_group.bf16_grad_entries = 0


def sgd_group(ins, in_place=False, upload=None):
    """K7: ``p - lr * g`` for every param of a group in one launch;
    returns ``{"ParamOut": [...]}`` (per-param views of one new buffer,
    or with ``in_place`` the params themselves, updated where they lie).
    ``upload`` as in ``adam_group``. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    sizes = _check_group("sgd_group", "sgd", ins)
    ps = ins["Param"]
    if ps[0].device.type == "cpu":
        return sgd_group_reference(ins)
    dev = ps[0].device
    columns = {s: _ptrs(ins[s]) for s in SGD_FIELDS[:3]}
    if in_place:
        p_out = ps
        columns["ParamOut"] = columns["Param"]
    else:
        flat = torch.empty((1, padded_offsets(sizes)[1]),
                           dtype=torch.float32, device=dev)
        (p_out,) = _outputs(flat, ps, sizes)
        columns["ParamOut"] = _flat_ptrs(flat[0], sizes)
    bf16 = _bf16_flags(ins["Grad"])
    table, tiles, vec = _table("sgd", columns, sizes, bf16, dev, upload)
    _launch("sgd_group", table, len(ps), tiles)
    sgd_group.launches += 1
    sgd_group.vector_entries += vec
    sgd_group.bf16_grad_entries += int(bf16.sum())
    return {"ParamOut": p_out}


sgd_group.launches = 0
sgd_group.vector_entries = 0
sgd_group.bf16_grad_entries = 0
