#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Phases, each of which passes or ends the script with a non-zero exit:

1. the card: nvidia-smi's name and power limit, the torch version, TF32
   switched off for f32 products;
2. build: every CUDA source of the port compiled with nvcc for sm_90a,
   in parallel;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at the main path's shapes and a few edge shapes, with
   its time, the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   and the least time the card could take (the bound);
3b. backward kernels: the flash dK/dV and dQ kernels against their
   plain versions on the phase-3 cases (a trainable-bias score grad on
   the causal and the ragged case), with their times, the plain versions', the
   backward of one ``scaled_dot_product_attention`` call (a yardstick
   the port never calls) and the bound;
4. serve: BERT-base (12 layers, d_model 768, S = 512, random weights
   from a seed) built with the port's layers, started on the card,
   saved with ``save_inference_model`` and served by the inference
   Predictor (warmup buckets 1, 4, 8) for requests of batch 1, 3 and 8,
   each answered 10 times (the same answer every time).
   Every ``fused_attention`` launches the flash kernel (12 per
   dispatch, counted); the answers are finite, of shape [B, 512, 768],
   and agree with the composed attention path on the card;
5. profile: one more request per batch size under torch.profiler, for
   the device's busy share and its time by kernel (after the main path's
   counts are read);
6. train: BERT-base masked-LM (S = 512, 80 masked slots, batch 8,
   dropout 0.1, f32) built with the port's layers, ``Adam.minimize``,
   startup on the card, 2 warm-up and 10 timed steps on fixed synthetic
   batches. Every step launches the flash forward kernel 24 times and
   each backward kernel 12 times (counted); losses are finite; one step
   run twice from the same scope gives bitwise the same loss and
   params; from the same scope and RNG state, the flash and the composed
   path agree on the first step's param grads and on the losses and
   params of 3 steps within the stated tolerances; one more step is
   profiled.

It prints one JSON line of kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. With ``--out DIR`` it also writes
every measurement to ``DIR/chip_smoke.json``. It exits non-zero without
a result when no CUDA device is visible.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 1234
SEQ = 512
BUCKETS = [1, 4, 8]
REQUESTS = [1, 3, 8]
REPEATS = 10  # each request is answered this many times (latency samples)
SERVE_ATOL = 1e-3  # flash vs composed attention through 12 f32 layers
# backward kernels vs their plain versions: the JAX package's stated
# backward tolerance at f32 (docs/KERNELS.md), 2e-2 at bf16
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# training (phase 6)
TRAIN_BATCH = 8
MAX_MASK = 80          # BERT phase-2 max_predictions_per_seq
TRAIN_LR = 1e-4
WARMUP_STEPS, TIMED_STEPS, PARITY_STEPS = 2, 10, 3
# flash vs composed training from one scope. The first step's param
# grads: the l2 norm of each one's difference within PARITY_GRAD_L2 of
# its own l2 norm. The two forwards differ by rounding, and where that
# flips a relu pre-activation near 0 the grads of that FFN (and, less,
# of every layer below it) differ by more than rounding; a wrong dQ, dK
# or dV is off by far more on every param below the attention.
# Params after PARITY_STEPS Adam steps: Adam moves a param by about lr
# per step whatever its grad's size, so wrong grads can move params by
# no more than about 2 * lr * steps (6e-4); 1e-4 sits between that and
# the 6.6e-6 measured (PERF.md). The losses at a relative 1e-3.
PARITY_GRAD_L2 = 1e-2
PARITY_PARAM_ATOL = 1e-4
PARITY_LOSS_RTOL = 1e-3

# H100 SXM published peaks (dense): the bound's denominators
PEAK_FLOPS = {torch.float32: 67e12,     # f32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores
PEAK_BYTES = 3.35e12

# Each TPU kernel of the JAX package (paddle_tpu) that reaches
# pl.pallas_call; the ones the port has not ported yet are listed with
# "ported": false.
NOT_PORTED = [
    ("layernorm_residual_fwd", "kernels/layernorm.py:98 _fwd_kernel"),
    ("layernorm_residual_bwd", "kernels/layernorm.py:143 _bwd_kernel"),
    ("adam_group_sweep", "kernels/optimizer_update.py:149 _adam_kernel"),
    ("sgd_group_sweep", "kernels/optimizer_update.py:233 _sgd_kernel"),
]


def log(*args):
    print(*args, flush=True)


def time_ms(fn, budget_ms=150.0, max_iters=200):
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(5, budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 1
def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: %s | torch %s (CUDA %s) | matmul.allow_tf32=%s "
        "cudnn.allow_tf32=%s" % (
            torch.cuda.get_device_name(0), torch.__version__,
            torch.version.cuda, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32))
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build():
    from paddle_tpu_torch.kernels import build

    t0 = time.perf_counter()
    took = build.build_all()
    secs = time.perf_counter() - t0
    log("build: %d kernel(s) in %.1f s %s" % (len(took), secs, {
        k: round(v, 1) for k, v in took.items()}))
    for name in build.sources():
        for line in _ptxas_summary(build.ptxas_report(name)):
            log("  ptxas %s: %s" % (name, line))
    return secs


def _ptxas_summary(report):
    """One line per compiled kernel from ``-Xptxas=-v``: the kernel, its
    element type and head dim (from the mangled name), its registers and
    its spills."""
    out, kernel, spills = [], "?", "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_(?:fwd|dkv|dq)_kernel)I(\w+?)Li(\d+)E",
                          m.group(1))
            kernel = m.group(1) if k is None else "%s<%s, %s>" % (
                k.group(1), "float" if k.group(2) == "f" else "bfloat16",
                k.group(3))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append("%s: %s registers; %s" % (
                kernel, regs.group(1) if regs else "?", spills))
    return out


# ---------------------------------------------------------------- phase 3
ATTN_CASES = [
    # name, (B, H, S, D), dtype, bias kind, causal
    ("bert_f32", (8, 12, 512, 64), torch.float32, "keypad", False),
    ("bert_bf16", (8, 12, 512, 64), torch.bfloat16, "keypad", False),
    ("causal_f32", (2, 12, 1024, 64), torch.float32, None, True),
    ("ragged200_f32", (2, 12, 200, 64), torch.float32, "full", False),
    ("d128_f32", (4, 8, 512, 128), torch.float32, "keypad", False),
]


def _attn_inputs(shape, dtype, bias_kind, gen, dev):
    B, H, S, D = shape
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    bias = None
    if bias_kind == "keypad":  # 10-40% padded keys per batch row
        bias = torch.zeros(B, 1, 1, S, device=dev)
        pads = torch.randint(S // 10, 2 * S // 5 + 1, (B,), generator=gen,
                             device=dev)
        for b in range(B):
            bias[b, ..., S - int(pads[b]):] = -1e9
    elif bias_kind == "full":
        bias = torch.randn(B, 1, S, S, generator=gen, device=dev)
    return q, k, v, bias


def _attn_bound(shape, dtype, bias, causal):
    B, H, S, D = shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * D * pairs
    nbytes = 4 * B * H * S * D * torch.tensor([], dtype=dtype).element_size()
    nbytes += B * H * S * 4  # lse
    if bias is not None:
        nbytes += bias.numel() * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_kernels(seed):
    from paddle_tpu_torch.ops import attention as attn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for name, shape, dtype, bias_kind, causal in ATTN_CASES:
        q, k, v, bias = _attn_inputs(shape, dtype, bias_kind, gen, dev)
        scale = shape[3] ** -0.5
        before = attn.flash_attention_fwd.launches
        out, lse = attn.flash_attention_fwd(q, k, v, bias, scale, causal)
        torch.cuda.synchronize()
        if attn.flash_attention_fwd.launches != before + 1:
            raise AssertionError("%s: the wrapper did not count its launch"
                                 % name)
        want, want_lse = attn.composed_attention_with_lse(
            q.float(), k.float(), v.float(), bias, scale, causal)
        err_o = float((out.float() - want).abs().max())
        err_lse = float((lse - want_lse).abs().max())
        tol_o, tol_lse = (2e-5, 1e-5) if dtype == torch.float32 else \
            (2e-2, 2e-2)
        ok = err_o <= tol_o and err_lse <= tol_lse and \
            bool(torch.isfinite(out).all())
        ms = time_ms(lambda: attn.flash_attention_fwd(q, k, v, bias, scale,
                                                      causal))
        plain_ms = time_ms(lambda: attn.composed_attention_with_lse(
            q, k, v, bias, scale, causal))
        lib_mask = None if bias is None else bias.to(dtype)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask, is_causal=causal, scale=scale))
        bound_ms, bound_by, flops, nbytes = _attn_bound(shape, dtype, bias,
                                                        causal)
        row = dict(case=name, shape=list(shape), dtype=str(dtype),
                   bias=None if bias is None else list(bias.shape),
                   causal=causal, max_abs_err=err_o, max_abs_err_lse=err_lse,
                   tol=[tol_o, tol_lse], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes,
                   roofline_share=bound_ms / ms, ok=ok)
        rows.append(row)
        log("kernel %-14s %-22s err O %.2e lse %.2e | kernel %.4f ms plain "
            "%.4f ms sdpa %.4f ms | bound %.4f ms (%s) = %.1f%% of roofline"
            "%s" % (name, tuple(shape), err_o, err_lse, ms, plain_ms,
                    library_ms, bound_ms, bound_by, 100 * bound_ms / ms,
                    "" if ok else "  <-- FAILED"))
        del q, k, v, bias, out, lse, want, want_lse
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("flash kernel disagrees with its plain version "
                             "in %s" % bad)
    return rows


# --------------------------------------------------------------- phase 3b
# the cases that also check the raw score grad (a trainable bias's): on
# the causal one the dK/dV kernel skips the tiles above the diagonal
BWD_WANT_DB = {"causal_f32", "ragged200_f32"}


def _bwd_bounds(shape, dtype, bias, causal, want_db):
    """Bounds of the dK/dV and dQ kernels: (ms, bound_by) each. The
    dK/dV kernel does 8 FLOPs per (pair, head-dim element), the dQ
    kernel 6; each reads q, k, v, dO, lse, delta and the bias once and
    writes its outputs once."""
    B, H, S, D = shape
    pairs = S * (S + 1) // 2 if causal else S * S
    esize = torch.tensor([], dtype=dtype).element_size()
    ins = 4 * B * H * S * D * esize + 2 * B * H * S * 4
    if bias is not None:
        ins += bias.numel() * 4
    out = []
    for flops_per, nbytes in (
            (8, ins + 2 * B * H * S * D * esize
             + (B * H * S * S * 4 if want_db else 0)),
            (6, ins + B * H * S * D * esize)):
        t_ops = flops_per * B * H * pairs * D / PEAK_FLOPS[dtype]
        t_bytes = nbytes / PEAK_BYTES
        out.append((max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops >= t_bytes else "bytes"))
    return out


def phase_bwd_kernels(seed):
    from paddle_tpu_torch.ops import attention as attn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rows = []
    for name, shape, dtype, bias_kind, causal in ATTN_CASES:
        want_db = name in BWD_WANT_DB
        q, k, v, bias = _attn_inputs(shape, dtype, bias_kind, gen, dev)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        scale = shape[3] ** -0.5
        f32 = [t.float() for t in (q, k, v, g)]
        o, lse = attn.composed_attention_with_lse(*f32[:3], bias, scale,
                                                  causal)
        delta = torch.sum(f32[3] * o, dim=-1)
        args = (q, k, v, bias, g, lse, delta, scale, causal)
        n_dkv = attn.flash_attention_dkv.launches
        n_dq = attn.flash_attention_dq.launches
        dk, dv, ds = attn.flash_attention_dkv(*args, want_db=want_db)
        dq = attn.flash_attention_dq(*args)
        torch.cuda.synchronize()
        if (attn.flash_attention_dkv.launches, attn.flash_attention_dq
                .launches) != (n_dkv + 1, n_dq + 1):
            raise AssertionError("%s: a backward wrapper did not count its "
                                 "launch" % name)
        # the plain versions on f32 copies of the same inputs
        ref_args = (*f32[:3], bias, f32[3], lse, delta, scale, causal)
        rdk, rdv, rds = attn.flash_attention_dkv_reference(
            *ref_args, want_db=want_db)
        rdq = attn.flash_attention_dq_reference(*ref_args)
        errs = {n: float((a.float() - b).abs().max())
                for n, a, b in (("dq", dq, rdq), ("dk", dk, rdk),
                                ("dv", dv, rdv))}
        if want_db:
            errs["ds"] = float((ds - rds).abs().max())
        tol = BWD_TOL[dtype]
        ok = max(errs.values()) <= tol and all(
            bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        ms_dkv = time_ms(lambda: attn.flash_attention_dkv(
            *args, want_db=want_db))
        ms_dq = time_ms(lambda: attn.flash_attention_dq(*args))
        plain_dkv = time_ms(lambda: attn.flash_attention_dkv_reference(
            *args, want_db=want_db))
        plain_dq = time_ms(lambda: attn.flash_attention_dq_reference(*args))
        # yardstick: the backward alone of one scaled_dot_product_attention
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=None if bias is None else bias.to(dtype),
            is_causal=causal, scale=scale)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (lq, lk, lv), g, retain_graph=True))
        (b_dkv, by_dkv), (b_dq, by_dq) = _bwd_bounds(shape, dtype, bias,
                                                     causal, want_db)
        row = dict(case=name, shape=list(shape), dtype=str(dtype),
                   bias=None if bias is None else list(bias.shape),
                   causal=causal, want_db=want_db, max_abs_err=errs, tol=tol,
                   dkv=dict(ms=ms_dkv, plain_ms=plain_dkv, bound_ms=b_dkv,
                            bound_by=by_dkv, roofline_share=b_dkv / ms_dkv),
                   dq=dict(ms=ms_dq, plain_ms=plain_dq, bound_ms=b_dq,
                           bound_by=by_dq, roofline_share=b_dq / ms_dq),
                   library_ms=library_ms, ok=ok)
        rows.append(row)
        log("bwd %-14s %-22s err %s | dkv %.4f ms (plain %.4f, bound %.4f "
            "%s, %.1f%%) | dq %.4f ms (plain %.4f, bound %.4f %s, %.1f%%) | "
            "sdpa bwd %.4f ms%s" % (
                name, tuple(shape),
                " ".join("%s %.2e" % kv for kv in errs.items()), ms_dkv,
                plain_dkv, b_dkv, by_dkv, 100 * b_dkv / ms_dkv, ms_dq,
                plain_dq, b_dq, by_dq, 100 * b_dq / ms_dq, library_ms,
                "" if ok else "  <-- FAILED"))
        del q, k, v, g, bias, f32, o, lse, delta, args, ref_args, dk, dv, ds
        del dq, rdk, rdv, rds, rdq, lq, lk, lv, lib_out
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("flash backward kernels disagree with their "
                             "plain versions in %s" % bad)
    return rows


# ---------------------------------------------------------------- phase 4
def _encoder_output(program):
    """The encoder output [B, S, d_model]: the X of the reshape2 that
    feeds the MLM head's gather (models/bert.py)."""
    blk = program.global_block()
    gather = next(op for op in blk.ops if op.type == "gather")
    flat = gather.input("X")[0]
    reshape = next(op for op in blk.ops
                   if op.type == "reshape2" and flat in op.output("Out"))
    return blk.var(reshape.input("X")[0])


def _request(batch, cfg, rs):
    mask = np.ones((batch, SEQ), "float32")
    for i in range(batch):  # 10-40% of each row is padding
        mask[i, SEQ - rs.randint(SEQ // 10, 2 * SEQ // 5 + 1):] = 0.0
    return {"src_ids": rs.randint(0, cfg["vocab"], (batch, SEQ)).astype(
                "int64"),
            "sent_ids": rs.randint(0, 2, (batch, SEQ)).astype("int64"),
            "input_mask": mask}


def phase_serve(workdir, seed):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as attn

    cfg = bert.base_config()
    feeds = ["src_ids", "sent_ids", "input_mask"]
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bert.build(cfg, seq_len=SEQ, is_test=True)
    enc = _encoder_output(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(workdir, feeds, [enc], exe,
                                      main_program=main)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    del scope, exe
    torch.cuda.empty_cache()
    log("serve: BERT-base %s built, started on the card and saved in "
        "%.1f s (%d parameters)" % (
            {k: cfg[k] for k in ("n_layer", "d_model", "n_head", "d_ff",
                                 "vocab")},
            time.perf_counter() - t0, n_params))

    config = fluid.inference.AnalysisConfig(workdir)
    config.warmup_batch_sizes = list(BUCKETS)
    rs = np.random.RandomState(seed)
    reqs = [_request(b, cfg, rs) for b in REQUESTS]

    # ---- the main path: counts zeroed here, read after the last request
    os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)  # static threshold
    attn.flash_attention_fwd.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = fluid.inference.create_paddle_predictor(config)
    init_s = time.perf_counter() - t0
    per_dispatch = cfg["n_layer"]  # one fused_attention per layer
    if attn.flash_attention_fwd.launches != per_dispatch * len(BUCKETS):
        raise AssertionError("warmup launched the flash kernel %d times, "
                             "expected %d" % (attn.flash_attention_fwd
                                              .launches,
                                              per_dispatch * len(BUCKETS)))
    answers, lat_ms = [], []
    for req in reqs:
        b = req["src_ids"].shape[0]
        lat_ms.append([])
        for rep in range(REPEATS):
            before = attn.flash_attention_fwd.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (out,) = pred.run(req)
            torch.cuda.synchronize()
            lat_ms[-1].append((time.perf_counter() - t0) * 1e3)
            got = attn.flash_attention_fwd.launches - before
            if got != per_dispatch:  # one dispatch per request
                raise AssertionError("batch %d: %d flash launches, "
                                     "expected %d" % (b, got, per_dispatch))
            if rep == 0:
                if out.shape != (b, SEQ, cfg["d_model"]) or \
                        not np.isfinite(out).all():
                    raise AssertionError("batch %d: bad output %s finite=%s"
                                         % (b, out.shape,
                                            np.isfinite(out).all()))
                answers.append(out)
            elif not np.array_equal(out, answers[-1]):
                raise AssertionError("batch %d: a repeated request gave "
                                     "another answer" % b)
    launches = attn.flash_attention_fwd.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # ---- end of the main path

    os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = "100000"  # composed on card
    try:
        diffs = []
        for req, out in zip(reqs, answers):
            (ref,) = pred.run(req)
            diffs.append(float(np.abs(out - ref).max()))
    finally:
        os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
    if attn.flash_attention_fwd.launches != launches:
        raise AssertionError("the composed path launched the flash kernel")
    for b, lat, d in zip(REQUESTS, lat_ms, diffs):
        log("serve: batch %d (bucket %d) latency median %.3f ms, max %.3f "
            "ms over %d requests; max |flash - composed| = %.3e"
            % (b, pred.bucket_for(b) or b, float(np.median(lat)), max(lat),
               len(lat), d))
    log("serve: predictor init (3 warmup dispatches) %.2f s; %d flash "
        "launches on the main path; peak device memory %.1f MiB"
        % (init_s, launches, peak_mb))
    if max(diffs) > SERVE_ATOL:
        raise AssertionError("flash and composed answers differ by %.3e > "
                             "%.0e" % (max(diffs), SERVE_ATOL))
    return dict(requests=REQUESTS, buckets=BUCKETS, latency_ms=lat_ms,
                max_abs_diff_vs_composed=diffs, init_s=init_s,
                launches=launches, peak_mem_mib=peak_mb,
                n_params=n_params), pred, reqs


# ---------------------------------------------------------------- phase 5
def _kernel_class(name):
    if "flash_fwd" in name:
        return "flash fwd"
    if "flash_dkv" in name or "flash_dq" in name:
        return "flash bwd"
    if any(t in name for t in ("gemm", "cutlass", "cublas", "xmma")):
        return "matmul"
    return "other"


def _device_breakdown(prof, wall_us):
    """Device busy time (union of kernel intervals) and device time by
    kernel class and by kernel, from one torch.profiler window."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    by_class, by_name = {}, {}
    for s0, s1, name in spans:
        d = s1 - s0
        by_class[_kernel_class(name)] = by_class.get(
            _kernel_class(name), 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        if end is None or s0 >= end:
            busy += d
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share=busy / wall_us, kernels=len(spans),
                by_class_ms={k: v / 1e3 for k, v in by_class.items()},
                top_kernels_ms=[(n[:80], v / 1e3) for n, v in top])


def _log_breakdown(what, r):
    log("profile: %s wall %.3f ms, device busy %.3f ms (%.1f%%), %d kernels; "
        "%s" % (what, r["wall_ms"], r["device_busy_ms"],
                100 * r["busy_share"], r["kernels"],
                {k: round(v, 3) for k, v in r["by_class_ms"].items()}))
    for n, v in r["top_kernels_ms"]:
        log("  %8.3f ms  %s" % (v, n[:100]))


def _profiled(fn):
    """torch.profiler (CPU + CUDA) around one synchronized call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _device_breakdown(prof, wall_us)


def phase_profile(pred, reqs):
    """One profiled request per batch size: the device's busy share and
    its time by kernel class and by kernel."""
    out = {}
    for req in reqs:
        b = req["src_ids"].shape[0]
        pred.run(req)
        torch.cuda.synchronize()
        out[b] = _profiled(lambda: pred.run(req))
        _log_breakdown("batch %d" % b, out[b])
    return out


# ---------------------------------------------------------------- phase 6
def _train_batch(cfg, rs):
    """One synthetic MLM batch: 10-40% padding per row; 15% of the real
    tokens masked (capped at MAX_MASK), their ids replaced by [MASK]
    (103) and kept as labels; unused mask slots point at position 0 with
    weight 0."""
    src = rs.randint(0, cfg["vocab"], (TRAIN_BATCH, SEQ)).astype("int64")
    mask = np.ones((TRAIN_BATCH, SEQ), "float32")
    pos = np.zeros((TRAIN_BATCH, MAX_MASK), "int64")
    label = np.zeros((TRAIN_BATCH, MAX_MASK), "int64")
    weight = np.zeros((TRAIN_BATCH, MAX_MASK), "float32")
    for i in range(TRAIN_BATCH):
        real = SEQ - rs.randint(SEQ // 10, 2 * SEQ // 5 + 1)
        mask[i, real:] = 0.0
        n = min(MAX_MASK, int(round(0.15 * real)))
        picks = rs.choice(real, n, replace=False)
        pos[i, :n] = i * SEQ + picks
        label[i, :n] = src[i, picks]
        weight[i, :n] = 1.0
        src[i, picks] = min(103, cfg["vocab"] - 1)
    return {"src_ids": src,
            "sent_ids": rs.randint(0, 2, (TRAIN_BATCH, SEQ)).astype("int64"),
            "input_mask": mask, "mask_pos": pos, "mask_label": label,
            "mask_weight": weight}


def _snapshot(scope):
    """The scope's values by name. The executor replaces scope values
    and never updates them in place, so this is the state as it is now."""
    return {n: scope.find_var(n) for n in scope.local_var_names()}


def _restored(snap):
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    for n, v in snap.items():
        scope.set_var(n, v)
    return scope


def _op_class(op_type):
    from paddle_tpu_torch.core.registry import get_op

    if op_type in ("adam", "sgd", "momentum"):
        return "optimizer"
    if not op_type.endswith("_grad"):
        return "forward"
    if get_op(op_type[:-len("_grad")]).grad_lowering is not None:
        return "grad (custom)"
    return "grad (generic vjp)"


def _host_breakdown(run_step):
    """The host's time in each op lowering during one step, by class: a
    wrapper times ``core.lowering.lower_op`` without synchronizing, so
    each number is the time the host spends issuing that op's work."""
    from paddle_tpu_torch.core import lowering

    by = {}
    orig = lowering.lower_op

    def timed(ctx, op, env):
        t = time.perf_counter()
        orig(ctx, op, env)
        n, ms = by.get(_op_class(op.type), (0, 0.0))
        by[_op_class(op.type)] = (n + 1, ms + (time.perf_counter() - t) * 1e3)

    lowering.lower_op = timed
    try:
        t0 = time.perf_counter()
        run_step()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        lowering.lower_op = orig
    out = {k: dict(ops=n, host_ms=ms, ms_per_op=ms / n)
           for k, (n, ms) in sorted(by.items())}
    log("train: host time by op class in one step (wall %.3f ms): %s" % (
        wall, "; ".join("%s %d ops %.3f ms (%.4f ms/op)"
                        % (k, v["ops"], v["host_ms"], v["ms_per_op"])
                        for k, v in out.items())))
    return dict(wall_ms=wall, by_class=out)


def _counts(attn):
    return (attn.flash_attention_fwd.launches,
            attn.flash_attention_dkv.launches,
            attn.flash_attention_dq.launches)


def _grad_parity(flash, composed):
    """Each param's grad on the flash path against the composed one: the
    worst l2 relative difference (the gate) and the worst relative
    difference of the largest element, each as (param, value)."""
    l2, top = ("", 0.0), ("", 0.0)
    for n, c in composed.items():
        d = flash[n] - c
        r2 = float(np.linalg.norm(d) / max(np.linalg.norm(c), 1e-30))
        rt = float(np.abs(d).max() / max(np.abs(c).max(), 1e-30))
        l2 = max(l2, (n, r2), key=lambda t: t[1])
        top = max(top, (n, rt), key=lambda t: t[1])
    return l2, top


def phase_train(seed):
    """BERT-base MLM training through the port's entry points: layers,
    ``Adam.minimize``, ``Executor.run`` on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import attention as attn

    cfg = bert.base_config()
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = bert.build(cfg, seq_len=SEQ, max_mask=MAX_MASK)
        _, params_grads = fluid.optimizer.Adam(
            learning_rate=TRAIN_LR).minimize(loss)
    ops = [op.type for op in main.global_block().ops]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    grads = {g.name: p.name for p, g in params_grads}
    rs = np.random.RandomState(seed)
    batches = [_train_batch(cfg, rs) for _ in range(4)]
    log("train: BERT %s MLM, S = %d, batch %d, %d masked slots: %d ops (%d "
        "grad ops, %d adam, %d fused_attention_grad), %d parameters; built "
        "and started in %.1f s" % (
            {k: cfg[k] for k in ("n_layer", "d_model", "n_head", "d_ff",
                                 "vocab")}, SEQ, TRAIN_BATCH, MAX_MASK,
            len(ops), sum(t.endswith("_grad") for t in ops),
            ops.count("adam"), ops.count("fused_attention_grad"),
            sum(int(np.prod(main.global_block().var(n).shape))
                for n in params), time.perf_counter() - t0))

    def step(sc, feed, fetch=()):
        """One step; its loss, and the values of ``fetch`` when asked."""
        vals = exe.run(main, feed=feed, fetch_list=[loss, *fetch], scope=sc)
        torch.cuda.synchronize()
        val = float(np.asarray(vals[0]).reshape(()))
        return (val, vals[1:]) if fetch else val

    per_step = (2 * cfg["n_layer"], cfg["n_layer"], cfg["n_layer"])
    # ---- the main path: counts zeroed here, read after the last step
    os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)  # static threshold
    attn.flash_attention_fwd.launches = 0
    attn.flash_attention_dkv.launches = 0
    attn.flash_attention_dq.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        before = _counts(attn)
        t1 = time.perf_counter()
        val = step(scope, batches[i % len(batches)])
        if i >= WARMUP_STEPS:
            step_ms.append((time.perf_counter() - t1) * 1e3)
        got = tuple(a - b for a, b in zip(_counts(attn), before))
        if got != per_step:
            raise AssertionError("step %d launched (fwd, dkv, dq) = %s "
                                 "kernels, expected %s" % (i, got, per_step))
        if not np.isfinite(val):
            raise AssertionError("step %d: loss %r is not finite" % (i, val))
        losses.append(val)
    launches = _counts(attn)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    # ---- end of the main path

    # one step, twice, from the same scope: bitwise the same
    snap = _snapshot(scope)
    runs = []
    for _ in range(2):
        sc = _restored(snap)
        val = step(sc, batches[0])
        runs.append((val, {n: sc.find_var(n) for n in params}))
    bitwise = runs[0][0] == runs[1][0] and all(
        torch.equal(runs[0][1][n], runs[1][1][n]) for n in params)
    if not bitwise:
        raise AssertionError("one step from one scope gave two results: "
                             "loss %r / %r" % (runs[0][0], runs[1][0]))

    # the flash path against the composed one, from the same scope and
    # RNG state (so the same dropout masks): the first step's param grads,
    # then the losses and params of PARITY_STEPS steps
    paths = {}
    for name, min_seq in (("flash", None), ("composed", "100000")):
        if min_seq is not None:
            os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = min_seq
        try:
            sc = _restored(snap)
            before = _counts(attn)
            first, gvals = step(sc, batches[0], list(grads))
            ls = [first] + [step(sc, batches[i % len(batches)])
                            for i in range(1, PARITY_STEPS)]
        finally:
            os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
        if min_seq is not None and _counts(attn) != before:
            raise AssertionError("the composed path launched a flash kernel")
        ps = {n: sc.find_var(n) for n in params}
        finite = np.isfinite(ls).all() and all(
            np.isfinite(v).all() for v in gvals) and all(
            bool(torch.isfinite(v).all()) for v in ps.values())
        if not finite:
            raise AssertionError("the %s path gave a value that is not "
                                 "finite" % name)
        paths[name] = (ls, dict(zip(grads.values(), gvals)), ps)
    flash, composed = paths["flash"], paths["composed"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(flash[0], composed[0]))
    grad_l2, grad_top = _grad_parity(flash[1], composed[1])
    param_diff = max(float((flash[2][n] - composed[2][n]).abs().max())
                     for n in params)
    del runs, paths, flash, composed, sc

    host = _host_breakdown(lambda: step(scope, batches[0]))
    prof = _profiled(lambda: step(scope, batches[1]))
    _log_breakdown("train step", prof)

    med = float(np.median(step_ms))
    tokens_per_s = TRAIN_BATCH * SEQ / (med / 1e3)
    log("train: losses %s" % ["%.4f" % v for v in losses])
    log("train: step median %.3f ms, max %.3f ms over %d steps; %.1f "
        "tokens/s; launches (fwd, dkv, dq) %s on the main path; peak device "
        "memory %.1f MiB" % (med, max(step_ms), len(step_ms), tokens_per_s,
                             launches, peak_mb))
    log("train: one step twice from one scope: bitwise equal; flash vs "
        "composed: param grads worst l2 rel diff %.3e (%s, <= %.0e), worst "
        "max-element rel diff %.3e (%s); over %d steps loss rel diff %.3e "
        "(<= %.0e), param max |diff| %.3e (<= %.0e)" % (
            grad_l2[1], grad_l2[0], PARITY_GRAD_L2, grad_top[1], grad_top[0],
            PARITY_STEPS, loss_rel, PARITY_LOSS_RTOL, param_diff,
            PARITY_PARAM_ATOL))
    if grad_l2[1] > PARITY_GRAD_L2 or loss_rel > PARITY_LOSS_RTOL or \
            param_diff > PARITY_PARAM_ATOL:
        raise AssertionError("flash and composed training disagree")
    return dict(ops=len(ops), adam_ops=ops.count("adam"),
                grad_ops=sum(t.endswith("_grad") for t in ops),
                losses=losses, step_ms=step_ms, step_ms_median=med,
                tokens_per_s=tokens_per_s, launches=launches,
                peak_mem_mib=peak_mb, bitwise_repeatable=bitwise,
                parity=dict(steps=PARITY_STEPS, loss_rel=loss_rel,
                            param_max_abs=param_diff,
                            grad_l2_rel=grad_l2, grad_max_rel=grad_top),
                host=host, profile=prof)


def _kernel_row(name, source, replaces, launches, by_path, err, t,
                library_ms):
    return dict(name=name, ported=True, route="cuda", source=source,
                replaces=replaces, launches=launches,
                launches_by_path=by_path, max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=library_ms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement to "
                    "OUT/chip_smoke.json")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the weights and the synthetic batches "
                    "(default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_card()
    build_s = phase_build()
    rows = phase_kernels(args.seed)
    bwd_rows = phase_bwd_kernels(args.seed)
    with tempfile.TemporaryDirectory() as workdir:
        serve, pred, reqs = phase_serve(workdir, args.seed)
    profile = phase_profile(pred, reqs)
    del pred
    torch.cuda.empty_cache()
    train = phase_train(args.seed)

    # the main paths' shape: [8, 12, 512, 64] f32
    fwd, bwd = rows[0], bwd_rows[0]
    fwd_train, dkv_train, dq_train = train["launches"]
    kernels = [
        _kernel_row("flash_attention_fwd",
                    "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
                    "paddle_tpu/ops/attention.py:281",
                    serve["launches"] + fwd_train,
                    dict(serve=serve["launches"], train=fwd_train),
                    fwd["max_abs_err"], fwd, fwd["library_ms"]),
        _kernel_row("flash_attention_dkv",
                    "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                    "paddle_tpu/ops/attention.py:383", dkv_train,
                    dict(train=dkv_train),
                    max(bwd["max_abs_err"][n] for n in ("dk", "dv")),
                    bwd["dkv"], bwd["library_ms"]),
        _kernel_row("flash_attention_dq",
                    "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                    "paddle_tpu/ops/attention.py:432", dq_train,
                    dict(train=dq_train), bwd["max_abs_err"]["dq"],
                    bwd["dq"], bwd["library_ms"]),
    ]
    not_ported = [dict(name=n, tpu=t, ported=False) for n, t in NOT_PORTED]
    log("chip_smoke: all phases passed in %.1f s"
        % (time.perf_counter() - t_start))

    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__,
                           build_s=build_s, kernel_cases=rows,
                           bwd_kernel_cases=bwd_rows, serve=serve,
                           profile=profile, train=train, kernels=kernels,
                           not_ported=not_ported), f, indent=1)
    log(json.dumps({"kernels": kernels, "not_ported": not_ported}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
