"""Detection ops and image interpolation: the port of
paddle_tpu/ops/detection_ops.py, all 22 of its ops.

Each is plain torch math, as each is plain jnp / lax there (the JAX
package computes none of them in a Pallas kernel), with the JAX
lowerings' dense, fixed-shape contracts: ``multiclass_nms`` emits
[keep_top_k, 6] rows (class, score, box) padded with class -1,
``generate_proposals`` zero-padded [N, post_nms_topN] rois, the
sampling ops fixed-size index sets padded with -1. Where the JAX
lowering ``vmap``s over images or classes the port computes the batch
at once; its ``fori_loop``s (greedy NMS, greedy bipartite matching)
are Python loops of the same static length over whole batches, so
every count stays a mask on the device and a plan holding these ops is
captured as a CUDA graph (no value is read on the host).

Ties break as JAX's do: every ``lax.top_k`` and ``jnp.argsort`` is a
stable ``torch.sort`` (``top_k`` puts the lower index first among equal
values), ``jnp.sort(x)[::-1]`` a stable ascending sort flipped, and
``torch.argmax`` takes the first maximum as ``jnp.argmax`` does.
Greedy NMS computes the IoU of every candidate pair once, before its
loop, with the JAX loop body's arithmetic, so each step is a few small
kernels (five a step without ``nms_eta``). Gathers index with advanced
indexing, whose autograd backward sums repeated rows in a fixed order
on CUDA, so the grads of ``roi_align``, ``roi_pool``, ``ssd_loss`` and
``yolov3_loss`` (the generic ``torch.func.vjp`` grad) repeat bitwise.
The random samplers (``rpn_target_assign``,
``generate_proposal_labels``) draw their priorities from the port's
generator chain (held by their properties, and bitwise within the port).

``box_decoder_and_assign`` takes a scalar ``box_clip`` (what its layer
passes) as the clip of the decoded log-sizes; the JAX lowering iterates
that attr and raises on a scalar, clipping at 4.135 only where it is a
list or absent, which the port follows (ROADMAP §C).

The interpolations use the JAX package's own source-index formulas,
NCHW: ``align_corners`` (default True) maps the corners onto each
other, dst * (src - 1) / (dst - 1) per axis (an axis of one output
keeps the other formula); without it bilinear takes max((dst + 0.5) *
src / dst - 0.5, 0), and nearest rounds half to even with align, floors
dst * src / dst without. ``F.interpolate`` rounds and clamps otherwise,
so it is not used. ``_interp_sizes`` is the JAX package's, unchanged
(tests/test_torch_isolation.py pins it).
"""

from __future__ import annotations

import math

import numpy as np
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


# ------------------------------------------------------------- helpers
def _const(ctx, values, device, dtype=torch.float32):
    """A constant made from attrs (a list, or a host tensor built from
    them) on ``device``: a host copy cannot be captured, so on a CUDA
    graph's path the graph keeps it on the card (as ``assign_value``
    does)."""
    host = values if isinstance(values, torch.Tensor) else torch.tensor(
        values, dtype=dtype)
    if ctx.graph is not None:
        return ctx.graph.constant(host, device)
    return host.to(device)


def _variances(ctx, variances, cells, device):
    """A prior table's Variances: the four attrs at every cell, [*cells,
    4], a constant on ``device``."""
    return _const(ctx, torch.tensor(variances, dtype=torch.float32).expand(
        *cells, 4).contiguous(), device)


def _top_k(x, k):
    """``lax.top_k`` along the last axis: the k largest, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _batch_rows(n, device):
    """[n, 1] row ids for gathering along dim 1 of a batch."""
    return torch.arange(n, device=device)[:, None]


def _greedy_nms(boxes, valid, thresh, eta=1.0, off=0.0):
    """The JAX package's greedy NMS over lanes: ``boxes`` [L, n, 4]
    pre-sorted by score (descending) in each lane, ``valid`` [L, n].
    Candidate i is kept iff its IoU with every kept j < i is <= the
    lane's threshold, which decays by eta after each kept box while eta
    < 1 and it is > 0.5. Returns the keep mask [L, n]."""
    lanes, n = boxes.shape[0], boxes.shape[1]
    iou = _pairwise_iou_xyxy(boxes, boxes, off)           # [L, n, n]
    keep = torch.zeros((lanes, n), dtype=torch.bool, device=boxes.device)
    thr = torch.full((lanes,), thresh, dtype=torch.float32,
                     device=boxes.device)
    decays = eta < 1.0
    for i in range(n):
        mx = torch.where(keep, iou[:, i], 0.0).amax(-1)
        ok = (mx <= thr) & valid[:, i]
        keep[:, i] = ok
        if decays:
            thr = torch.where(ok & (thr > 0.5), thr * eta, thr)
    return keep


def _pairwise_iou_xyxy(a, b, off=0.0):
    """[..., G, 4] x [..., P, 4] -> [..., G, P] IoU (xyxy; ``off`` 1 for
    pixel boxes, whose sides count both end pixels)."""
    def side(hi, lo):
        return torch.clamp(hi - lo + off if off else hi - lo, min=0)

    def area(t):
        return side(t[..., 2], t[..., 0]) * side(t[..., 3], t[..., 1])

    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = side(ix2, ix1) * side(iy2, iy1)
    del ix1, iy1, ix2, iy2
    return inter / torch.clamp(area(a)[..., :, None] + area(b)[..., None, :]
                               - inter, min=1e-10)


def _greedy_bipartite(dist, valid_rows):
    """bipartite_match_op.cc's greedy core over a batch: G times take the
    batch row's global max cell (the first, row-major, among equal
    ones), binding its row to its column while it is > 0. dist [B, G,
    P], valid_rows [B, G] bool. Returns each column's matched row (-1
    unmatched, int32) and distance, [B, P]."""
    B, G, P = dist.shape
    dev = dist.device
    d = torch.where(valid_rows[:, :, None], dist, -1.0)
    match = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((B, P), dtype=torch.float32, device=dev)
    rows = torch.arange(G, device=dev)
    cols = torch.arange(P, device=dev)
    for _ in range(G):
        flat_d = d.reshape(B, G * P)
        flat = flat_d.argmax(-1)
        gi, pi = flat // P, flat % P
        best = flat_d.gather(1, flat[:, None])[:, 0]
        take = (best > 0.0)[:, None]
        col_hit = (cols == pi[:, None]) & take             # [B, P]
        row_hit = (rows == gi[:, None]) & take             # [B, G]
        match = torch.where(col_hit, gi[:, None].to(torch.int32), match)
        mdist = torch.where(col_hit, best[:, None].to(torch.float32), mdist)
        d = torch.where(row_hit[:, :, None] | col_hit[:, None, :], -1.0, d)
    return match, mdist


def _sce(x, label):
    """Numerically stable sigmoid cross entropy (yolov3_loss_op.h):
    max(x, 0) - x * z + log(1 + exp(-|x|))."""
    return torch.clamp(x, min=0.0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))


# ----------------------------------------------------------- SSD path
@register_op("prior_box", no_grad=True)
def _prior_box(ctx, ins, attrs):
    """prior_box_op.cc: SSD priors over the feature map's grid, Boxes and
    Variances [H, W, P, 4] (normalized xyxy). The table depends on
    shapes and attrs alone: it is built on the host in f32 and put on
    the device as a constant, so every device gives the CPU's bits."""
    feat = ins["Input"][0]
    image = ins["Image"][0]
    min_sizes = [float(v) for v in attrs["min_sizes"]]
    max_sizes = [float(v) for v in attrs.get("max_sizes", [])]
    ratios = [float(v) for v in attrs.get("aspect_ratios", [1.0])]
    flip = bool(attrs.get("flip", False))
    clip = bool(attrs.get("clip", False))
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = float(attrs.get("offset", 0.5))
    step_w = float(attrs.get("step_w", 0.0))
    step_h = float(attrs.get("step_h", 0.0))
    H, W = int(feat.shape[2]), int(feat.shape[3])
    IH, IW = int(image.shape[2]), int(image.shape[3])
    if step_w <= 0:
        step_w = IW / W
    if step_h <= 0:
        step_h = IH / H

    ars = [1.0]
    for r in ratios:
        if all(abs(r - a) > 1e-6 for a in ars):
            ars.append(r)
            if flip:
                ars.append(1.0 / r)
    whs = []
    for ms in min_sizes:
        whs.append((ms, ms))
        for r in ars:
            if abs(r - 1.0) < 1e-6:
                continue
            whs.append((ms * (r ** 0.5), ms / (r ** 0.5)))
        if max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            whs.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
    P = len(whs)

    cx = (torch.arange(W, dtype=torch.float32) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32) + offset) * step_h
    cx = cx[None, :, None].expand(H, W, P)
    cy = cy[:, None, None].expand(H, W, P)
    bw = torch.tensor([w for w, _ in whs], dtype=torch.float32) / 2.0
    bh = torch.tensor([h for _, h in whs], dtype=torch.float32) / 2.0
    boxes = torch.stack([(cx - bw) / IW, (cy - bh) / IH,
                         (cx + bw) / IW, (cy + bh) / IH], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return {"Boxes": [_const(ctx, boxes, feat.device)],
            "Variances": [_variances(ctx, variances, (H, W, P),
                                     feat.device)]}


@register_op("iou_similarity", no_grad=True)
def _iou_similarity(ctx, ins, attrs):
    """iou_similarity_op.cc: pairwise IoU of [N, 4] x [M, 4] xyxy boxes."""
    return {"Out": [_pairwise_iou_xyxy(ins["X"][0], ins["Y"][0])]}


@register_op("box_coder", no_grad=True)
def _box_coder(ctx, ins, attrs):
    """box_coder_op.cc: encode boxes [N, 4] against priors [M, 4] into
    [N, M, 4] center-size offsets, or decode offsets [N, M, 4] (or [M,
    4]) back into boxes."""
    prior = ins["PriorBox"][0]
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else None
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    one = 0 if bool(attrs.get("box_normalized", True)) else 1
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if pvar is None:
        pvar = torch.ones((prior.shape[0], 4), dtype=prior.dtype,
                          device=prior.device)
    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + one
        th = target[:, 3] - target[:, 1] + one
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / pvar[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / pvar[None, :, 1]
        ow = torch.log(tw[:, None] / pw[None, :]) / pvar[None, :, 2]
        oh = torch.log(th[:, None] / ph[None, :]) / pvar[None, :, 3]
        return {"OutputBox": [torch.stack([ox, oy, ow, oh], dim=-1)]}
    t = target if target.ndim == 3 else target[None]
    dcx = t[..., 0] * pvar[None, :, 0] * pw[None, :] + pcx[None, :]
    dcy = t[..., 1] * pvar[None, :, 1] * ph[None, :] + pcy[None, :]
    dw = torch.exp(t[..., 2] * pvar[None, :, 2]) * pw[None, :]
    dh = torch.exp(t[..., 3] * pvar[None, :, 3]) * ph[None, :]
    out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                       dcx + dw * 0.5 - one, dcy + dh * 0.5 - one], dim=-1)
    return {"OutputBox": [out if target.ndim == 3 else out[0]]}


@register_op("multiclass_nms", no_grad=True)
def _multiclass_nms(ctx, ins, attrs):
    """multiclass_nms_op.cc, static-shape: per (image, class) lane the
    nms_top_k best scores (those under score_threshold set to -1), greedy
    NMS over all lanes at once, then per image the keep_top_k best kept
    rows (class, score, x1, y1, x2, y2) of all classes, padded with -1;
    a dropped candidate's row keeps its box. The background class
    (background_label) is never kept."""
    boxes = ins["BBoxes"][0]     # [M, 4] or [B, M, 4]
    scores = ins["Scores"][0]    # [C, M] or [B, C, M]
    batched = boxes.ndim == 3
    if not batched:
        boxes, scores = boxes[None], scores[None]
    score_thresh = float(attrs.get("score_threshold", 0.0))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    nms_eta = float(attrs.get("nms_eta", 1.0))
    background = int(attrs.get("background_label", -1))
    B, C, M = scores.shape
    K = min(nms_top_k, M)
    dev = boxes.device

    s = torch.where(scores >= score_thresh, scores, -1.0)
    top_s, top_i = _top_k(s, K)                            # [B, C, K]
    cand = boxes[torch.arange(B, device=dev)[:, None, None], top_i]
    cls = torch.arange(C, dtype=boxes.dtype, device=dev)[None, :, None]
    valid = (top_s > -1.0) & (cls != background)
    keep = _greedy_nms(cand.reshape(B * C, K, 4), valid.reshape(B * C, K),
                       nms_thresh, eta=nms_eta).reshape(B, C, K)
    rows = torch.cat([torch.where(keep, cls, -1.0)[..., None],
                      torch.where(keep, top_s, -1.0)[..., None], cand],
                     dim=-1).reshape(B, C * K, 6)
    k = min(keep_top_k, C * K)
    _, order = _top_k(torch.where(rows[..., 0] >= 0, rows[..., 1], -1.0), k)
    out = rows[_batch_rows(B, dev), order]
    if keep_top_k > k:
        out = torch.cat([out, torch.full((B, keep_top_k - k, 6), -1.0,
                                         dtype=out.dtype, device=dev)], 1)
    return {"Out": [out if batched else out[0]]}


@register_op("bipartite_match", no_grad=True)
def _bipartite_match(ctx, ins, attrs):
    """bipartite_match_op.cc: DistMat [B, G, P] (dense batch; a row with
    no positive distance is padding). match_type='per_prediction' also
    assigns each unmatched column whose best row distance reaches
    dist_threshold (ssd_loss's matching)."""
    dist = ins["DistMat"][0]
    if dist.ndim == 2:
        dist = dist[None]
    valid = (dist > 0).any(dim=2)
    match, mdist = _greedy_bipartite(dist, valid)
    if attrs.get("match_type", "bipartite") == "per_prediction":
        thresh = float(attrs.get("dist_threshold", 0.5))
        best_val = dist.amax(dim=1)
        best_row = dist.argmax(dim=1).to(torch.int32)
        extra = (match < 0) & (best_val >= thresh)
        match = torch.where(extra, best_row, match)
        mdist = torch.where(extra, best_val, mdist)
    return {"ColToRowMatchIndices": [match], "ColToRowMatchDist": [mdist]}


@register_op("target_assign", no_grad=True)
def _target_assign(ctx, ins, attrs):
    """target_assign_op.cc: prior p with match[p] = g >= 0 takes X[b, g]
    (weight 1); a mismatch takes ``mismatch_value`` (weight 0)."""
    x = ins["X"][0]                    # [B, G, K]
    match = ins["MatchIndices"][0]     # [B, P]
    mis = float(attrs.get("mismatch_value", 0.0))
    if not x.is_floating_point():
        x = x.to(torch.float32)
    gathered = x[_batch_rows(x.shape[0], x.device),
                 torch.clamp(match.long(), min=0)]
    hit = (match >= 0)[:, :, None]
    return {"Out": [torch.where(hit, gathered, mis)],
            "OutWeight": [hit.to(torch.float32)]}


@register_op("ssd_loss", diff_inputs=["Location", "Confidence"])
def _ssd_loss(ctx, ins, attrs):
    """ssd_loss (the reference's detection.py composition, fused), over
    the batch at once: IoU -> greedy bipartite then per-prediction
    matching -> encoded location targets -> smooth L1 on positives +
    softmax CE with hard negative mining (neg_pos_ratio negatives a
    positive, the largest CE first), per image over its positive count.
    Dense gt: [B, G, 4] boxes with zero-area rows as padding, labels
    [B, G]. Loss [B]."""
    loc = ins["Location"][0]           # [B, P, 4]
    conf = ins["Confidence"][0].to(torch.float32)   # [B, P, C]
    gt_box = ins["GTBox"][0].to(torch.float32)      # [B, G, 4]
    gt_label = ins["GTLabel"][0]       # [B, G]
    prior = ins["PriorBox"][0]         # [P, 4]
    pvar = (ins.get("PriorBoxVar") or [None])[0]
    background = int(attrs.get("background_label", 0))
    overlap_t = float(attrs.get("overlap_threshold", 0.5))
    neg_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    loc_w = float(attrs.get("loc_loss_weight", 1.0))
    conf_w = float(attrs.get("conf_loss_weight", 1.0))
    B, P, C = conf.shape
    dev = conf.device
    if pvar is None:
        pvar = torch.ones((P, 4), dtype=torch.float32, device=dev)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5

    valid = (gt_box[..., 2] - gt_box[..., 0] > 0) & (
        gt_box[..., 3] - gt_box[..., 1] > 0)               # [B, G]
    iou = torch.where(valid[:, :, None], _pairwise_iou_xyxy(gt_box, prior),
                      0.0)                                 # [B, G, P]
    match, _ = _greedy_bipartite(iou, valid)
    best_row = iou.argmax(dim=1).to(torch.int32)
    best_val = iou.amax(dim=1)
    match = torch.where((match < 0) & (best_val >= overlap_t), best_row,
                        match)
    pos = match >= 0
    rows = _batch_rows(B, dev)
    g = torch.clamp(match.long(), min=0)

    gb = gt_box[rows, g]                                   # [B, P, 4]
    gw = gb[..., 2] - gb[..., 0]
    gh = gb[..., 3] - gb[..., 1]
    gcx = gb[..., 0] + gw * 0.5
    gcy = gb[..., 1] + gh * 0.5
    tx = (gcx - pcx) / pw / pvar[:, 0]
    ty = (gcy - pcy) / ph / pvar[:, 1]
    tw = torch.log(torch.clamp(gw / pw, min=1e-10)) / pvar[:, 2]
    th = torch.log(torch.clamp(gh / ph, min=1e-10)) / pvar[:, 3]
    ad = torch.abs(loc - torch.stack([tx, ty, tw, th], dim=-1))
    smooth = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5)
    loc_loss = torch.where(pos[..., None], smooth, 0.0).sum(dim=(1, 2))

    labels = torch.where(pos, gt_label[rows, g].to(torch.int32), background)
    logp = torch.log_softmax(conf, dim=-1)
    ce = -logp[rows, torch.arange(P, device=dev)[None, :], labels.long()]
    npos = pos.to(torch.int32).sum(dim=1)
    nneg = torch.minimum((neg_ratio * npos.to(torch.float32)).to(
        torch.int32), P - npos)
    neg_ce = torch.where(pos, -math.inf, ce)
    sorted_neg = torch.sort(neg_ce, dim=-1, stable=True)[0].flip(-1)
    rank = torch.arange(P, device=dev)[None, :]
    neg_loss = torch.where(rank < nneg[:, None], torch.where(
        torch.isfinite(sorted_neg), sorted_neg, 0.0), 0.0).sum(dim=1)
    pos_loss = torch.where(pos, ce, 0.0).sum(dim=1)
    total = conf_w * (pos_loss + neg_loss) + loc_w * loc_loss
    return {"Loss": [total / torch.clamp(npos.to(torch.float32), min=1.0)]}


# ---------------------------------------- two-stage (Faster R-CNN, FPN)
@register_op("anchor_generator", no_grad=True)
def _anchor_generator(ctx, ins, attrs):
    """anchor_generator_op.h: RPN anchors per feature-map cell for every
    (aspect_ratio, anchor_size) pair, Anchors / Variances [H, W, A, 4]
    (xyxy), built on the host as ``prior_box``'s table is."""
    x = ins["Input"][0]
    H, W = int(x.shape[2]), int(x.shape[3])
    sizes = [float(s) for s in attrs.get("anchor_sizes",
                                         [64.0, 128.0, 256.0])]
    ratios = [float(r) for r in attrs.get("aspect_ratios", [0.5, 1.0, 2.0])]
    sw, sh = (float(s) for s in attrs.get("stride", [16.0, 16.0]))
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = float(attrs.get("offset", 0.5))
    xc = torch.arange(W, dtype=torch.float32) * sw + offset * (sw - 1)
    yc = torch.arange(H, dtype=torch.float32) * sh + offset * (sh - 1)
    ws, hs = [], []
    for ar in ratios:
        base_w = float(np.round(np.sqrt(sw * sh / ar)))
        base_h = float(np.round(base_w * ar))
        for size in sizes:
            ws.append(size / sw * base_w)
            hs.append(size / sh * base_h)
    ws = torch.tensor(ws, dtype=torch.float32)
    hs = torch.tensor(hs, dtype=torch.float32)
    A = ws.shape[0]
    x_ctr = xc[None, :, None].expand(H, W, A)
    y_ctr = yc[:, None, None].expand(H, W, A)
    anchors = torch.stack([
        x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
        x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], dim=-1)
    return {"Anchors": [_const(ctx, anchors, x.device)],
            "Variances": [_variances(ctx, variances, (H, W, A), x.device)]}


@register_op("generate_proposals", no_grad=True)
def _generate_proposals(ctx, ins, attrs):
    """generate_proposals_op.cc ProposalForOneImage, static-shape, every
    image at once: the pre_nms_topN best scores -> deltas decoded
    against their anchors -> clipped to the image -> the min_size filter
    (in the original image's scale) -> greedy NMS (the +1 pixel
    convention) -> the post_nms_topN best. RpnRois [N, post_nms_topN,
    4] and RpnRoiProbs [N, post_nms_topN, 1], zero-padded (a row is
    valid iff its prob > 0)."""
    scores = ins["Scores"][0]       # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]   # [N, A*4, H, W]
    im_info = ins["ImInfo"][0]      # [N, 3] (h, w, scale)
    anchors = ins["Anchors"][0]     # [H, W, A, 4]
    variances = ins["Variances"][0]
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.5))
    min_size = float(attrs.get("min_size", 0.1))
    eta = float(attrs.get("eta", 1.0))
    N, A, H, W = scores.shape
    M = A * H * W
    pre_n = min(pre_n, M)
    dev = scores.device
    rows = _batch_rows(N, dev)
    # entry (a, h, w) pairs with anchors[h, w, a] and deltas[a*4 ..]
    anc = anchors.permute(2, 0, 1, 3).reshape(M, 4)
    var = variances.permute(2, 0, 1, 3).reshape(M, 4)
    dl = deltas.reshape(N, A, 4, H, W).permute(0, 1, 3, 4, 2).reshape(
        N, M, 4)
    aw = anc[:, 2] - anc[:, 0] + 1.0
    ah = anc[:, 3] - anc[:, 1] + 1.0
    acx = anc[:, 0] + aw * 0.5
    acy = anc[:, 1] + ah * 0.5

    top_s, top_i = _top_k(scores.reshape(N, M), pre_n)     # [N, pre_n]
    d = dl[rows, top_i]
    cw, ch, ccx, ccy, v = aw[top_i], ah[top_i], acx[top_i], acy[top_i], \
        var[top_i]
    # log(1000 / 16) in float32 (the JAX lowering's jnp.log of a Python
    # float), taken on the host: the clamps' scalar argument
    clip_val = float(torch.log(torch.tensor(1000.0 / 16.0)))
    cx = v[..., 0] * d[..., 0] * cw + ccx
    cy = v[..., 1] * d[..., 1] * ch + ccy
    bw = torch.exp(torch.clamp(v[..., 2] * d[..., 2], max=clip_val)) * cw
    bh = torch.exp(torch.clamp(v[..., 3] * d[..., 3], max=clip_val)) * ch
    ih, iw, isc = (im_info[:, k:k + 1] for k in range(3))  # [N, 1]

    def clip(t, hi):
        return torch.minimum(torch.clamp(t, min=0), hi)

    x1 = clip(cx - bw / 2, iw - 1)
    y1 = clip(cy - bh / 2, ih - 1)
    x2 = clip(cx + bw / 2 - 1, iw - 1)
    y2 = clip(cy + bh / 2 - 1, ih - 1)
    ms = max(min_size, 1.0)
    ww = x2 - x1 + 1
    hh = y2 - y1 + 1
    ok = (((x2 - x1) / isc + 1 >= ms) & ((y2 - y1) / isc + 1 >= ms)
          & (x1 + ww / 2 <= iw) & (y1 + hh / 2 <= ih))
    s_f = torch.where(ok, top_s, -math.inf)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    order = torch.sort(-s_f, dim=-1, stable=True)[1]
    boxes = boxes[rows, order]
    s_f = s_f[rows, order]
    keep = _greedy_nms(boxes, torch.isfinite(s_f), nms_thresh, eta=eta,
                       off=1.0)
    k = min(post_n, pre_n)
    out_s, out_i = _top_k(torch.where(keep, s_f, -math.inf), k)
    valid = torch.isfinite(out_s)
    out_b = torch.where(valid[..., None], boxes[rows, out_i], 0.0)
    out_s = torch.where(valid, out_s, 0.0)
    if k < post_n:
        out_b = torch.cat([out_b, out_b.new_zeros((N, post_n - k, 4))], 1)
        out_s = torch.cat([out_s, out_s.new_zeros((N, post_n - k))], 1)
    return {"RpnRois": [out_b], "RpnRoiProbs": [out_s[..., None]]}


def _sample(fg, bg, K, fg_cap, gen):
    """The samplers' random subsample over candidates [B, n]: at most
    fg_cap foreground and K - (taken fg) background candidates, each set
    the top of uniform priorities drawn from ``gen`` (-1 off the set),
    taken first-fg-then-bg and compacted: indices [B, K] (-1 pads)."""
    B, n = fg.shape
    dev = fg.device
    fg_pri = torch.where(fg, torch.rand((B, n), generator=gen, device=dev),
                         -1.0)
    bg_pri = torch.where(bg, torch.rand((B, n), generator=gen, device=dev),
                         -1.0)
    fg_val, fg_idx = _top_k(fg_pri, fg_cap)
    fg_take = fg_val > 0
    nfg = fg_take.to(torch.int32).sum(dim=1, keepdim=True)
    bg_val, bg_idx = _top_k(bg_pri, K)
    bg_take = (bg_val > 0) & (torch.arange(K, device=dev)[None, :]
                              < (K - nfg))
    idx = torch.cat([torch.where(fg_take, fg_idx, -1),
                     torch.where(bg_take, bg_idx, -1)], dim=1)
    order = torch.sort((idx < 0).to(torch.int32), dim=1, stable=True)[1]
    return idx.gather(1, order)[:, :K]


@register_op("rpn_target_assign", no_grad=True, uses_rng=True)
def _rpn_target_assign(ctx, ins, attrs):
    """rpn_target_assign_op.cc, dense: per image, anchors labelled fg
    (IoU >= positive_overlap, or the best for a gt) and bg (max IoU <
    negative_overlap, not fg), randomly subsampled to
    rpn_batch_size_per_im with rpn_fg_fraction; FIXED-size outputs:
    ScoreIndex / LocIndex [B, K] (-1 pads), TargetLabel [B, K] (1 fg, 0
    bg, -1 pad), TargetBBox [B, K, 4] (fg rows encoded against their
    anchors), BBoxInsideWeight [B, K, 4]."""
    anchors = ins["Anchor"][0].reshape(-1, 4)     # [A, 4]
    gt = ins["GtBoxes"][0].to(torch.float32)      # [B, G, 4]
    K = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_t = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_t = float(attrs.get("rpn_negative_overlap", 0.3))
    B, G = gt.shape[0], gt.shape[1]
    A = anchors.shape[0]
    dev = gt.device
    gen = ctx.next_rng()
    rows = _batch_rows(B, dev)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5

    valid = (gt[..., 2] - gt[..., 0] > 0) & (gt[..., 3] - gt[..., 1] > 0)
    iou = torch.where(valid[:, :, None], _pairwise_iou_xyxy(gt, anchors),
                      0.0)                                 # [B, G, A]
    amax = iou.amax(dim=1)
    agt = iou.argmax(dim=1)                                # [B, A]
    # the best anchor of each valid gt is fg whatever its IoU
    best = torch.where(valid, iou.argmax(dim=2), A)        # [B, G]
    is_best = torch.zeros((B, A + 1), dtype=torch.bool, device=dev)
    is_best[rows, best] = True
    fg = (amax >= pos_t) | is_best[:, :A]
    bg = ~fg & (amax < neg_t)

    idx = _sample(fg, bg, K, int(K * fg_frac), gen)
    sel = torch.clamp(idx, min=0)
    label = torch.where(idx < 0, -1, torch.where(fg.gather(1, sel), 1, 0))
    g = gt[rows, agt.gather(1, sel)]                       # [B, K, 4]
    gw = g[..., 2] - g[..., 0] + 1.0
    gh = g[..., 3] - g[..., 1] + 1.0
    gcx = g[..., 0] + gw * 0.5
    gcy = g[..., 1] + gh * 0.5
    saw, sah = aw[sel], ah[sel]
    tgt = torch.stack([(gcx - acx[sel]) / saw, (gcy - acy[sel]) / sah,
                       torch.log(gw / saw), torch.log(gh / sah)], dim=-1)
    is_fg = (label == 1)[..., None]
    inside = torch.where(is_fg, 1.0, torch.zeros_like(tgt))
    tgt = torch.where(is_fg, tgt, 0.0)
    idx = idx.to(torch.int32)
    return {"ScoreIndex": [idx], "LocIndex": [idx],
            "TargetLabel": [label.to(torch.int32)], "TargetBBox": [tgt],
            "BBoxInsideWeight": [inside]}


@register_op("generate_proposal_labels", no_grad=True, uses_rng=True)
def _generate_proposal_labels(ctx, ins, attrs):
    """generate_proposal_labels_op.cc, dense: per image, K rois sampled
    from rpn_rois and the gt boxes (fg: IoU >= fg_thresh, at most
    fg_fraction * K; bg: IoU in [bg_thresh_lo, bg_thresh_hi)); Rois [B,
    K, 4], LabelsInt32 [B, K] (-1 pads), BboxTargets [B, K, 4 * C]
    (each fg row's encoded box in its class's 4 columns) and the
    inside / outside weights."""
    rois = ins["RpnRois"][0].to(torch.float32)    # [B, R, 4]
    gt_lab = ins["GtClasses"][0]                  # [B, G]
    gt = ins["GtBoxes"][0].to(torch.float32)      # [B, G, 4]
    K = int(attrs.get("batch_size_per_im", 256))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_t = float(attrs.get("fg_thresh", 0.25))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    wts = [float(w) for w in attrs.get("bbox_reg_weights",
                                       [0.1, 0.1, 0.2, 0.2])]
    C = int(attrs["class_nums"])
    B = rois.shape[0]
    dev = rois.device
    gen = ctx.next_rng()
    rows = _batch_rows(B, dev)

    valid = (gt[..., 2] - gt[..., 0] > 0) & (gt[..., 3] - gt[..., 1] > 0)
    cand = torch.cat([rois, gt], dim=1)                    # [B, R+G, 4]
    iou = torch.where(valid[:, :, None], _pairwise_iou_xyxy(gt, cand), 0.0)
    amax = iou.amax(dim=1)
    agt = iou.argmax(dim=1)
    fg = amax >= fg_t
    bg = (amax < bg_hi) & (amax >= bg_lo) & ~fg

    idx = _sample(fg, bg, K, int(K * fg_frac), gen)
    sel = torch.clamp(idx, min=0)
    out_rois = cand[rows, sel]                             # [B, K, 4]
    is_fg = fg.gather(1, sel) & (idx >= 0)
    gsel = agt.gather(1, sel)
    labels = torch.where(idx < 0, -1, torch.where(
        is_fg, gt_lab[rows, gsel].to(torch.int32), 0))
    g = gt[rows, gsel]
    rw = out_rois[..., 2] - out_rois[..., 0] + 1.0
    rh = out_rois[..., 3] - out_rois[..., 1] + 1.0
    rcx = out_rois[..., 0] + rw * 0.5
    rcy = out_rois[..., 1] + rh * 0.5
    gw = g[..., 2] - g[..., 0] + 1.0
    gh = g[..., 3] - g[..., 1] + 1.0
    gcx = g[..., 0] + gw * 0.5
    gcy = g[..., 1] + gh * 0.5
    t = torch.stack([(gcx - rcx) / rw / wts[0], (gcy - rcy) / rh / wts[1],
                     torch.log(gw / rw) / wts[2],
                     torch.log(gh / rh) / wts[3]], dim=-1)  # [B, K, 4]
    in_class = torch.clamp(labels, min=0)[..., None] == torch.arange(
        C, device=dev)                                     # [B, K, C]
    tgt = torch.where((in_class & is_fg[..., None])[..., None],
                      t[:, :, None, :], 0.0).reshape(B, K, 4 * C)
    inside = (tgt != 0).to(torch.float32)
    return {"Rois": [out_rois], "LabelsInt32": [labels.to(torch.int32)],
            "BboxTargets": [tgt], "BboxInsideWeights": [inside],
            "BboxOutsideWeights": [inside]}


def _roi_grid(x, rois, roi_batch, pooled_h, pooled_w, spatial_scale,
              sampling, mode):
    """The ROI pools' shared sampling: per roi and bin a sampling x
    sampling sub-grid of bilinear samples (clamped at the border),
    averaged ("align") or maxed ("pool"); every roi at once, each
    corner a gather of [B * H * W, C] rows. Out [N, C, PH, PW]."""
    B, C, H, W = x.shape
    dev = x.device
    r = rois * spatial_scale
    x1, y1, x2, y2 = (r[:, k] for k in range(4))
    if mode == "align":
        rw = torch.clamp(x2 - x1, min=1.0)
        rh = torch.clamp(y2 - y1, min=1.0)
    else:
        x1, y1 = torch.round(x1), torch.round(y1)
        x2, y2 = torch.round(x2), torch.round(y2)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
    bin_w = rw / pooled_w
    bin_h = rh / pooled_h
    sub = (torch.arange(sampling, device=dev)[None, :] + 0.5) / sampling
    gy = torch.arange(pooled_h, device=dev)[:, None] + sub     # [PH, S]
    gx = torch.arange(pooled_w, device=dev)[:, None] + sub     # [PW, S]
    # pixel i's center sits at coordinate i + 0.5 (ROIAlign's convention)
    sy = y1[:, None, None] + gy[None] * bin_h[:, None, None] - 0.5
    sx = x1[:, None, None] + gx[None] * bin_w[:, None, None] - 0.5
    # [N, PH, PW, S, S] sample coordinates
    shape = (rois.shape[0], pooled_h, pooled_w, sampling, sampling)
    yy = torch.clamp(sy[:, :, None, :, None].expand(shape), 0.0, H - 1.0)
    xx = torch.clamp(sx[:, None, :, None, :].expand(shape), 0.0, W - 1.0)
    y0 = torch.floor(yy).long().clamp(0, H - 1)
    x0 = torch.floor(xx).long().clamp(0, W - 1)
    y1_ = torch.clamp(y0 + 1, max=H - 1)
    x1_ = torch.clamp(x0 + 1, max=W - 1)
    dy = (yy - y0)[..., None]
    dx = (xx - x0)[..., None]
    rows = x.permute(0, 2, 3, 1).reshape(B * H * W, C)
    base = roi_batch.long()[:, None, None, None, None] * H

    def at(yi, xi):
        return rows[(base + yi) * W + xi]                  # [..., C]

    vals = (at(y0, x0) * (1 - dy) * (1 - dx)
            + at(y0, x1_) * (1 - dy) * dx
            + at(y1_, x0) * dy * (1 - dx)
            + at(y1_, x1_) * dy * dx)                    # [N, PH, PW, S, S, C]
    out = vals.mean(dim=(3, 4)) if mode == "align" else vals.amax(dim=(3, 4))
    return out.permute(0, 3, 1, 2)


def _roi_batch(ins, rois):
    if ins.get("RoisBatch"):
        return ins["RoisBatch"][0].reshape(-1).to(torch.int32)
    return torch.zeros((rois.shape[0],), dtype=torch.int32,
                       device=rois.device)


@register_op("roi_align", diff_inputs=["X"])
def _roi_align(ctx, ins, attrs):
    """roi_align_op.cc: the average of bilinear samples per bin."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    out = _roi_grid(x, rois, _roi_batch(ins, rois),
                    int(attrs.get("pooled_height", 1)),
                    int(attrs.get("pooled_width", 1)),
                    float(attrs.get("spatial_scale", 1.0)),
                    max(int(attrs.get("sampling_ratio", 2)), 1), "align")
    return {"Out": [out]}


@register_op("roi_pool", diff_inputs=["X"])
def _roi_pool(ctx, ins, attrs):
    """roi_pool_op.cc: the max over a sampled grid per bin (the JAX
    package's sampled approximation of the exact integer-bin max,
    identical for aligned bins)."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    out = _roi_grid(x, rois, _roi_batch(ins, rois),
                    int(attrs.get("pooled_height", 1)),
                    int(attrs.get("pooled_width", 1)),
                    float(attrs.get("spatial_scale", 1.0)),
                    max(int(attrs.get("sampling_ratio", 4)), 1), "pool")
    return {"Out": [out], "Argmax": [None]}


@register_op("distribute_fpn_proposals", no_grad=True)
def _distribute_fpn_proposals(ctx, ins, attrs):
    """distribute_fpn_proposals_op.cc: each roi to an FPN level by its
    sqrt-area; dense outputs: per level the roi count's rows, that
    level's rois first in their order, zero padding after, and
    RestoreIndex [N, 1]."""
    rois = ins["FpnRois"][0]           # [N, 4]
    min_l = int(attrs["min_level"])
    max_l = int(attrs["max_level"])
    canon_s = float(attrs.get("refer_scale", 224))
    canon_l = int(attrs.get("refer_level", 4))
    N = rois.shape[0]
    scale = torch.sqrt(torch.clamp(
        (rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]), min=1e-10))
    lvl = torch.floor(canon_l + torch.log2(scale / canon_s + 1e-10))
    lvl = torch.clamp(lvl, min_l, max_l).to(torch.int32)
    first = torch.arange(N, device=rois.device)[:, None]
    outs = []
    for level in range(min_l, max_l + 1):
        sel = lvl == level
        order = torch.sort((~sel).to(torch.int32), stable=True)[1]
        n_sel = sel.to(torch.int32).sum()
        outs.append(torch.where(first < n_sel, rois[order], 0.0))
    restore = torch.sort(torch.sort(lvl, stable=True)[1], stable=True)[1]
    return {"MultiFpnRois": outs,
            "RestoreIndex": [restore.to(torch.int32)[:, None]]}


@register_op("box_decoder_and_assign", no_grad=True)
def _box_decoder_and_assign(ctx, ins, attrs):
    """box_decoder_and_assign_op.cc: per-class deltas decoded against
    the prior boxes (log-sizes clipped at box_clip), then each roi's box
    of its best-scoring class past the background column 0."""
    prior = ins["PriorBox"][0]         # [N, 4]
    deltas = ins["TargetBox"][0]       # [N, C*4]
    scores = ins["BoxScore"][0]        # [N, C]
    box_clip = attrs.get("box_clip", 4.135)
    clip = 4.135 if isinstance(box_clip, (list, tuple)) else float(box_clip)
    N, C = scores.shape
    d = deltas.reshape(N, C, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    cx = d[..., 0] * pw[:, None] + pcx[:, None]
    cy = d[..., 1] * ph[:, None] + pcy[:, None]
    bw = torch.exp(torch.clamp(d[..., 2], max=clip)) * pw[:, None]
    bh = torch.exp(torch.clamp(d[..., 3], max=clip)) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2,
                           cx + bw / 2 - 1, cy + bh / 2 - 1], dim=-1)
    best = scores[:, 1:].argmax(dim=1) + 1
    assigned = decoded[torch.arange(N, device=prior.device), best]
    return {"DecodeBox": [decoded.reshape(N, C * 4)],
            "OutputAssignBox": [assigned]}


@register_op("box_clip", no_grad=True)
def _box_clip(ctx, ins, attrs):
    """box_clip_op.cc: [B, ..., 4] xyxy boxes clipped into each image's
    [0, w / scale - 1] x [0, h / scale - 1]."""
    x = ins["Input"][0]
    im = ins["ImInfo"][0]              # [B, 3] h, w, scale
    shape = (-1,) + (1,) * (x.ndim - 2)
    hh = (im[:, 0] / im[:, 2] - 1.0).reshape(shape)
    ww = (im[:, 1] / im[:, 2] - 1.0).reshape(shape)

    def clip(t, hi):
        return torch.minimum(torch.clamp(t, min=0), hi)

    return {"Output": [torch.stack([
        clip(x[..., 0], ww), clip(x[..., 1], hh),
        clip(x[..., 2], ww), clip(x[..., 3], hh)], dim=-1)]}


# ------------------------------------------------------------ the rest
@register_op("density_prior_box", no_grad=True)
def _density_prior_box(ctx, ins, attrs):
    """density_prior_box_op.h: SSD priors densified per fixed_size, a
    density x density sub-grid of centers a cell, one box per
    fixed_ratio, in the reference's loop order (size, ratio, row,
    column). Boxes / Variances [H, W, P, 4] normalized xyxy ([H*W*P, 4]
    with flatten_to_2d), built on the host as ``prior_box``'s table is."""
    x = ins["Input"][0]
    img = ins["Image"][0]
    H, W = int(x.shape[2]), int(x.shape[3])
    IH, IW = int(img.shape[2]), int(img.shape[3])
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities", [])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    clip = bool(attrs.get("clip", False))
    offset = float(attrs.get("offset", 0.5))
    step_w = float(attrs.get("step_w", 0.0)) or IW / W
    step_h = float(attrs.get("step_h", 0.0)) or IH / H
    step_avg = int((step_w + step_h) * 0.5)
    cx = (torch.arange(W, dtype=torch.float32) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32) + offset) * step_h
    shifts_x, shifts_y, bws, bhs = [], [], [], []
    for size, density in zip(fixed_sizes, densities):
        shift = step_avg // density
        for r in fixed_ratios:
            sq = float(np.sqrt(r))
            for di in range(density):
                for dj in range(density):
                    shifts_x.append(-step_avg / 2.0 + shift / 2.0 + dj * shift)
                    shifts_y.append(-step_avg / 2.0 + shift / 2.0 + di * shift)
                    bws.append(size * sq)
                    bhs.append(size / sq)
    sx, sy, bw, bh = (torch.tensor(v, dtype=torch.float32)
                      for v in (shifts_x, shifts_y, bws, bhs))
    P = sx.shape[0]
    px = (cx[None, :, None] + sx[None, None, :]).expand(H, W, P)
    py = (cy[:, None, None] + sy[None, None, :]).expand(H, W, P)
    boxes = torch.stack([
        torch.clamp((px - bw / 2) / IW, min=0.0),
        torch.clamp((py - bh / 2) / IH, min=0.0),
        torch.clamp((px + bw / 2) / IW, max=1.0),
        torch.clamp((py + bh / 2) / IH, max=1.0)], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = _variances(ctx, variances, (H, W, P), x.device)
    boxes = _const(ctx, boxes, x.device)
    if attrs.get("flatten_to_2d"):
        boxes = boxes.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return {"Boxes": [boxes], "Variances": [var]}


@register_op("polygon_box_transform", no_grad=True)
def _polygon_box_transform(ctx, ins, attrs):
    """polygon_box_transform_op.cc: [N, 8, H, W] offset maps to absolute
    quad coordinates (x = 4 * w_idx - offset, y = 4 * h_idx - offset)."""
    x = ins["Input"][0]
    _, C, H, W = x.shape
    col = torch.arange(W, dtype=torch.float32, device=x.device)[
        None, :].expand(H, W) * 4.0
    row = torch.arange(H, dtype=torch.float32, device=x.device)[
        :, None].expand(H, W) * 4.0
    grid = torch.stack([col, row] * (C // 2), dim=0)
    return {"Output": [grid[None] - x]}


@register_op("yolov3_loss", diff_inputs=["X"])
def _yolov3_loss(ctx, ins, attrs):
    """yolov3_loss_op.h Yolov3LossKernel, every prediction and gt at once:

    - each prediction decodes to a box; its best IoU against the valid
      gts above ignore_thresh ignores its objectness
    - each gt matches its best shape-only anchor; if that anchor is in
      anchor_mask, its (cell, mask) slot takes the location loss (sce
      for x / y, L2 for w / h, scaled by 2 - w * h), objectness 1 and
      the class sce losses
    - Loss [N]; ObjectnessMask [N, mask, H, W] (1 pos, -1 ignored, 0
      neg); GTMatchMask [N, B] (the matched mask index or -1)

    The positive slots are set through one extra slot that takes every
    unmatched gt and is dropped, so a padding gt whose clipped cell
    meets a real match never erases it."""
    x = ins["X"][0]                            # [N, C, H, W]
    gt_box = ins["GTBox"][0].to(torch.float32)  # [N, B, 4] cx, cy, w, h
    gt_label = ins["GTLabel"][0]               # [N, B]
    anchors = [int(a) for a in attrs["anchors"]]
    anchor_mask = [int(a) for a in attrs["anchor_mask"]]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    N, _, H, W = x.shape
    dev = x.device
    an_num = len(anchors) // 2
    mask_num = len(anchor_mask)
    B = gt_box.shape[1]
    input_size = downsample * H
    xf = x.to(torch.float32).reshape(N, mask_num, 5 + class_num, H, W)
    aw = _const(ctx, anchors[0::2], dev)
    ah = _const(ctx, anchors[1::2], dev)
    m_aw = _const(ctx, [anchors[2 * a] for a in anchor_mask], dev)
    m_ah = _const(ctx, [anchors[2 * a + 1] for a in anchor_mask], dev)

    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    px = (gx + torch.sigmoid(xf[:, :, 0])) / W            # [N, mask, H, W]
    py = (gy + torch.sigmoid(xf[:, :, 1])) / H
    pw = torch.exp(xf[:, :, 2]) * m_aw[None, :, None, None] / input_size
    ph = torch.exp(xf[:, :, 3]) * m_ah[None, :, None, None] / input_size
    gt_valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)  # [N, B]

    def iou_cwh(x1, y1, w1, h1, x2, y2, w2, h2):
        lx = torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
        rx = torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
        ly = torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
        ry = torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
        inter = torch.clamp(rx - lx, min=0.0) * torch.clamp(ry - ly,
                                                             min=0.0)
        return inter / torch.clamp(w1 * h1 + w2 * h2 - inter, min=1e-10)

    if B:
        g = gt_box[:, None, None, None]                   # [N, 1, 1, 1, B, 4]
        iou_pg = iou_cwh(px[..., None], py[..., None], pw[..., None],
                         ph[..., None], g[..., 0], g[..., 1], g[..., 2],
                         g[..., 3])
        best_iou = torch.where(gt_valid[:, None, None, None, :], iou_pg,
                               0.0).amax(dim=-1)
    else:
        best_iou = torch.zeros_like(px)
    ignore = best_iou > ignore_thresh

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    an_iou = iou_cwh(zero, zero, gt_box[..., 2][..., None],
                     gt_box[..., 3][..., None], zero, zero,
                     (aw / input_size)[None, None, :],
                     (ah / input_size)[None, None, :])    # [N, B, an_num]
    best_n = an_iou.argmax(dim=-1)
    lut = [-1] * an_num
    for mi, a in enumerate(anchor_mask):
        lut[a] = mi
    mask_lut = _const(ctx, lut, dev, torch.int32)
    match = torch.where(gt_valid, mask_lut[best_n], -1)   # [N, B]
    gi = torch.clamp((gt_box[..., 0] * W).to(torch.int32), 0, W - 1)
    gj = torch.clamp((gt_box[..., 1] * H).to(torch.int32), 0, H - 1)
    matched = match >= 0
    mslot = torch.clamp(match, min=0)

    tx = gt_box[..., 0] * W - gi
    ty = gt_box[..., 1] * H - gj
    tw = torch.log(torch.clamp(gt_box[..., 2] * input_size / aw[best_n],
                               min=1e-9))
    th = torch.log(torch.clamp(gt_box[..., 3] * input_size / ah[best_n],
                               min=1e-9))
    scale = 2.0 - gt_box[..., 2] * gt_box[..., 3]
    pred = xf[_batch_rows(N, dev), mslot.long(), :, gj.long(), gi.long()]
    loc = (_sce(pred[..., 0], tx) + _sce(pred[..., 1], ty)
           + 0.5 * (pred[..., 2] - tw) ** 2
           + 0.5 * (pred[..., 3] - th) ** 2) * scale
    onehot = (gt_label.long()[..., None] == torch.arange(
        class_num, device=dev)).to(torch.float32)
    cls = _sce(pred[..., 5:], onehot).sum(dim=-1)         # [N, B]
    per_gt = torch.where(matched, loc + cls, 0.0)

    slots = mask_num * H * W
    flat_idx = (mslot * H + gj) * W + gi
    safe_idx = torch.where(matched, flat_idx, slots).long()
    pos = torch.zeros((N, slots + 1), dtype=torch.bool, device=dev)
    pos[_batch_rows(N, dev), safe_idx] = True
    pos = pos[:, :slots].reshape(N, mask_num, H, W)
    obj_mask = torch.where(pos, 1.0, torch.where(ignore, -1.0, 0.0))
    conf = xf[:, :, 4]
    obj_loss = torch.where(
        obj_mask > 0.5, _sce(conf, 1.0),
        torch.where(obj_mask > -0.5, _sce(conf, 0.0), 0.0))
    loss = per_gt.sum(dim=1) + obj_loss.sum(dim=(1, 2, 3))
    return {"Loss": [loss.to(x.dtype)],
            "ObjectnessMask": [obj_mask.to(torch.float32)],
            "GTMatchMask": [match.to(torch.int32)]}
