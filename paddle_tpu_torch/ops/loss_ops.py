"""Loss and structured-prediction ops: cos_sim, rank_loss,
margin_rank_loss, bpr_loss, nce (with a grad lowering of its own),
hierarchical_sigmoid, warpctc, linear_chain_crf, crf_decoding and
edit_distance.

The port of paddle_tpu/ops/loss_ops.py. Ragged inputs take the padded
+ length convention of ops/sequence.py. The JAX package's four
``lax.scan``s (CTC's forward algorithm, the CRF's forward algorithm,
Viterbi and its backtrack, Levenshtein's rows) are Python loops over
time on tensors here, as ops/rnn.py's recurrences are: lengths mask the
steps on the device, so nothing is read on the host and a step that
holds them can be captured as a CUDA graph. Their grads (CTC, the CRF)
are the generic vjp of the loop, as the JAX package's are the vjp of
the scan.

Indexing follows JAX's modes: plain indexing (``w[ids]``,
``trans[a, b]``) clamps (ops/tensor_ops.py ``clamped_index``),
``take_along_axis`` fills NaN past the end (``take_rows``' rule).

``nce`` draws its negatives from the op's generator and returns them in
SampleLabels; its grad lowering replays those labels instead of drawing
again (the RNG is not available in a vjp's pure context), as the JAX
package's does. ``crf_decoding``'s argmaxes (the best previous tag, the
best last tag) take the first index among ties, as ``jnp.argmax``.
``warpctc``'s ``norm_by_times`` does not change the loss (the JAX
package reads it nowhere either).
"""

from __future__ import annotations

import math

import torch

from ..core.registry import register_grad_lowering, register_op
from .activations import _softplus
from .tensor_ops import clamped_index

NEG = -1e30


@register_op("cos_sim", diff_inputs=["X", "Y"])
def _cos_sim(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / \
        torch.clamp(xn * yn, min=1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("rank_loss", diff_inputs=["Left", "Right"])
def _rank_loss(ctx, ins, attrs):
    """RankNet's pairwise loss: softplus(l - r) - label * (l - r)."""
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [_softplus(d) - ins["Label"][0] * d]}


@register_op("margin_rank_loss", diff_inputs=["X1", "X2"])
def _margin_rank_loss(ctx, ins, attrs):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    out = torch.clamp(-label * (x1 - x2) + float(attrs.get("margin", 0.0)),
                      min=0.0)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("bpr_loss", diff_inputs=["X"])
def _bpr_loss(ctx, ins, attrs):
    """Bayesian Personalized Ranking over logits [B, C] with the
    positive item's Label [B, 1]: the mean over the other items of
    -log(sigmoid(x_pos - x_i) + 1e-12)."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    B, C = x.shape
    safe = clamped_index(label, C)[:, None]
    pos = torch.gather(x, 1, safe)
    pos = torch.where(((label >= -C) & (label < C))[:, None], pos,
                      float("nan"))
    lose = -torch.log(torch.sigmoid(pos - x) + 1e-12)
    mask = torch.ones_like(x).scatter(1, safe, 0.0)
    out = torch.sum(lose * mask, dim=1, keepdim=True) / max(C - 1, 1)
    return {"Out": [out]}


def nce_loss(x, w, b, ids, k, C):
    """(Cost [B, 1], logits [B, 1 + k]) of the sampled ids (the label
    first): binary logistic losses of the true id against ``k`` uniform
    negatives, the logits corrected by -log(k / C)."""
    B = x.shape[0]
    safe = clamped_index(ids, C)
    logits = torch.einsum("bd,bkd->bk", x, w[safe])
    if b is not None:
        logits = logits + b[safe]
    logits = logits - math.log(k / C)
    labels01 = torch.cat([torch.ones((B, 1), dtype=x.dtype, device=x.device),
                          torch.zeros((B, k), dtype=x.dtype,
                                      device=x.device)], dim=1)
    loss = torch.sum(_softplus(logits) - labels01 * logits, dim=1,
                     keepdim=True)
    return loss, logits


@register_op("nce", diff_inputs=["Input", "Weight", "Bias"], uses_rng=True)
def _nce(ctx, ins, attrs):
    """NCE loss with the uniform negative sampler (the reference's
    default): ``num_neg_samples`` ids per row drawn from [0, C), kept in
    SampleLabels (int32, the label first) for the grad."""
    x, w = ins["Input"][0], ins["Weight"][0]
    b = ins["Bias"][0] if ins.get("Bias") else None
    label = ins["Label"][0].reshape(-1).to(torch.int32)
    k = int(attrs.get("num_neg_samples", 10))
    C, B = w.shape[0], x.shape[0]
    neg = torch.randint(0, C, (B, k), generator=ctx.next_rng(),
                        dtype=torch.int32, device=x.device)
    ids = torch.cat([label[:, None], neg], dim=1)
    loss, logits = nce_loss(x, w, b, ids, k, C)
    return {"Cost": [loss], "SampleLogits": [logits], "SampleLabels": [ids]}


@register_grad_lowering("nce")
def _nce_grad(ctx, ins, attrs):
    """The vjp of the loss on the forward's SampleLabels (no new draw)."""
    x, w = ins["Input"][0], ins["Weight"][0]
    has_bias = bool(ins.get("Bias")) and ins["Bias"][0] is not None
    ids = ins["SampleLabels"][0]
    if ids is None:
        raise ValueError("nce grad needs the SampleLabels output "
                         "materialized")
    k = int(attrs.get("num_neg_samples", 10))
    C = w.shape[0]
    dcost = ins["Cost@GRAD"][0]
    primals = (x, w, ins["Bias"][0]) if has_bias else (x, w)

    def f(*p):
        return nce_loss(p[0], p[1], p[2] if has_bias else None, ids, k,
                        C)[0]

    out, vjp = torch.func.vjp(f, *primals)
    grads = vjp(dcost.to(out.dtype))
    return {"Input@GRAD": [grads[0]], "Weight@GRAD": [grads[1]],
            "Bias@GRAD": [grads[2] if has_bias else None],
            "Label@GRAD": [None]}


@register_op("hierarchical_sigmoid", diff_inputs=["X", "W", "Bias"])
def _hsigmoid(ctx, ins, attrs):
    """The default complete binary tree (the reference's SimpleCode,
    matrix_bit_code.h): class c's code is c + C, its node at depth d is
    (code >> (d + 1)) - 1 and its branch bit (code >> d) & 1; the loss
    sums softplus(logit) - bit * logit over the nodes on the path."""
    x, w = ins["X"][0], ins["W"][0]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    C = int(attrs["num_classes"])
    code = label + C
    out = 0
    for d in range(max((C - 1).bit_length(), 1)):
        idx = (code >> (d + 1)) - 1
        bit = (code >> d) & 1
        idxc = idx.clamp(0, w.shape[0] - 1)
        logit = torch.einsum("bd,bd->b", x, w[idxc])
        if bias is not None:
            logit = logit + bias.reshape(-1)[idxc]
        loss = _softplus(logit) - bit.to(x.dtype) * logit
        out = out + torch.where(idx >= 0, loss, torch.zeros_like(loss))
    return {"Out": [out.reshape(-1, 1)], "PreOut": [None]}


def _shift(a, n):
    """``a`` moved ``n`` states right along axis 1, NEG shifted in."""
    return torch.cat([torch.full_like(a[:, :n], NEG), a[:, :-n]], dim=1)


@register_op("warpctc", diff_inputs=["Logits"])
def _warpctc(ctx, ins, attrs):
    """CTC's negative log-likelihood of padded [B, T, C] logits (softmax
    taken here) and [B, L] labels: the forward algorithm over the
    extended labels (blank, l1, blank, ..., blank) in log space, a loop
    over time; a row's alpha after its LogitsLength - 1 steps gives its
    loss."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].to(torch.int64)
    logit_len = ins["LogitsLength"][0].reshape(-1).to(torch.int64)
    label_len = ins["LabelLength"][0].reshape(-1).to(torch.int64)
    blank = int(attrs.get("blank", 0))
    B, T, C = logits.shape
    S = 2 * label.shape[1] + 1
    dev = logits.device

    logp = torch.log_softmax(logits, dim=-1)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    ext_valid = torch.arange(S, device=dev)[None, :] < \
        (2 * label_len + 1)[:, None]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    # emit[b, t, s] = logp[b, t, ext[b, s]] (take_along_axis: NaN past
    # C), by advanced indexing: its grad adds a repeated blank's terms
    # with index_put_(accumulate=True), in a fixed order (torch.gather's
    # grad adds them with atomics on CUDA, in an order that changes from
    # run to run)
    inside = (ext >= -C) & (ext < C)
    emit = logp[torch.arange(B, device=dev)[:, None, None],
                torch.arange(T, device=dev)[None, :, None],
                clamped_index(ext, C)[:, None, :]]
    emit = torch.where(inside[:, None, :], emit, float("nan"))

    neg = torch.full((B, S), NEG, dtype=logp.dtype, device=dev)
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(label_len[:, None] > 0, emit[:, 0, 1:2],
                                   neg[:, :1]), neg[:, 2:]], dim=1)
    # a row's last step: t = LogitsLength - 1, a negative one wrapping
    # once (take_along_axis), then filled NaN past the ends
    last_t = logit_len - 1
    last_t = torch.where(last_t < 0, last_t + T, last_t)
    final = torch.where((last_t == 0)[:, None], alpha, neg)
    for t in range(1, T):
        skip = torch.where(can_skip, _shift(alpha, 2), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                              skip) + emit[:, t]
        alpha = torch.where(ext_valid, new, neg)
        final = torch.where((last_t == t)[:, None], alpha, final)
    final = torch.where(((last_t >= 0) & (last_t < T))[:, None], final,
                        float("nan"))
    send = torch.gather(final, 1, (2 * label_len).clamp(0, S - 1)[:, None])
    send = torch.where((2 * label_len < S)[:, None], send, float("nan"))
    send1 = torch.gather(final, 1,
                         torch.clamp(2 * label_len - 1, min=0).clamp(
                             max=S - 1)[:, None])
    send1 = torch.where((2 * label_len - 1 < S)[:, None], send1,
                        float("nan"))
    ll = torch.logaddexp(send, torch.where(label_len[:, None] > 0, send1,
                                           neg[:, :1]))
    return {"Loss": [-ll]}


def _crf_parts(ins):
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    length = ins["Length"][0].reshape(-1).to(torch.int64)
    return emission, transition[0], transition[1], transition[2:], length


@register_op("linear_chain_crf", diff_inputs=["Emission", "Transition"])
def _linear_chain_crf(ctx, ins, attrs):
    """Per-sequence log-likelihood [B, 1] of the gold tags: their score
    (emissions, transitions, the start and stop rows of Transition, the
    reference's [C + 2, C] layout) less the log partition function (the
    forward algorithm, a loop over time; a row keeps its alpha past its
    length)."""
    emission, start, stop, trans, length = _crf_parts(ins)
    label = ins["Label"][0].to(torch.int64)
    B, T, C = emission.shape
    dev = emission.device
    mask = torch.arange(T, device=dev)[None, :] < length[:, None]
    # take_along_axis: a tag outside [-C, C) picks NaN
    lab = clamped_index(label, C)
    em = torch.gather(emission, 2, lab[:, :, None])[..., 0]
    em = torch.where((label >= -C) & (label < C), em, float("nan"))
    em_score = torch.sum(torch.where(mask, em, torch.zeros_like(em)), dim=1)
    last = torch.gather(label, 1, torch.clamp(length - 1, 0, T - 1)[:, None])
    tr_pairs = trans[lab[:, :-1], lab[:, 1:]]
    tr_score = torch.sum(torch.where(mask[:, 1:], tr_pairs,
                                     torch.zeros_like(tr_pairs)), dim=1)
    gold = em_score + tr_score + start[lab[:, 0]] + \
        stop[clamped_index(last[:, 0], C)]

    alpha = start[None, :] + emission[:, 0]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            emission[:, t]
        alpha = torch.where((t < length)[:, None], new, alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=1)
    return {"LogLikelihood": [(gold - logz).reshape(-1, 1)], "Alpha": [None],
            "EmissionExps": [None], "TransitionExps": [None]}


@register_op("crf_decoding", no_grad=True)
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decode [B, T] int32 with linear_chain_crf's Transition:
    the forward max with backpointers (a row past its length keeps its
    scores and points each tag at itself), then the backtrack from the
    best last tag; positions past a row's length are 0."""
    emission, start, stop, trans, length = _crf_parts(ins)
    B, T, C = emission.shape
    dev = emission.device
    tags = torch.arange(C, device=dev)[None, :]
    alpha = start[None, :] + emission[:, 0]
    bps = []
    for t in range(1, T):
        scores = alpha[:, :, None] + trans[None]
        live = (t < length)[:, None]
        alpha = torch.where(live, torch.amax(scores, dim=1) + emission[:, t],
                            alpha)
        bps.append(torch.where(live, torch.argmax(scores, dim=1), tags))
    cur = torch.argmax(alpha + stop[None, :], dim=1)
    path = [cur]
    for bp in reversed(bps):
        cur = torch.gather(bp, 1, cur[:, None])[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1)
    mask = torch.arange(T, device=dev)[None, :] < length[:, None]
    return {"ViterbiPath": [torch.where(mask, path, torch.zeros_like(path))
                            .to(torch.int32)]}


@register_op("edit_distance", no_grad=True)
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance [B, 1] f32 between padded id rows, a loop
    over the hypothesis (rows past its length stay); ``normalized``
    divides by the reference's length (at least 1). Each row of the
    table is d[j] = min(d[j - 1] + 1, prev[j] + 1, prev[j - 1] + (h !=
    r_j)), whose left-to-right chain is a running minimum: d[j] = j +
    min over k <= j of (c_k - k), exact in integers."""
    hyp = ins["Hyps"][0].to(torch.int64)
    ref = ins["Refs"][0].to(torch.int64)
    hyp_len = ins["HypsLength"][0].reshape(-1).to(torch.int64)
    ref_len = ins["RefsLength"][0].reshape(-1).to(torch.int64)
    B, T1 = hyp.shape
    T2 = ref.shape[1]
    dev = hyp.device
    j = torch.arange(T2 + 1, device=dev)
    row = j[None, :].expand(B, T2 + 1)
    for i in range(T1):
        ins_cost = row[:, 1:] + 1
        sub = row[:, :-1] + (hyp[:, i:i + 1] != ref).to(torch.int64)
        c = torch.cat([row[:, :1] + 1, torch.minimum(ins_cost, sub)], dim=1)
        new = torch.cummin(c - j, dim=1).values + j
        row = torch.where((i < hyp_len)[:, None], new, row)
    d = torch.gather(row, 1, clamped_index(ref_len, T2 + 1)[:, None])
    d = d.to(torch.float32)
    if attrs.get("normalized", False):
        d = d / torch.clamp(ref_len.to(torch.float32), min=1)[:, None]
    return {"Out": [d.reshape(-1, 1)],
            "SequenceNum": [torch.full((1,), float(B), dtype=torch.float32,
                                       device=dev)]}
