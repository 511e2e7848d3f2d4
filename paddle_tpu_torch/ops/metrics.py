"""Metric ops: ``accuracy``, ``auc`` and ``precision_recall``.

Counterparts of paddle_tpu/ops/metrics.py (the reference's
operators/metrics/accuracy_op.cc, auc_op.cc, precision_recall_op.cc),
op for op. ``auc`` adds each prediction to its threshold bucket with
``index_add`` on integer stats, whose sum is the same in any order, so
a step stays bitwise repeatable on the card.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", no_grad=True)
def _accuracy(ctx, ins, attrs):
    idx = ins["Indices"][0]
    label = ins["Label"][0]
    if label.ndim == 2 and label.shape[1] == 1:
        label = label[:, 0]
    hit = torch.any(idx == label[:, None].to(idx.dtype), dim=1)
    correct = torch.sum(hit.to(torch.float32))
    # a fill on the card: a host copy cannot be captured in a CUDA graph
    total = torch.full((), float(label.shape[0]), dtype=torch.float32,
                       device=idx.device)
    return {
        "Accuracy": [(correct / total).reshape((1,))],
        "Correct": [correct.to(torch.int32).reshape((1,))],
        "Total": [total.to(torch.int32).reshape((1,))],
    }


@register_op("auc", no_grad=True)
def _auc(ctx, ins, attrs):
    """Streaming AUC with histogram stat buffers (auc_op.cc): each
    prediction's positive probability picks one of ``num_thresholds +
    1`` buckets, then the trapezoid rule over descending thresholds."""
    preds = ins["Predict"][0]
    label = ins["Label"][0]
    stat_pos = ins["StatPos"][0]
    stat_neg = ins["StatNeg"][0]
    num_thresh = stat_pos.shape[0] - 1
    if label.ndim == 2:
        label = label[:, 0]
    pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
        else preds.reshape(-1)
    bucket = torch.clamp((pos_prob * num_thresh).to(torch.int32), 0,
                         num_thresh).to(torch.int64)
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_add(0, bucket, is_pos)
    stat_neg = stat_neg.index_add(0, bucket, 1 - is_pos)
    tp = torch.cumsum(stat_pos.flip(0), 0).to(stat_pos.dtype)
    fp = torch.cumsum(stat_neg.flip(0), 0).to(stat_neg.dtype)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp_prev = torch.cat([torch.zeros_like(tp[:1]), tp[:-1]])
    fp_prev = torch.cat([torch.zeros_like(fp[:1]), fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    denom = tot_pos * tot_neg
    auc = torch.where(denom > 0, area / denom, torch.zeros_like(area))
    return {"AUC": [auc.reshape((1,))], "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg]}


def _one_hot(idx, n):
    """f32 rows of ``n``; an id outside [0, n) gives a row of zeros, as
    ``jax.nn.one_hot`` does."""
    classes = torch.arange(n, dtype=idx.dtype, device=idx.device)
    return (idx.unsqueeze(-1) == classes).to(torch.float32)


@register_op("precision_recall", no_grad=True)
def _precision_recall(ctx, ins, attrs):
    """precision_recall_op.cc: per-class TP/FP/FN stats and macro/micro
    precision/recall/F1, accumulated through StatesInfo ([C, 4] rows of
    TP, FP, TN, FN). A class id outside [0, C) counts in no class, as
    ``jax.nn.one_hot`` gives it a zero row."""
    idx = ins["Indices"][0].reshape(-1).to(torch.int32)   # predicted class
    label = ins["Label"][0].reshape(-1).to(torch.int32)
    weights = (ins["Weights"][0].reshape(-1)
               if ins.get("Weights") and ins["Weights"][0] is not None
               else torch.ones(idx.shape, dtype=torch.float32,
                               device=idx.device))
    states = (ins["StatesInfo"][0]
              if ins.get("StatesInfo") and ins["StatesInfo"][0] is not None
              else None)
    C = int(attrs["class_number"])

    onehot_pred = _one_hot(idx, C) * weights[:, None]
    onehot_lab = _one_hot(label, C) * weights[:, None]
    hit = (idx == label).to(torch.float32) * weights
    tp = torch.sum(_one_hot(label, C) * hit[:, None], dim=0)
    fp = torch.sum(onehot_pred, dim=0) - tp
    fn = torch.sum(onehot_lab, dim=0) - tp
    total = torch.sum(weights)
    tn = total - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)      # [C, 4]

    def ratio(a, b):
        return torch.where(b > 0, a / b, torch.zeros_like(a))

    def metrics(st):
        tp_, fp_, fn_ = st[:, 0], st[:, 1], st[:, 3]
        prec, rec = ratio(tp_, tp_ + fp_), ratio(tp_, tp_ + fn_)
        # macro F1 = F1 of the macro-averaged p/r (precision_recall_op.h
        # :142-144), not the mean of per-class F1s
        mp_, mr_ = prec.mean(), rec.mean()
        mf1 = ratio(2 * mp_ * mr_, mp_ + mr_)
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mp, mr = ratio(stp, stp + sfp), ratio(stp, stp + sfn)
        mf = ratio(2 * mp * mr, mp + mr)
        return torch.stack([mp_, mr_, mf1, mp, mr, mf])

    accum_states = (states + batch_states if states is not None
                    else batch_states)
    return {"BatchMetrics": [metrics(batch_states)],
            "AccumMetrics": [metrics(accum_states)],
            "AccumStatesInfo": [accum_states]}
