"""Beam-search ops on a dense beam axis: ``beam_search``,
``beam_search_decode``, ``beam_gather``, and ``py_func``.

The port of paddle_tpu/ops/beam_search_ops.py. Beams are a dense axis:
the state is [B, beam], and each source's candidate pool is beam * V.

Ties. The JAX package takes ``lax.top_k`` over [B, beam * V], which
returns the lower index first among equal values, and ties are common
there: dead beams all sit at ``NEG`` and a uniform first step ties
every candidate. ``torch.topk`` on CUDA promises no order among ties,
so ``beam_search`` sorts each row with a stable descending
``torch.sort`` and keeps the first ``beam``: the lowest flat index wins
a tie, and the parents and ids are the JAX package's.

``py_func`` calls its Python function on host copies of its inputs.
That is a host sync, so it carries ``host_sync`` and a step that holds
it runs uncaptured (core/executor.py). Forward only, as in the JAX
package: gradients stop at a ``py_func``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lowering import as_torch_dtype
from ..core.registry import register_op

NEG = -1e9


def _rows(x, idx):
    """``jnp.take_along_axis(x, idx[..., None...], axis=1)``."""
    idx = idx.to(torch.int64).reshape(tuple(idx.shape)
                                      + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2])
                                         + tuple(x.shape[2:])))


@register_op("beam_search", no_grad=True)
def _beam_search(ctx, ins, attrs):
    """One expansion step. pre_ids / pre_scores: [B, beam]; scores: the
    next-token log-probs of each beam [B, beam, V]. A finished beam
    (pre_id == end_id) offers one candidate, end_id at its unchanged
    score. Outputs the selected ids and scores and each one's parent
    beam."""
    pre_ids = ins["pre_ids"][0].to(torch.int32)       # [B, beam]
    pre_scores = ins["pre_scores"][0]                 # [B, beam]
    scores = ins["scores"][0]                         # [B, beam, V]
    beam = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    B, K, V = scores.shape

    neg = torch.full((), NEG, dtype=scores.dtype, device=scores.device)
    finished = pre_ids == end_id                      # [B, beam]
    total = pre_scores[:, :, None] + scores           # [B, beam, V]
    total = torch.where(finished[:, :, None], neg, total)
    end_col = torch.where(finished, pre_scores, neg)  # [B, beam]
    total = torch.cat([total[:, :, :end_id],
                       torch.where(finished, end_col,
                                   total[:, :, end_id])[:, :, None],
                       total[:, :, end_id + 1:]], dim=2)

    flat = total.reshape(B, K * V)
    vals, order = torch.sort(flat, dim=1, descending=True, stable=True)
    top_s, top_i = vals[:, :beam], order[:, :beam]
    parent = torch.div(top_i, V, rounding_mode="floor").to(torch.int32)
    ids = (top_i % V).to(torch.int32)
    return {"selected_ids": [ids], "selected_scores": [top_s],
            "parent_idx": [parent]}


@register_op("beam_search_decode", no_grad=True)
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack the stacked per-step ids and parents into whole
    sequences. Ids / ParentIdx: [T, B, beam]; SentenceIds [B, beam, T]
    and the final cumulative scores."""
    ids = ins["Ids"][0].to(torch.int64)               # [T, B, beam]
    parents = ins["ParentIdx"][0].to(torch.int64)     # [T, B, beam]
    scores = ins["Scores"][0]                         # [T, B, beam]
    T, B, K = ids.shape
    beam_at = torch.arange(K, device=ids.device)[None].expand(B, K)
    toks = [None] * T
    for t in reversed(range(T)):
        toks[t] = torch.gather(ids[t], 1, beam_at)
        beam_at = torch.gather(parents[t], 1, beam_at)
    sentences = torch.stack(toks).permute(1, 2, 0).to(torch.int32)
    return {"SentenceIds": [sentences], "SentenceScores": [scores[-1]]}


@register_op("py_func", no_grad=True, needs_env=False, host_sync=True)
def _py_func(ctx, ins, attrs):
    """Call back into Python: ``forward_func`` on numpy copies of the
    inputs; ``out_shapes`` / ``out_dtypes`` describe its results, which
    go back to the inputs' device."""
    fn = attrs["forward_func"]
    shapes = [tuple(s) for s in attrs["out_shapes"]]
    dtypes = [as_torch_dtype(d) for d in attrs["out_dtypes"]]
    xs = [v for v in ins.get("X", []) if v is not None]
    device = xs[0].device if xs else ctx.device
    out = fn(*[v.detach().cpu().numpy() for v in xs])
    if not isinstance(out, (list, tuple)):
        out = [out]
    res = [torch.as_tensor(np.asarray(o).reshape(s)).to(device, d)
           for o, s, d in zip(out, shapes, dtypes)]
    return {"Out": res}


@register_op("beam_gather", no_grad=True)
def _beam_gather(ctx, ins, attrs):
    """Reorder per-row decoder state by parent beam: X [B*K, ...] (rows
    grouped by source), Index [B, K] -> X[b*K + Index[b, k]], laid out
    as [B*K, ...]."""
    x = ins["X"][0]
    idx = ins["Index"][0]                             # [B, K]
    B, K = idx.shape
    x3 = x.reshape((B, K) + tuple(x.shape[1:]))
    return {"Out": [_rows(x3, idx).reshape(x.shape)]}
