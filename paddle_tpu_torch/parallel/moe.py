"""Expert parallelism: switch-style MoE over an 'expert' mesh axis
(top-1 Switch routing by default; top_k=2 for GShard-style).

The port of paddle_tpu/parallel/moe.py. Experts sit one per position of
a mesh axis; tokens travel to their expert's position with
``all_to_all``, the expert FFN runs on its capacity rows, and the rows
travel back. Capacity is static: each position sends up to
``capacity`` tokens to each expert; overflow tokens contribute zero,
the Switch-Transformer discipline. The router's load-balancing aux loss
follows Switch (mean fraction x mean probability per expert).

``route_tokens`` is the one routing derivation that every path shares
(``moe_apply`` and ``ops/moe_ops.py``'s lowering), so their results
cannot drift apart. Its top-k is a stable descending
sort, which breaks ties by the lower expert index as ``lax.top_k`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .mesh import all_to_all, note_collective

__all__ = ["moe_apply", "route_tokens"]


def route_tokens(x, gate_w, E, capacity, top_k=1, z_loss=0.0):
    """Top-k routing and capacity claims of the tokens ``x`` [T, D]
    under the router ``gate_w`` [D, E].

    top_k=1 is Switch routing (the output scales by the raw router
    probability, the product through which the router learns); top_k>1
    is GShard-style: each token goes to its k best experts with gates
    renormalized over the chosen probabilities, and capacity is claimed
    choice-major (every token's first choice before any second choice).
    With ``z_loss > 0`` the ST-MoE router z-loss ``z_loss *
    mean(logsumexp(logits)^2)`` folds into aux.

    Returns (expert_idx [K, T], gate [K, T], pos [K, T] int32, keep
    [K, T] bool, aux scalar)."""
    T = x.shape[0]
    logits = x @ gate_w                                  # [T, E]
    probs = torch.softmax(logits, dim=-1)                # [T, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]    # [T, K] each
    if top_k == 1:
        gate = top_p.T                                   # [1, T]
    else:
        gate = (top_p / torch.sum(top_p, dim=-1, keepdim=True)).T
    expert_idx = top_e.T                                 # [K, T]

    onehot1 = F.one_hot(expert_idx[0], E).to(probs.dtype)
    aux = E * torch.sum(torch.mean(onehot1, dim=0)
                        * torch.mean(probs, dim=0))
    if z_loss:
        aux = aux + z_loss * torch.mean(
            torch.logsumexp(logits.float(), dim=-1) ** 2)

    # positions: choice-major, so a cumsum over the flattened choices
    # gives first choices priority within each expert's capacity
    onehot = F.one_hot(expert_idx.reshape(-1), E)        # [K*T, E]
    pos = (torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
           ).to(torch.int32).reshape(top_k, T)
    keep = pos < capacity
    return expert_idx, gate, pos, keep, aux


def dispatch(x, expert_idx, pos, keep, E, capacity):
    """The [E, capacity, D] send buffer: each kept (token, choice) at its
    expert's slot (a top-2 token lands in both its experts' rows)."""
    D = x.shape[-1]
    buf = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device)
    safe_e = torch.where(keep, expert_idx, 0).long()
    safe_p = torch.where(keep, pos, 0).long()
    for kk in range(expert_idx.shape[0]):
        buf = buf.index_put((safe_e[kk], safe_p[kk]),
                            torch.where(keep[kk][:, None], x, 0.0),
                            accumulate=True)
    return buf


def combine(rows, expert_idx, gate, pos, keep):
    """Each token's output: its kept choices' rows of ``rows`` [E,
    capacity, D], gated and summed."""
    safe_e = torch.where(keep, expert_idx, 0).long()
    safe_p = torch.where(keep, pos, 0).long()
    out = None
    for kk in range(expert_idx.shape[0]):
        got = rows[safe_e[kk], safe_p[kk]]               # [T, D]
        got = torch.where(keep[kk][:, None], got, 0.0) * gate[kk][:, None]
        out = got if out is None else out + got
    return out


def expert_ffn(rows, w1, b1, w2, b2):
    """relu(rows @ w1 + b1) @ w2 + b2 for each expert's rows [E, C, D]
    against its stacked weights, the experts' products batched (one
    launch for every position of the axis)."""
    h = torch.relu(torch.baddbmm(b1[:, None, :], rows, w1))
    return torch.baddbmm(b2[:, None, :], h, w2)


def moe_apply(expert_params: Sequence[torch.Tensor], gate_w,
              x: Sequence[torch.Tensor], axis_name: str = "expert",
              capacity=None, top_k=1, z_loss=0.0):
    """Route each position's tokens to the experts and back.

    expert_params: (w1, b1, w2, b2) stacked [E, ...], expert e at
        position e of the axis; applied as relu(x @ w1 + b1) @ w2 + b2.
    gate_w: [D, E] router weights (every position's).
    x: the E positions' tokens, a list of [T, D].
    capacity: the most tokens each position routes to each expert
        (static); default ceil(2 * T * top_k / E).

    Returns (the positions' [T, D] outputs, their aux losses). Notes one
    ``all_to_all`` collective (parallel/mesh.py)."""
    E = len(x)
    T, D = x[0].shape
    capacity = int(capacity or -(-2 * T * top_k // E))
    note_collective("all_to_all", axis_name, E, capacity=capacity,
                    top_k=int(top_k))
    routes = [route_tokens(xi, gate_w, E, capacity, top_k, z_loss)
              for xi in x]
    bufs = [dispatch(xi, r[0], r[2], r[3], E, capacity)
            for xi, r in zip(x, routes)]
    # dim 0 (expert) scatters: expert e's position receives every
    # position's rows for it, [E sources, capacity, D]
    recv = all_to_all(bufs, split_axis=0, concat_axis=0)
    w1, b1, w2, b2 = expert_params
    rows = torch.stack([r.reshape(-1, D) for r in recv])  # [E, E*C, D]
    y = expert_ffn(rows, w1, b1, w2, b2)
    back = all_to_all([ye.reshape(E, capacity, D) for ye in y],
                      split_axis=0, concat_axis=0)
    outs = [combine(b, r[0], r[1], r[2], r[3]) for b, r in zip(back, routes)]
    return outs, [r[4] for r in routes]
