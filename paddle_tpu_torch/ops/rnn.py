"""Recurrent ops over padded batches: ``lstm``, ``gru``, ``lstmp``,
``gru_unit`` and the programmable ``recurrent``.

The port of paddle_tpu/ops/rnn.py. Where the JAX package runs
``lax.scan`` over the time axis, the port runs a Python loop of torch
ops over the static time axis; the ``Length`` freeze is a
``torch.where`` on the device, so the loop holds no host sync and a
step that runs it is captured as one CUDA graph like any other.

The JAX package's contracts hold:
  - the input is pre-projected: [B, S, 4D] for lstm, [B, S, 3D] for gru
    (the layer applies the input fc);
  - with a ``Length`` input [B], steps past a row's length keep its
    state and emit zeros; ``is_reverse`` walks the time axis backwards
    with the mask indexed in walking order, as the JAX scan does;
  - gate order i, f, g (candidate), o for lstm and u, r, c for gru,
    with ``origin_mode`` as there.

``lstm``, ``gru``, ``lstmp`` and ``gru_unit`` take the generic
``torch.func.vjp`` grad, as they take ``jax.vjp`` there. ``recurrent``
(StaticRNN and DynamicRNN, layers/rnn_blocks.py) lowers its step
sub-block once per step; its grad re-runs the loop under autograd, the
way ops/recompute_ops.py re-runs a segment, and replays the random
streams the forward drew: the forward records a token per chain draw
(``LowerContext.streams``: the seed, or under a CUDA graph hook its
slot) and exports them as ``UsedRng`` (a ``SegmentStreams``), and the
re-run takes them back in order (``LowerContext.replay``), so its
dropout masks are the forward's bit for bit, eager or replayed.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core.autodiff import ATTR_DIFF
from ..core.lowering import LowerContext, lower_block
from ..core.registry import register_grad_lowering, register_op
from .recompute_ops import SegmentStreams

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _alive(t, length, like):
    """[B, 1, ...] bool: whether each row is still inside its length at
    step ``t``."""
    return (length > t).reshape((-1,) + (1,) * (like.ndim - 1))


def _mask_scan(step, init, xs_t, length):
    """The scan with the per-step freeze: xs_t is [S, B, *]; returns the
    per-step outputs, each stacked to [S, B, *]."""
    carry = tuple(init)
    outs: List[List[torch.Tensor]] = []
    for t in range(xs_t.shape[0]):
        new_carry, out = step(carry, xs_t[t])
        if length is not None:
            alive = _alive(t, length, out[0])
            new_carry = tuple(torch.where(alive, n, c)
                              for n, c in zip(new_carry, carry))
            out = tuple(torch.where(alive, o, torch.zeros_like(o))
                        for o in out)
        carry = new_carry
        outs.append(list(out))
    return [torch.stack(col) for col in zip(*outs)]


def _opt(ins, slot):
    return (ins.get(slot) or [None])[0]


@register_op("lstm", diff_inputs=["Input", "Weight", "Bias", "H0", "C0"])
def _lstm(ctx, ins, attrs):
    x = ins["Input"][0]                      # [B, S, 4D]
    w = ins["Weight"][0]                     # [D, 4D]
    b = _opt(ins, "Bias")                    # [1, 4D]
    length = _opt(ins, "Length")
    B, S, four_d = x.shape
    D = four_d // 4
    h0, c0 = _opt(ins, "H0"), _opt(ins, "C0")
    h0 = x.new_zeros((B, D)) if h0 is None else h0
    c0 = x.new_zeros((B, D)) if c0 is None else c0
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    reverse = attrs.get("is_reverse", False)

    def step(carry, xt):
        h, c = carry
        g = xt + h @ w
        if b is not None:
            g = g + b.reshape(1, -1)
        i, f, gg, o = torch.chunk(g, 4, dim=-1)
        i, f, o = gate_act(i), gate_act(f), gate_act(o)
        gg = cand_act(gg)
        c2 = f * c + i * gg
        h2 = o * cell_act(c2)
        return (h2, c2), (h2, c2)

    xs = x.transpose(0, 1)                   # [S, B, 4D]
    if reverse:
        xs = xs.flip(0)
    hs, cs = _mask_scan(step, (h0, c0), xs, length)
    if reverse:
        hs, cs = hs.flip(0), cs.flip(0)
    return {"Hidden": [hs.transpose(0, 1)], "Cell": [cs.transpose(0, 1)]}


@register_op("gru", diff_inputs=["Input", "Weight", "Bias", "H0"])
def _gru(ctx, ins, attrs):
    x = ins["Input"][0]                      # [B, S, 3D]
    w = ins["Weight"][0]                     # [D, 3D]: [u|r | c]
    b = _opt(ins, "Bias")
    length = _opt(ins, "Length")
    B, S, three_d = x.shape
    D = three_d // 3
    h0 = _opt(ins, "H0")
    h0 = x.new_zeros((B, D)) if h0 is None else h0
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACT[attrs.get("activation", "tanh")]
    reverse = attrs.get("is_reverse", False)
    origin_mode = attrs.get("origin_mode", False)
    w_ur, w_c = w[:, : 2 * D], w[:, 2 * D:]
    b_ur = b_c = None
    if b is not None:
        b_ur, b_c = b.reshape(1, -1)[:, : 2 * D], b.reshape(1, -1)[:, 2 * D:]

    def step(carry, xt):
        (h,) = carry
        x_ur, x_c = xt[:, : 2 * D], xt[:, 2 * D:]
        g_ur = x_ur + h @ w_ur
        if b_ur is not None:
            g_ur = g_ur + b_ur
        u, r = torch.chunk(gate_act(g_ur), 2, dim=-1)
        g_c = x_c + (r * h) @ w_c
        if b_c is not None:
            g_c = g_c + b_c
        c = cand_act(g_c)
        # origin_mode: h' = u*h + (1-u)*c; default: h' = (1-u)*h + u*c
        h2 = u * h + (1 - u) * c if origin_mode else (1 - u) * h + u * c
        return (h2,), (h2,)

    xs = x.transpose(0, 1)
    if reverse:
        xs = xs.flip(0)
    (hs,) = _mask_scan(step, (h0,), xs, length)
    if reverse:
        hs = hs.flip(0)
    return {"Hidden": [hs.transpose(0, 1)]}


@register_op("lstmp", diff_inputs=["Input", "Weight", "ProjWeight", "Bias",
                                   "H0", "C0"])
def _lstmp(ctx, ins, attrs):
    """LSTM with a recurrent projection: the gates read the projected
    hidden r [B, P]; r = proj_act(h @ W_proj)."""
    x = ins["Input"][0]                      # [B, S, 4D]
    w = ins["Weight"][0]                     # [P, 4D]
    wp = ins["ProjWeight"][0]                # [D, P]
    b = _opt(ins, "Bias")
    length = _opt(ins, "Length")
    B, S, four_d = x.shape
    D = four_d // 4
    P = wp.shape[1]
    r0, c0 = _opt(ins, "H0"), _opt(ins, "C0")
    r0 = x.new_zeros((B, P)) if r0 is None else r0
    c0 = x.new_zeros((B, D)) if c0 is None else c0
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACT[attrs.get("cell_activation", "tanh")]
    cand_act = _ACT[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACT[attrs.get("proj_activation", "tanh")]

    def step(carry, xt):
        r, c = carry
        g = xt + r @ w
        if b is not None:
            g = g + b.reshape(1, -1)
        i, f, gg, o = torch.chunk(g, 4, dim=-1)
        i, f, o = gate_act(i), gate_act(f), gate_act(o)
        c2 = f * c + i * cand_act(gg)
        h2 = o * cell_act(c2)
        r2 = proj_act(h2 @ wp)
        return (r2, c2), (r2, c2)

    rs_, cs = _mask_scan(step, (r0, c0), x.transpose(0, 1), length)
    return {"Projection": [rs_.transpose(0, 1)],
            "Cell": [cs.transpose(0, 1)]}


@register_op("gru_unit", diff_inputs=["Input", "HiddenPrev", "Weight",
                                      "Bias"])
def _gru_unit(ctx, ins, attrs):
    """One GRU step: u / r gates from the pre-projected input plus
    HiddenPrev @ W[:, :2D], the candidate from (r * HiddenPrev) @
    W[:, 2D:], h = (1 - u) * h_prev + u * c (``origin_mode`` flips the
    mix)."""
    x = ins["Input"][0]                        # [B, 3D]
    h_prev = ins["HiddenPrev"][0]              # [B, D]
    w = ins["Weight"][0]                       # [D, 3D]
    b = _opt(ins, "Bias")                      # [1, 3D]
    D = h_prev.shape[-1]
    act = _ACT[attrs.get("activation", "tanh")]
    gate_act = _ACT[attrs.get("gate_activation", "sigmoid")]
    origin = bool(attrs.get("origin_mode", False))

    g = x if b is None else x + b
    g = g.to(torch.float32)
    gates = g[:, :2 * D] + h_prev @ w[:, :2 * D]
    u = gate_act(gates[:, :D])
    r = gate_act(gates[:, D:])
    reset_h = r * h_prev
    c = act(g[:, 2 * D:] + reset_h @ w[:, 2 * D:])
    if origin:
        h = u * h_prev + (1.0 - u) * c
    else:
        h = (1.0 - u) * h_prev + u * c
    return {"Hidden": [h.to(h_prev.dtype)],
            "ResetHiddenPrev": [reset_h.to(h_prev.dtype)],
            "Gate": [torch.cat([u, r, c], dim=-1).to(x.dtype)]}


# ----------------------------------------------------------------- recurrent
def _run_recurrent(ctx, block, xs, inits, params, length, attrs,
                   streams=None, replay=None):
    """The step loop shared by the forward and its grad's re-run:
    (stacked step outputs, final states)."""
    step_in = attrs["step_in_names"]
    pre = attrs["pre_state_names"]
    nxt = attrs["next_state_names"]
    souts = attrs["step_out_names"]
    pnames = attrs["param_names"]
    time_major = attrs.get("time_major", True)

    if not xs:
        raise ValueError("recurrent op needs at least one step input")
    if not time_major:
        xs = [x.transpose(0, 1) for x in xs]
    sctx = LowerContext(block, ctx._rng, ctx.device, ctx.is_test, ctx.amp,
                        ctx.graph, **ctx.mesh_kw())
    sctx.streams, sctx.replay = streams, replay
    states = list(inits)
    ys: List[List[torch.Tensor]] = []
    for t in range(xs[0].shape[0]):
        local: Dict[str, Any] = dict(zip(pnames, params))
        local.update(zip(pre, states))
        local.update((n, x[t]) for n, x in zip(step_in, xs))
        lower_block(sctx, block, local)
        new_states = [local[n] for n in nxt]
        y = [local[n] for n in souts]
        if length is not None:
            new_states = [torch.where(_alive(t, length, s), s, old)
                          for s, old in zip(new_states, states)]
            y = [torch.where(_alive(t, length, v), v, torch.zeros_like(v))
                 for v in y]
        states = new_states
        ys.append(y)
    outs = [torch.stack(col) for col in zip(*ys)] if souts else []
    if not time_major:
        outs = [y.transpose(0, 1) for y in outs]
    return outs, states


def _draws(ctx, block) -> bool:
    """Whether the step block draws random streams to record (its
    nested sub-blocks included)."""
    from ..core.recompute import segment_uses_rng

    return segment_uses_rng(block.ops, block.program) and \
        ctx._rng is not None


@register_op("recurrent", diff_inputs=["inputs", "initial_states",
                                       "parameters"], uses_rng=True)
def _recurrent(ctx, ins, attrs):
    """User-programmable RNN: the step sub-block lowered once per step.

    carry = the states (pre_state_names -> next_state_names); step
    inputs are sliced on the time axis and step outputs stacked back on
    it; params = every outer var the sub-block reads (explicit op
    inputs, so append_backward reaches the weights used inside). With a
    ``SequenceLength`` input (DynamicRNN) finished rows keep their state
    and emit zeros; ``time_major=False`` walks axis 1. ``UsedRng``
    holds the streams the steps drew, for the grad's replay."""
    block = ctx.block.program.block(attrs["sub_block"])
    streams = [] if _draws(ctx, block) else None
    ys, finals = _run_recurrent(
        ctx, block, list(ins.get("inputs") or []),
        list(ins.get("initial_states") or []),
        list(ins.get("parameters") or []), _opt(ins, "SequenceLength"),
        attrs, streams=streams)
    return {"outputs": ys, "final_states": finals,
            "UsedRng": [SegmentStreams(streams or ())]}


@register_grad_lowering("recurrent")
def _recurrent_grad(ctx, ins, attrs):
    """The loop again under autograd over detached inputs, with the
    forward's random streams replayed; the output and final-state
    cotangents applied with ``torch.autograd.grad``."""
    block = ctx.block.program.block(attrs["sub_block"])
    slots = ("inputs", "initial_states", "parameters")
    vals = {s: list(ins.get(s) or []) for s in slots}
    used = _opt(ins, "UsedRng")
    tokens = list(used.tokens) if isinstance(used, SegmentStreams) else []

    leaves = []
    diff = [tuple(d) for d in attrs[ATTR_DIFF]]
    for slot, i in diff:
        v = vals[slot][i]
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            vals[slot][i] = v.detach().requires_grad_()
            leaves.append((slot, i, vals[slot][i]))
    replay = list(tokens) if tokens else None
    with torch.enable_grad():
        ys, finals = _run_recurrent(
            ctx, block, vals["inputs"], vals["initial_states"],
            vals["parameters"], _opt(ins, "SequenceLength"), attrs,
            replay=replay)
    if replay:
        raise RuntimeError(
            "a recurrent op's grad drew %d random streams fewer than its "
            "forward drew" % len(replay))

    primals, cots = [], []
    for outs, gslot in ((ys, "outputs@GRAD"), (finals,
                                              "final_states@GRAD")):
        grads = ins.get(gslot) or []
        for j, pv in enumerate(outs):
            if not pv.requires_grad:
                continue
            g = grads[j] if j < len(grads) else None
            if g is None:
                continue
            if g.dtype != pv.dtype or g.shape != pv.shape:
                g = torch.broadcast_to(g.to(pv.dtype), pv.shape)
            primals.append(pv)
            cots.append(g)
    dins = (torch.autograd.grad(primals, [v for _, _, v in leaves], cots,
                                allow_unused=True)
            if primals and leaves else [None] * len(leaves))
    out = {s + "@GRAD": [None] * len(vals[s]) for s in slots}
    for (slot, i, v), d in zip(leaves, dins):
        out[slot + "@GRAD"][i] = d if d is not None else torch.zeros_like(v)
    return out
