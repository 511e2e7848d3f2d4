"""moe_ffn op: switch-routed expert FFN as one graph op (top-1 Switch by
default, top_k=2 GShard-style).

The port of paddle_tpu/ops/moe_ops.py. Expert weights arrive stacked
[E, ...]. One lowering serves every mesh: ``parallel.moe.route_tokens``
(static capacity, choice-major priority, overflow tokens contribute
zero, the aux load-balancing loss), then each expert's FFN on the
capacity rows routed to it, the experts' products batched into one
launch, then each token's kept rows gathered back, gated and summed.
Under a ``ParallelEngine`` mesh with an 'expert' axis of size E, expert
e sits at position e and one ``all_gather`` brings the [E, capacity, D]
rows back for the token-side gather: the tokens are replicated under
the engine's global semantics, so every position routes them alike and
none travels. The positions share a device, so the gathered rows are
the ones already computed; the collective is noted, not copied. The
JAX package's single-device path computes every expert on every token
and selects by routing: the same values to rounding (the tests hold
the two together).
"""

from __future__ import annotations

from typing import List

from ..core.registry import register_op

__all__: List[str] = []


def _moe(x, w1, b1, w2, b2, gate_w, E, capacity, top_k, z_loss, axis):
    """Route, each expert's FFN on its capacity rows, combine; notes the
    ``all_gather`` over ``axis`` where the mesh has one."""
    from ..parallel import mesh as pm
    from ..parallel.moe import combine, dispatch, expert_ffn, route_tokens

    expert_idx, gate, pos, keep, aux = route_tokens(x, gate_w, E, capacity,
                                                    top_k, z_loss)
    buf = dispatch(x, expert_idx, pos, keep, E, capacity)
    ys = expert_ffn(buf, w1, b1, w2, b2)                 # [E, capacity, D]
    if axis is not None:
        pm.note_collective("all_gather", axis, E, capacity=capacity,
                           top_k=int(top_k))
    return combine(ys, expert_idx, gate, pos, keep), aux


@register_op("moe_ffn",
             diff_inputs=["X", "W1", "B1", "W2", "B2", "Gate"],
             needs_env=False)
def _moe_ffn(ctx, ins, attrs):
    x = ins["X"][0]
    w1, b1, w2, b2 = ins["W1"][0], ins["B1"][0], ins["W2"][0], ins["B2"][0]
    gate_w = ins["Gate"][0]
    E = int(attrs["n_experts"])
    axis = attrs.get("axis", "expert")
    top_k = int(attrs.get("top_k", 1))
    z_loss = float(attrs.get("z_loss", 0.0))

    D = x.shape[-1]
    xf = x.reshape(-1, D)
    T = xf.shape[0]
    capacity = int(attrs.get("capacity") or -(-2 * T * top_k // E))

    mesh = ctx.mesh
    use_ep = mesh is not None and axis in mesh.axis_names \
        and mesh.shape[axis] > 1
    if use_ep and mesh.shape[axis] != E:
        raise ValueError(
            "moe_ffn with n_experts=%d under a mesh whose %r axis has %d "
            "devices — experts map one-per-device" % (E, axis,
                                                      mesh.shape[axis]))
    out, aux = _moe(xf, w1, b1, w2, b2, gate_w, E, capacity, top_k, z_loss,
                    axis if use_ep else None)
    return {"Out": [out.reshape(x.shape)], "AuxLoss": [aux]}
