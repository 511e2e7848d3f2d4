"""Generic grad-op lowering via ``torch.func.vjp`` of the forward lowering.

The port's counterpart of paddle_tpu/core/autodiff.py. A grad op
``<type>_grad`` is synthesized on first use (core/registry.py get_op):
its lowering runs the *forward* lowering again under ``torch.func.vjp``
and applies the output cotangents.

The JAX package traces a probe of the forward first to learn which
outputs are floating point; XLA drops that probe as dead code. Run
eagerly, a probe would be a second forward of every op, so here the
vjp'd function returns the float outputs and records which ones they
are as it runs: one forward re-run per generic grad op, not two.

Under bf16 AMP a grad op takes its forward op's class (core/amp.py
``policy_for`` strips ``_grad``), and ``lower_op`` casts its inputs
before this lowering runs: the forward re-runs in the dtypes the forward
ran in, and each output cotangent is cast to its primal's dtype below,
so a bf16 op's input grads come out bf16 and an f32 op's f32.

Ops whose gradient must reuse saved forward state (dropout's mask,
fused_attention's mask) or has a cheaper closed form register a custom
grad lowering instead (registry.register_grad_lowering); it is called
first.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

ATTR_FWD_IN = "__fwd_in_slots__"
ATTR_FWD_OUT = "__fwd_out_slots__"
ATTR_DIFF = "__diff__"


def make_generic_grad(fwd_type: str):
    from .registry import OPS

    def _grad(ctx, ins: Dict[str, List[Any]], attrs: Dict[str, Any]):
        fdef = OPS[fwd_type]
        if fdef.grad_lowering is not None:
            return fdef.grad_lowering(ctx, ins, attrs)

        fwd_in_slots: Dict[str, int] = attrs[ATTR_FWD_IN]
        fwd_out_slots: Dict[str, int] = attrs[ATTR_FWD_OUT]
        diff: List = [tuple(d) for d in attrs[ATTR_DIFF]]

        fwd_ins = {s: list(ins[s])[:n] for s, n in fwd_in_slots.items()}
        pure = ctx.pure()
        forward = fdef.lowering
        if pure.xp is not None:
            # the forward as the cross-process plan completes it
            forward = pure.xp.lowering_for(fwd_type, forward)
        float_outs: List = []  # (slot, index) of the float outputs, set by f

        def f(dvals):
            merged = {s: list(v) for s, v in fwd_ins.items()}
            for s, i in diff:
                merged[s][i] = dvals["%s:%d" % (s, i)]
            outs = forward(pure, merged, attrs)
            outs = {s: _as_list(outs.get(s)) for s in fwd_out_slots}
            float_outs[:] = [(s, i) for s in fwd_out_slots
                             for i, v in enumerate(outs[s])
                             if v is not None and v.is_floating_point()]
            return [outs[s][i] for s, i in float_outs]

        dvals0 = {"%s:%d" % (s, i): fwd_ins[s][i] for s, i in diff}
        primals, vjp = torch.func.vjp(f, dvals0)

        cots = []
        for (s, i), pv in zip(float_outs, primals):
            gslot = ins.get(s + "@GRAD")
            g = gslot[i] if gslot and i < len(gslot) else None
            if g is None:
                g = torch.zeros_like(pv)
            elif g.dtype != pv.dtype or g.shape != pv.shape:
                g = torch.broadcast_to(g.to(pv.dtype), pv.shape)
            cots.append(g)
        (dins,) = vjp(cots)

        out: Dict[str, List[Any]] = {}
        for s, n in fwd_in_slots.items():
            out[s + "@GRAD"] = [None] * n
        for s, i in diff:
            out[s + "@GRAD"][i] = dins["%s:%d" % (s, i)]
        return out

    return _grad


def _as_list(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]
