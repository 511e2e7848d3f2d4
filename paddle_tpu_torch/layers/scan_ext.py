"""scan_layers: compile N identical layers as ONE scanned body.

TPU-first compile-time lever with no reference analog (Fluid v1.3
unrolls everything): a 12-layer BERT/GPT encoder traced per-layer
produces 12 copies of the layer HLO and XLA compile time scales with
graph size; `lax.scan` over stacked per-layer parameters compiles the
body ONCE regardless of depth — the standard scan-over-layers pattern
of large TPU codebases. Inside the body, ORDINARY layer calls work
unchanged: LayerHelper.create_parameter is intercepted
(layer_helper._ParamStacker) to create one stacked [n_layers, *shape]
parameter per weight and hand the body its per-iteration slice.

Tensors computed OUTSIDE the body (attention bias, rope positions,
segment ids, ...) are captured automatically: free names in the
sub-block become explicit op inputs, broadcast into every iteration,
with gradients flowing back through the capture.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core.program import Variable, unique_name
from ..layer_helper import LayerHelper, _PARAM_STACKERS, _ParamStacker

__all__ = ["scan_layers"]


def scan_layers(x: Variable, n_layers: int,
                layer_fn: Callable[[Variable], Variable],
                remat: bool = False,
                name: Optional[str] = None) -> Variable:
    """Apply ``layer_fn`` ``n_layers`` times as one ``lax.scan``.

    ``layer_fn(x) -> y`` builds ONE layer with ordinary layer calls;
    every parameter it creates is stored stacked ([n_layers, *shape],
    one slice per iteration — checkpoints hold the stacked arrays) and
    y must have x's shape (scan carry contract). Stochastic bodies
    (dropout) draw an independent per-layer key (fold_in by layer
    index), replayed exactly in the backward.

    ``remat=True`` wraps the body in ``jax.checkpoint``: activations
    inside each layer are rematerialized in the backward — the
    standard scan+remat memory profile for deep stacks (peak
    activations O(1) layers instead of O(N)).

    Compared to ``layers.pipeline`` (which also stacks a repeated
    body): pipeline spreads stages over a mesh axis for model scale;
    scan_layers keeps all layers on every device and spends the
    stacking purely on COMPILE TIME. The two compose with tp/sp rules
    like any parameters (patterns match the stacked names; specs get a
    leading None for the layer dim).
    """
    helper = LayerHelper("scan_layers", name=name)
    prog = helper.main_program
    parent = prog.current_block()
    sub = prog.create_block()
    stacker = _ParamStacker(n_layers, sub)
    x_in = sub.create_var(
        name=unique_name.generate(helper.name + ".carry_in"),
        shape=x.shape, dtype=x.dtype)
    _PARAM_STACKERS.append(stacker)
    try:
        out_var = layer_fn(x_in)
    finally:
        _PARAM_STACKERS.pop()
    prog.rollback()
    if tuple(out_var.shape or ()) != tuple(x.shape or ()):
        raise ValueError(
            "scan_layers body must preserve the carry shape: maps %s -> %s"
            % (x.shape, out_var.shape))

    # free names in the body = captured outer tensors (bias, positions,
    # segment ids...): broadcast into every iteration as explicit inputs
    produced = {x_in.name} | set(stacker.slice_names)
    captured: List[str] = []
    for op in sub.ops:
        for nm in op.input_names():
            if nm not in produced and nm not in captured:
                v = parent.vars.get(nm) or prog.global_block().vars.get(nm)
                if v is not None:
                    captured.append(nm)
        produced.update(op.output_names())

    from ..core.recompute import segment_uses_rng

    uses_rng = segment_uses_rng(sub.ops, prog)

    out = parent.create_var(
        name=unique_name.generate(helper.name + ".out"),
        shape=x.shape, dtype=x.dtype)
    outputs = {"Out": [out]}
    if uses_rng:
        rng_var = parent.create_var(
            name=unique_name.generate(helper.name + ".rngkey"),
            shape=[], dtype="float32", persistable=False)
        outputs["RngKey"] = [rng_var]
    parent.append_op(
        type="scan_layers",
        inputs={"X": [x],
                "StackedParams": [p.name for p in stacker.stacked],
                "Captured": captured},
        outputs=outputs,
        attrs={
            "sub_block": sub.idx,
            "n_layers": int(n_layers),
            "slice_names": list(stacker.slice_names),
            "captured_names": list(captured),
            "in_name": x_in.name,
            "out_name": out_var.name,
            "remat": bool(remat),
            "uses_rng": uses_rng,
            "__sub_bound__": [x_in.name] + list(stacker.slice_names)
            + list(captured),
        })
    return out
