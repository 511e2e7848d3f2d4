"""Parallelism-extension layers: pipeline stage stacks (pp) and MoE (ep).

The reference (Fluid v1.3) has neither; these are the TPU-first
extensions that complete the dp/tp/sp/pp/ep set at the *framework* level
— Program-built models reach `parallel/pipeline.py` / `parallel/moe.py`
through ordinary layer calls, and ParallelEngine picks the collective
path when its mesh carries the matching axis (see
`ops/pipeline_ops.py`, `ops/moe_ops.py`).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..core.program import Variable, unique_name
from ..initializer import Constant, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["pipeline", "moe_ffn"]


class StageBuilder:
    """Handed to the stage-body callback of ``pipeline``: creates
    per-stage parameters that are STORED stacked with a leading
    [n_stages] dim (one slice per pipeline device) and returns the
    current stage's slice as an ordinary variable the body's ops
    consume."""

    def __init__(self, helper: LayerHelper, sub_block, n_stages: int):
        self._helper = helper
        self._sub = sub_block
        self.n_stages = n_stages
        self.stacked: List[Variable] = []      # [n_stages, *shape] params
        self.slice_names: List[str] = []       # per-stage views in the body

    def param(self, shape, dtype: str = "float32", is_bias: bool = False,
              initializer=None) -> Variable:
        shape = [int(s) for s in shape]
        init = initializer or (Constant(0.0) if is_bias else Xavier())
        stacked = self._helper.create_parameter(
            ParamAttr(initializer=init), [self.n_stages] + shape, dtype,
            is_bias=is_bias)
        slice_var = self._sub.create_var(
            name=unique_name.generate(stacked.name + ".stage"),
            shape=tuple(shape), dtype=dtype)
        self.stacked.append(stacked)
        self.slice_names.append(slice_var.name)
        return slice_var


def pipeline(x: Variable, n_stages: int,
             stage_fn: Callable[[StageBuilder, Variable], Variable],
             n_microbatches: Optional[int] = None,
             name: Optional[str] = None) -> Variable:
    """GPipe-style stack of ``n_stages`` identical stages.

    ``stage_fn(pb, x) -> y`` builds ONE stage's computation (ordinary
    layer calls on ``x``); per-stage weights come from ``pb.param(...)``
    and are stored stacked. The classic GPipe contract applies: every
    stage maps activations of one shape to the same shape (y.shape ==
    x.shape). Stochastic bodies (dropout) are supported: one base PRNG
    key per pipeline op is folded per (stage, microbatch) and replayed
    in the backward (recompute's RngKey pattern), so the pipelined and
    sequential paths produce identical masks.

    Single device: the stages apply sequentially. Under ParallelEngine
    with a mesh 'pipe' axis of size n_stages: stages run one-per-device
    with ``lax.ppermute`` activation hops and microbatch overlap
    (parallel/pipeline.py); the engine shards the stacked params (and
    their optimizer slots) over the axis automatically — the layer
    records them on ``program._pipeline_params`` and
    ``ParallelEngine._with_ext_rules`` injects the 'pipe' rules; an
    explicit user rule for a stacked param overrides. Stages are
    per-sample maps, so both paths compute identical results.

    n_microbatches (default n_stages) splits the batch on the pipelined
    path; the batch size must be divisible by it.
    """
    helper = LayerHelper("pipeline", name=name)
    prog = helper.main_program
    parent = prog.current_block()
    sub = prog.create_block()
    pb = StageBuilder(helper, sub, n_stages)
    x_in = sub.create_var(
        name=unique_name.generate(helper.name + ".stage_in"),
        shape=x.shape, dtype=x.dtype)
    out_var = stage_fn(pb, x_in)
    prog.rollback()
    if tuple(out_var.shape or ()) != tuple(x.shape or ()):
        raise ValueError(
            "pipeline stage must preserve the activation shape (GPipe "
            "contract): body maps %s -> %s" % (x.shape, out_var.shape))
    # stochastic stage bodies (dropout) are supported via recompute's
    # RngKey pattern: one base key per pipeline op, folded per
    # (stage, microbatch) and replayed in the grad (ops/pipeline_ops.py)
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
        type="pipeline",
        inputs={"X": [x], "StackedParams": [p.name for p in pb.stacked]},
        outputs=outputs,
        attrs={
            "sub_block": sub.idx,
            "n_stages": int(n_stages),
            "n_microbatches": int(n_microbatches or n_stages),
            "slice_names": list(pb.slice_names),
            "in_name": x_in.name,
            "out_name": out_var.name,
            "axis": "pipe",
            "uses_rng": uses_rng,
            "__sub_bound__": [x_in.name] + list(pb.slice_names),
        })
    # record for ParallelEngine's automatic 'pipe' sharding rules
    pp = getattr(prog, "_pipeline_params", None)
    if pp is None:
        pp = prog._pipeline_params = []
    pp.extend(p.name for p in pb.stacked)
    return out


def moe_ffn(x: Variable, n_experts: int, d_hidden: int,
            capacity: Optional[int] = None, top_k: int = 1,
            z_loss: float = 0.0, name: Optional[str] = None):
    """Switch/GShard mixture-of-experts FFN (see ops/moe_ops.py).

    x: [B, D] (or [B, S, D], flattened internally). Returns (out, aux)
    where out has x's shape and aux is the Switch load-balancing loss
    (top_k=1 is Switch routing; top_k>=2 routes each token to its k
    best experts with renormalized gates, GShard-style) —
    add ``aux_weight * aux`` into the training objective or routing
    collapses. ``z_loss`` > 0 folds the ST-MoE router z-loss
    (``z_loss * mean(logsumexp(router logits)^2)``) into aux, keeping
    router logits small — the bf16-stability regularizer. Expert
    weights are stored stacked [n_experts, ...]; under a ParallelEngine
    mesh with an 'expert' axis of size n_experts the tokens shuffle to
    their expert's device with all_to_all, otherwise every expert
    computes locally (identical math).
    """
    if not 1 <= int(top_k) <= int(n_experts):
        raise ValueError(
            "moe_ffn top_k must be in [1, n_experts]; got top_k=%s with "
            "n_experts=%s" % (top_k, n_experts))
    helper = LayerHelper("moe_ffn", name=name)
    D = int(x.shape[-1])
    mk = helper.create_parameter  # stacked expert weights + router
    w1 = mk(ParamAttr(), [n_experts, D, d_hidden], "float32")
    b1 = mk(ParamAttr(initializer=Constant(0.0)), [n_experts, d_hidden],
            "float32", is_bias=True)
    w2 = mk(ParamAttr(), [n_experts, d_hidden, D], "float32")
    b2 = mk(ParamAttr(initializer=Constant(0.0)), [n_experts, D],
            "float32", is_bias=True)
    gate = mk(ParamAttr(), [D, n_experts], "float32")
    out = helper.create_variable_for_type_inference(x.dtype)
    aux = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [x], "W1": [w1], "B1": [b1], "W2": [w2], "B2": [b2],
                "Gate": [gate]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"n_experts": int(n_experts),
               "capacity": int(capacity) if capacity else 0,
               "top_k": int(top_k),
               "z_loss": float(z_loss),
               "axis": "expert"})
    out.shape = x.shape
    aux.shape = ()
    prog = helper.main_program
    ep = getattr(prog, "_expert_params", None)
    if ep is None:
        ep = prog._expert_params = []
    ep.extend([w1.name, b1.name, w2.name, b2.name])
    return out, aux
