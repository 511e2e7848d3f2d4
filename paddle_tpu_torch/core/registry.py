"""Op registry: op type -> lowering rule (+ optional custom grad).

The same registry as paddle_tpu/core/registry.py, holding PyTorch
lowerings: a lowering is a function from torch tensors to torch tensors
with the same ``fn(ctx, ins, attrs) -> {slot: [values]}`` contract, so
one Program (op types, slots, attrs) runs in both packages. The
executor calls the lowerings eagerly in program order.

Gradients: ``get_op`` synthesizes a ``*_grad`` op from the forward
lowering (core/autodiff.py, ``torch.func.vjp``); an op registers a custom
grad lowering only where its grad must differ from the vjp of its
forward (dropout reusing its saved mask) or has a cheaper closed form.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

__all__ = ["OpDef", "register_op", "get_op", "has_op", "all_ops", "OPS"]

# lowering signature: fn(ctx, ins: Dict[slot, List[torch.Tensor]], attrs) ->
#                     Dict[slot, List[torch.Tensor]]
LoweringFn = Callable[[Any, Dict[str, List[Any]], Dict[str, Any]], Dict[str, List[Any]]]


class OpDef:
    def __init__(
        self,
        type: str,
        lowering: LoweringFn,
        grad_maker: Optional[Callable] = None,
        grad_lowering: Optional[LoweringFn] = None,
        no_grad: bool = False,
        diff_inputs: Optional[List[str]] = None,
        uses_rng: bool = False,
        infer_shape: Optional[Callable] = None,
        needs_env: bool = False,
        synthesized: bool = False,
        host_sync: bool = False,
    ):
        self.type = type
        self.lowering = lowering
        self.grad_maker = grad_maker  # custom append-backward rule, if any
        self.grad_lowering = grad_lowering  # custom grad lowering, if any
        self.no_grad = no_grad  # op is never differentiated (optimizers, io)
        # slots that may carry gradients; None = all float inputs
        self.diff_inputs = diff_inputs
        self.uses_rng = uses_rng
        # compile-time shape/dtype rule: fn(InferContext) -> None, registered
        # either at register_op time or attached later via
        # register_shape_rule (analysis/shape_rules.py ships the core set)
        self.infer_shape = infer_shape
        # True for *_grad OpDefs synthesized lazily by get_op from the
        # forward lowering (they carry no hand-written kernel of their own)
        self.synthesized = synthesized
        # control-flow ops get the live lowering env injected as
        # attrs["__env__"] and may return {"__env_update__": {...}}
        self.needs_env = needs_env
        # the lowering reads a value on the host (a loop's condition, a
        # Python callback's inputs): a step that holds such an op at any
        # depth cannot be captured as a CUDA graph (core/executor.py)
        self.host_sync = host_sync
        # what the op does to inputs split by rows over trainer ranks
        # (the data axis across processes): "local", "reduce",
        # "batch_norm", "accuracy", "gather_rows", "random" or
        # "optimizer"; None: no rule, such an input raises at plan time
        # (parallel/partition.py attaches them, register_row_rule)
        self.rows = None


OPS: Dict[str, OpDef] = {}


def register_op(
    type: str,
    *,
    grad_maker=None,
    grad_lowering=None,
    no_grad: bool = False,
    diff_inputs: Optional[List[str]] = None,
    uses_rng: bool = False,
    infer_shape=None,
    needs_env: bool = False,
    host_sync: bool = False,
):
    """Decorator: @register_op("softmax") def _softmax(ctx, ins, attrs): ..."""

    def deco(fn: LoweringFn) -> LoweringFn:
        if type in OPS:
            raise ValueError("op %r registered twice" % type)
        OPS[type] = OpDef(
            type,
            fn,
            grad_maker=grad_maker,
            grad_lowering=grad_lowering,
            no_grad=no_grad,
            diff_inputs=diff_inputs,
            uses_rng=uses_rng,
            infer_shape=infer_shape,
            needs_env=needs_env,
            host_sync=host_sync,
        )
        return fn

    return deco


def register_grad_lowering(fwd_type: str):
    """Attach a custom grad lowering to an already-registered op."""

    def deco(fn: LoweringFn) -> LoweringFn:
        if fwd_type not in OPS:
            raise KeyError(
                "cannot attach a grad lowering to op %r: it has no "
                "registered forward lowering (known: %d ops) — register "
                "the forward op first" % (fwd_type, len(OPS))
            )
        OPS[fwd_type].grad_lowering = fn
        return fn

    return deco


def register_shape_rule(*op_types: str):
    """Attach a compile-time shape/dtype inference rule to already-
    registered ops (fills the OpDef.infer_shape hook — the analog of the
    reference's per-op InferShape). The rule receives an
    ``analysis.InferContext`` and sets output shapes/dtypes or calls
    ``ctx.fail(msg)`` on a mismatch. Raises for unregistered op types so
    a typo'd rule never silently no-ops."""

    def deco(fn: Callable) -> Callable:
        for t in op_types:
            if t not in OPS:
                raise KeyError(
                    "cannot attach a shape rule to op %r: it has no "
                    "registered lowering (known: %d ops)" % (t, len(OPS))
                )
            OPS[t].infer_shape = fn
        return fn

    return deco


def register_row_rule(rule: str, *op_types: str) -> None:
    """Attach the row rule ``rule`` (see ``OpDef.rows``) to registered
    ops; raises for an unregistered type so a typo never silently
    leaves an op without one."""
    for t in op_types:
        if t not in OPS:
            raise KeyError("cannot attach a row rule to op %r: it has no "
                           "registered lowering" % t)
        OPS[t].rows = rule


def get_op(type: str) -> OpDef:
    if type not in OPS:
        if type.endswith("_grad") and type[:-5] in OPS:
            # synthesize the grad op from the forward lowering (see autodiff)
            from .autodiff import make_generic_grad

            OPS[type] = OpDef(type, make_generic_grad(type[:-5]),
                              no_grad=True, synthesized=True)
        else:
            raise KeyError(
                "op %r has no registered lowering (known: %d ops)" % (type, len(OPS))
            )
    return OPS[type]


def has_op(type: str) -> bool:
    return type in OPS or (type.endswith("_grad") and type[:-5] in OPS)


def all_ops() -> List[str]:
    """Sorted registered op types. ``*_grad`` ops whose lowering is derived
    mechanically from the forward (via torch.func.vjp, see core.autodiff) are
    synthesized LAZILY by get_op — they appear here only once something
    has requested them (their OpDef carries ``synthesized=True``).
    Eagerly materializing all of them would double the registry with
    entries that add no information beyond ``<fwd> in OPS``; use
    ``has_op("<fwd>_grad")`` to test differentiability instead of
    scanning this list."""
    return sorted(OPS)
