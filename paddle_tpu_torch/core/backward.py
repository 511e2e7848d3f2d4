"""append_backward: graph autodiff by appending grad ops to the Program.

A copy of paddle_tpu/core/backward.py (the Fluid ``append_backward``:
op-path slice, sum-op dedup of gradient contributions). No tape:
gradients are more ops in the same Program, each ``<type>_grad`` op
lowered by core/autodiff.py or by the op's custom grad lowering, and the
executor runs them eagerly after the forward ops.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .autodiff import ATTR_DIFF, ATTR_FWD_IN, ATTR_FWD_OUT
from .program import Parameter, Variable, grad_var_name, unique_name
from .registry import get_op

__all__ = ["append_backward", "calc_gradient"]


def _is_float(var: Optional[Variable]) -> bool:
    if var is None:
        return True  # unknown vars: assume float temp
    return np.issubdtype(np.dtype(var.dtype if var.dtype != "bool" else "bool"), np.floating)


def _find_op_path(block, loss_name: str, extra_targets: Sequence[str] = ()):
    """Backward slice: ops the loss (transitively) depends on
    (reference backward.py:573 _find_op_path_)."""
    relevant: Set[str] = {loss_name, *extra_targets}
    path = []
    for op in reversed(block.ops):
        if any(n in relevant for n in op.output_names()):
            path.append(op)
            relevant.update(op.input_names())
    path.reverse()
    return path


def _requires_grad_set(block, no_grad: Set[str]) -> Set[str]:
    """Vars that may carry gradient: any float var not marked stop_gradient
    (params, temps, and leaves the caller unfroze — the OpTest numeric-grad
    harness feeds leaf vars with stop_gradient=False). Over-inclusion is
    harmless: a grad op is appended only on the loss's op path."""
    req: Set[str] = set()
    for var in block.vars.values():
        if var.stop_gradient or var.name in no_grad or not _is_float(var):
            continue
        if isinstance(var, Parameter) and not var.trainable:
            continue
        req.add(var.name)
    return req


def _create_grad_var(block, name: str, like: Optional[Variable]):
    if block.has_var(name):
        return block.var(name)
    kw = {}
    if like is not None and like.shape is not None:
        kw = dict(shape=like.shape, dtype=like.dtype)
    return block.create_var(name=name, stop_gradient=True, **kw)


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for `loss`; returns [(param, grad_var)] like the
    reference (backward.py:394)."""
    block = loss.block
    program = block.program
    no_grad: Set[str] = set(no_grad_set or ())
    for var in block.vars.values():
        if var.stop_gradient and not isinstance(var, Parameter):
            no_grad.add(var.name)

    path_ops = _find_op_path(block, loss.name)
    req = _requires_grad_set(block, no_grad)

    # seed d(loss)/d(loss) = 1 (reference: fill_constant then scale-by-1/N
    # lives in the data-parallel engine, not here)
    loss_grad = grad_var_name(loss.name)
    _create_grad_var(block, loss_grad, loss)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={"shape": list(loss.shape or ()), "value": 1.0, "dtype": loss.dtype,
               "__op_role__": "backward"},
    )

    # var -> list of gradient contribution names (summed on materialize)
    contribs: Dict[str, List[str]] = {loss.name: [loss_grad]}

    def materialize(name: str) -> Optional[str]:
        c = contribs.get(name)
        if not c:
            return None
        gname = grad_var_name(name)
        if len(c) == 1:
            if c[0] != gname:
                _create_grad_var(block, gname, block.vars.get(name))
                block.append_op("assign", {"X": [c[0]]}, {"Out": [gname]},
                                {"__op_role__": "backward"})
            contribs[name] = [gname]
            return gname
        _create_grad_var(block, gname, block.vars.get(name))
        block.append_op("sum", {"X": list(c)}, {"Out": [gname]},
                        {"__op_role__": "backward"})
        contribs[name] = [gname]
        return gname

    for op in reversed(path_ops):
        opdef = get_op(op.type)
        if opdef.no_grad:
            continue

        # pick differentiable inputs
        diff: List[Tuple[str, int]] = []
        for slot, names in op.inputs.items():
            if opdef.diff_inputs is not None and slot not in opdef.diff_inputs:
                continue
            for i, n in enumerate(names):
                if not n or n in no_grad or n not in req:
                    continue
                if not _is_float(block.vars.get(n)):
                    continue
                diff.append((slot, i))
        if not diff:
            continue

        # materialize incoming output grads
        out_grads: Dict[str, List[Optional[str]]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs: List[Optional[str]] = []
            for n in names:
                g = materialize(n) if n else None
                gs.append(g)
                any_grad = any_grad or g is not None
            out_grads[slot] = gs
        if not any_grad:
            continue

        grad_inputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            grad_inputs[slot] = list(names)
        for slot, names in op.outputs.items():
            grad_inputs.setdefault(slot, list(names))
        for slot, gs in out_grads.items():
            grad_inputs[slot + "@GRAD"] = [g or "" for g in gs]
        # an empty name is an absent grad; the lowering sees None
        grad_inputs = {
            s: [n for n in ns] for s, ns in grad_inputs.items()
        }

        grad_outputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            outs = []
            for i, n in enumerate(names):
                if (slot, i) in diff:
                    if contribs.get(n):
                        gname = unique_name.generate(grad_var_name(n) + "@RENAME")
                    else:
                        gname = grad_var_name(n)
                    _create_grad_var(block, gname, block.vars.get(n))
                    contribs.setdefault(n, []).append(gname)
                    outs.append(gname)
                else:
                    outs.append("")
            grad_outputs[slot + "@GRAD"] = outs

        attrs = dict(op.attrs)
        attrs[ATTR_FWD_IN] = {s: len(ns) for s, ns in op.inputs.items()}
        attrs[ATTR_FWD_OUT] = {s: len(ns) for s, ns in op.outputs.items()}
        attrs[ATTR_DIFF] = [list(d) for d in diff]
        attrs["__op_role__"] = "backward"
        block.append_op(op.type + "_grad", grad_inputs, grad_outputs, attrs)

    params = (
        [block.var(p) if isinstance(p, str) else p for p in parameter_list]
        if parameter_list
        else block.all_parameters()
    )
    result = []
    for p in params:
        if not p.trainable or p.name in no_grad:
            continue
        g = materialize(p.name)
        if g is not None:
            result.append((p, block.var(g)))
    program._bump()
    return result


def calc_gradient(targets, inputs, target_gradients=None):
    """Reference backward.py:613 analog: grads of targets w.r.t. inputs."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = targets[0].block
    pairs = append_backward(targets[0], parameter_list=None)
    del pairs
    out = []
    for v in inputs:
        g = grad_var_name(v.name)
        out.append(block.var(g) if block.has_var(g) else None)
    return out
