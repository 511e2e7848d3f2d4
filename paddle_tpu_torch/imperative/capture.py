"""Dygraph trace capture: record eager ops into a real Program.

The reference's imperative tier executes op-by-op and can never feed the
static toolchain; this module is the bridge (the eager-capture-then-
compile shape of PyTorch->Calyx, arxiv 2512.06177). While a
:class:`CaptureContext` is active, ``trace_op`` still dispatches each op
eagerly AND appends an equivalent :class:`~..core.program.Operator` to a
real :class:`~..core.program.Program` block:

* Eager inputs that are the function's arguments become ``is_data`` feed
  vars with a dynamic leading dim, so the memory engine's ``BytesPoly``
  polynomials stay batch-size-free and every bucket prices from ONE
  analysis.
* Every other ``VarBase`` input (parameters, optimizer moments, BatchNorm
  running stats) becomes persistable captured state — trainable leaves as
  ``Parameter`` so ``append_backward`` finds them, the rest as plain
  persistable vars the executor classifies as write-back state.
* The graph convention's in-place aliasing is reproduced: an output slot
  ``<S>Out`` whose matching input slot ``<S>`` resolved to captured state
  writes to the SAME var name (``adam``'s ParamOut, ``batch_norm``'s
  MeanOut), so ``analyze_block`` sees mutable state, not SSA garbage.
* ``loss.backward()`` under capture routes through the SAME
  ``append_backward`` graph autodiff the static tier uses, then maps each
  eager leaf gradient's array identity to its graph ``@GRAD`` name so a
  following eager optimizer step (``imperative.optimizer.Adam``) resolves
  its Grad inputs to graph vars.
* ``bool()``/``int()``/``float()`` forced on a captured ``VarBase`` are
  recorded as branch GUARDS: the Python control-flow decision the trace
  baked in. Replays re-evaluate the guards (a pruned slice of the
  captured program, run in a throwaway scope) and a mismatch re-traces
  the new branch instead of silently replaying the wrong one.

Provenance: ``imperative/`` is op-appending machinery
(``core/program.py`` ``_MACHINERY_PREFIXES``), so each captured op's
``def_site`` points at the USER's eager line — a lint finding on a
captured program reads like a finding on the eager source.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

from ..core.program import Program

# ops whose lowering is a host callback on concrete values — they cannot
# enter a compiled Program (graph mode uses layers.py_func instead)
_UNCAPTURABLE = frozenset({"py_layer"})

_active: Optional["CaptureContext"] = None


def active() -> Optional["CaptureContext"]:
    """The CaptureContext currently recording, or None (the common,
    zero-overhead case: trace_op checks one module global)."""
    return _active


@contextlib.contextmanager
def capturing(ctx: "CaptureContext"):
    global _active
    if _active is not None:
        raise CaptureError("capture contexts do not nest: a CapturedFunction "
                           "must not be traced inside another trace")
    _active = ctx
    try:
        yield ctx
    finally:
        _active = None


class CaptureError(RuntimeError):
    """An eager construct that cannot be captured into a Program."""


class _Guard:
    """One Python control-flow decision the trace observed: the graph
    var it coerced and the concrete value the branch was taken on."""

    __slots__ = ("var_name", "kind", "value")

    def __init__(self, var_name: str, kind: str, value):
        self.var_name = var_name
        self.kind = kind        # "bool" | "int" | "float"
        self.value = value

    def matches(self, raw) -> bool:
        import numpy as np

        arr = np.asarray(raw)
        if self.kind == "bool":
            return bool(arr) == self.value
        if self.kind == "int":
            return int(arr) == self.value
        return float(arr) == self.value

    def __repr__(self):
        return "Guard(%s %s== %r)" % (self.var_name, self.kind, self.value)


class CaptureContext:
    """One in-flight trace: the Program under construction plus the
    eager-object -> graph-name maps that keep both worlds aligned."""

    def __init__(self, name: str = "captured"):
        self.program = Program()
        # replay must be BITWISE the eager dispatch sequence (params +
        # RNG chain): the executor runs exact_numerics plans unjitted,
        # per-primitive, exactly as eager dispatch does (jit.py's
        # exact_numerics=False opts back into whole-graph compilation)
        self.program.exact_numerics = True
        self.block = self.program.global_block()
        self.name = name
        # id(VarBase) -> graph var name; keepalive pins the objects so a
        # recycled id() can never alias a dead VarBase to a live name
        self._names: Dict[int, str] = {}
        self._keep: List[Any] = []
        # id(torch.Tensor) -> graph @GRAD name (filled by map_grad after
        # backward; arrays pinned for the capture's lifetime)
        self._grad_names: Dict[int, str] = {}
        self._grad_keep: List[Any] = []
        self.feeds: Dict[str, Any] = {}       # feed name -> VarBase
        self.feed_order: List[str] = []
        self.state: Dict[str, Any] = {}       # state name -> VarBase
        self.guards: List[_Guard] = []
        self.param_grads: List[Tuple[Any, Any]] = []  # append_backward result
        self._used_names: set = set()
        self._n_tmp = 0
        self._n_state = 0
        self.used_rng = False

    # ------------------------------------------------------------ naming
    def _unique(self, base: str) -> str:
        name = base
        k = 0
        while name in self._used_names:
            k += 1
            name = "%s_%d" % (base, k)
        self._used_names.add(name)
        return name

    def _bind(self, v, name: str) -> str:
        self._names[id(v)] = name
        self._keep.append(v)
        return name

    # ------------------------------------------------------- registration
    def register_feed(self, v, name: Optional[str] = None) -> str:
        """Declare one function argument as an is_data feed var. The
        leading dim is dynamic (-1) for rank>=1 tensors — the serving
        batch_major convention, and what keeps the captured program's
        MemoryAnalysis a polynomial of B."""
        name = self._unique(name or getattr(v, "name", None)
                            or "arg%d" % len(self.feeds))
        shape = tuple(v.shape)
        decl = (-1,) + shape[1:] if len(shape) >= 1 else shape
        self.block.create_var(name=name, shape=decl, dtype=v.dtype,
                              is_data=True, stop_gradient=v.stop_gradient)
        self.feeds[name] = v
        self.feed_order.append(name)
        return self._bind(v, name)

    def _register_state(self, v) -> str:
        """A non-argument VarBase entering the graph: captured state.
        Trainable eager leaves (stop_gradient=False) become Parameters so
        append_backward's parameter sweep finds them."""
        base = getattr(v, "name", None) or "capture_state_%d" % self._n_state
        self._n_state += 1
        name = self._unique(base)
        if not v.stop_gradient:
            self.block.create_parameter(name=name, shape=tuple(v.shape),
                                        dtype=v.dtype, trainable=True)
        else:
            self.block.create_var(name=name, shape=tuple(v.shape),
                                  dtype=v.dtype, persistable=True,
                                  stop_gradient=True)
        self.state[name] = v
        return self._bind(v, name)

    def name_of(self, v) -> str:
        """Graph name for an eager VarBase: already bound (feed, state or
        a captured op's output), a mapped gradient array, else fresh
        captured state."""
        name = self._names.get(id(v))
        if name is not None:
            return name
        gname = self._grad_names.get(id(v.value))
        if gname is not None:
            return self._bind(v, gname)
        return self._register_state(v)

    def map_grad(self, arr, name: str) -> None:
        """Pin 'this eager gradient array IS graph var ``name``' — how an
        optimizer's Grad inputs resolve after backward."""
        self._grad_names[id(arr)] = name
        self._grad_keep.append(arr)

    # --------------------------------------------------------- recording
    def record_op(self, op_type: str, norm_ins, outs, attrs) -> None:
        """Mirror one eagerly-dispatched op into the captured block."""
        if op_type in _UNCAPTURABLE:
            raise CaptureError(
                "op %r runs a host callback on concrete values and cannot "
                "be captured into a Program — use layers.py_func in graph "
                "mode, or keep this function eager" % op_type)
        inputs: Dict[str, List[str]] = {}
        for slot, vs in norm_ins.items():
            inputs[slot] = [self.name_of(v) if v is not None else ""
                            for v in vs]
        outputs: Dict[str, List[str]] = {}
        for slot, vs in outs.items():
            names: List[str] = []
            for v in vs:
                if v is None:
                    names.append("")
                    continue
                alias = self._alias_for(slot, inputs)
                if alias is not None:
                    names.append(self._bind(v, alias))
                    continue
                tmp = self._unique("capture_tmp_%d" % self._n_tmp)
                self._n_tmp += 1
                self.block.create_var(name=tmp, shape=tuple(v.shape),
                                      dtype=v.dtype)
                names.append(self._bind(v, tmp))
            outputs[slot] = names
        self.block.append_op(type=op_type, inputs=inputs, outputs=outputs,
                             attrs=dict(attrs))

    def _alias_for(self, out_slot: str, inputs) -> Optional[str]:
        """Graph in-place convention: output slot ``<S>Out`` writes the
        SAME var as input slot ``<S>`` when that input is captured
        persistable state (adam ParamOut, batch_norm MeanOut, ...)."""
        if not out_slot.endswith("Out"):
            return None
        in_slot = out_slot[:-3]
        src = inputs.get(in_slot)
        if not src or len(src) != 1 or not src[0]:
            return None
        return src[0] if src[0] in self.state else None

    def record_guard(self, v, kind: str, value) -> None:
        """A bool/int/float coercion under capture = a branch decision
        baked into this trace. Only GRAPH-reachable values guard; a
        coercion of an unseen VarBase (never an op input/output) has no
        graph slice to re-evaluate and cannot vary between replays of
        this trace's inputs anyway."""
        name = self._names.get(id(v))
        if name is None:
            return
        self.guards.append(_Guard(name, kind, value))

    def record_backward(self, loss) -> None:
        """Route the captured program through the static tier's graph
        autodiff (tape -> append_backward: one gradient implementation
        for both tiers), then remember the (param, grad) pairs
        so eager gradients map onto graph @GRAD names."""
        from ..core.backward import append_backward

        loss_name = self._names.get(id(loss))
        if loss_name is None:
            raise CaptureError(
                "backward() target was never captured — the loss must be "
                "produced by ops traced under this capture")
        self.param_grads = append_backward(self.block.var(loss_name))

    def map_leaf_grads(self) -> None:
        """After the eager tape walk filled ``VarBase._grad`` on leaves,
        bind each state leaf's gradient ARRAY to its graph @GRAD name."""
        from ..core.program import grad_var_name

        for name, v in self.state.items():
            g = getattr(v, "_grad", None)
            if g is not None:
                self.map_grad(g, grad_var_name(name))

    # ----------------------------------------------------------- results
    def fetch_names_for(self, result) -> List[str]:
        """Graph names of the traced function's return value(s)."""
        vs = result if isinstance(result, (list, tuple)) else [result]
        names = []
        for v in vs:
            name = self._names.get(id(v))
            if name is None:
                raise CaptureError(
                    "a captured function must return VarBases produced by "
                    "captured ops; got %r" % (v,))
            names.append(name)
        return names
