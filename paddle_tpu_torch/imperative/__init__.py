"""Imperative (dygraph) mode: eager op execution with a tape.

The port of paddle_tpu/imperative/__init__.py (the reference's
paddle/fluid/imperative/: ``Tracer::Trace`` records each eagerly
executed op and its grad op; ``VarBase`` pairs a value with its
gradient; ``Layer`` is the module base).

An eager op IS its registered torch lowering applied to concrete
tensors (op-by-op dispatch, bypassing the Program). ``backward()`` walks
the tape in reverse and invokes the SAME grad-op lowerings the graph
Executor runs (core/autodiff.py's ``torch.func.vjp`` of the forward,
or a custom grad lowering such as dropout's saved mask), so graph mode
and dygraph share one gradient implementation. The walk drops each
tape entry, and the gradients of its outputs, once it has consumed
them: a deep encoder holds its activations once, not twice.

Where the JAX package holds a ``jax.Array`` and a ``PRNGKey`` chain:

* ``VarBase.value`` is a ``torch.Tensor`` on the guard's place: the
  card by default, the CPU under ``guard(place=CPUPlace())``. A numpy
  value converts as ``jnp.asarray`` converts it with x64 off: float64 to
  float32, int64 to int32 (range-checked, as every feed is).
* The ``Tracer``'s key chain is a CPU ``torch.Generator`` that hands out
  seeds (``core.lowering.draw_seed``): each random op's stream is a
  generator on the device seeded from it, the scheme of
  core/lowering.py, so an eager step and its captured Program
  (``imperative.jit``) draw the same masks and advance the chain alike.
* Eager ops run under ``torch.no_grad()``, as the executor's steps do:
  gradients come from the tape.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.autodiff import ATTR_DIFF, ATTR_FWD_IN, ATTR_FWD_OUT
from ..core.lowering import (LowerContext, as_torch_dtype, draw_seed,
                             seeded_generator)
from ..core.place import default_place, require_device
from ..core import registry as _registry
from ..core.registry import get_op
from . import capture as _capture
from .capture import CaptureError

__all__ = ["guard", "enabled", "to_variable", "VarBase", "Tracer", "Layer",
           "PyLayer", "trace_op", "jit", "CapturedFunction", "CaptureError"]

_tracer: Optional["Tracer"] = None


def enabled() -> bool:
    return _tracer is not None


@contextlib.contextmanager
def guard(place=None, seed: int = 0):
    """Enable dygraph mode (python/paddle/fluid/imperative/base.py guard
    analog) on ``place``: the card unless the caller passes
    ``CPUPlace()``."""
    global _tracer
    old = _tracer
    _tracer = Tracer(seed=seed, place=place)
    try:
        yield
    finally:
        _tracer = old


def get_tracer() -> "Tracer":
    if _tracer is None:
        raise RuntimeError("imperative ops need `with imperative.guard():`")
    return _tracer


def _device() -> torch.device:
    """Where new VarBases live: the active guard's place, else the
    card."""
    if _tracer is not None:
        return _tracer.device
    return require_device(default_place().torch_device())


_NARROW = {np.dtype("float64"): np.float32, np.dtype("int64"): np.int32,
           np.dtype("uint64"): np.int32}


def _as_tensor(value, dtype=None, device=None) -> torch.Tensor:
    """A VarBase's value: a tensor stays where it is; anything else
    converts as ``jnp.asarray`` would with x64 off (float64 -> float32,
    int64 -> int32 with a range check) onto ``device`` (default the
    guard's place)."""
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(dtype)
    arr = np.asarray(value)
    if dtype is None and arr.dtype in _NARROW:
        if arr.dtype.kind in "iu" and arr.size:
            from ..core.executor import _check_int32_range

            _check_int32_range("VarBase", int(arr.min()), int(arr.max()))
        arr = arr.astype(_NARROW[arr.dtype])
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device if device is not None else _device())


def _dtype_name(t: torch.Tensor) -> str:
    """A tensor's dtype by its Program name (``"float32"``, ...)."""
    return str(t.dtype).replace("torch.", "")


class VarBase:
    """value (+ gradient) holder — reference layer.h:113."""

    def __init__(self, value, name: Optional[str] = None,
                 stop_gradient: bool = False):
        self.value = _as_tensor(value)
        self.name = name
        self.stop_gradient = stop_gradient
        self._grad: Optional[torch.Tensor] = None

    # ---- tensor protocol
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return _dtype_name(self.value)

    def numpy(self) -> np.ndarray:
        from ..core.executor import to_numpy

        return to_numpy(self.value)

    def gradient(self) -> Optional[np.ndarray]:
        from ..core.executor import to_numpy

        return None if self._grad is None else to_numpy(self._grad)

    def clear_gradient(self):
        self._grad = None

    def backward(self):
        get_tracer().backward(self)

    # legacy reference spelling
    _backward = backward

    def detach(self) -> "VarBase":
        return VarBase(self.value, stop_gradient=True)

    def __repr__(self):
        return "VarBase(shape=%s, dtype=%s%s)" % (
            self.shape, self.dtype, ", grad" if self._grad is not None else "")

    # ---- eager math sugar
    def _binary(self, other, op, reverse=False):
        o = other if isinstance(other, VarBase) else VarBase(
            torch.as_tensor(other, dtype=self.value.dtype,
                            device=self.value.device), stop_gradient=True)
        a, b = (o, self) if reverse else (self, o)
        return trace_op(op, {"X": [a], "Y": [b]}, {})["Out"][0]

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    # ---- scalar coercions: under capture these are BRANCH DECISIONS —
    # the concrete value Python control flow acted on — so each one is
    # recorded as a guard the replay path re-evaluates (capture.py)
    def _coerce(self, kind: str, py):
        val = py(self.numpy())
        cap = _capture.active()
        if cap is not None:
            cap.record_guard(self, kind, val)
        return val

    def __bool__(self):
        return self._coerce("bool", bool)

    def __int__(self):
        return self._coerce("int", int)

    def __float__(self):
        return self._coerce("float", float)

    def item(self):
        v = self.numpy().item()
        return self._coerce("int" if isinstance(v, int)
                            and not isinstance(v, bool) else
                            "bool" if isinstance(v, bool) else "float",
                            type(v))


def to_variable(value, name=None, block=None) -> VarBase:
    """numpy -> VarBase (python/paddle/fluid/imperative/base.py:to_variable
    analog). Data fed this way is a gradient leaf unless stop_gradient."""
    if isinstance(value, VarBase):
        return value
    return VarBase(value if isinstance(value, torch.Tensor)
                   else np.asarray(value), name=name)


class _TapeEntry:
    __slots__ = ("type", "ins", "outs", "attrs")

    def __init__(self, type, ins, outs, attrs):
        self.type = type
        self.ins = ins      # slot -> List[Optional[VarBase]]
        self.outs = outs    # slot -> List[Optional[VarBase]]
        self.attrs = attrs


class Tracer:
    """Records (op, inputs, outputs) per eager execution
    (reference tracer.h:44 Tracer::Trace). ``place`` is where its ops
    run (default the card); ``_rng`` is the seed chain."""

    def __init__(self, seed: int = 0, place=None):
        self.tape: List[_TapeEntry] = []
        self.place = place if place is not None else default_place()
        self.device = require_device(self.place.torch_device())
        self._rng = torch.Generator()
        self._rng.manual_seed(int(seed))

    def next_rng(self) -> torch.Generator:
        return seeded_generator(draw_seed(self._rng), self.device)

    def trace(self, entry: _TapeEntry):
        self.tape.append(entry)

    # ----------------------------------------------------------- backward
    def backward(self, loss: VarBase):
        cap = _capture.active()
        if cap is not None:
            # graph autodiff FIRST (tape -> append_backward, the shared-
            # gradient contract): the captured block grows the same grad
            # ops the static tier would build, then the eager walk below
            # computes the concrete values those ops describe
            cap.record_backward(loss)
        grads: Dict[int, torch.Tensor] = {
            id(loss): torch.ones_like(loss.value)}
        ctx = LowerContext(None, None, self.device)

        with torch.no_grad():
            while self.tape:
                # each entry leaves the tape once walked, and its
                # outputs' gradients with it: nothing later reads them
                entry = self.tape.pop()
                self._backward_entry(entry, grads, ctx)
                for vs in entry.outs.values():
                    for v in vs:
                        if v is not None:
                            grads.pop(id(v), None)
        if cap is not None:
            # bind each leaf's concrete gradient tensor to its graph
            # @GRAD name so a following eager optimizer step resolves
            # its Grad inputs to the captured gradients
            cap.map_leaf_grads()

    @staticmethod
    def _backward_entry(entry, grads, ctx) -> None:
        opdef = get_op(entry.type)
        if opdef.no_grad:
            return
        out_grads: Dict[str, List[Optional[torch.Tensor]]] = {}
        any_g = False
        for slot, vs in entry.outs.items():
            gs = []
            for v in vs:
                g = grads.get(id(v)) if v is not None else None
                gs.append(g)
                any_g = any_g or g is not None
            out_grads[slot] = gs
        if not any_g:
            return

        diff = []
        for slot, vs in entry.ins.items():
            if opdef.diff_inputs is not None and slot not in opdef.diff_inputs:
                continue
            for i, v in enumerate(vs):
                if (v is not None and not v.stop_gradient
                        and v.value.is_floating_point()):
                    diff.append((slot, i))
        if not diff:
            return

        grad_ins: Dict[str, List[Any]] = {}
        for slot, vs in entry.ins.items():
            grad_ins[slot] = [v.value if v is not None else None for v in vs]
        for slot, vs in entry.outs.items():
            grad_ins.setdefault(
                slot, [v.value if v is not None else None for v in vs])
        for slot, gs in out_grads.items():
            grad_ins[slot + "@GRAD"] = gs

        attrs = dict(entry.attrs)
        attrs[ATTR_FWD_IN] = {s: len(v) for s, v in entry.ins.items()}
        attrs[ATTR_FWD_OUT] = {s: len(v) for s, v in entry.outs.items()}
        attrs[ATTR_DIFF] = [list(d) for d in diff]

        outs = get_op(entry.type + "_grad").lowering(ctx, grad_ins, attrs)
        for slot, i in diff:
            g = outs.get(slot + "@GRAD", [None] * (i + 1))[i]
            if g is None:
                continue
            v = entry.ins[slot][i]
            prev = grads.get(id(v))
            acc = g if prev is None else prev + g
            grads[id(v)] = acc
            v._grad = acc


class _EagerCtx(LowerContext):
    """LowerContext whose RNG chains through the tracer so dropout etc.
    work eagerly."""

    def __init__(self, tracer: Tracer):
        super().__init__(None, None, tracer.device, is_test=False)
        self._tracer = tracer

    def next_rng(self):
        self.rng_used = True
        return self._tracer.next_rng()


def trace_op(op_type: str, ins: Dict[str, Sequence[Optional[VarBase]]],
             attrs: Dict[str, Any]) -> Dict[str, List[Optional[VarBase]]]:
    """Execute one op eagerly through its registered lowering and record it
    on the tape (the analog of imperative::Tracer::Trace + kernel run)."""
    tracer = get_tracer()
    opdef = get_op(op_type)
    norm_ins = {s: list(vs if isinstance(vs, (list, tuple)) else [vs])
                for s, vs in ins.items()}
    vals = {s: [v.value if v is not None else None for v in vs]
            for s, vs in norm_ins.items()}
    ctx = _EagerCtx(tracer)
    with torch.no_grad():
        raw = opdef.lowering(ctx, vals, dict(attrs))
    outs: Dict[str, List[Optional[VarBase]]] = {}
    stop = all(v is None or v.stop_gradient
               for vs in norm_ins.values() for v in vs)
    for slot, vs in raw.items():
        if slot == "__env_update__":
            continue
        if not isinstance(vs, (list, tuple)):
            vs = [vs]
        outs[slot] = [None if v is None else VarBase(v, stop_gradient=stop)
                      for v in vs]
    tracer.trace(_TapeEntry(op_type, norm_ins, outs, dict(attrs)))
    cap = _capture.active()
    if cap is not None:
        # capture mode: the op ALSO lands in the in-flight Program block
        # (record-and-dispatch, not record-instead-of-dispatch)
        cap.record_op(op_type, norm_ins, outs, attrs)
    return outs


class Layer:
    """Module base (reference imperative layer.h:106 /
    python/paddle/fluid/imperative/layers.py)."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self._name = name_scope or type(self).__name__
        self._dtype = dtype
        self._parameters: Dict[str, VarBase] = {}
        self._sub_layers: Dict[str, "Layer"] = {}

    def create_parameter(self, name: str, shape, dtype="float32",
                         initializer=None) -> VarBase:
        if initializer is None:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
            limit = float(np.sqrt(6.0 / max(fan_in + shape[-1], 1)))
            init = np.random.uniform(-limit, limit, size=shape)
        elif callable(initializer):
            init = initializer(shape)
        else:
            init = np.full(shape, float(initializer))
        p = VarBase(_as_tensor(init, as_torch_dtype(dtype)), name=name)
        self._parameters[name] = p
        return p

    def add_sublayer(self, name: str, layer: "Layer") -> "Layer":
        self._sub_layers[name] = layer
        return layer

    def __setattr__(self, k, v):
        if isinstance(v, Layer):
            self.__dict__.setdefault("_sub_layers", {})[k] = v
        elif isinstance(v, VarBase) and not k.startswith("_"):
            self.__dict__.setdefault("_parameters", {})[k] = v
        object.__setattr__(self, k, v)

    def parameters(self) -> List[VarBase]:
        out = list(self._parameters.values())
        for sub in self._sub_layers.values():
            out.extend(sub.parameters())
        return out

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def forward(self, *a, **kw):
        raise NotImplementedError

    def __call__(self, *a, **kw):
        return self.forward(*a, **kw)


class PyLayer:
    """User-defined forward/backward as numpy functions
    (reference imperative/layers.py:216 PyLayer / pybind imperative.cc).
    Subclass with two @staticmethods:

        class Double(imperative.PyLayer):
            @staticmethod
            def forward(x):                 # numpy in
                return 2 * x                # numpy out
            @staticmethod
            def backward(dout):
                return 2 * dout

        y = Double()(x_varbase)

    Eager-mode only, like the reference: the callback runs on concrete
    values (copied to the host and back), so it cannot be captured.
    """

    @staticmethod
    def forward(*inputs):
        raise NotImplementedError("PyLayer subclasses define forward()")

    @staticmethod
    def backward(*douts):
        raise NotImplementedError("PyLayer subclasses define backward()")

    def __call__(self, *inputs):
        vs = [to_variable(i) for i in inputs]
        outs = trace_op("py_layer", {"X": vs},
                        {"__forward__": type(self).forward,
                         "__backward__": type(self).backward})["Out"]
        return outs[0] if len(outs) == 1 else outs


def _as_seq(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _host(t) -> np.ndarray:
    from ..core.executor import to_numpy

    return to_numpy(t)


def _on(ctx, arr) -> torch.Tensor:
    """A host result of a PyLayer callback as a tensor on the op's
    device, converted as a VarBase converts it."""
    return _as_tensor(arr, device=ctx.device).to(ctx.device)


@_registry.register_op("py_layer", diff_inputs=["X"])
def _py_layer(ctx, ins, attrs):
    fn = attrs["__forward__"]
    outs = _as_seq(fn(*[_host(v) for v in ins["X"]]))
    return {"Out": [_on(ctx, o) for o in outs]}


@_registry.register_grad_lowering("py_layer")
def _py_layer_grad(ctx, ins, attrs):
    bwd = attrs["__backward__"]
    # an output unused by the loss carries no gradient; the user's
    # backward is promised numpy arrays, so fill zeros shaped like the
    # forward output (available as a grad-op input)
    fwd_outs = ins.get("Out", [])
    douts = [_host(g) if g is not None
             else np.zeros_like(_host(fwd_outs[i]))
             for i, g in enumerate(ins.get("Out@GRAD", []))]
    dins = _as_seq(bwd(*douts))
    n_in = len(ins["X"])
    if len(dins) != n_in:
        raise ValueError(
            "PyLayer.backward returned %d grads for %d inputs"
            % (len(dins), n_in))
    return {"X@GRAD": [None if d is None else _on(ctx, d)
                       for d in dins]}

from . import nn  # noqa: E402,F401  (FC/Conv2D/BatchNorm/Embedding/Pool2D)
from . import optimizer  # noqa: E402,F401  (eager Adam/SGD via trace_op)
from .jit import CapturedFunction, jit  # noqa: E402,F401
