"""Control-flow layers (reference: python/paddle/fluid/layers/control_flow.py).

The reference's While (control_flow.py While class) builds a sub-block that
a nested C++ Executor interprets per iteration (operators/controlflow/
while_op.cc). Here the sub-block lowers into the body of one XLA While
(ops/control_flow_ops.py) — compiled once, no per-iteration host work.

Semantics note (TPU/XLA static-shape contract): any variable that must be
visible AFTER the loop has to exist BEFORE it (created with fill_constant/
assign in the parent block); loop-local temporaries stay local. The
reference has the same requirement, enforced through its scope chain.
"""

from __future__ import annotations

import contextlib

from ..layer_helper import LayerHelper
from .tensor import assign, fill_constant

__all__ = ["increment", "While", "Switch", "cond", "while_loop",
           "create_array", "array_write", "array_read", "array_length",
           "TensorArray", "reorder_lod_tensor_by_rank", "is_empty",
           "Print"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    out.shape = x.shape
    return out


class While:
    """reference control_flow.py While:

        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ...body layers...
            layers.increment(i)
            layers.assign(layers.less_than(i, n), cond)
    """

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    @contextlib.contextmanager
    def block(self):
        prog = self.helper.main_program
        parent = prog.current_block()
        sub = prog.create_block()
        yield
        prog.rollback()
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var]},
            outputs={},
            attrs={"sub_block": sub.idx, "condition": self.cond_var.name,
                   "is_test": False},
        )


def while_loop(cond_fn, body_fn, loop_vars):
    """Functional wrapper (the later paddle.static.nn.while_loop shape):
    loop_vars are pre-created variables mutated in body_fn via assign."""
    c = cond_fn(*loop_vars)
    w = While(c)
    with w.block():
        new_vars = body_fn(*loop_vars)
        if new_vars is not None:
            if not isinstance(new_vars, (list, tuple)):
                new_vars = [new_vars]
            for old, new in zip(loop_vars, new_vars):
                if new is not old:
                    assign(new, output=old)
        assign(cond_fn(*loop_vars), output=c)
    return loop_vars


def cond(pred, true_fn=None, false_fn=None):
    """Two-branch conditional. Both branches must write the same output
    variables (assign into pre-created vars); lowers to XLA Conditional.
    reference analog: conditional_block_op.cc + layers.cond."""
    helper = LayerHelper("conditional_block")
    prog = helper.main_program
    out_true = out_false = None
    if true_fn is not None:
        parent = prog.current_block()
        sub = prog.create_block()
        out_true = true_fn()
        prog.rollback()
        parent.append_op(type="conditional_block",
                         inputs={"Cond": [pred]}, outputs={},
                         attrs={"sub_block": sub.idx})
    if false_fn is not None:
        import paddle_tpu_torch.layers as L

        not_pred = L.logical_not(pred)
        parent = prog.current_block()
        sub = prog.create_block()
        out_false = false_fn()
        prog.rollback()
        parent.append_op(type="conditional_block",
                         inputs={"Cond": [not_pred]}, outputs={},
                         attrs={"sub_block": sub.idx})
    return out_true if out_true is not None else out_false


class Switch:
    """reference control_flow.py Switch — sequential case chain of
    conditional blocks (used for learning-rate schedules)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._taken = None  # float [1] flag: 1.0 once a case has fired

    @contextlib.contextmanager
    def case(self, condition):
        import paddle_tpu_torch.layers as L

        if self._taken is None:
            self._taken = fill_constant([1], "float32", 0.0)
        not_taken = L.less_than(self._taken, fill_constant([1], "float32", 0.5))
        fire = L.logical_and(L.cast(condition, "bool"), not_taken)
        prog = self.helper.main_program
        parent = prog.current_block()
        sub = prog.create_block()
        yield
        assign(fill_constant([1], "float32", 1.0), output=self._taken)
        prog.rollback()
        parent.append_op(type="conditional_block",
                         inputs={"Cond": [fire]}, outputs={},
                         attrs={"sub_block": sub.idx})

    @contextlib.contextmanager
    def default(self):
        import paddle_tpu_torch.layers as L

        not_taken = L.less_than(self._taken, fill_constant([1], "float32", 0.5))
        prog = self.helper.main_program
        parent = prog.current_block()
        sub = prog.create_block()
        yield
        prog.rollback()
        parent.append_op(type="conditional_block",
                         inputs={"Cond": [not_taken]}, outputs={},
                         attrs={"sub_block": sub.idx})


# ---------------------------------------------------- tensor arrays (static)
class TensorArray:
    """Build-time LOD_TENSOR_ARRAY (reference framework LoDTensorArray +
    array ops). The dynamic in-loop uses the reference puts these to
    (DynamicRNN bodies, beam search) are served by the `recurrent` scan
    op and the dense beam ops here, so this array is a STATIC build-time
    container: indices must be Python ints or fill_constant results, and
    reads/writes unroll into ordinary ops."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.items = []


def _static_index(i):
    if isinstance(i, int):
        return i
    from ..core.program import default_main_program

    if hasattr(i, "name"):
        block = default_main_program().current_block()
        for op in reversed(block.ops):
            if op.type == "fill_constant" and i.name in op.output_names():
                return int(op.attrs["value"])
    raise ValueError(
        "array index must be a python int or a fill_constant variable at "
        "build time; data-dependent indices belong inside StaticRNN/"
        "DynamicRNN (the recurrent op) in this design")


def create_array(dtype):
    """reference control_flow.py create_array."""
    return TensorArray(dtype)


def array_write(x, i, array=None):
    """reference control_flow.py:783 array_write (static index)."""
    if array is None:
        array = create_array(x.dtype)
    idx = _static_index(i)
    while len(array.items) <= idx:
        array.items.append(None)
    array.items[idx] = x
    return array


def array_read(array, i):
    """reference control_flow.py:915 array_read (static index)."""
    idx = _static_index(i)
    if idx >= len(array.items) or array.items[idx] is None:
        raise IndexError("array has no element %d" % idx)
    return array.items[idx]


def array_length(array):
    """reference control_flow.py:999 array_length."""
    return fill_constant([1], "int64", float(len(array.items)))


def reorder_lod_tensor_by_rank(x, rank_table):
    """LoD rank reordering is a no-op under the masked-dense contract
    (sequences are never sorted; lengths travel separately) — kept for
    reference API parity (reorder_lod_tensor_by_rank_op.cc)."""
    return x


def is_empty(x, cond=None):
    """reference control_flow.py is_empty -> bool [1] var."""
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference(
        "bool", stop_gradient=True)
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [out]})
    out.shape = (1,)
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """reference control_flow.py:146 Print: runtime tensor printing from
    inside the compiled step (jax.debug.print), passthrough value."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print_op", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or "",
                            "name": input.name if print_tensor_name else ""})
    out.shape = input.shape
    return out
