"""Per-op FLOPs / bytes-moved transfer rules for the cost engine.

A copy of paddle_tpu/analysis/cost_rules.py (tests/test_torch_isolation.py
pins it): the rules count an op's work from its Program shapes, so one
table prices a Program in either package.

The fifth analysis engine's rule vocabulary (``analysis/cost.py`` is the
engine; this module is its per-primitive knowledge, the TPP shape —
arXiv:2104.05755 — of composing a whole-program estimate from per-op
analyses). Every op type with a shape rule must either carry a cost
rule here or appear in the explicit ``ZERO_COST`` declaration;
``tools/repo_lint.py`` rule 10 pins that partition total exactly like
rule 7 pins the range-rule partition, so no op can fall through the
roofline silently.

A rule takes a :class:`CostContext` and returns the op's FLOPs as a
:class:`~paddle_tpu_torch.analysis.memory.BytesPoly`-style polynomial of the
batch dim (coefficients are flop counts, not bytes — the class is just
non-negative polynomial algebra), or a ``(flops, extra_bytes)`` pair
when the op is known to move MORE bytes than its declared inputs +
outputs (the engine's generic bytes model). ``None`` means "unknown":
the engine prices the op's bytes generically, counts zero FLOPs, and
records the op in ``CostAnalysis.unruled``.

FLOP constants are deliberately coarse (1 for an add/compare, ~10 for a
transcendental, 2·M·N·K for a GEMM): the roofline consumer only needs
op costs ranked and summed within the model-zoo gate's stated factor
(``analysis/cost.py`` ``ZOO_COST_GATE_FACTOR``), not cycle-accurate
counts. Gradients follow the ``*_grad`` convention in the ENGINE (the
base op's rule scaled by ``GRAD_FLOPS_FACTOR``), mirroring how the
range engine widens them — grad ops never need their own entries here.
"""

from __future__ import annotations

from typing import Dict, Optional

from .memory import BytesPoly

__all__ = ["COST_RULES", "CostContext", "GRAD_FLOPS_FACTOR",
           "ZERO_COST", "register_cost_rule"]

# backward ops cost ~2x their forward (two GEMMs per matmul, two
# products per elementwise chain rule) — the engine applies this to the
# base rule for any "<op>_grad" whose base op is ruled
GRAD_FLOPS_FACTOR = 2.0


class CostContext:
    """What a cost rule sees: the op plus shape/dtype lookups resolved
    through the analyzed program (the ``FootprintContext`` idiom from
    analysis/memory.py). ``out_elems()`` / ``in_elems()`` return the
    LARGEST single output / input's element-count polynomial — the
    deterministic anchor for per-element rules (ties and multi-output
    ops like batch_norm resolve to the big tensor, never a stats
    scalar)."""

    # the batch size per-element polys are compared at when choosing
    # the "largest" tensor (any value >> typical concrete dims works;
    # what matters is that a degree-1 poly beats a small constant)
    _PROBE_B = 1 << 20

    def __init__(self, op, analysis):
        self.op = op
        self._an = analysis

    # ------------------------------------------------------- slot lookups
    def input_shape(self, slot: str, idx: int = 0):
        names = self.op.inputs.get(slot) or []
        if idx >= len(names) or not names[idx]:
            return None
        return self._an.shape_of(names[idx])

    def input_dtype(self, slot: str, idx: int = 0):
        names = self.op.inputs.get(slot) or []
        if idx >= len(names) or not names[idx]:
            return None
        return self._an.dtype_of(names[idx])

    def output_shape(self, slot: str, idx: int = 0):
        names = self.op.outputs.get(slot) or []
        if idx >= len(names) or not names[idx]:
            return None
        return self._an.shape_of(names[idx])

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    # ---------------------------------------------------- element counts
    @staticmethod
    def elems(shape) -> Optional[BytesPoly]:
        """Element-count polynomial of a shape (1 "byte" per element)."""
        if shape is None:
            return None
        return BytesPoly.from_dims(tuple(shape), 1)

    def _largest(self, slot_map) -> Optional[BytesPoly]:
        best, best_n = None, -1
        for names in slot_map.values():
            for n in names or ():
                if not n:
                    continue
                p = self.elems(self._an.shape_of(n))
                if p is None:
                    continue
                size = p.at(self._PROBE_B)
                if size > best_n:
                    best, best_n = p, size
        return best

    def out_elems(self) -> Optional[BytesPoly]:
        return self._largest(self.op.outputs)

    def in_elems(self) -> Optional[BytesPoly]:
        return self._largest(self.op.inputs)

    def n_inputs(self, slot: str) -> int:
        return len([n for n in (self.op.inputs.get(slot) or []) if n])


COST_RULES: Dict[str, object] = {}


def register_cost_rule(*op_types):
    """Attach a FLOPs rule to one or more op types (the
    ``register_shape_rule`` / ``register_footprint_rule`` idiom).
    tools/repo_lint.py rule 10 resolves the same three registration
    spellings as rule 7: literal args, ``*TUPLE`` star-args, and
    ``for V in (...)`` loops."""

    def deco(fn):
        for t in op_types:
            COST_RULES[t] = fn
        return fn

    return deco


# ------------------------------------------------------------- factories
def _per_out_elem(k: float):
    """k FLOPs per element of the op's (largest) output."""

    def rule(ctx):
        p = ctx.out_elems()
        return None if p is None else p.scaled(k)

    return rule


def _per_in_elem(k: float):
    """k FLOPs per element of the op's (largest) input — reductions,
    losses and normalizations do their work over the INPUT extent (the
    output may be a scalar)."""

    def rule(ctx):
        p = ctx.in_elems()
        return None if p is None else p.scaled(k)

    return rule


# ------------------------------------------------- declared free ops
# Metadata/layout-only ops: each lowers to a view or a
# shape-relabel — no math, no materialized movement. Declared here (not
# ruled) so rule 10 can prove the partition covers the whole shape-ruled
# vocabulary; the engine prices them at zero FLOPs AND zero bytes.
ZERO_COST = (
    "flatten", "flatten2", "reshape", "reshape2", "shape", "share_data",
    "squeeze", "squeeze2", "unsqueeze", "unsqueeze2",
)

# ----------------------------------------------------- data movement
# Pure copies/gathers/fills/RNG draws: bytes ride the engine's generic
# input+output model, FLOPs are negligible next to the movement.
_MOVE_ONLY = (
    "assign", "assign_value", "cast", "concat", "crop", "expand",
    "expand_as", "fill_any_like", "fill_constant",
    "fill_constant_batch_size_like", "gather", "gaussian_random",
    "kv_cache_write", "lookup_table", "lookup_table_v2", "one_hot",
    "pad", "pad2d", "range", "reverse", "roll", "sampling_id",
    "scatter", "shard_index", "slice", "split", "stack", "tile",
    "transpose", "transpose2", "truncated_gaussian_random",
    "uniform_random", "uniform_random_batch_size_like", "unstack",
)
register_cost_rule(*_MOVE_ONLY)(_per_out_elem(0))

# --------------------------------------------------- cheap elementwise
# one-ish VPU op per output element: unary trivials, binaries,
# comparisons, logicals
_SIMPLE_ELEMWISE = (
    "abs", "brelu", "ceil", "clip", "elementwise_add", "elementwise_div",
    "elementwise_floordiv", "elementwise_max", "elementwise_min",
    "elementwise_mod", "elementwise_mul", "elementwise_sub", "equal",
    "floor", "greater_equal", "greater_than", "increment", "isfinite",
    "leaky_relu", "less_equal", "less_than", "logical_and",
    "logical_not", "logical_or", "logical_xor", "not_equal",
    "reciprocal", "relu", "relu6", "round", "scale", "sign", "square",
    "thresholded_relu", "where_op",
)
register_cost_rule(*_SIMPLE_ELEMWISE)(_per_out_elem(1))

# piecewise / short-composite elementwise (a handful of ops per element)
_PIECEWISE_ELEMWISE = (
    "dropout", "hard_shrink", "hard_sigmoid", "hard_swish",
    "label_smooth", "maxout", "prelu",
)
register_cost_rule(*_PIECEWISE_ELEMWISE)(_per_out_elem(4))

# ------------------------------------------------------ transcendental
# exp/log/erf/division chains: ~10 VPU ops per element, coarse
_TRANSCENDENTAL = (
    "cos", "elementwise_pow", "elu", "exp", "gelu", "log", "logsigmoid",
    "mish", "pow", "rope", "rsqrt", "sigmoid", "silu", "sin", "soft_relu",
    "softplus", "softsign", "sqrt", "stanh", "swish", "tanh",
    "tanh_shrink",
)
register_cost_rule(*_TRANSCENDENTAL)(_per_out_elem(10))

# ------------------------------------------------- quantize/dequantize
# scale-compute + clamp + convert per element (analysis/range_rules.py
# carries these ops' value stories; here they are 3-op elementwise)
_QUANT = (
    "dequantize_channel_abs_max", "fake_dequantize_max_abs",
    "fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
    "fake_quantize_range_abs_max", "quantize_channel_abs_max",
)
register_cost_rule(*_QUANT)(_per_out_elem(3))

# ---------------------------------------------------------- reductions
# work scales with the INPUT extent (outputs may be scalars)
register_cost_rule("arg_max", "arg_min", "cumsum", "mean", "reduce_all",
                   "reduce_any", "reduce_max", "reduce_mean",
                   "reduce_min", "reduce_prod",
                   "reduce_sum")(_per_in_elem(1))
register_cost_rule("dot", "pool2d", "pool2d_with_index", "squared_l2_norm",
                   "top_k")(_per_in_elem(2))
register_cost_rule("clip_by_norm", "norm")(_per_in_elem(3))
register_cost_rule("argsort", "lrn")(_per_in_elem(10))


@register_cost_rule("sum")
def _cost_sum(ctx):
    """N-ary tensor add: (N-1) adds per output element."""
    p = ctx.out_elems()
    if p is None:
        return None
    return p.scaled(max(1, ctx.n_inputs("X") - 1))


# ------------------------------------------------------ losses/softmax
register_cost_rule("cross_entropy", "huber_loss",
                   "smooth_l1_loss")(_per_in_elem(4))
register_cost_rule("square_error_cost")(_per_in_elem(3))
register_cost_rule("log_loss",
                   "sigmoid_cross_entropy_with_logits")(_per_in_elem(12))
register_cost_rule("softmax")(_per_in_elem(5))
register_cost_rule("log_softmax")(_per_in_elem(6))
register_cost_rule("softmax_with_cross_entropy")(_per_in_elem(8))

# -------------------------------------------------------- normalization
register_cost_rule("batch_norm", "group_norm",
                   "layer_norm")(_per_in_elem(8))
register_cost_rule("rms_norm")(_per_in_elem(6))

# ---------------------------------------------------- optimizer updates
# k FLOPs per parameter element (moments, bias correction, update);
# inputs Param/Grad/moments are all parameter-sized, so the generic
# largest-input anchor is the parameter tensor
register_cost_rule("sgd")(_per_in_elem(2))
register_cost_rule("adagrad", "momentum")(_per_in_elem(5))
register_cost_rule("decayed_adagrad")(_per_in_elem(6))
register_cost_rule("rmsprop")(_per_in_elem(7))
register_cost_rule("adadelta", "lars_momentum")(_per_in_elem(8))
register_cost_rule("adamax", "ftrl")(_per_in_elem(10))
register_cost_rule("adam")(_per_in_elem(12))
register_cost_rule("lamb")(_per_in_elem(14))


# -------------------------------------------------------------- GEMMs
def _contract_scaled(out_elems: BytesPoly, kdim) -> BytesPoly:
    """2 * out_elems * contraction-length; a symbolic contraction dim
    (-1) raises every term's degree by one instead of multiplying a
    coefficient (the BytesPoly symbolic-dim convention)."""
    if kdim is None:
        return out_elems.scaled(2)
    if int(kdim) < 0:
        return BytesPoly({d + 1: 2.0 * c
                          for d, c in out_elems.terms.items()})
    return out_elems.scaled(2 * int(kdim))


@register_cost_rule("matmul", "matmul_v2", "bmm")
def _cost_matmul(ctx):
    """2*M*N*K: the output's elements times twice the contraction
    length (X's last dim, or second-to-last under transpose_x)."""
    out = ctx.out_elems()
    xs = ctx.input_shape("X")
    if out is None or xs is None or len(xs) < 1:
        return out
    tx = bool(ctx.attr("transpose_x", ctx.attr("trans_x", False)))
    kdim = xs[-2] if (tx and len(xs) >= 2) else xs[-1]
    return _contract_scaled(out, kdim)


@register_cost_rule("mul")
def _cost_mul(ctx):
    """The flattened GEMM: 2 * elems(X) * N where Y is [K, N...] —
    exactly 2*M*K*N without needing num_col_dims algebra."""
    xp = ctx.elems(ctx.input_shape("X"))
    ys = ctx.input_shape("Y")
    if xp is None or ys is None or len(ys) < 2:
        return xp
    n = 1
    for d in ys[1:]:
        if int(d) < 0:
            return _contract_scaled(xp, -1)
        n *= int(d)
    return xp.scaled(2 * n)


# -------------------------------------------------------- convolutions
@register_cost_rule("conv2d", "conv2d_transpose", "conv3d",
                    "depthwise_conv2d")
def _cost_conv(ctx):
    """2 * output elements * (per-output-element window work =
    C_in/groups x kernel window, i.e. filter elems / C_out)."""
    # grad ops ride this rule too (engine *_grad convention): they have
    # no Output slot, so anchor on the largest output (dInput)
    out = ctx.elems(ctx.output_shape("Output") or ctx.output_shape("Out"))
    if out is None:
        out = ctx.out_elems()
    ws = ctx.input_shape("Filter")
    if out is None or ws is None or len(ws) < 3:
        return out
    window = 1
    for d in ws[1:]:  # [C_in/g, *kernel] — everything but C_out
        window *= max(1, int(d))
    return out.scaled(2 * window)


# ---------------------------------------------------- fused attention
# not in the shape-ruled vocabulary (it is born in the fusion pass),
# but the engine prices it: two GEMMs over the score matrix plus a
# softmax, and the composed path materializes the [*, Sq, Sk] scores
# (extra bytes beyond declared inputs/outputs — the memory engine's
# _fp_attention budgets the same tensor)
@register_cost_rule("fused_attention")
def _cost_attention(ctx):
    qs, ks = ctx.input_shape("Q"), ctx.input_shape("K")
    if qs is None or ks is None or len(qs) < 2 or len(ks) < 2:
        return ctx.out_elems()
    q_elems = ctx.elems(qs)
    scores = ctx.elems(tuple(qs[:-1]) + (ks[-2],))
    if q_elems is None or scores is None:
        return ctx.out_elems()
    flops = _contract_scaled(q_elems, ks[-2]).scaled(2) + scores.scaled(10)
    return flops, scores.scaled(2 * 4)  # score matrix written + read, f32
