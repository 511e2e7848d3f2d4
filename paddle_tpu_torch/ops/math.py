"""Math ops: ``mul``, ``matmul``, ``matmul_v2``, ``bmm``, the broadcasted
elementwise family, ``sum`` / ``mean``, the reductions, ``squared_l2_norm``,
``norm``, ``dot``, ``cumsum``, the six comparisons (bool outputs,
Paddle's broadcast of Y), and the index ops ``arg_max`` / ``arg_min``
(the first index among ties, int32), ``argsort`` (stable, as
``jnp.argsort``) and ``maximum_with_index``.

Counterparts of paddle_tpu/ops/math.py. The matrix product stays a plain
``torch.matmul``, as the JAX package leaves it to XLA, with one attr of
the port's own: ``slot_rows`` on a ``mul`` (the serving engine sets it
on its verify step's products, serving/engine.py) says that X's rows are
``slot_rows`` slots by S positions, slot-major, and the product runs
once per position over that position's ``slot_rows`` rows: the decode
step's own shape. cuBLAS picks its algorithm by shape, and at another
row count another algorithm sums in another order: with one product of
8 x 5 rows GPT-2 small's verify step differs from 5 single decode steps
by 1.1e-6 (NVIDIA H100 80GB HBM3, chip_smoke.py phase 12c), with the
product per position it is the same bits, as the JAX package's
multi-token step is on the CPU. Integer sums and products stay int32,
as the JAX package's do with 64-bit types off (torch would widen them to
int64).
"""

from __future__ import annotations

import functools
import operator

import torch

from ..core.registry import register_op
from .basic import weak_scalar


def _product(a, b, slot_rows=0):
    """``a @ b`` for 2-D ``a`` and ``b``; with ``slot_rows``, one
    product per position of ``a``'s slot-major [slot_rows, S] rows."""
    m = a.shape[0]
    if not slot_rows or m <= slot_rows:
        return torch.matmul(a, b)
    if m % slot_rows:
        raise ValueError("mul: %d rows are not slot_rows=%d slots by whole "
                         "positions" % (m, slot_rows))
    per = a.reshape(slot_rows, m // slot_rows, a.shape[1])
    return torch.stack([torch.matmul(per[:, s].contiguous(), b)
                        for s in range(per.shape[1])], 1).reshape(m, -1)


def _flatten2d(x, num_col_dims):
    lead = functools.reduce(operator.mul, x.shape[:num_col_dims], 1)
    tail = functools.reduce(operator.mul, x.shape[num_col_dims:], 1)
    return x.reshape(lead, tail)


@register_op("mul", diff_inputs=["X", "Y"])
def _mul(ctx, ins, attrs):
    """Flattening matmul (reference mul_op.cc): x -> 2D by x_num_col_dims,
    y -> 2D by y_num_col_dims, result reshaped back; ``slot_rows`` as in
    the module's docstring."""
    x, y = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    out = _product(_flatten2d(x, xnc), _flatten2d(y, ync),
                   attrs.get("slot_rows", 0))
    return {"Out": [out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))]}


@register_op("matmul", diff_inputs=["X", "Y"])
def _matmul(ctx, ins, attrs):
    """Fluid's matmul: ``transpose_X`` / ``transpose_Y`` on the last two
    dims, a 1-D X taken as a row ([1, K], or [K, 1] transposed), a 1-D Y
    as a vector (never transposed), batch dims broadcast, times
    ``alpha`` (a weak scalar beside bf16, as in the JAX package)."""
    x, y = ins["X"][0], ins["Y"][0]
    alpha = attrs.get("alpha", 1.0)
    if x.ndim == 1:
        x = x[:, None] if attrs.get("transpose_X", False) else x[None, :]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * weak_scalar(alpha, out)
    return {"Out": [out]}


@register_op("matmul_v2", diff_inputs=["X", "Y"])
def _matmul_v2(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y)]}


@register_op("bmm", diff_inputs=["X", "Y"])
def _bmm(ctx, ins, attrs):
    return {"Out": [torch.matmul(ins["X"][0], ins["Y"][0])]}


# ---------------------------------------------------------------- elementwise
def _bcast_y(x, y, axis):
    """Paddle broadcast: y's shape matches a contiguous run of x's dims
    starting at `axis` (elementwise_op_function.h). axis=-1 aligns trailing
    (== numpy broadcasting)."""
    if y.ndim == 0 or x.ndim == y.ndim:
        return y
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    # strip trailing 1-dims paddle allows in y
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > x.ndim - axis:
        yshape.pop()
    if tuple(yshape) != tuple(y.shape):
        y = y.reshape(yshape)
    pad = x.ndim - axis - y.ndim
    if pad > 0:
        y = y.reshape(tuple(y.shape) + (1,) * pad)
    return y


def _ew(name, fn, diff=True):
    @register_op(name, diff_inputs=(["X", "Y"] if diff else None),
                 no_grad=not diff)
    def _op(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [_fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}

    return _op


_ew("elementwise_add", operator.add)
_ew("elementwise_sub", operator.sub)
_ew("elementwise_mul", operator.mul)
_ew("elementwise_div", operator.truediv)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_pow", torch.pow)
_ew("elementwise_mod", torch.remainder, diff=False)
_ew("elementwise_floordiv", torch.floor_divide, diff=False)


@register_op("sum")
def _sum(ctx, ins, attrs):
    """Multi-input add: the gradient-aggregation op (sum_op.cc)."""
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(_as_float(ins["X"][0]))]}


# ---------------------------------------------------------------- reductions
def _as_float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _int32(fn):
    """An integer reduction keeps the JAX package's int32 result."""
    def red(x, dims, keep):
        out = fn(x, dims, keep)
        if not x.is_floating_point() and out.dtype == torch.int64:
            out = out.to(torch.int32)
        return out

    return red


def _prod(x, dims, keep):
    out = x
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keep)
    return out


_REDUCE = {
    "reduce_sum": _int32(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)),
    "reduce_mean": lambda x, d, k: torch.mean(_as_float(x), dim=d,
                                              keepdim=k),
    "reduce_max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "reduce_min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
    "reduce_prod": _int32(_prod),
    "reduce_all": lambda x, d, k: torch.all(x.bool(), dim=d, keepdim=k),
    "reduce_any": lambda x, d, k: torch.any(x.bool(), dim=d, keepdim=k),
}


def _reduce(name, diff=True):
    @register_op(name, no_grad=not diff)
    def _op(ctx, ins, attrs, _fn=_REDUCE[name]):
        x = ins["X"][0]
        if attrs.get("reduce_all", False):
            dims = tuple(range(x.ndim))
        else:
            dims = tuple(d % x.ndim for d in attrs.get("dim", [0]))
        return {"Out": [_fn(x, dims, attrs.get("keep_dim", False))]}

    return _op


_reduce("reduce_sum")
_reduce("reduce_mean")
_reduce("reduce_max")
_reduce("reduce_min")
_reduce("reduce_prod")
_reduce("reduce_all", diff=False)
_reduce("reduce_any", diff=False)


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.sum(x * x).reshape(())]}


# ---------------------------------------------------------------- comparisons
def _cmp(name, fn):
    @register_op(name, no_grad=True)
    def _op(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [_fn(x, _bcast_y(x, y, attrs.get("axis", -1)))]}

    return _op


_cmp("less_than", operator.lt)
_cmp("less_equal", operator.le)
_cmp("greater_than", operator.gt)
_cmp("greater_equal", operator.ge)
_cmp("equal", operator.eq)
_cmp("not_equal", operator.ne)


# ------------------------------------------------------------ logical ops
def _logical(name, fn, unary=False):
    @register_op(name, no_grad=True)
    def _op(ctx, ins, attrs, _fn=fn, _u=unary):
        if _u:
            return {"Out": [_fn(ins["X"][0])]}
        return {"Out": [_fn(ins["X"][0], ins["Y"][0])]}

    return _op


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, unary=True)


# ------------------------------------------------------------ index ops
@register_op("arg_max", no_grad=True)
def _arg_max(ctx, ins, attrs):
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(torch.int32)]}


@register_op("arg_min", no_grad=True)
def _arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))
                    .to(torch.int32)]}


@register_op("argsort", no_grad=True)
def _argsort(ctx, ins, attrs):
    vals, idx = torch.sort(ins["X"][0], dim=attrs.get("axis", -1),
                           stable=True)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register_op("maximum_with_index", no_grad=True)
def _max_with_index(ctx, ins, attrs):
    """The largest element and its flat index (the first among ties)."""
    x = ins["X"][0]
    return {"Out": [torch.amax(x)],
            "Index": [torch.argmax(x).to(torch.int32)]}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """Inclusive sums along ``axis`` (of the flattened x with
    ``flatten``); ``exclusive`` subtracts x from them (the JAX package's
    formula, so the rounding is its), ``reverse`` sums from the end.
    An integer x keeps its dtype (torch would widen int32 to int64)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0

    def csum(v):
        return torch.cumsum(v, dim=axis).to(x.dtype)

    if attrs.get("reverse", False):
        out = torch.flip(csum(torch.flip(x, [axis])), [axis])
    else:
        out = csum(x)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}


@register_op("norm")
def _norm(ctx, ins, attrs):
    """x / sqrt(sum(x * x, axis) + epsilon), and that root as Norm."""
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(x * x, dim=attrs.get("axis", -1),
                                keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("dot", diff_inputs=["X", "Y"])
def _dot(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.sum(x * y, dim=-1, keepdim=True)]}
