"""The fused ops the pass pipeline creates: ``fused_elementwise``,
``fused_layernorm_residual`` and ``fused_optimizer_update``.

The port of paddle_tpu/ops/fused_ops.py. Each composed path REPLAYS the
constituents' own registered lowerings in order, applying the same
per-op AMP cast ``lower_op`` would have applied (core/amp.py
``amp_cast``; a constituent's stamped ``__amp__`` wins), so a fused op
is bitwise the unfused ops by construction. The two kernel-tier ops
(created by core/passes/kernel_fuse.py) take their route from the
device: on the card they launch their hand-written kernel (K4 for the
layer norm, its AMP instantiation under AMP; K6 / K7 for the optimizer
group, which take a bf16-AMP step's bf16 grads as they come), on the
CPU they replay.
"""

from __future__ import annotations

import math

from ..core.amp import amp_cast, policy_for
from ..core.registry import get_op, register_op
from ..kernels import layernorm as _ln
from ..kernels import optimizer_update as _ou
from ..observe.families import KERNEL_DISPATCHES


@register_op("fused_elementwise")
def _fused_elementwise(ctx, ins, attrs):
    """A single-consumer chain of elementwise/activation ops collapsed
    by ``fuse_elementwise_pass``. ``attrs["ops"]`` holds the
    constituents' descriptors::

        {"type": "relu", "attrs": {...}, "ins": {"X": [["x", 0]]},
         "out_slot": "Out"}

    with input refs ``["x", i]`` (the i-th external input, this op's
    ``X`` slot), ``["t", j]`` (the j-th constituent's output) or
    ``["none", 0]``. Under AMP each constituent's inputs take its own
    cast."""
    ext = ins["X"]
    tmps = []
    amp = ctx.amp
    for spec in attrs["ops"]:
        sub_ins = {}
        for slot, refs in spec["ins"].items():
            vals = []
            for kind, i in refs:
                if kind == "none":
                    vals.append(None)
                elif kind == "x":
                    vals.append(ext[i])
                else:
                    vals.append(tmps[i])
            sub_ins[slot] = vals
        if amp:
            sub_ins = amp_cast(spec["type"], spec["attrs"], sub_ins)
        outs = get_op(spec["type"]).lowering(ctx, sub_ins, spec["attrs"])
        val = outs[spec["out_slot"]]
        tmps.append(val[0] if isinstance(val, (list, tuple)) else val)
    return {"Out": [tmps[-1]]}


def _first(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _on_card(t) -> bool:
    """The route of a kernel-tier fused op: its kernel for tensors on the
    card, the replay of its constituents for CPU tensors."""
    return t.device.type == "cuda"


def _count_dispatch(op, on_card):
    KERNEL_DISPATCHES.labels(op=op, impl="cuda" if on_card
                             else "composed").inc()


def _amp_tags(add_attrs, ln_attrs):
    """The AMP classes of a fused pair's two constituents: each one's
    stamped ``__amp__`` or the table's."""
    return (add_attrs.get("__amp__") or policy_for("elementwise_add"),
            ln_attrs.get("__amp__") or policy_for("layer_norm"))


def _ln_kernel(x, r, scale, bias, eps, amp, tags):
    """K4 on [N, D] rows for the fused op on the card: (y, s, mean [N, 1],
    var [N, 1]). Without AMP, K4 at the rows' dtype. Under AMP, the
    instantiation that computes the pair's casts: the AMP one for a bf16
    add and an f32 layer norm (the policy's classes), the f32 one for
    an add kept in f32 (the range-aware pass's stamp); another pair of
    classes has no kernel and raises."""
    if not amp:
        return _ln.layernorm_residual(x, r, scale, bias, eps=eps)
    scale, bias = scale.float(), bias.float()
    if tags == ("bf16", "f32"):
        return _ln.layernorm_residual_fwd_amp(x, r, scale, bias, eps)
    if tags == ("f32", "f32"):
        return _ln.layernorm_residual_fwd(x.float(), r.float(), scale, bias,
                                          eps)
    raise NotImplementedError(
        "fused_layernorm_residual under AMP: no kernel computes an add "
        "of class %r followed by a layer norm of class %r (K4 has f32, "
        "bf16 and AMP instantiations)" % tags)


@register_op("fused_layernorm_residual",
             diff_inputs=["X", "Residual", "Scale", "Bias"])
def _fused_layernorm_residual(ctx, ins, attrs):
    """``elementwise_add`` -> ``layer_norm`` collapsed into one op by
    ``fuse_kernel_tier_pass``. Emits BOTH originals' outputs — the new
    residual stream (``ResOut``, the add's name) and the norm's
    ``Y``/``Mean``/``Variance`` — so the program's pre-built backward
    ops keep reading the names they were appended against.

    On the card: flattens to ``[N, D]`` rows and launches K4
    (kernels/layernorm.py; fwd atol 1e-5 vs the replay), under AMP its
    AMP instantiation (s bf16, Y f32: the bf16 add and the f32 layer
    norm); Mean/Variance come out as ``[N]``, the shape
    ``layer_norm_grad`` reads. On the CPU: replays ``elementwise_add``
    and ``layer_norm`` with their original attrs and, under AMP, each
    one's cast, bitwise the unfused pair."""
    x, r = ins["X"][0], ins["Residual"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    add_attrs = dict(attrs.get("add_attrs") or {})
    ln_attrs = dict(attrs.get("ln_attrs") or {})
    amp = ctx.amp
    on_card = _on_card(x)
    _count_dispatch("layernorm_residual", on_card)
    if on_card:
        if x.shape != r.shape:
            # the pass fuses only pairs declared of one shape
            raise ValueError(
                "fused_layernorm_residual: X is %s and Residual %s; the "
                "kernel adds rows of one shape" % (tuple(x.shape),
                                                   tuple(r.shape)))
        begin = ln_attrs.get("begin_norm_axis", 1)
        n = math.prod(int(v) for v in x.shape[:begin])
        d = math.prod(int(v) for v in x.shape[begin:])
        y2, s2, mean2, var2 = _ln_kernel(
            x.reshape(n, d).contiguous(), r.reshape(n, d).contiguous(),
            scale.reshape(-1), bias.reshape(-1),
            ln_attrs.get("epsilon", 1e-5), amp,
            _amp_tags(add_attrs, ln_attrs))
        return {"ResOut": [s2.reshape(x.shape)],
                "Y": [y2.reshape(x.shape)],
                "Mean": [mean2.reshape(-1)],
                "Variance": [var2.reshape(-1)]}
    add_ins = {"X": [x], "Y": [r]}
    if amp:
        add_ins = amp_cast("elementwise_add", add_attrs, add_ins)
    s = _first(get_op("elementwise_add").lowering(
        ctx, add_ins, add_attrs)["Out"])
    ln_ins = {"X": [s], "Scale": [scale], "Bias": [bias]}
    if amp:
        ln_ins = amp_cast("layer_norm", ln_attrs, ln_ins)
    outs = get_op("layer_norm").lowering(ctx, ln_ins, ln_attrs)
    return {"ResOut": [s], "Y": outs["Y"], "Mean": outs["Mean"],
            "Variance": outs["Variance"]}


def _donated(op, ins, kind, donated):
    """Whether the group may update its params and moments in place:
    under a CUDA graph, when each of them is the scope's own tensor of
    a var the op writes back under the same name (``donated``: var name
    -> the captured state tensor, core/cuda_graph.py)."""
    if not donated or op is None:
        return False
    for src, dst in _ou.IN_PLACE_SLOTS[kind]:
        for n_in, n_out, t in zip(op.input(src), op.output(dst), ins[src]):
            if n_in != n_out or donated.get(n_out) is not t:
                return False
    return True


@register_op("fused_optimizer_update", no_grad=True)
def _fused_optimizer_update(ctx, ins, attrs):
    """A consecutive run of same-hyperparameter ``adam``/``sgd`` ops
    collapsed into ONE op by ``fuse_kernel_tier_pass``.

    On the card: the whole group in one launch of K6 (Adam) or K7 (SGD)
    over a per-param pointer table (kernels/optimizer_update.py, atol
    2e-6 vs the replay): f32 params, moments and scalars, each grad f32
    or bf16; another dtype raises. Under a CUDA graph (``ctx.graph``)
    the table is built once, at capture, and kept by the plan, and the
    params and moments the scope donated are updated in place. Under AMP the group takes its
    constituents' cast (their uniform ``__amp__``, carried as
    ``amp_override``, or the table's f32) except for the grads, which
    the kernel widens in registers, bit for bit the cast. On the CPU:
    replays each constituent's own registered lowering in order, with
    its cast under AMP — bitwise the unfused run."""
    kind = attrs["kind"]
    hyper = dict(attrs.get("hyper") or {})
    amp = ctx.amp
    # the constituents' per-op __amp__ user override (uniform across the
    # group: it is part of the pass's group key) rides the fused attrs as
    # "amp_override"; reinstated for the casts so the override wins
    cast_attrs = dict(hyper)
    if attrs.get("amp_override"):
        cast_attrs["__amp__"] = attrs["amp_override"]
    on_card = _on_card(ins["Param"][0])
    _count_dispatch(kind + "_update", on_card)
    if on_card:
        if amp:
            # an f32 cast of a bf16 grad is what the kernel's widening in
            # registers computes: the grads go as they come
            keep = ({"Grad": ins["Grad"]} if (cast_attrs.get("__amp__")
                                               or policy_for(kind)) == "f32"
                    else {})
            ins = dict(amp_cast(kind, cast_attrs, {
                s: v for s, v in ins.items() if s not in keep}), **keep)
        graph, kw = ctx.graph, {}
        if graph is not None:
            # on a CUDA graph's path: the plan keeps the table, donated
            # state is updated in place
            kw = dict(in_place=_donated(ctx.op, ins, kind, graph.donated),
                      upload=graph.keep_table)
        if kind == "sgd":
            return _ou.sgd_group(ins, **kw)
        return _ou.adam_group(ins, hyper, **kw)
    outs = {slot: [] for slot in _ou.OPT_OUT_SLOTS[kind]}
    lowering = get_op(kind).lowering
    for i in range(len(ins["Param"])):
        sub_ins = {s: [ins[s][i]] for s in _ou.OPT_IN_SLOTS[kind]}
        if amp:
            sub_ins = amp_cast(kind, cast_attrs, sub_ins)
        o = lowering(ctx, sub_ins, hyper)
        for slot in outs:
            outs[slot].append(_first(o[slot]))
    return outs
