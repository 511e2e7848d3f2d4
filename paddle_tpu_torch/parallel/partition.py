"""Row propagation: a step whose data axis spans trainer processes.

Under a mesh whose ``data`` axis crosses ranks (parallel/mesh.py), each
of N trainer processes owns the rows of the positions it holds. Every
rank feeds the same global batch and takes its rows as a view
(``ShardingRules.feed_spec``: a feed split on dim 0 over ``data``);
params and other state are replicated, except ZeRO-1's optimizer slots,
of which each rank holds its block of rows. The plan made here, once
per plan (``XPlan``), follows each var of the optimized program through
its ops and gives it one of four kinds:

- ``rows``: this rank's rows of the single-process value;
- ``repl``: the single-process value, on every rank;
- ``partial``: this rank's addend of the single-process value (the grad
  of a replicated param, summed over the rank's rows);
- ``block``: a ZeRO-1 slot, this rank's block of rows.

What an op does to ``rows`` inputs is its row rule on the registry
(``OpDef.rows``, attached below):

- ``local``: each row's result depends on that row alone (elementwise
  ops, ``mul`` / ``matmul``, conv and pool, attention, the norms over
  features, the losses, ``reshape`` that keeps rows whole, a lookup in a
  replicated table);
- ``reduce``: ``mean``, and ``reduce_sum`` / ``reduce_mean`` /
  ``reduce_max`` / ``reduce_min`` over dim 0 or all dims: the local
  partial is completed by an all-reduce, a mean divides by the global
  count;
- ``batch_norm``: the training statistics are all-reduced;
- ``accuracy``: the counts are all-reduced;
- ``gather_rows``: a ``gather`` or ``lookup_table`` whose table holds
  rows: the table is all-gathered, the rank's own ids pick from it;
- ``random``: ``dropout`` (and ``fused_attention``'s dropout) draw the
  global shape from the single-process chain and keep their own rows
  (core/lowering.py ``rand_rows``): a rank's masks are the single-process
  run's rows, bit for bit;
- ``optimizer``: an update whose slots hold ``block``s runs on the
  rank's rows of its param and grad (one K6 launch over every entry of a
  fused group on the card) and all-gathers the params.

A grad op takes its forward op's rule. An op that consumes a ``rows``
input with no rule raises here, at plan time, naming the op and the rule
it lacks: wrong numbers never come out silently. ``partial`` values flow
through the grad ops of local ops and through ``sum`` (both linear in
them); before any other op reads one, every ``partial`` value live at
that op is all-reduced, through flat buckets: for a training program
that is once, the grads of every replicated param before the first
optimizer, clip or regularizer op (where Fluid's ``AllReduceOpHandle``
sits and the JAX partitioner puts its psum). A fetched ``repl`` value
is the global value on every rank; a ``rows`` or ``block`` fetch comes
back all-gathered, a ``partial`` one all-reduced.

Such a plan holds collectives, so it runs its eager step at every run
and is never captured as a CUDA graph (it counts in
``paddle_executor_uncaptured_plans_total{op="xproc_collective"}``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import torch

from ..core.lowering import LowerContext, lower_block
from ..core.program import op_effects
from ..core.registry import OPS, get_op, register_row_rule
from .collective import all_gather_rows, all_reduce
from .mesh import P, _axes

__all__ = ["BLOCK", "PARTIAL", "Partitioner", "REPL", "ROWS",
           "XPlanError", "XPlan"]

ROWS, REPL, PARTIAL, BLOCK = "rows", "repl", "partial", "block"
# the label a cross-process plan counts under in
# paddle_executor_uncaptured_plans_total{op}
UNCAPTURED_LABEL = "xproc_collective"


class XPlanError(NotImplementedError):
    """An op cannot run with its inputs split by rows over ranks."""


# ------------------------------------------------------------ row rules
_ELEMENTWISE = (
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv")
_UNARY = (
    "relu", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt", "rsqrt",
    "square", "abs", "softsign", "softplus", "leaky_relu", "elu", "relu6",
    "swish", "hard_sigmoid", "hard_swish", "brelu", "stanh", "pow",
    "reciprocal", "floor", "ceil", "round", "sin", "cos", "logsigmoid",
    "scale", "cast", "clip", "assign", "fill_zeros_like", "sign",
    "dropout_fused_free", "equal", "not_equal", "less_than", "less_equal",
    "greater_than", "greater_equal", "logical_and", "logical_or",
    "logical_not", "logical_xor", "isfinite", "one_hot", "label_smooth")
_LOCAL = (
    _ELEMENTWISE + _UNARY + (
        "mul", "matmul", "conv2d", "depthwise_conv2d", "pool2d",
        "fused_attention", "layer_norm", "fused_layernorm_residual",
        "fused_elementwise", "softmax", "log_softmax",
        "softmax_with_cross_entropy", "cross_entropy",
        "square_error_cost", "sigmoid_cross_entropy_with_logits",
        "reshape", "reshape2", "transpose", "transpose2", "unsqueeze",
        "unsqueeze2", "squeeze", "squeeze2", "concat", "split", "top_k",
        "sum", "flatten", "flatten2"))
_REDUCE = ("mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min")
_OPTIMIZER = ("sgd", "momentum", "adam", "adamax", "adagrad",
              "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
              "fused_optimizer_update")
# the ops whose grads are linear in their cotangents and take a partial
# one as it is
_PASSTHROUGH = ("local", "random", None)


def _attach_rules() -> None:
    for rule, types in (("local", _LOCAL), ("reduce", _REDUCE),
                        ("batch_norm", ("batch_norm",)),
                        ("accuracy", ("accuracy",)),
                        ("gather_rows", ("gather", "lookup_table",
                                         "lookup_table_v2")),
                        ("random", ("dropout",)),
                        ("optimizer", _OPTIMIZER)):
        register_row_rule(rule, *[t for t in types if t in OPS])


def _norm_axes(axes, ndim):
    return {int(a) % ndim for a in axes} if ndim else {int(a) for a in axes}


class _Planner:
    """The plan-time walk over one block's ops."""

    def __init__(self, block, world: int):
        self.block = block
        self.world = world
        self.kind: Dict[str, str] = {}

    def kind_of(self, name: str) -> str:
        return self.kind.get(name, REPL) if name else REPL

    def ndim(self, name: str) -> Optional[int]:
        var = self.block.vars.get(name)
        shape = getattr(var, "shape", None)
        return None if shape is None else len(shape)

    def fail(self, op, why: str):
        raise XPlanError(
            "op %r (inputs %s) cannot run with the data axis across %d "
            "trainer processes: %s" % (op.type, dict(op.inputs), self.world,
                                       why))

    # the effective rule of a forward op on these kinds: (rule, the kind
    # of each output)
    def forward(self, op, rule) -> (Optional[str], Dict[str, str]):
        ins = {s: [self.kind_of(n) for n in ns]
               for s, ns in op.inputs.items()}
        outs = [n for ns in op.outputs.values() for n in ns if n]
        any_rows = any(k == ROWS for ks in ins.values() for k in ks)
        if not any_rows:
            return None, {n: REPL for n in outs}
        first = lambda s: (op.inputs.get(s) or [""])[0]  # noqa: E731
        a = op.attrs
        if rule is None:
            self.fail(op, "it has no row rule (OpDef.rows) for an input "
                      "split by rows; give it one in parallel/partition.py")
        if rule == "gather_rows":
            table = "X" if op.type == "gather" else "W"
            index = "Index" if op.type == "gather" else "Ids"
            if op.type == "gather" and a.get("axis", 0) != 0:
                self.fail(op, "a gather along axis %s of rows"
                          % a.get("axis"))
            if self.kind_of(first(table)) == ROWS:
                out = ROWS if self.kind_of(first(index)) == ROWS else REPL
                return "gather_rows", {n: out for n in outs}
            return "local", {n: ROWS for n in outs}
        if rule == "reduce":
            x = first("X")
            nd = self.ndim(x)
            if op.type != "mean" and not a.get("reduce_all", False):
                if nd is None:
                    self.fail(op, "the rank of %r is unknown" % x)
                if 0 not in _norm_axes(a.get("dim", [0]), nd):
                    return "local", {n: ROWS for n in outs}
            return "reduce", {n: REPL for n in outs}
        if rule == "batch_norm":
            return "batch_norm", {n: ROWS if n in op.outputs.get("Y", [])
                                  else REPL for n in outs}
        if rule == "accuracy":
            return "accuracy", {n: REPL for n in outs}
        if rule == "optimizer":
            self.fail(op, "an optimizer's grad holds rows (sparse grads "
                      "do not cross ranks)")
        if rule in ("local", "random"):
            self._check_local(op, ins)
            return rule, {n: ROWS for n in outs}
        self.fail(op, "its row rule %r is unknown" % rule)

    def _check_local(self, op, ins) -> None:
        a, t = op.attrs, op.type
        x = (op.inputs.get("X") or [""])[0]
        nd = self.ndim(x)
        if t in ("transpose", "transpose2") and list(a["axis"])[:1] != [0]:
            self.fail(op, "a transpose that moves the rows' dim 0")
        if t in ("unsqueeze", "unsqueeze2", "squeeze", "squeeze2"):
            axes = a.get("axes", [])
            if 0 in _norm_axes(axes, (nd or 0) + (len(axes) if t.startswith(
                    "unsqueeze") else 0)) or (not axes and t.startswith(
                    "squeeze")):
                self.fail(op, "a (un)squeeze at the rows' dim 0")
        if t in ("concat", "split", "softmax", "log_softmax") and \
                nd is not None and int(a.get("axis", -1)) % nd == 0:
            self.fail(op, "axis 0 is the rows' dim")
        if t in ("mul", "matmul") and ins.get("Y", [REPL])[0] == ROWS and (
                ins.get("X", [REPL])[0] != ROWS or t == "mul"
                or (self.ndim(op.inputs["Y"][0]) or 0) < 3):
            self.fail(op, "a product that contracts over the rows")
        if t in _ELEMENTWISE and ins.get("Y", [REPL])[0] == ROWS and \
                ins.get("X", [REPL])[0] != ROWS and \
                a.get("axis", -1) not in (-1, 0):
            self.fail(op, "a broadcast of rows along axis %s"
                      % a.get("axis"))
        if t == "sum" and len(set(k for k in ins.get("X", []))) > 1:
            self.fail(op, "a sum of rows and whole values")

    def forward_of(self, grad_op) -> Optional[str]:
        """A grad op's forward rule on the forward's inputs (the grad op
        holds them under the same slots and names)."""
        fwd = type("FwdOp", (), dict(
            type=grad_op.type[:-5], attrs=grad_op.attrs, outputs={},
            inputs={s: ns for s, ns in grad_op.inputs.items()
                    if not s.endswith("@GRAD")}))
        return self.forward(fwd, get_op(fwd.type).rows)[0]

    def grad(self, op) -> Dict[str, str]:
        """A grad op's outputs' kinds: each input grad the kind of its
        forward input, a replicated input's a partial where any row or
        partial fed it. Raises where the forward has no rule."""
        self.forward_of(op)
        kinds = [self.kind_of(n) for ns in op.inputs.values() for n in ns]
        mixed = ROWS in kinds or PARTIAL in kinds
        outs = {}
        for slot, names in op.outputs.items():
            base = op.inputs.get(slot[:-5], []) if slot.endswith("@GRAD") \
                else []
            for j, n in enumerate(names):
                if not n:
                    continue
                fk = self.kind_of(base[j]) if j < len(base) else REPL
                outs[n] = ROWS if fk == ROWS else (PARTIAL if mixed
                                                   else REPL)
        return outs


class Partitioner:
    """What the engine hands a plan under a cross-process mesh: the
    process group, the feeds' specs, the ZeRO-1 slots and their global
    shapes. ``plan`` walks one optimized program."""

    def __init__(self, comm, data_axis: str, feed_specs: Dict[str, P],
                 slots: Dict[str, int]):
        _attach_rules()
        self.comm = comm
        self.data_axis = data_axis
        self.feed_specs = feed_specs
        self.slots = slots  # ZeRO-1 slot name -> its global dim 0

    def row_feeds(self) -> Set[str]:
        out = set()
        for n, spec in self.feed_specs.items():
            for dim, part in enumerate(spec):
                axes = _axes(part)
                if self.data_axis in axes:
                    if dim != 0 or axes[0] != self.data_axis:
                        raise XPlanError(
                            "feed %r splits its dim %d over %s: across "
                            "ranks only dim 0 splits over the data axis"
                            % (n, dim, spec))
                    out.add(n)
        return out

    def plan(self, program, feed_names, fetch_names, const_state,
             mut_state, pure_written) -> "XPlan":
        return XPlan(self, program, feed_names, fetch_names, const_state,
                     mut_state, pure_written)


class XPlan:
    """One plan's row propagation (see the module docstring) and its
    cross-process step."""

    def __init__(self, setup: Partitioner, program, feed_names, fetch_names,
                 const_state, mut_state, pure_written):
        self.comm = setup.comm
        self.world = setup.comm.world
        block = program.global_block()
        self.row_feeds = setup.row_feeds() & set(feed_names)
        state = set(const_state) | set(mut_state)
        self.blocks = {n: d for n, d in setup.slots.items() if n in state}
        pl = _Planner(block, self.world)
        pl.kind.update((n, ROWS) for n in self.row_feeds)
        pl.kind.update((n, BLOCK) for n in self.blocks)

        ops = block.ops
        keep = set(fetch_names) | set(mut_state) | set(pure_written)
        last: Dict[str, int] = {}
        for i, op in enumerate(ops):
            for n in op_effects(program, op)[0]:
                last[n] = i
        self.in_kinds: Dict[int, Dict[str, str]] = {}
        # id(op) -> the partials all-reduced just before op runs
        self.pre: Dict[int, List[str]] = {}
        for i, op in enumerate(ops):
            reads = [n for ns in op.inputs.values() for n in ns if n]
            if "sub_block" in op.attrs:
                deep = op_effects(program, op)[0]
                if any(pl.kind_of(n) != REPL for n in deep):
                    pl.fail(op, "a control-flow op over values split "
                            "across ranks")
            opdef = get_op(op.type)
            is_grad = op.type.endswith("_grad") and op.type[:-5] in OPS
            rule = OPS[op.type[:-5]].rows if is_grad else opdef.rows
            if any(pl.kind_of(n) == BLOCK for n in reads) and \
                    rule != "optimizer":
                pl.fail(op, "it reads a ZeRO-1 slot that holds this rank's "
                        "block")
            partial = [n for n in reads if pl.kind_of(n) == PARTIAL]
            if partial:
                if is_grad:
                    linear = self._grad_takes_partial(pl, op, partial)
                else:
                    linear = op.type == "sum" and all(
                        pl.kind_of(n) == PARTIAL for n in reads)
                if not linear:
                    live = sorted(n for n, k in pl.kind.items()
                                  if k == PARTIAL and (last.get(n, -1) >= i
                                                       or n in keep))
                    self.pre[id(op)] = live
                    pl.kind.update((n, REPL) for n in live)
            if is_grad:
                outs = pl.grad(op)
            elif rule == "optimizer" and any(
                    pl.kind_of(n) != REPL for n in reads):
                if any(pl.kind_of(n) == ROWS for n in reads):
                    pl.fail(op, "an optimizer's input holds rows")
                outs = {n: (BLOCK if pl.kind_of(n) == BLOCK else REPL)
                        for ns in op.outputs.values() for n in ns if n}
            else:
                outs = pl.forward(op, rule)[1]
            if any(pl.kind_of(n) != REPL for n in reads):
                self.in_kinds[id(op)] = {n: pl.kind_of(n) for n in reads}
            for n, k in outs.items():
                if k == REPL:
                    pl.kind.pop(n, None)
                else:
                    pl.kind[n] = k
        end = [n for n in keep if pl.kind_of(n) == PARTIAL]
        self.final = sorted(end)
        for n in self.final:
            pl.kind.pop(n, None)
        bad = [n for n in list(mut_state) + list(pure_written)
               if pl.kind_of(n) == ROWS]
        if bad:
            raise XPlanError(
                "persistable vars %s would hold this rank's rows after the "
                "step: state split by rows does not cross ranks" % bad)
        self.fetch_kinds = {n: pl.kind_of(n) for n in fetch_names}

    @staticmethod
    def _grad_takes_partial(pl, op, partial) -> bool:
        """Whether grad op ``op`` reads its partial inputs as they are:
        only in cotangent slots, and its forward is linear in them."""
        cot = {n for s, ns in op.inputs.items() if s.endswith("@GRAD")
               for n in ns}
        return set(partial) <= cot and pl.forward_of(op) in _PASSTHROUGH

    # ------------------------------------------------------- run time
    def kind(self, ctx, name: str) -> str:
        return self.in_kinds.get(id(ctx.op), {}).get(name, REPL)

    def holds_rows(self, ctx, slot: str) -> bool:
        names = (ctx.op.inputs.get(slot) or [""]) if ctx.op is not None \
            else [""]
        return self.kind(ctx, names[0]) == ROWS

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.rows(x)

    def lowering_for(self, op_type: str, base: Callable) -> Callable:
        """The lowering that completes ``op_type`` across ranks, or
        ``base``."""
        fn = _LOWERINGS.get(op_type)
        if fn is None:
            return base
        return lambda ctx, ins, attrs: fn(self, ctx, ins, attrs, base)

    def before(self, op, env: Dict[str, Any]) -> None:
        """What ``lower_op`` runs before ``op``: the partials the plan
        completes there, all-reduced in ``env``."""
        names = self.pre.get(id(op))
        if names:
            self.complete(env, names)

    def complete(self, env: Dict[str, Any], names: List[str]) -> None:
        """All-reduce the partial values ``names`` in place in ``env``
        (flat buckets)."""
        vals = self.comm.all_reduce_flat([env[n] for n in names])
        env.update(zip(names, vals))

    def own_block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A ZeRO-1 slot as this rank holds it: its block of rows, in
        memory of its own (cut from the whole value at the first step)."""
        full = self.blocks[name]
        if t.shape[0] == full // self.world:
            return t
        if t.shape[0] != full:
            raise ValueError("ZeRO-1 slot %r has %d rows; expected %d (whole) "
                             "or %d (this rank's block)" % (
                                 name, t.shape[0], full, full // self.world))
        return self.comm.rows(t).clone()

    def fetch(self, name: str, v: torch.Tensor) -> torch.Tensor:
        k = self.fetch_kinds.get(name, REPL)
        if k in (ROWS, BLOCK):
            return self.comm.gather_rows(v)
        if k == PARTIAL:
            return self.comm.all_reduce_(v.clone())
        return v

    def step_fn(self, block, fetch_names, mut_state, pure_written, amp,
                mesh_kw, release):
        """The plan's step (``analyze_block``'s contract): this rank's
        rows of the feeds and blocks of the ZeRO-1 slots, the block
        lowered as the plan completes it (``lower_op`` consults ``xp``),
        fetches made global."""
        kw = dict(mesh_kw, xp=self)

        def step(feeds, state, rng, device, graph=None):
            env: Dict[str, Any] = dict(state)
            for n in self.blocks:
                if n in env:
                    env[n] = self.own_block(n, env[n])
            for n, v in feeds.items():
                env[n] = self.comm.rows(v) if n in self.row_feeds else v
            ctx = LowerContext(block, rng, device, amp=amp, graph=graph,
                               **kw)
            lower_block(ctx, block, env, release)
            if self.final:
                self.complete(env, self.final)
            missing = [n for n in fetch_names if n not in env]
            if missing:
                raise KeyError("fetch vars %s were not produced at the top "
                               "level" % missing)
            return ([self.fetch(n, env[n]) for n in fetch_names],
                    {n: env[n] for n in list(mut_state) + list(pure_written)})

        return step


# ------------------------------------------------- cross-rank lowerings
def _rows_in(xp, ctx, slot) -> bool:
    return xp.holds_rows(ctx, slot)


def _mean(xp, ctx, ins, attrs, base):
    if not _rows_in(xp, ctx, "X"):
        return base(ctx, ins, attrs)
    x = ins["X"][0]
    x = x if x.is_floating_point() else x.to(torch.float32)
    total = all_reduce(torch.sum(x), xp.comm)
    return {"Out": [total / (x.numel() * xp.world)]}


def _reduce(xp, ctx, ins, attrs, base, op_type):
    x = ins["X"][0]
    if not _rows_in(xp, ctx, "X"):
        return base(ctx, ins, attrs)
    dims = tuple(range(x.ndim)) if attrs.get("reduce_all", False) else \
        tuple(d % x.ndim for d in attrs.get("dim", [0]))
    if 0 not in dims:
        return base(ctx, ins, attrs)
    keep = attrs.get("keep_dim", False)
    if op_type in ("reduce_max", "reduce_min"):
        local = base(ctx, ins, attrs)["Out"][0]
        return {"Out": [all_reduce(local, xp.comm, op=op_type[7:])]}
    if op_type == "reduce_sum":
        return {"Out": [all_reduce(base(ctx, ins, attrs)["Out"][0],
                                   xp.comm)]}
    xf = x if x.is_floating_point() else x.to(torch.float32)
    count = 1
    for d in dims:
        count *= x.shape[d]
    total = all_reduce(torch.sum(xf, dim=dims, keepdim=keep), xp.comm)
    return {"Out": [total / (count * xp.world)]}


def _batch_norm(xp, ctx, ins, attrs, base):
    x = ins["X"][0]
    if not _rows_in(xp, ctx, "X") or attrs.get("is_test", False) or \
            attrs.get("use_global_stats", False):
        return base(ctx, ins, attrs)
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != caxis)
    bshape = tuple(x.shape[caxis] if i == caxis else 1
                   for i in range(x.ndim))
    count = 1
    for a in axes:
        count *= x.shape[a]
    count *= xp.world
    # two passes, as the single-process statistics: the mean, then the
    # centred squares; each rank normalizes its own rows with them, so
    # their cotangents are partials (grad="sum")
    use_mean = all_reduce(x.sum(dim=axes), xp.comm, grad="sum") / count
    centred = x - use_mean.reshape(bshape)
    use_var = all_reduce((centred * centred).sum(dim=axes), xp.comm,
                         grad="sum") / count
    mean_out = mean * momentum + use_mean * (1 - momentum)
    var_out = var * momentum + use_var * (1 - momentum)
    inv = torch.rsqrt(use_var + eps)
    y = centred * inv.reshape(bshape) * scale.reshape(bshape) + \
        bias.reshape(bshape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [use_mean], "SavedVariance": [use_var]}


def _accuracy(xp, ctx, ins, attrs, base):
    if not _rows_in(xp, ctx, "Indices"):
        return base(ctx, ins, attrs)
    out = base(ctx, ins, attrs)
    counts = torch.stack([out["Correct"][0].reshape(()),
                          out["Total"][0].reshape(())]).to(torch.float32)
    correct, total = xp.comm.all_reduce_(counts)
    return {"Accuracy": [(correct / total).reshape((1,))],
            "Correct": [correct.to(torch.int32).reshape((1,))],
            "Total": [total.to(torch.int32).reshape((1,))]}


def _table_slots(op_type):
    if op_type.startswith("gather"):
        return "X", "Index"
    return "W", "Ids"


def _gather_rows(xp, ctx, ins, attrs, base, op_type):
    table, index = _table_slots(op_type)
    if not _rows_in(xp, ctx, table):
        return base(ctx, ins, attrs)
    grad = "reduce_scatter" if _rows_in(xp, ctx, index) else "slice"
    whole = all_gather_rows(ins[table][0], xp.comm, grad=grad)
    return base(ctx, dict(ins, **{table: [whole]}), attrs)


def _gather_rows_grad(xp, ctx, ins, attrs, base, op_type):
    table, _ = _table_slots(op_type)
    if not _rows_in(xp, ctx, table):
        return base(ctx, ins, attrs)
    x = ins[table][0]
    whole = torch.empty((x.shape[0] * xp.world,) + tuple(x.shape[1:]),
                        dtype=x.dtype, device="meta")
    g = base(ctx, dict(ins, **{table: [whole]}), attrs)[table + "@GRAD"][0]
    if _rows_in(xp, ctx, "Out@GRAD"):
        return {table + "@GRAD": [xp.comm.scatter_rows(g)]}
    return {table + "@GRAD": [xp.comm.rows(g).clone()]}


def _reshape(xp, ctx, ins, attrs, base, op_type):
    x = ins["X"][0]
    if not _rows_in(xp, ctx, "X"):
        return base(ctx, ins, attrs)
    from ..ops.tensor_ops import _infer_reshape

    whole = torch.empty((x.shape[0] * xp.world,) + tuple(x.shape[1:]),
                        device="meta")
    shape = _infer_reshape(whole, attrs["shape"])
    if not shape or shape[0] % xp.world:
        raise XPlanError(
            "%s of rows to %s does not keep rows whole across %d ranks"
            % (op_type, tuple(shape), xp.world))
    out = x.reshape((shape[0] // xp.world,) + tuple(shape[1:]))
    if op_type == "reshape":
        return {"Out": [out]}
    return {"Out": [out], "XShape": [torch.zeros(
        (0,) + tuple(x.shape), dtype=x.dtype, device=x.device)]}


_IN_SLOTS_FIXED = ("LearningRate", "Beta1Pow", "Beta2Pow")


def _zero1_update(xp, ctx, ins, attrs, base):
    """An optimizer update whose slots hold this rank's blocks: the
    update on the rank's rows of each such entry's param and grad (views,
    so a fused group stays one launch), then its params all-gathered
    through flat buckets."""
    op = ctx.op
    n = len(ins["Param"])
    sharded = [i for i in range(n) if any(
        xp.kind(ctx, names[i]) == BLOCK
        for s, names in op.inputs.items() if i < len(names))]
    if not sharded:
        return base(ctx, ins, attrs)
    ins = {s: list(v) for s, v in ins.items()}
    for i in sharded:
        whole = ins["Param"][i].shape
        for s in ins:
            if s in _IN_SLOTS_FIXED or i >= len(ins[s]):
                continue
            name = op.inputs[s][i]
            t = ins[s][i]
            if t is not None and xp.kind(ctx, name) != BLOCK and \
                    tuple(t.shape) == tuple(whole):
                ins[s][i] = xp.comm.rows(t)
    outs = base(ctx, ins, attrs)
    outs = {s: list(v) if isinstance(v, (list, tuple)) else [v]
            for s, v in outs.items()}
    gathered = xp.comm.all_gather_rows_flat(
        [outs["ParamOut"][i] for i in sharded])
    for i, full in zip(sharded, gathered):
        outs["ParamOut"][i] = full
    return outs


_LOWERINGS: Dict[str, Callable] = {
    "mean": _mean,
    "batch_norm": _batch_norm,
    "accuracy": _accuracy,
}
for _t in _REDUCE[1:]:
    _LOWERINGS[_t] = (lambda t: lambda xp, c, i, a, b: _reduce(
        xp, c, i, a, b, t))(_t)
for _t in ("gather", "lookup_table", "lookup_table_v2"):
    _LOWERINGS[_t] = (lambda t: lambda xp, c, i, a, b: _gather_rows(
        xp, c, i, a, b, t))(_t)
    _LOWERINGS[_t + "_grad"] = (lambda t: lambda xp, c, i, a, b:
                                _gather_rows_grad(xp, c, i, a, b, t))(_t)
for _t in ("reshape", "reshape2"):
    _LOWERINGS[_t] = (lambda t: lambda xp, c, i, a, b: _reshape(
        xp, c, i, a, b, t))(_t)
for _t in _OPTIMIZER:
    _LOWERINGS[_t] = _zero1_update
