"""User-programmable RNN and batch-conditional builders.

Reference: python/paddle/fluid/layers/control_flow.py — StaticRNN (:278,
completes into a 'recurrent' op over a step sub-block), DynamicRNN
(:1394, assembles While + lod_rank_table + TensorArray reads/writes per
timestep), IfElse (:1264, split_lod_tensor / merge_lod_tensor around two
conditional blocks).

TPU-native redesign:

* StaticRNN / DynamicRNN both complete into the single differentiable
  `recurrent` op (ops/rnn.py): the step sub-block lowers into the body
  of ONE lax.scan — no per-step host interpreter, no TensorArray ops,
  gradients via the generic vjp synthesis (core/autodiff.py).
* DynamicRNN replaces LoD bookkeeping with the masked-dense contract of
  the sequence family (SURVEY §5): inputs are padded [B, T, ...] plus a
  length vector [B]; finished rows freeze their memories and emit zeros.
  `step_input` therefore takes the length on its first call instead of
  reading LoD; no lod_rank_table sorting is needed (and `need_reorder`
  is accepted-and-ignored).
* IfElse computes BOTH branches densely over the full batch and merges
  with a mask select — the XLA-friendly equivalent of the reference's
  batch split/merge. Per-sample math is exact; ops that reduce across
  the batch inside a branch see the full batch (same documented
  divergence class as the sequence family).
"""

from __future__ import annotations

import contextlib

from ..core.program import Variable, unique_name
from ..layer_helper import LayerHelper
from .tensor import fill_constant_batch_size_like

__all__ = ["StaticRNN", "DynamicRNN", "IfElse"]


@contextlib.contextmanager
def _in_parent_block(prog):
    """Temporarily append to the parent of the current (sub-)block."""
    cur = prog.current_block_idx
    parent = prog.current_block().parent_idx
    assert parent >= 0, "not inside a sub-block"
    prog.current_block_idx = parent
    try:
        yield prog.current_block()
    finally:
        prog.current_block_idx = cur


class _MemLink:
    def __init__(self, init_var, pre_var):
        self.init = init_var
        self.pre = pre_var
        self.mem = None  # set by update_memory


class _RecurrentBase:
    """Shared builder state + the recurrent-op completion step."""

    BEFORE, IN, AFTER = 0, 1, 2

    def __init__(self, layer_type, name=None):
        self.helper = LayerHelper(layer_type, name=name)
        self.status = self.BEFORE
        self.mem_links = []          # [_MemLink]
        self.seq_inputs = []         # [(parent seq var, in-block step var)]
        self.step_outs = []          # [(in-block var, parent stacked var)]
        self.sub_block = None
        self.length_var = None       # DynamicRNN only
        self.time_major = True
        self.outputs = []

    def _assert_in_block(self, method):
        if self.status != self.IN:
            raise ValueError("%s() must be called inside the rnn block"
                             % method)

    def _make_block(self):
        prog = self.helper.main_program
        self.sub_block = prog.create_block()
        self.status = self.IN

    def _finish_block(self):
        prog = self.helper.main_program
        prog.rollback()
        self.status = self.AFTER
        self._complete_op()

    def update_memory(self, mem, var):
        if not isinstance(mem, Variable) or not isinstance(var, Variable):
            raise TypeError("update_memory takes (pre_mem, new_mem) variables")
        for link in self.mem_links:
            if link.pre.name == mem.name:
                link.mem = var
                return
        raise ValueError("%r is not a memory of this RNN" % mem.name)

    def _step_output(self, o, stacked_shape):
        tmp = o
        parent = self.helper.main_program.block(self.sub_block.parent_idx)
        out = parent.create_var(
            name=unique_name.generate(self.helper.name + ".out"),
            dtype=o.dtype, shape=stacked_shape)
        self.step_outs.append((tmp, out))
        return out

    def _complete_op(self):
        sub = self.sub_block
        parent = self.helper.main_program.block(sub.parent_idx)
        for link in self.mem_links:
            if link.mem is None:
                raise ValueError(
                    "memory %r was never update_memory()'d" % link.pre.name)

        bound = {v.name for _, v in self.seq_inputs}
        bound |= {l.pre.name for l in self.mem_links}
        produced = set(bound)
        params = []
        prog = self.helper.main_program

        # nested While/cond bodies: THE shared effect analysis
        # (core/program.py op_effects, also used by the executor and the
        # IR lint suite — three hand-synchronized copies once drifted)
        from ..core.program import op_effects

        for op in sub.ops:
            reads, writes = op_effects(prog, op)
            for n in reads:
                if n and n not in produced and n not in params:
                    params.append(n)
            produced.update(writes)

        final_states = [
            parent.create_var(
                name=unique_name.generate(self.helper.name + ".final"),
                dtype=l.init.dtype, shape=l.init.shape)
            for l in self.mem_links
        ]
        inputs = {
            "inputs": [x.name for x, _ in self.seq_inputs],
            "initial_states": [l.init.name for l in self.mem_links],
            "parameters": params,
        }
        if self.length_var is not None:
            inputs["SequenceLength"] = [self.length_var.name]
        used_rng = parent.create_var(
            name=unique_name.generate(self.helper.name + ".rng"),
            dtype="uint32", shape=[2], stop_gradient=True)
        parent.append_op(
            type="recurrent",
            inputs=inputs,
            outputs={
                "outputs": [o.name for _, o in self.step_outs],
                "final_states": [v.name for v in final_states],
                "UsedRng": [used_rng.name],
            },
            attrs={
                "sub_block": sub.idx,
                "step_in_names": [v.name for _, v in self.seq_inputs],
                "pre_state_names": [l.pre.name for l in self.mem_links],
                "next_state_names": [l.mem.name for l in self.mem_links],
                "step_out_names": [v.name for v, _ in self.step_outs],
                "param_names": list(params),
                "time_major": self.time_major,
                # tells the executor's effect analysis these names are
                # bound by the scan body, not read from the parent scope
                "__sub_bound__": sorted(bound),
            },
        )
        self.outputs = [o for _, o in self.step_outs]

    def __call__(self, *args, **kwargs):
        if self.status != self.AFTER:
            raise ValueError(
                "RNN output can only be retrieved after the rnn block")
        if not self.outputs:
            raise ValueError("RNN has no output")
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs


class StaticRNN(_RecurrentBase):
    """Fixed-length user-programmable RNN (reference control_flow.py:278).

        rnn = StaticRNN()
        with rnn.step():
            word = rnn.step_input(x_t)           # x_t: [T, B, D] time-major
            prev = rnn.memory(shape=[-1, H], batch_ref=word)
            hidden = layers.fc([word, prev], size=H, act='tanh')
            rnn.update_memory(prev, hidden)
            rnn.step_output(hidden)
        out = rnn()                              # [T, B, H]
    """

    def __init__(self, name=None):
        super().__init__("static_rnn", name=name)
        self.seq_len = None

    @contextlib.contextmanager
    def step(self):
        if self.status != self.BEFORE:
            raise ValueError("rnn.step() can only be entered once")
        self._make_block()
        yield
        self._finish_block()

    def memory(self, init=None, shape=None, batch_ref=None, init_value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._assert_in_block("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "memory() needs either init or (shape, batch_ref)")
            # the boot fill runs in the parent block, where in-block step
            # vars don't exist: substitute the parent sequence var (whose
            # batch axis is 1 in time-major layout — hence the reference's
            # ref_batch_dim_idx default of 1)
            for parent_x, step_v in self.seq_inputs:
                if batch_ref is step_v or batch_ref.name == step_v.name:
                    batch_ref = parent_x
                    break
            with _in_parent_block(self.helper.main_program):
                init = fill_constant_batch_size_like(
                    input=batch_ref, shape=list(shape),
                    dtype=batch_ref.dtype, value=init_value,
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx)
        pre = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".mem"),
            dtype=init.dtype, shape=init.shape)
        self.mem_links.append(_MemLink(init, pre))
        return pre

    def step_input(self, x):
        self._assert_in_block("step_input")
        if not isinstance(x, Variable):
            raise TypeError("step_input takes a Variable")
        if self.seq_len is None:
            self.seq_len = x.shape[0]
        elif self.seq_len != x.shape[0]:
            raise ValueError("StaticRNN needs fixed sequence length inputs")
        ipt = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".step_in"),
            dtype=x.dtype, shape=list(x.shape[1:]))
        self.seq_inputs.append((x, ipt))
        return ipt

    def step_output(self, o):
        self._assert_in_block("step_output")
        return self._step_output(o, [self.seq_len] + list(o.shape))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)


class DynamicRNN(_RecurrentBase):
    """Variable-length RNN over padded dense batches
    (reference control_flow.py:1394).

        drnn = DynamicRNN()
        with drnn.block():
            word = drnn.step_input(emb, length=seq_len)   # emb: [B, T, D]
            prev = drnn.memory(shape=[H])
            hidden = layers.fc([word, prev], size=H, act='relu')
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()                                      # [B, T, H], zeros
                                                          # past each length

    Divergence from the LoD reference: the ragged lengths come from an
    explicit `length` var [B] on the first step_input (the masked-dense
    contract, layers/sequence.py), not from LoD; sequences are NOT
    reordered, so `need_reorder` on memory() is a no-op.
    """

    def __init__(self, name=None):
        super().__init__("dynamic_rnn", name=name)
        self.time_major = False
        self.max_len = None

    @contextlib.contextmanager
    def block(self):
        if self.status != self.BEFORE:
            raise ValueError("drnn.block() can only be entered once")
        self._make_block()
        yield
        self._finish_block()

    def step_input(self, x, length=None):
        self._assert_in_block("step_input")
        if not isinstance(x, Variable):
            raise TypeError("step_input takes a Variable")
        if self.length_var is None:
            if length is None:
                raise ValueError(
                    "the first step_input() must pass length=<[B] int var> "
                    "(masked-dense replacement for the reference's LoD)")
            self.length_var = length
        elif length is not None and length.name != self.length_var.name:
            raise ValueError(
                "conflicting lengths: step_input() already bound %r, got %r "
                "— all step inputs of one DynamicRNN share one length"
                % (self.length_var.name, length.name))
        if self.max_len is None:
            self.max_len = x.shape[1]
        ipt = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".step_in"),
            dtype=x.dtype, shape=[x.shape[0]] + list(x.shape[2:]))
        self.seq_inputs.append((x, ipt))
        return ipt

    def static_input(self, x):
        """A non-scattered input: visible unchanged at every step (the
        reference reorders it by LoD rank; no reorder is needed here)."""
        self._assert_in_block("static_input")
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_block("memory")
        if init is None:
            if shape is None:
                raise ValueError("memory() needs init or shape")
            if not self.seq_inputs:
                raise ValueError("call step_input() before memory(shape=...)")
            ref = self.seq_inputs[0][0]
            with _in_parent_block(self.helper.main_program):
                init = fill_constant_batch_size_like(
                    input=ref, shape=[-1] + list(shape), dtype=dtype,
                    value=value, input_dim_idx=0, output_dim_idx=0)
        pre = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".mem"),
            dtype=init.dtype, shape=init.shape)
        self.mem_links.append(_MemLink(init, pre))
        return pre

    def update_memory(self, ex_mem=None, new_mem=None):
        super().update_memory(ex_mem, new_mem)

    def output(self, *outputs):
        self._assert_in_block("output")
        for o in outputs:
            self._step_output(
                o, [o.shape[0] if o.shape else -1, self.max_len]
                + list(o.shape[1:]))


class IfElse:
    """Batch-wise two-branch conditional (reference control_flow.py:1264).

        ie = IfElse(cond)                 # cond: [B, 1] bool
        with ie.true_block():
            prob = layers.fc(ie.input(image), size=10, act='softmax')
            ie.output(prob)
        with ie.false_block():
            prob = layers.fc(ie.input(image), size=10, act='softmax')
            ie.output(prob)
        out, = ie()                       # rows picked per cond

    The reference splits the batch with split_lod_tensor, runs each
    partition through its conditional block, and merges; here both
    branches run densely over the full batch and a mask select merges
    them — identical per-sample results, one XLA program, and gradients
    reach only the branch each row selected (jnp.where's vjp)."""

    OUT, IN_TRUE, IN_FALSE = 0, 1, 2

    def __init__(self, cond, name=None):
        if not isinstance(cond, Variable):
            raise TypeError("cond must be a Variable")
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.status = IfElse.OUT
        self.out_table = ([], [])  # (false_outs, true_outs)

    @contextlib.contextmanager
    def true_block(self):
        if self.status != IfElse.OUT:
            raise ValueError("blocks cannot nest")
        self.status = IfElse.IN_TRUE
        yield
        self.status = IfElse.OUT

    @contextlib.contextmanager
    def false_block(self):
        if self.status != IfElse.OUT:
            raise ValueError("blocks cannot nest")
        self.status = IfElse.IN_FALSE
        yield
        self.status = IfElse.OUT

    def input(self, x):
        if self.status == IfElse.OUT:
            raise ValueError("input() must be called inside a branch block")
        return x  # dense contract: branches see the full batch

    def output(self, *outs):
        if self.status == IfElse.OUT:
            raise ValueError("output() must be called inside a branch block")
        table = self.out_table[1 if self.status == IfElse.IN_TRUE else 0]
        for o in outs:
            if not isinstance(o, Variable):
                raise TypeError("each output must be a Variable")
            table.append(o)

    def __call__(self):
        if self.status != IfElse.OUT:
            raise ValueError("__call__ must be outside the branch blocks")
        false_outs, true_outs = self.out_table
        if not false_outs and not true_outs:
            raise ValueError("invoke true_block/false_block first")
        if not false_outs or not true_outs:
            # the reference returns the one-sided *partition* (only the
            # selected rows); the dense design has no row-shrinking
            # equivalent, and returning full-batch values would silently
            # ignore cond for the other rows
            raise ValueError(
                "IfElse: both branches must produce outputs (the dense "
                "merge needs a value for every row); add an output() in "
                "the other block")
        if len(false_outs) != len(true_outs):
            raise ValueError("both branches must produce the same number "
                             "of outputs")
        merged = []
        for f, t in zip(false_outs, true_outs):
            out = self.helper.create_variable_for_type_inference(t.dtype)
            self.helper.append_op(
                type="where_op",
                inputs={"Condition": [self.cond], "X": [t], "Y": [f]},
                outputs={"Out": [out]})
            out.shape = t.shape
            merged.append(out)
        return merged
