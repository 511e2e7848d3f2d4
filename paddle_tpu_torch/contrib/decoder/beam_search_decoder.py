"""StateCell / TrainingDecoder / BeamSearchDecoder.

Reference: python/paddle/fluid/contrib/decoder/beam_search_decoder.py —
a seq2seq decoding framework where a `StateCell` owns the per-step
recurrence (states + updater), `TrainingDecoder` runs it over the target
sequence for training, and `BeamSearchDecoder` runs it autoregressively
with beam search for inference.

TPU redesign of the mechanics (same user API, documented divergences):

- TrainingDecoder runs on the masked-dense DynamicRNN
  (layers/rnn_blocks.py) instead of LoD dynamic_rnn; StateCell states
  materialize as its memories.
- BeamSearchDecoder decodes a STATIC ``max_len`` steps over a dense
  [B, beam] hypothesis grid (XLA needs static shapes; finished beams are
  frozen inside the beam_search op — ops/beam_search_ops.py — so the
  reference's dynamic while + is_empty early-stop switch is subsumed).
  State reordering by parent beam uses the dense `beam_gather` op in
  place of the reference's sequence_expand/lod_reset plumbing.

Usage (the reference's machine-translation example, unchanged):

    cell = StateCell(inputs={'x': None, 'context': None},
                     states={'h': InitState(init=enc_last)},
                     out_state='h')

    @cell.state_updater
    def updater(cell):
        h = cell.get_state('h')
        x = cell.get_input('x')
        # NAME every parameter: BeamSearchDecoder statically unrolls this
        # updater, and unnamed params would not be shared across steps
        # (decode() raises if they are not)
        nh, _, _ = layers.gru_unit(x, h, size=H * 3,
                                   param_attr=ParamAttr(name='dec_gru.w_0'),
                                   bias_attr=ParamAttr(name='dec_gru.b_0'))
        cell.set_state('h', nh)

    decoder = TrainingDecoder(cell)
    with decoder.block():
        w = decoder.step_input(trg_emb)
        cell.compute_state(inputs={'x': w})
        score = layers.fc(cell.get_state('h'), size=V, act='softmax')
        cell.update_states()
        decoder.output(score)
    rnn_out = decoder()
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

from ... import layers
from ...layer_helper import LayerHelper
from ...layers import ops as _act_ops
from ...layers.rnn_blocks import DynamicRNN
from ...param_attr import ParamAttr

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]

_NEG = -1e9


class InitState:
    """Initial value of one decoder state (reference InitState:43).
    Either an existing Variable (``init``) or a (shape, value) boot
    filled like the batch at decode time."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is None and init_boot is None and shape is None:
            raise ValueError(
                "InitState needs `init` (a Variable), `init_boot`, or "
                "`shape` + `value`")
        self._init = init if init is not None else init_boot
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder

    def materialize(self, batch_ref):
        """The concrete initial Variable (boot from batch_ref if needed)."""
        if self._init is not None:
            return self._init
        shape = list(self._shape)
        if not shape or shape[0] not in (-1, None):
            shape = [-1] + shape  # batch axis fills from batch_ref
        return layers.fill_constant_batch_size_like(
            input=batch_ref, shape=shape, dtype=self._dtype,
            value=self._value)


class StateCell:
    """Per-step recurrence container (reference StateCell:159): named
    inputs, named states with InitState boots, and a user updater that
    maps (inputs, states) -> new states via get/set."""

    def __init__(self, inputs: Dict[str, Optional[object]],
                 states: Dict[str, InitState], out_state: str,
                 name: Optional[str] = None):
        self._inputs = dict(inputs)
        self._init_states = dict(states)
        self._state_names = list(states)
        if out_state not in self._init_states:
            raise ValueError("out_state %r is not a declared state" % out_state)
        self._out_state_name = out_state
        self._updater = None
        self._decoder = None          # adapter set by the active decoder
        self._cur: Dict[str, object] = {}
        self._next: Dict[str, object] = {}

    # ----------------------------------------------------------- wiring
    def state_updater(self, fn):
        """Decorator registering the step function (reference :314)."""
        self._updater = fn
        return fn

    def _enter(self, decoder):
        self._decoder = decoder
        self._cur = {}
        self._next = {}

    def _leave(self):
        self._decoder = None
        self._cur = {}
        self._next = {}

    def _force_state(self, name, var):
        """Decoder-side state replacement (beam reorder)."""
        self._cur[name] = var

    # ------------------------------------------------------------ step API
    def get_input(self, name):
        if name not in self._inputs or self._inputs[name] is None:
            raise ValueError("input %r was not fed to compute_state" % name)
        return self._inputs[name]

    def get_state(self, name):
        if name in self._next:
            return self._next[name]
        if name not in self._cur:
            if self._decoder is None:
                raise RuntimeError(
                    "get_state outside a decoder block: StateCell states "
                    "materialize inside TrainingDecoder/BeamSearchDecoder")
            self._cur[name] = self._decoder._materialize_state(
                name, self._init_states[name])
        return self._cur[name]

    def set_state(self, name, value):
        if name not in self._init_states:
            raise ValueError("unknown state %r" % name)
        self._next[name] = value

    def compute_state(self, inputs: Dict[str, object]):
        """Bind this step's inputs and run the updater (reference :335)."""
        if self._updater is None:
            raise RuntimeError("no state_updater registered")
        for k, v in inputs.items():
            if k not in self._inputs:
                raise ValueError("unknown input %r" % k)
            self._inputs[k] = v
        self._updater(self)

    def update_states(self):
        """Commit set_state values to the decoder's storage (:360)."""
        for name, var in self._next.items():
            if self._decoder is not None:
                self._decoder._commit_state(name, var)
            self._cur[name] = var
        self._next = {}

    def out_state(self):
        """The (possibly just-updated) output state (:374)."""
        return self.get_state(self._out_state_name)


class TrainingDecoder:
    """Run the StateCell over the target sequence for training
    (reference TrainingDecoder:384), on the masked-dense DynamicRNN."""

    BEFORE, IN, AFTER = 0, 1, 2

    def __init__(self, state_cell: StateCell, name: Optional[str] = None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._state_cell = state_cell
        self._status = self.BEFORE
        self._drnn = DynamicRNN()
        self._mems: Dict[str, object] = {}

    @property
    def state_cell(self):
        return self._state_cell

    @contextlib.contextmanager
    def block(self):
        if self._status != self.BEFORE:
            raise RuntimeError("decoder.block() can only be entered once")
        self._status = self.IN
        self._state_cell._enter(self)
        with self._drnn.block():
            yield
        self._state_cell._leave()
        self._status = self.AFTER

    def step_input(self, x, length=None):
        return self._drnn.step_input(x, length=length)

    def static_input(self, x):
        return self._drnn.static_input(x)

    def output(self, *outputs):
        self._drnn.output(*outputs)

    def __call__(self):
        if self._status != self.AFTER:
            raise RuntimeError("decoder output is available after its block")
        return self._drnn()

    # ------------------------------------------------- StateCell adapter
    def _materialize_state(self, name, init_state: InitState):
        mem = self._drnn.memory(init=init_state.value) \
            if init_state.value is not None else \
            self._drnn.memory(shape=init_state._shape,
                              value=init_state._value,
                              dtype=init_state._dtype)
        self._mems[name] = mem
        return mem

    def _commit_state(self, name, var):
        if name in self._mems:
            self._drnn.update_memory(self._mems[name], var)


class BeamSearchDecoder:
    """Autoregressive beam-search inference over the same StateCell
    (reference BeamSearchDecoder). Static-length decode on a dense
    [B, beam] grid; see the module docstring for the divergences."""

    def __init__(self, state_cell: StateCell, init_ids, init_scores,
                 target_dict_dim: int, word_dim: int,
                 input_var_dict: Optional[Dict[str, object]] = None,
                 topk_size: int = 50, sparse_emb: bool = True,
                 max_len: int = 100, beam_size: int = 1, end_id: int = 1,
                 name: Optional[str] = None,
                 word_emb_param_name: Optional[str] = None,
                 score_fc_param_name: Optional[str] = None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size          # kept for API parity; the
        self._sparse_emb = sparse_emb        # dense op top-ks beam*V direct
        self._max_len = int(max_len)
        self._beam_size = int(beam_size)
        self._end_id = int(end_id)
        self._word_emb_param_name = word_emb_param_name
        self._score_fc_param_name = score_fc_param_name
        self._done = False
        self._final = None
        # decode-loop state storage (the StateCell adapter's backing)
        self._beam_states: Dict[str, object] = {}

    # ------------------------------------------------- StateCell adapter
    def _materialize_state(self, name, init_state: InitState):
        return self._beam_states[name]

    def _commit_state(self, name, var):
        self._beam_states[name] = var

    # ------------------------------------------------------------ decode
    def _expand_to_beam(self, x):
        """[B, ...] -> [B*beam, ...] (each source row repeated beam×)."""
        K = self._beam_size
        if K == 1:
            return x
        ex = layers.unsqueeze(x, [1])                       # [B, 1, ...]
        ex = layers.expand(ex, [1, K] + [1] * (len(x.shape) - 1))
        return layers.reshape(ex, [-1] + list(x.shape[1:]))

    def decode(self):
        """Build the static decode loop (reference decode():~430)."""
        if self._done:
            raise RuntimeError("decode() already called")
        K, V, D = self._beam_size, self._target_dict_dim, self._word_dim
        cell = self._state_cell
        cell._enter(self)

        # [B, 1] -> [B, K]: beam 0 carries the init score, the rest are
        # dead (NEG) so step 1 expands only genuine hypotheses
        pre_ids = layers.expand(self._init_ids, [1, K]) if K > 1 \
            else self._init_ids
        if K > 1:
            dead = layers.fill_constant_batch_size_like(
                self._init_scores, shape=[-1, K - 1], dtype="float32",
                value=_NEG)
            pre_scores = layers.concat([self._init_scores, dead], axis=1)
        else:
            pre_scores = self._init_scores

        for name, st in cell._init_states.items():
            self._beam_states[name] = self._expand_to_beam(
                st.materialize(self._init_ids))
        static_feeds = {k: self._expand_to_beam(v)
                        for k, v in self._input_var_dict.items()}
        for k in static_feeds:
            if k not in cell._inputs:
                raise ValueError("Variable %s not found in StateCell" % k)

        # the decode loop is a static unroll: every step MUST reference
        # the same parameters by name, so both built-in params get one
        # shared explicit name up front (an auto-generated name per step
        # would silently give each step fresh random weights)
        emb_attr = ParamAttr(name=self._word_emb_param_name
                             or self._helper.name + "_word_emb.w_0")
        score_base = self._score_fc_param_name or \
            (self._helper.name + "_score_fc")
        fc_w = ParamAttr(name=score_base + ".w_0")
        fc_b = ParamAttr(name=score_base + ".b_0")

        ids_steps: List = []
        scores_steps: List = []
        parents_steps: List = []
        params_after_step0 = None
        for _t in range(self._max_len):
            flat_ids = layers.reshape(pre_ids, [-1, 1])     # [B*K, 1]
            emb = layers.embedding(flat_ids, size=[V, D],
                                   is_sparse=self._sparse_emb,
                                   param_attr=emb_attr)
            emb = layers.reshape(emb, [-1, D])              # [B*K, D]

            feeds = dict(static_feeds)
            for k in cell._inputs:
                if k not in feeds:
                    feeds[k] = emb
            cell.compute_state(inputs=feeds)
            out = cell.out_state()                          # [B*K, H]
            cell.update_states()

            probs = layers.fc(out, size=V, act="softmax",
                              param_attr=fc_w, bias_attr=fc_b)
            log_probs = _act_ops.log(probs)
            scores3 = layers.reshape(log_probs, [-1, K, V])
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids, pre_scores, scores3, K, end_id=self._end_id)

            # reorder every state row to follow its selected parent beam
            for name in list(self._beam_states):
                self._beam_states[name] = layers.beam_gather(
                    self._beam_states[name], parent)
                cell._force_state(name, self._beam_states[name])

            ids_steps.append(sel_ids)
            scores_steps.append(sel_scores)
            parents_steps.append(parent)
            pre_ids, pre_scores = sel_ids, sel_scores

            # static-unroll guard: a parameter auto-named inside the
            # user's state_updater gets a FRESH name (and fresh random
            # weights) each step — silently garbage at inference. Catch
            # it on step 2 and fail with the fix.
            block = self._helper.main_program.global_block()
            pnames = {p.name for p in block.all_parameters()}
            if _t == 0:
                params_after_step0 = pnames
            elif _t == 1 and pnames - params_after_step0:
                raise RuntimeError(
                    "BeamSearchDecoder.decode() unrolls the step %d times "
                    "and every step must share parameters by NAME, but the "
                    "state_updater created new auto-named parameters on "
                    "the second step: %s. Give every layer inside the "
                    "updater an explicit ParamAttr(name=...) (matching the "
                    "training program's names)."
                    % (self._max_len,
                       sorted(pnames - params_after_step0)))

        ids_arr = layers.stack(ids_steps, axis=0)           # [T, B, K]
        scores_arr = layers.stack(scores_steps, axis=0)
        parents_arr = layers.stack(parents_steps, axis=0)
        self._final = layers.beam_search_decode(
            ids_arr, scores_arr, parents_arr, beam_size=K,
            end_id=self._end_id)
        cell._leave()
        self._done = True

    def __call__(self):
        """(translation_ids [B, beam, T], translation_scores [B, beam])."""
        if not self._done:
            raise RuntimeError("call decode() first")
        return self._final
