"""Legacy Evaluator API (reference python/paddle/fluid/evaluator.py).

The modern accumulators live in metrics.py (reference fluid/metrics.py);
this module keeps the older in-graph-state API working: an Evaluator
appends its metric layer AND persistable state-accumulation ops to the
main program, so every `exe.run(main)` batch updates the states on
device, and `eval(exe)` reads them back. `reset(exe)` zeroes the states
in the scope.

    evaluator = fluid.evaluator.ChunkEvaluator(words, labels,
                                               chunk_scheme="IOB",
                                               num_chunk_types=3,
                                               seq_length=lens)
    for batch: exe.run(main, ...)
    precision, recall, f1 = evaluator.eval(exe)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import layers
from .core.scope import Scope, global_scope
from .layer_helper import LayerHelper

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator:
    """Base (reference evaluator.py:44): owns persistable state vars and
    the reset/eval protocol."""

    def __init__(self, name: str, **kwargs):
        self.helper = LayerHelper(name, **kwargs)
        self.states: List = []
        self.metrics: List = []

    def _create_state(self, suffix: str, dtype: str, shape=(1,)):
        var = self.helper.create_global_variable(
            name="%s.%s" % (self.helper.name, suffix), shape=list(shape),
            dtype=dtype)
        self.states.append(var)
        return var

    def _accumulate(self, state, batch_value):
        """state += batch_value, in-graph (runs every exe.run of main)."""
        inc = layers.elementwise_add(
            state, layers.cast(batch_value, state.dtype))
        layers.assign(inc, output=state)

    def reset(self, executor, reset_program=None, scope: Optional[Scope]
              = None):
        scope = scope or global_scope()
        for var in self.states:
            cur = scope.find_var(var.name)
            z = np.zeros([int(s) for s in var.shape],
                         dtype=str(var.dtype)) if cur is None \
                else np.zeros_like(np.asarray(cur))
            scope.set_var(var.name, z)

    def _state_value(self, var, scope: Optional[Scope] = None):
        scope = scope or global_scope()
        v = scope.find_var(var.name)
        if v is None:
            raise RuntimeError(
                "evaluator state %r not initialized: run the startup "
                "program (or reset(exe)) first" % var.name)
        return np.asarray(v)

    def eval(self, executor, eval_program=None, scope=None):
        raise NotImplementedError


class ChunkEvaluator(Evaluator):
    """Accumulated chunking precision/recall/F1 (reference :126), built
    on layers.chunk_eval's per-batch counts."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, seq_length=None):
        super().__init__("chunk_eval")
        (precision, recall, f1, n_infer, n_label, n_correct) = \
            layers.chunk_eval(input, label, chunk_scheme, num_chunk_types,
                              excluded_chunk_types=excluded_chunk_types,
                              seq_length=seq_length)
        self.num_infer_chunks = self._create_state("num_infer", "float32")
        self.num_label_chunks = self._create_state("num_label", "float32")
        self.num_correct_chunks = self._create_state("num_correct",
                                                     "float32")
        self._accumulate(self.num_infer_chunks, n_infer)
        self._accumulate(self.num_label_chunks, n_label)
        self._accumulate(self.num_correct_chunks, n_correct)
        self.metrics = [precision, recall, f1]

    def eval(self, executor, eval_program=None, scope=None):
        ni = float(self._state_value(self.num_infer_chunks, scope)[0])
        nl = float(self._state_value(self.num_label_chunks, scope)[0])
        nc = float(self._state_value(self.num_correct_chunks, scope)[0])
        precision = nc / ni if ni else 0.0
        recall = nc / nl if nl else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0
        return np.array(precision), np.array(recall), np.array(f1)


class EditDistance(Evaluator):
    """Accumulated average edit distance + instance error rate
    (reference :217)."""

    def __init__(self, input, label, input_length, label_length,
                 ignored_tokens=None):
        super().__init__("edit_distance")
        distances, seq_num = layers.edit_distance(
            input, label, input_length, label_length,
            ignored_tokens=ignored_tokens)
        self.total_distance = self._create_state("total_distance", "float32")
        self.seq_num = self._create_state("seq_num", "float32")
        self.instance_error = self._create_state("instance_error", "float32")
        batch_total = layers.reduce_sum(distances)
        nonzero = layers.reduce_sum(
            layers.cast(layers.greater_than(
                distances, layers.fill_constant([1], "float32", 0.0)),
                "float32"))
        self._accumulate(self.total_distance, batch_total)
        self._accumulate(self.seq_num, seq_num)
        self._accumulate(self.instance_error, nonzero)
        self.metrics = [distances, seq_num]

    def eval(self, executor, eval_program=None, scope=None):
        total = float(self._state_value(self.total_distance, scope)[0])
        n = float(self._state_value(self.seq_num, scope)[0])
        err = float(self._state_value(self.instance_error, scope)[0])
        avg = total / n if n else 0.0
        rate = err / n if n else 0.0
        return np.array(avg), np.array(rate)


class DetectionMAP(Evaluator):
    """Accumulated detection mAP (reference :298): per-batch mAP from
    layers.detection_map, averaged over batches with a host-side state
    (the reference threads accumulative pos-count state through the op;
    the dense op computes per-batch mAP, so the evaluator keeps the
    running mean)."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super().__init__("detection_map")
        if class_num is None:
            raise ValueError("class_num is required")
        label = layers.concat([layers.cast(gt_label, "float32"), gt_box],
                              axis=-1)
        batch_map = layers.detection_map(
            input, label, class_num, background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version,
            difficult=gt_difficult)
        self.map_sum = self._create_state("map_sum", "float32")
        self.batches = self._create_state("batches", "float32")
        self._accumulate(self.map_sum, batch_map)
        self._accumulate(self.batches,
                         layers.fill_constant([1], "float32", 1.0))
        self.cur_map = batch_map
        self.metrics = [batch_map]

    def eval(self, executor, eval_program=None, scope=None):
        s = float(self._state_value(self.map_sum, scope)[0])
        n = float(self._state_value(self.batches, scope)[0])
        return np.array(s / n if n else 0.0)
