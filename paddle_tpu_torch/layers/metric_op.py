"""Metric layers (reference: python/paddle/fluid/layers/metric_op.py)."""

from __future__ import annotations

from ..initializer import Constant
from ..layer_helper import LayerHelper
from .nn import topk

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    vals, ids = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [vals], "Indices": [ids], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]},
    )
    acc.shape = (1,)
    return acc


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        shape=[num_thresholds + 1], dtype="int64", initializer=Constant(0)
    )
    stat_neg = helper.create_global_variable(
        shape=[num_thresholds + 1], dtype="int64", initializer=Constant(0)
    )
    auc_out = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    auc_out.shape = (1,)
    return auc_out, [stat_pos, stat_neg]
