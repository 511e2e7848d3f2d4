"""Automatic mixed precision: a lowering-time dtype policy.

The port of paddle_tpu/core/amp.py. Master weights and optimizer state
stay float32 in the Scope; when a Program has AMP enabled, each op's
lowering sees its floating inputs cast per a three-way policy (bf16
compute / f32 numerics / passthrough), so the forward and the backward
run their products in bfloat16 on the tensor cores while reductions,
softmax and losses, norm statistics and the optimizer update run in
float32.

bfloat16 shares float32's exponent range, so no loss scaling is needed.

Grad ops are the ``torch.func.vjp`` of their forward lowering
(core/autodiff.py) and this policy is applied uniformly in ``lower_op``
(a grad op takes its forward's class), so the backward computes in
exactly the dtypes the forward did: activations and grads flow bf16,
parameter gradients are upcast at the optimizer boundary (FP32_OPS).

The tables are the JAX package's, op for op; a cast is ``Tensor.to``
of a floating tensor of another dtype, and everything else (integer
ids, masks, ``None``) passes through.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

__all__ = ["BF16_OPS", "FP32_OPS", "amp_cast", "apply_amp_policy",
           "policy_for"]

# Compute ops: cast every floating input to bf16. Products hit the
# tensor cores at bf16 rate; elementwise/activation ops halve their
# memory traffic.
BF16_OPS = frozenset({
    "mul", "matmul", "matmul_v2", "bmm", "dot",
    "conv2d", "conv2d_transpose", "conv3d", "depthwise_conv2d",
    "fused_attention",
    "lookup_table", "lookup_table_v2",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow",
    "relu", "relu6", "gelu", "tanh", "sigmoid", "silu", "swish",
    "leaky_relu", "elu", "brelu", "soft_relu", "softplus", "softsign",
    "hard_sigmoid", "hard_swish", "mish", "stanh", "tanh_shrink",
    "hard_shrink", "thresholded_relu", "prelu", "maxout",
    "pool2d", "pool2d_with_index", "pad", "pad2d",
    "dropout", "scale",
    "gru", "lstm", "row_conv",
    "sequence_conv", "sequence_pool",
    "affine_channel", "im2sequence",
})

# Numerically sensitive ops: cast every floating input to f32 (exp/log and
# large reductions, norm statistics, losses, and the optimizer update
# against f32 master state).
FP32_OPS = frozenset({
    "softmax", "log_softmax", "sequence_softmax",
    "softmax_with_cross_entropy", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "bpr_loss", "huber_loss",
    "smooth_l1_loss", "log_loss", "square_error_cost", "margin_rank_loss",
    "rank_loss", "nce", "hierarchical_sigmoid", "warpctc",
    "linear_chain_crf", "crf_decoding",
    "layer_norm", "batch_norm", "group_norm", "lrn", "norm",
    "squared_l2_norm", "clip_by_norm",
    "mean", "reduce_mean", "reduce_sum", "reduce_prod",
    "exp", "log", "sqrt", "rsqrt", "pow", "reciprocal", "cumsum",
    "cos_sim", "edit_distance",
    # optimizer family: reads f32 master params/moments, upcasts bf16 grads
    "sgd", "momentum", "lars_momentum", "adagrad", "adam", "adamax",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb",
})
# Everything else passes its input dtypes through untouched (reshape,
# transpose, concat, sum-of-grads, control flow, comparisons, metrics, io...).


def _cast_ins(ins: Dict[str, List[Any]], dtype) -> Dict[str, List[Any]]:
    out = {}
    for slot, vals in ins.items():
        out[slot] = [
            v.to(dtype)
            if isinstance(v, torch.Tensor) and v.is_floating_point()
            and v.dtype != dtype else v
            for v in vals
        ]
    return out


def policy_for(op_type: str) -> str:
    """The three-way policy class for one op type: "bf16", "f32", or
    "keep" (grad ops follow their forward op's class so the vjp's
    forward re-run sees consistent dtypes). This is the decision the
    ``amp_bf16_pass`` (core/passes/amp_pass.py) stamps onto the IR as
    each op's ``__amp__`` attr."""
    base = op_type[:-5] if op_type.endswith("_grad") else op_type
    if base in BF16_OPS:
        return "bf16"
    if base in FP32_OPS:
        return "f32"
    return "keep"


def _apply_tag(tag: Optional[str], ins: Dict[str, List[Any]]):
    if tag == "bf16":
        return _cast_ins(ins, torch.bfloat16)
    if tag == "f32":
        return _cast_ins(ins, torch.float32)
    return ins


def amp_cast(op_type: str, attrs: Dict[str, Any],
             ins: Dict[str, List[Any]]):
    """Cast ``ins`` for one op under AMP: an ``__amp__`` attr stamped by
    the IR pass (or set per op by the user) wins; otherwise the table
    policy applies. THE one casting entry point — ``lower_op``, the
    fused ops' replays and the folding pass share it, so the stamped and
    table paths cannot drift."""
    return _apply_tag(attrs.get("__amp__") or policy_for(op_type), ins)


def apply_amp_policy(op_type: str, ins: Dict[str, List[Any]]):
    """Cast `ins` per the table policy for `op_type` (no per-op
    override; kept for callers without an attr dict in hand)."""
    return _apply_tag(policy_for(op_type), ins)
