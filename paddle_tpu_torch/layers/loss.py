"""Loss / structured-prediction / interpolation layers.

Reference locations: python/paddle/fluid/layers/nn.py — cos_sim, nce,
hsigmoid, warpctc, linear_chain_crf, crf_decoding, edit_distance,
rank_loss, margin_rank_loss, bpr_loss, image_resize / resize_bilinear /
resize_nearest, affine_channel. Lowerings live in ops/loss_ops.py and
ops/detection_ops.py; ragged inputs follow the padded+length convention.
"""

from __future__ import annotations

from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "rank_loss",
    "margin_rank_loss",
    "bpr_loss",
    "nce",
    "hsigmoid",
    "warpctc",
    "linear_chain_crf",
    "crf_decoding",
    "edit_distance",
    "image_resize",
    "resize_bilinear",
    "resize_nearest",
    "affine_channel",
]


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]}, attrs={})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype,
                                                    stop_gradient=True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out], "Activated": [act]},
                     attrs={"margin": margin})
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="bpr_loss",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Out": [out]}, attrs={})
    return out


def nce(input, label, num_total_classes, num_neg_samples=10,
        param_attr=None, bias_attr=None, name=None, sampler="uniform",
        seed=0, is_sparse=False):
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, dim],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_total_classes], input.dtype,
                                is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    slog = helper.create_variable_for_type_inference(input.dtype,
                                                     stop_gradient=True)
    slab = helper.create_variable_for_type_inference("int64",
                                                     stop_gradient=True)
    helper.append_op(type="nce",
                     inputs={"Input": [input], "Weight": [w], "Bias": [b],
                             "Label": [label]},
                     outputs={"Cost": [cost], "SampleLogits": [slog],
                              "SampleLabels": [slab]},
                     attrs={"num_neg_samples": num_neg_samples,
                            "num_total_classes": num_total_classes})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    helper = LayerHelper("hsigmoid", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_classes - 1, dim],
                                input.dtype)
    ins = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_classes - 1], input.dtype,
                                    is_bias=True)
        ins["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hierarchical_sigmoid", inputs=ins,
                     outputs={"Out": [out], "PreOut": [None]},
                     attrs={"num_classes": num_classes})
    return out


def warpctc(input, label, input_length, label_length, blank=0,
            norm_by_times=False, name=None):
    """CTC loss over padded [B, T, C] logits (reference warpctc layer; the
    LoD inputs become explicit length vars)."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input], "Label": [label],
                             "LogitsLength": [input_length],
                             "LabelLength": [label_length]},
                     outputs={"Loss": [loss]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss


def linear_chain_crf(input, label, length=None, param_attr=None, name=None):
    assert length is not None, (
        "padded-batch linear_chain_crf needs `length` (the LoD of the "
        "reference becomes an explicit [B] length var)")
    helper = LayerHelper("linear_chain_crf", name=name)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, [num_tags + 2, num_tags], input.dtype,
        default_initializer=Constant(0.0))
    ll = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label], "Length": [length]},
                     outputs={"LogLikelihood": [ll], "Alpha": [None],
                              "EmissionExps": [None],
                              "TransitionExps": [None]},
                     attrs={})
    return ll


def crf_decoding(input, param_attr=None, length=None, transition=None,
                 name=None):
    assert length is not None, (
        "padded-batch crf_decoding needs `length` (see linear_chain_crf)")
    helper = LayerHelper("crf_decoding", name=name)
    if transition is None:
        # share the transition learned by linear_chain_crf via param name
        from ..param_attr import ParamAttr

        attr = ParamAttr._to_attr(param_attr)
        if attr is None or attr.name is None:
            raise ValueError(
                "crf_decoding needs either `transition=` (the Variable "
                "returned param) or `param_attr=ParamAttr(name=...)` naming "
                "the SAME param passed to linear_chain_crf")
        transition = input.block.var(attr.name)
    path = helper.create_variable_for_type_inference("int64",
                                                     stop_gradient=True)
    helper.append_op(type="crf_decoding",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Length": [length]},
                     outputs={"ViterbiPath": [path]}, attrs={})
    return path


def edit_distance(input, label, input_length, label_length,
                  normalized=True, ignored_tokens=None, name=None):
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    seq_num = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label],
                             "HypsLength": [input_length],
                             "RefsLength": [label_length]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True):
    op_type = ("bilinear_interp" if resample.upper() == "BILINEAR"
               else "nearest_interp")
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    if input.shape is not None and out_shape is not None:
        out.shape = (input.shape[0], input.shape[1],
                     int(out_shape[0]), int(out_shape[1]))
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    helper = LayerHelper("affine_channel", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="affine_channel",
                     inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
                     outputs={"Out": [out]}, attrs={})
    out.shape = x.shape
    return out
