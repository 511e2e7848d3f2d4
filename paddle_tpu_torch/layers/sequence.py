"""Sequence layers over padded+masked dense batches (a copy of
paddle_tpu/layers/sequence.py).

The reference handles ragged sequences with LoDTensor offsets
(paddle/fluid/framework/lod_tensor.h) and a zoo of LoD-aware ops
(operators/sequence_ops/). Here, as in the JAX package, a sequence is a
padded batch plus an explicit length vector: every layer takes the data
var [B, T, ...] plus a `length` var [B] where the reference would read
LoD — the one deliberate API divergence of the sequence family. The
ops they build are paddle_tpu_torch/ops/sequence.py's masked dense
torch ops.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "sequence_mask",
    "sequence_pool",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_softmax",
    "sequence_reverse",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_conv",
    "sequence_pad",
    "sequence_unpad",
    "sequence_concat",
    "sequence_slice",
    "sequence_enumerate",
    "sequence_erase",
    "row_conv",
]


def sequence_mask(x, maxlen=None, dtype="float32", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(type="sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
                     attrs={"maxlen": maxlen or -1, "out_dtype": dtype})
    if x.shape is not None and maxlen:
        out.shape = tuple(x.shape) + (maxlen,)
    return out


def sequence_pool(input, pool_type, length=None, is_test=False, name=None):
    """reference layers/nn.py sequence_pool; `length` replaces the LoD."""
    assert length is not None, "padded-batch sequence_pool needs `length`"
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_pool",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out]},
                     attrs={"pool_type": pool_type})
    if input.shape is not None:
        out.shape = (input.shape[0],) + tuple(input.shape[2:])
    return out


def sequence_first_step(input, length=None, name=None):
    return sequence_pool(input, "first", length=length, name=name)


def sequence_last_step(input, length=None, name=None):
    return sequence_pool(input, "last", length=length, name=name)


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    assert length is not None
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_softmax",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out]}, attrs={})
    out.shape = input.shape
    return out


def sequence_reverse(x, length=None, name=None):
    assert length is not None
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_reverse",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Y": [out]}, attrs={})
    out.shape = x.shape
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, length=None, bias_attr=None, param_attr=None,
                  act=None, name=None):
    """reference layers/nn.py sequence_conv (context-window conv)."""
    assert length is not None
    helper = LayerHelper("sequence_conv", name=name, bias_attr=bias_attr,
                         act=act)
    D = input.shape[-1]
    filt = helper.create_parameter(param_attr, [filter_size * D, num_filters],
                                   input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filt], "Length": [length]},
        outputs={"Out": [out]},
        attrs={"context_length": filter_size,
               "context_start": -(filter_size // 2),
               "context_stride": filter_stride})
    out.shape = tuple(input.shape[:-1]) + (num_filters,)
    out = helper.append_bias_op(out, dim_start=-1, size=num_filters)
    out = helper.append_activation(out)
    # bias/act touched padded timesteps — re-zero them so t >= length never
    # leaks into downstream reductions (module contract)
    masked = helper.create_variable_for_type_inference(out.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [out], "Length": [length]},
                     outputs={"Out": [masked]}, attrs={})
    masked.shape = out.shape
    return masked


def sequence_pad(x, pad_value=None, maxlen=None, length=None, name=None):
    assert length is not None
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length_out = helper.create_variable_for_type_inference(
        length.dtype, stop_gradient=True)
    ins = {"X": [x], "Length": [length]}
    if pad_value is not None:
        ins["PadValue"] = [pad_value]
    helper.append_op(type="sequence_pad", inputs=ins,
                     outputs={"Out": [out], "Length": [length_out]}, attrs={})
    out.shape = x.shape
    return out, length_out


def sequence_unpad(x, length=None, name=None):
    assert length is not None
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]}, attrs={})
    out.shape = x.shape
    return out


def sequence_concat(input, length=None, name=None):
    """Concatenate a list of (padded) sequences along time; returns
    (out, out_length)."""
    assert length is not None and len(input) == len(length)
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    length_out = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(type="sequence_concat",
                     inputs={"X": list(input), "Length": list(length)},
                     outputs={"Out": [out], "LengthOut": [length_out]},
                     attrs={})
    return out, length_out


def sequence_slice(input, offset, length, name=None):
    """Per-row window [offset, offset+length); returns (out, out_length).
    `length` here is the slice-length var (reference sequence_slice_op)."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    length_out = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "SliceLength": [length]},
                     outputs={"Out": [out], "LengthOut": [length_out]},
                     attrs={})
    out.shape = input.shape
    return out, length_out


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ins = {"X": [input]}
    if length is not None:
        ins["Length"] = [length]
    helper.append_op(type="sequence_enumerate", inputs=ins,
                     outputs={"Out": [out]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    if input.shape is not None:
        out.shape = tuple(input.shape) + (win_size,)
    return out


def sequence_erase(input, tokens, length=None, name=None):
    assert length is not None
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    length_out = helper.create_variable_for_type_inference(
        length.dtype, stop_gradient=True)
    helper.append_op(type="sequence_erase",
                     inputs={"X": [input], "Length": [length]},
                     outputs={"Out": [out], "LengthOut": [length_out]},
                     attrs={"tokens": list(tokens)})
    out.shape = input.shape
    return out, length_out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """reference layers/nn.py row_conv (lookahead conv)."""
    helper = LayerHelper("row_conv", name=name, act=act)
    D = input.shape[-1]
    filt = helper.create_parameter(param_attr, [future_context_size + 1, D],
                                   input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filt]},
                     outputs={"Out": [out]}, attrs={})
    out.shape = input.shape
    return helper.append_activation(out)
