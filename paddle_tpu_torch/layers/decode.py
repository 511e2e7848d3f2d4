"""Decoding + host-callback layers (a copy of paddle_tpu/layers/decode.py).

The port lowers ``rope`` and ``kv_cache_write`` (ops/tensor_ops.py);
``beam_search``, ``beam_search_decode``, ``beam_gather`` and ``py_func``
build ops it does not lower yet.

Reference locations: layers/nn.py beam_search / beam_search_decode
(backed by operators/beam_search_op.cc, beam_search_decode_op.cc) and
layers/nn.py py_func (py_func_op.cc). Beams are a dense [B, beam] axis
here instead of a LoD level (see ops/beam_search_ops.py).
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["kv_cache_write", "rope", "beam_search", "beam_search_decode", "beam_gather", "py_func"]


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, name=None,
                ids=None, level=0):
    """One beam expansion step. pre_ids/pre_scores: [B, beam];
    scores: next-token log-probs [B, beam, V]. Returns
    (selected_ids, selected_scores, parent_idx), each [B, beam]."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference("int64",
                                                        stop_gradient=True)
    sel_scores = helper.create_variable_for_type_inference(
        pre_scores.dtype, stop_gradient=True)
    parent = helper.create_variable_for_type_inference("int64",
                                                       stop_gradient=True)
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "scores": [scores]},
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level})
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, scores, parent_idx, beam_size=None, end_id=0,
                       name=None):
    """Backtrack stacked [T, B, beam] step outputs into sequences
    [B, beam, T] + final scores [B, beam]."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = helper.create_variable_for_type_inference("int64",
                                                     stop_gradient=True)
    sc = helper.create_variable_for_type_inference(scores.dtype,
                                                   stop_gradient=True)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "ParentIdx": [parent_idx], "Scores": [scores]},
        outputs={"SentenceIds": [sent], "SentenceScores": [sc]},
        attrs={"beam_size": beam_size or 0, "end_id": end_id})
    return sent, sc


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None,
            name=None):
    """Run a Python callable inside the lowered step (py_func_op.cc).
    `out` declares result vars (shape/dtype must be set). backward_func is
    not differentiated through — py_func output gradients stop here, like
    registering the op no-grad; pass precomputed grads explicitly if
    needed (documented divergence: arbitrary Python backward in-graph
    would serialize the captured step)."""
    helper = LayerHelper("py_func", name=name)
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    for o in outs:
        assert o.shape is not None and all(
            s is not None and s >= 0 for s in o.shape), (
            "py_func out var %r needs a static shape" % o.name)
    helper.append_op(
        type="py_func",
        inputs={"X": list(xs)},
        outputs={"Out": list(outs)},
        attrs={"forward_func": func,
               "out_shapes": [list(o.shape) for o in outs],
               "out_dtypes": [o.dtype for o in outs]})
    return out


def beam_gather(x, parent_idx, name=None):
    """Reorder beam-grouped rows by parent index: x [B*beam, ...] with
    rows grouped per source, parent_idx [B, beam] -> x[b*beam + parent].
    The dense analog of the reference decoder's state reshuffle
    (contrib/decoder/beam_search_decoder.py sequence_expand/lod_reset)."""
    helper = LayerHelper("beam_gather", name=name)
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    stop_gradient=True)
    out.shape = tuple(x.shape)
    helper.append_op(type="beam_gather",
                     inputs={"X": [x], "Index": [parent_idx]},
                     outputs={"Out": [out]})
    return out


def rope(x, pos, base=10000.0, name=None):
    """Rotary position embedding on a head tensor [..., S, D] (D even,
    rotate-half convention): position i rotates pair (x_j, x_{j+D/2})
    by angle pos_i * base^(-2j/D). `pos` is a [S] int var (or [1] for
    a decode step, or [B, S] for PACKED sequences whose positions
    reset at segment starts) — runtime positions, one executable for
    every step. Apply to q and k after head split, BEFORE attention
    (and before any GQA head repeat — the rotation is per head-dim,
    head-count blind)."""
    if x.shape is not None and x.shape[-1] is not None \
            and int(x.shape[-1]) % 2:
        raise ValueError(
            "rope needs an even head dim (rotate-half pairs); got %s"
            % (x.shape[-1],))
    helper = LayerHelper("rope", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="rope", inputs={"X": [x], "Pos": [pos]},
                     outputs={"Out": [out]}, attrs={"base": float(base)})
    out.shape = x.shape
    return out


def kv_cache_write(cache, update, pos, name=None):
    """Write `update` [B, H, 1, D] into persistable `cache` [B, H, S, D]
    at sequence position `pos` — a [1] int var (all rows share one
    position: the lockstep decode step) or a [B]/[B, 1] int var
    (per-row positions: each cache slot advances independently, the
    continuous-batching serving step). Returns the cache var (the op
    writes the var in place graph-wise; the executor's donation makes
    it in-place on device). See models/gpt.py build_decode_step and
    build_serving_decode_step."""
    helper = LayerHelper("kv_cache_write", name=name)
    helper.append_op(
        type="kv_cache_write",
        inputs={"Cache": [cache], "Update": [update], "Pos": [pos]},
        outputs={"Out": [cache]},
        attrs={})
    return cache
