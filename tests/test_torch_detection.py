"""The detection ops and layers/detection.py in the port against the JAX
package on the CPU.

Every one of the 19 detection ops (paddle_tpu/ops/detection_ops.py
beside the interpolations) runs on the same numpy inputs through both
lowerings, one parametrised case an op type. Tolerances: box arithmetic
(priors, anchors, the coders, IoU, clipping, the ROI pools, decoded
proposals) within 1e-6 absolute plus 1e-6 relative (a pixel coordinate
of a few hundred is f32-exact only to about 3e-5, and ``exp`` / ``log``
may round their last place apart); indices, labels, keep masks and
class columns exactly; the losses (``ssd_loss``, ``yolov3_loss``: sums
over hundreds of terms taken in another order) within 1e-5 absolute
plus 1e-5 relative. ``multiclass_nms`` and ``generate_proposals`` rows
are gathers of their inputs, so where the keep decisions agree they are
exactly equal, ties (equal scores, scores under the threshold, all set
to -1) included. The two samplers (``rpn_target_assign``,
``generate_proposal_labels``) draw from another generator than the JAX
package's: their cases hold the properties the JAX package's tests hold,
and, where every fg and bg candidate is taken so the draw cannot matter,
the sampled rows equal the JAX package's as sets.

The grads of the four differentiable ops go through ``append_backward``
on a small program built by each package (``torch_parity``), param
grads within 1e-5; ``test_ssd_pipeline_trains``'s program
(tests/test_ssd_stack.py) trains 8 Adam steps at parity (losses within
a relative 1e-5) and its ``detection_output`` rows agree.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu_torch as pt
from paddle_tpu.core.lowering import LowerContext as JaxContext
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.lowering import LowerContext
from paddle_tpu_torch.core.registry import get_op

from torch_parity import run_both

CPU = torch.device("cpu")
BOX = dict(atol=1e-6, rtol=1e-6)
LOSS = dict(atol=1e-5, rtol=1e-5)
EXACT = dict(atol=0.0, rtol=0.0)


def _jax(op_type, ins, attrs, seed=0):
    """The JAX lowering, compiled whole as the JAX package's executor
    runs it (op by op, its many small programs take four times as long
    to compile)."""
    run = jax.jit(lambda i, key: jax_op(op_type).lowering(
        JaxContext(None, key), i, dict(attrs)))
    return run({k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()},
               jax.random.PRNGKey(seed))


def _port(op_type, ins, attrs, seed=0):
    return get_op(op_type).lowering(
        LowerContext(None, torch.Generator().manual_seed(seed), CPU),
        {k: [torch.from_numpy(np.array(v)) for v in vs]
         for k, vs in ins.items()}, dict(attrs))


def _np(outs):
    return {k: [None if v is None else np.asarray(v) for v in vs]
            for k, vs in outs.items()}


def _check(op_type, ins, attrs, tol, slots=None):
    """Both lowerings on ``ins``: each output of ``slots`` (all by
    default) of the same shape and dtype, floats within ``tol``,
    integers and bools exactly. Returns (jax, port) as numpy."""
    j, t = _np(_jax(op_type, ins, attrs)), _np(_port(op_type, ins, attrs))
    assert sorted(j) == sorted(t), (op_type, sorted(j), sorted(t))
    for slot in slots or j:
        for a, b in zip(j[slot], t[slot]):
            if a is None:
                assert b is None, (op_type, slot)
                continue
            assert a.shape == b.shape, (op_type, slot, a.shape, b.shape)
            assert a.dtype == b.dtype, (op_type, slot, a.dtype, b.dtype)
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(b, a, err_msg="%s.%s" % (
                    op_type, slot))
            else:
                np.testing.assert_allclose(b, a, err_msg="%s.%s" % (
                    op_type, slot), **tol)
    return j, t


def _boxes(rs, *shape, scale=1.0, min_wh=0.05):
    """Random xyxy boxes [..., 4] with x2 > x1, y2 > y1."""
    lo = rs.rand(*shape, 2) * 0.7
    wh = rs.rand(*shape, 2) * 0.4 + min_wh
    return (np.concatenate([lo, lo + wh], -1) * scale).astype("float32")


def _f(rs, *shape):
    return rs.randn(*shape).astype("float32")


# ----------------------------------------------------------- SSD path
def case_prior_box(rs):
    feat = np.zeros((1, 8, 3, 4), "float32")
    image = np.zeros((1, 3, 30, 40), "float32")
    for attrs in (
            {"min_sizes": [4.0, 9.0], "max_sizes": [9.0, 16.0],
             "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True},
            {"min_sizes": [12.0], "aspect_ratios": [1.0, 0.5],
             "variances": [0.1, 0.2, 0.3, 0.4], "step_w": 8.0,
             "step_h": 11.0, "offset": 0.3},
            {"min_sizes": [30.0], "max_sizes": [60.0],
             "aspect_ratios": [2.0], "flip": True}):
        _check("prior_box", {"Input": [feat], "Image": [image]}, attrs, BOX)


def case_iou_similarity(rs):
    x = _boxes(rs, 5)
    y = np.concatenate([_boxes(rs, 6), x[:2], np.zeros((1, 4), "float32")])
    _check("iou_similarity", {"X": [x], "Y": [y]}, {}, BOX)


def case_box_coder(rs):
    prior = _boxes(rs, 6)
    pvar = (rs.rand(6, 4) * 0.3 + 0.1).astype("float32")
    target = _boxes(rs, 4)
    for norm in (True, False):
        for var in ([pvar], None):
            ins = {"PriorBox": [prior * (1 if norm else 50)],
                   "TargetBox": [target * (1 if norm else 50)]}
            if var:
                ins["PriorBoxVar"] = var
            _check("box_coder", ins, {"code_type": "encode_center_size",
                                      "box_normalized": norm}, BOX)
    for tgt in (_f(rs, 3, 6, 4) * 0.5, _f(rs, 6, 4) * 0.5):
        for var in ([pvar], None):
            ins = {"PriorBox": [prior], "TargetBox": [tgt]}
            if var:
                ins["PriorBoxVar"] = var
            _check("box_coder", ins, {"code_type": "decode_center_size"},
                   BOX)
    _check("box_coder", {"PriorBox": [prior * 50], "TargetBox": [tgt]},
           {"code_type": "decode_center_size", "box_normalized": False}, BOX)


def _nms_inputs(rs, B, C, M, ties=False):
    boxes = _boxes(rs, B, M)
    if ties:
        boxes[:, M // 2:] = boxes[:, :M - M // 2]   # repeated boxes
        scores = (rs.randint(0, 5, (B, C, M)) / 4.0).astype("float32")
    else:
        scores = rs.rand(B, C, M).astype("float32")
    return boxes, scores


def case_multiclass_nms(rs):
    boxes, scores = _nms_inputs(rs, 2, 4, 30)
    base = {"score_threshold": 0.1, "nms_top_k": 12, "keep_top_k": 20,
            "nms_threshold": 0.4}
    for extra in ({}, {"nms_eta": 0.7, "nms_threshold": 0.9},
                  {"background_label": 0}, {"background_label": 2},
                  {"keep_top_k": 100}, {"nms_top_k": 64}):
        _check("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
               dict(base, **extra), EXACT)
    # one image, unbatched
    _check("multiclass_nms", {"BBoxes": [boxes[0]], "Scores": [scores[0]]},
           base, EXACT)
    # full of ties: equal scores, repeated boxes, most scores under the
    # threshold (all -1): the padded rows carry the candidates' boxes in
    # columns 2-5, so the tie order shows in every row
    boxes, scores = _nms_inputs(rs, 2, 3, 40, ties=True)
    for extra in ({"score_threshold": 0.6}, {"score_threshold": 0.3,
                                             "nms_eta": 0.8,
                                             "nms_threshold": 0.95}):
        _check("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
               dict(base, nms_top_k=30, keep_top_k=60, **extra), EXACT)


def _dist_with_padding(rs, B, G, P):
    dist = rs.rand(B, G, P).astype("float32")
    dist[:, -1] = 0.0                                   # a padding gt row
    dist[:, 1, :3] = dist[:, 0, :3]                     # tied cells
    return dist


def case_bipartite_match(rs):
    dist = _dist_with_padding(rs, 3, 4, 9)
    for attrs in ({}, {"match_type": "per_prediction",
                       "dist_threshold": 0.3}):
        _check("bipartite_match", {"DistMat": [dist]}, attrs, EXACT)
    _check("bipartite_match", {"DistMat": [dist[0]]},
           {"match_type": "per_prediction", "dist_threshold": 0.6}, EXACT)


def case_target_assign(rs):
    match = np.array([[2, -1, 0, 0], [-1, 1, 1, 2]], "int32")
    for x, mis in ((_f(rs, 2, 3, 4), 0.0), (_f(rs, 2, 3, 1), 9.0),
                   (rs.randint(0, 9, (2, 3, 1)).astype("int32"), -1.0)):
        _check("target_assign", {"X": [x], "MatchIndices": [match]},
               {"mismatch_value": mis}, EXACT)


def _ssd_inputs(rs, B=2, P=40, C=5, G=4):
    prior = _boxes(rs, P)
    gt = _boxes(rs, B, G)
    gt[:, -1] = 0.0                                     # padding gt
    gt[0, 1] = prior[3]                                 # an exact match
    ins = {"Location": [_f(rs, B, P, 4) * 0.5],
           "Confidence": [_f(rs, B, P, C)],
           "GTBox": [gt],
           "GTLabel": [rs.randint(1, C, (B, G)).astype("int32")],
           "PriorBox": [prior]}
    return ins


def case_ssd_loss(rs):
    ins = _ssd_inputs(rs)
    _check("ssd_loss", ins, {}, LOSS)
    pvar = (rs.rand(40, 4) * 0.2 + 0.1).astype("float32")
    _check("ssd_loss", dict(ins, PriorBoxVar=[pvar]),
           {"background_label": 2, "overlap_threshold": 0.3,
            "neg_pos_ratio": 2.0, "loc_loss_weight": 0.5,
            "conf_loss_weight": 2.0}, LOSS)


# ---------------------------------------- two-stage (Faster R-CNN, FPN)
def case_anchor_generator(rs):
    feat = np.zeros((1, 4, 3, 5), "float32")
    _check("anchor_generator", {"Input": [feat]}, {}, BOX)
    _check("anchor_generator", {"Input": [feat]},
           {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 2.0, 1.0],
            "stride": [8.0, 6.0], "offset": 0.25,
            "variances": [1.0, 1.0, 2.0, 2.0]}, BOX)


def _proposal_inputs(rs, N=2, A=3, H=4, W=5, ties=False):
    feat = np.zeros((1, 1, H, W), "float32")
    anc = _np(_port("anchor_generator", {"Input": [feat]}, {
        "anchor_sizes": [8.0, 16.0, 24.0], "aspect_ratios": [1.0],
        "stride": [8.0, 8.0]}))
    scores = rs.rand(N, A, H, W).astype("float32")
    if ties:
        scores = (np.round(scores * 3) / 3).astype("float32")
    return {"Scores": [scores],
            "BboxDeltas": [_f(rs, N, A * 4, H, W) * 0.3],
            "ImInfo": [np.array([[32.0, 40.0, 1.0], [30.0, 36.0, 0.8]],
                                "float32")[:N]],
            "Anchors": anc["Anchors"], "Variances": anc["Variances"]}


def case_generate_proposals(rs):
    ins = _proposal_inputs(rs)
    base = {"pre_nms_topN": 30, "post_nms_topN": 12, "nms_thresh": 0.5,
            "min_size": 2.0}
    for extra in ({}, {"eta": 0.8, "nms_thresh": 0.9},
                  {"post_nms_topN": 40}, {"min_size": 12.0}):
        _check("generate_proposals", ins, dict(base, **extra), BOX)
    _check("generate_proposals", _proposal_inputs(rs, ties=True),
           dict(base, pre_nms_topN=60), BOX)


def _rpn_inputs(K=16):
    feat = np.zeros((1, 8, 4, 4), "float32")
    anc = _np(_port("anchor_generator", {"Input": [feat]}, {
        "anchor_sizes": [8.0, 16.0, 32.0], "aspect_ratios": [1.0],
        "stride": [8.0, 8.0]}))["Anchors"][0]
    gt = np.array([[[2, 2, 14, 14], [16, 16, 30, 30], [0, 0, 0, 0]]],
                  "float32")
    return {"Anchor": [anc], "GtBoxes": [gt]}, {"rpn_batch_size_per_im": K}


def _rpn_properties(out, K):
    idx, lbl = out["ScoreIndex"][0], out["TargetLabel"][0]
    tgt, inw = out["TargetBBox"][0], out["BBoxInsideWeight"][0]
    assert idx.shape == lbl.shape == (1, K) and tgt.shape == (1, K, 4)
    assert idx.dtype == lbl.dtype == np.int32
    assert set(np.unique(lbl)) <= {-1, 0, 1}
    assert (lbl == 1).sum() >= 1          # a gt's best anchor is fg
    assert ((idx < 0) == (lbl < 0)).all()
    assert (inw[lbl == 1] == 1).all() and (inw[lbl != 1] == 0).all()
    assert (tgt[lbl != 1] == 0).all()
    taken = idx[idx >= 0]
    assert len(set(taken.tolist())) == len(taken)   # no anchor twice
    return {(int(i), int(l)) + tuple(np.round(t, 5))
            for i, l, t in zip(idx[0], lbl[0], tgt[0]) if i >= 0}


def case_rpn_target_assign(rs):
    """The properties of tests/test_ssd_stack.py's case, for the port's
    draws and the JAX package's; with K the 48 anchors (at most K / 2 of
    them fg) every fg and bg anchor is taken, so the sampled rows equal
    the JAX package's as sets; the same chain seed draws the same
    rows."""
    ins, attrs = _rpn_inputs(K=16)
    j = _np(_jax("rpn_target_assign", ins, attrs))
    t = _np(_port("rpn_target_assign", ins, attrs))
    _rpn_properties(j, 16)
    _rpn_properties(t, 16)
    attrs = dict(attrs, rpn_batch_size_per_im=48,
                 rpn_negative_overlap=0.05)
    j = _np(_jax("rpn_target_assign", ins, attrs))
    t = _np(_port("rpn_target_assign", ins, attrs))
    assert 0 < (j["TargetLabel"][0] >= 0).sum() < 48
    assert _rpn_properties(t, 48) == _rpn_properties(j, 48)
    again = _np(_port("rpn_target_assign", ins, attrs))
    for k in t:
        np.testing.assert_array_equal(again[k][0], t[k][0])


def _labels_inputs(rs):
    base = rs.rand(1, 20, 4).astype("float32") * 20
    rois = np.concatenate([base[..., :2], base[..., :2] + 5 + base[..., 2:]],
                          axis=-1).astype("float32")
    gt = np.array([[[2, 2, 10, 10], [12, 12, 20, 20], [0, 0, 0, 0]]],
                  "float32")
    return {"RpnRois": [rois], "GtClasses": [np.array([[1, 3, 0]], "int32")],
            "GtBoxes": [gt]}


def _labels_properties(out, K, C):
    rois, lbl, tgt = out["Rois"][0], out["LabelsInt32"][0], \
        out["BboxTargets"][0]
    inw, outw = out["BboxInsideWeights"][0], out["BboxOutsideWeights"][0]
    assert rois.shape == (1, K, 4) and tgt.shape == (1, K, 4 * C)
    assert lbl.dtype == np.int32 and (lbl > 0).sum() >= 2
    for r in np.where(lbl[0] > 0)[0]:
        other = np.delete(tgt[0, r].reshape(C, 4), lbl[0, r], axis=0)
        assert np.abs(other).sum() == 0
    assert (tgt[lbl <= 0] == 0).all()
    np.testing.assert_array_equal(inw, (tgt != 0).astype("float32"))
    np.testing.assert_array_equal(outw, inw)
    return {tuple(np.round(b, 5)) + (int(l),) + tuple(np.round(g, 5))
            for b, l, g in zip(rois[0], lbl[0], tgt[0]) if l >= 0}


def case_generate_proposal_labels(rs):
    """tests/test_ssd_stack.py's properties for both packages' draws;
    with K the 23 candidates (rois and gts, at most K / 2 fg) every fg
    and bg roi is taken, so the sampled rows equal the JAX package's as
    sets."""
    ins = _labels_inputs(rs)
    attrs = {"batch_size_per_im": 12, "class_nums": 5, "fg_thresh": 0.5}
    _labels_properties(_np(_jax("generate_proposal_labels", ins, attrs)),
                       12, 5)
    _labels_properties(_np(_port("generate_proposal_labels", ins, attrs)),
                       12, 5)
    attrs = dict(attrs, batch_size_per_im=23, fg_fraction=0.5,
                 bg_thresh_lo=0.05)
    j = _np(_jax("generate_proposal_labels", ins, attrs))
    t = _np(_port("generate_proposal_labels", ins, attrs))
    assert (j["LabelsInt32"][0] < 0).any()
    assert _labels_properties(t, 23, 5) == _labels_properties(j, 23, 5)


def _roi_inputs(rs, batch=True):
    x = _f(rs, 2, 3, 7, 8)
    rois = np.array([[0.5, 1.0, 5.0, 4.5], [2.0, 0.0, 6.5, 6.5],
                     [1.0, 1.0, 1.2, 1.1], [-2.0, 3.0, 9.5, 8.0]], "float32")
    ins = {"X": [x], "ROIs": [rois]}
    if batch:
        ins["RoisBatch"] = [np.array([1, 0, 1, 0], "int32")]
    return ins


def case_roi_align(rs):
    for batch in (True, False):
        for attrs in ({"pooled_height": 2, "pooled_width": 3,
                       "spatial_scale": 0.9, "sampling_ratio": 2},
                      {"pooled_height": 3, "pooled_width": 2,
                       "sampling_ratio": 3}):
            _check("roi_align", _roi_inputs(rs, batch), attrs, BOX)


def case_roi_pool(rs):
    for batch in (True, False):
        for attrs in ({"pooled_height": 2, "pooled_width": 3,
                       "spatial_scale": 0.9}, {"pooled_height": 3,
                                               "pooled_width": 2,
                                               "sampling_ratio": 2}):
            _check("roi_pool", _roi_inputs(rs, batch), attrs, BOX)


def case_distribute_fpn_proposals(rs):
    rois = np.array([[0, 0, 16, 16], [0, 0, 500, 500], [0, 0, 224, 224],
                     [5, 5, 21, 21], [10, 10, 234, 234], [0, 0, 90, 120],
                     [3, 3, 19, 19], [0, 0, 0, 0]], "float32")
    for attrs in ({"min_level": 2, "max_level": 5, "refer_level": 4,
                   "refer_scale": 224},
                  {"min_level": 3, "max_level": 4, "refer_level": 4,
                   "refer_scale": 112}):
        _check("distribute_fpn_proposals", {"FpnRois": [rois]}, attrs,
               EXACT)


def case_box_decoder_and_assign(rs):
    """The JAX lowering clips at 4.135 where box_clip is absent or a list
    and raises on a scalar (its layer's float: it iterates the attr); the
    port clips at the scalar (ROADMAP §C)."""
    prior = _boxes(rs, 5, scale=30.0)
    ins = {"PriorBox": [prior], "TargetBox": [_f(rs, 5, 12) * 3],
           "BoxScore": [rs.rand(5, 3).astype("float32")]}
    _check("box_decoder_and_assign", ins, {}, BOX)
    _check("box_decoder_and_assign", ins, {"box_clip": [1.0, 2.0]}, BOX)
    with pytest.raises(TypeError):
        _jax("box_decoder_and_assign", ins, {"box_clip": 4.135})
    want = _np(_jax("box_decoder_and_assign", ins, {}))
    got = _np(_port("box_decoder_and_assign", ins, {"box_clip": 4.135}))
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k][0], **BOX)
    tight = _np(_port("box_decoder_and_assign", ins, {"box_clip": 0.5}))
    d = ins["TargetBox"][0].reshape(5, 3, 4)
    w = tight["DecodeBox"][0].reshape(5, 3, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    np.testing.assert_allclose(w[..., 2] - w[..., 0] + 1.0,
                               np.exp(np.minimum(d[..., 2], 0.5))
                               * pw[:, None], rtol=1e-5, atol=1e-4)


def case_box_clip(rs):
    boxes = (_f(rs, 2, 5, 4) * 40 + 20).astype("float32")
    info = np.array([[40.0, 60.0, 1.0], [30.0, 20.0, 0.5]], "float32")
    _check("box_clip", {"Input": [boxes], "ImInfo": [info]}, {}, BOX)
    _check("box_clip", {"Input": [boxes[:, :, None]], "ImInfo": [info]},
           {}, BOX)


# ------------------------------------------------------------ the rest
def case_density_prior_box(rs):
    feat = np.zeros((1, 8, 3, 4), "float32")
    image = np.zeros((1, 3, 24, 32), "float32")
    for attrs in ({"densities": [2, 1], "fixed_sizes": [6.0, 12.0],
                   "fixed_ratios": [1.0, 2.0], "clip": True},
                  {"densities": [3], "fixed_sizes": [10.0],
                   "step_w": 8.0, "step_h": 9.0, "offset": 0.4,
                   "flatten_to_2d": True}):
        _check("density_prior_box", {"Input": [feat], "Image": [image]},
               attrs, BOX)


def case_polygon_box_transform(rs):
    _check("polygon_box_transform", {"Input": [_f(rs, 2, 8, 3, 5)]}, {},
           BOX)


def _yolo_inputs(rs, N=2, H=5, W=5, B=4, cls=3):
    mask = [0, 1]
    x = _f(rs, N, len(mask) * (5 + cls), H, W)
    gt = np.zeros((N, B, 4), "float32")
    gt[:, :3, :2] = rs.rand(N, 3, 2) * 0.9 + 0.05
    gt[:, :3, 2:] = rs.rand(N, 3, 2) * 0.4 + 0.05
    # a padding gt whose clipped cell is a real match's (0, 0) slot
    gt[0, 0] = [0.05, 0.05, 0.1, 0.1]
    lab = rs.randint(0, cls, (N, B)).astype("int32")
    attrs = {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": mask,
             "class_num": cls, "ignore_thresh": 0.5, "downsample_ratio": 32}
    return {"X": [x], "GTBox": [gt], "GTLabel": [lab]}, attrs


def case_yolov3_loss(rs):
    ins, attrs = _yolo_inputs(rs)
    _, t = _check("yolov3_loss", ins, attrs, LOSS)
    # the padding gt did not erase the match at the slot it collides with
    assert t["ObjectnessMask"][0][0, :, 0, 0].max() == 1.0
    _check("yolov3_loss", ins, dict(attrs, anchor_mask=[1, 2],
                                    ignore_thresh=0.2), LOSS)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}
DETECTION_OPS = sorted(CASES)


def test_cases_cover_the_19_detection_ops():
    from paddle_tpu.core.registry import OPS as JOPS
    from paddle_tpu_torch.core.registry import OPS

    assert len(CASES) == 19
    assert set(CASES) <= set(OPS) and set(CASES) <= set(JOPS)
    for t in CASES:
        j, p = JOPS[t], OPS[t]
        assert (p.no_grad, p.diff_inputs, p.uses_rng) == (
            j.no_grad, j.diff_inputs, j.uses_rng), t


@pytest.mark.parametrize("op_type", DETECTION_OPS)
def test_detection_op_matches_jax_lowering(op_type):
    CASES[op_type](np.random.RandomState(0))


def test_registry_misses_only_the_multi_device_ops():
    from paddle_tpu.core.registry import OPS as JOPS
    from paddle_tpu_torch.core.registry import OPS

    jax_ops = {t for t, d in JOPS.items() if not d.synthesized}
    port_ops = {t for t, d in OPS.items() if not d.synthesized}
    # moe_ffn and pipeline are ported since the mesh tier; the six
    # distributed ops are left
    assert sorted(jax_ops - port_ops) == sorted([
        "send", "recv", "send_barrier", "fetch_barrier", "prefetch",
        "send_sparse"])
    assert len(jax_ops & port_ops) == len(jax_ops) - 6


def test_public_names_equal_the_jax_modules():
    from paddle_tpu.layers import detection as jdet
    from paddle_tpu_torch.layers import detection as tdet

    assert tdet.__all__ == jdet.__all__
    for name in jdet.__all__:
        assert getattr(pt.layers, name) is getattr(tdet, name), name


def test_nms_keeps_the_first_of_equal_boxes():
    """Three equal boxes of one score in one class: the lowest index is
    kept, the others suppressed; a fourth apart is kept (both
    packages)."""
    box = [0.1, 0.1, 0.5, 0.5]
    boxes = np.array([[box, box, [0.6, 0.6, 0.9, 0.9], box]], "float32")
    scores = np.full((1, 1, 4), 0.5, "float32")
    attrs = {"score_threshold": 0.1, "nms_top_k": 4, "keep_top_k": 4,
             "nms_threshold": 0.5}
    j, t = _check("multiclass_nms", {"BBoxes": [boxes], "Scores": [scores]},
                  attrs, EXACT)
    out = t["Out"][0][0]
    np.testing.assert_array_equal(out[:, 0], [0, 0, -1, -1])
    np.testing.assert_array_equal(out[0, 2:], np.float32(box))


def test_detection_map_matches_jax():
    """``detection_map`` (a host callback over the detections and the
    labels, VOC's integral AP) in both packages on the same rows: a
    perfect match is 1.0, and a mixed one the JAX package's value."""
    lab = np.array([[[1, 0, 0, 10, 10], [2, 20, 20, 30, 30]],
                    [[1, 5, 5, 15, 15], [2, 0, 0, 8, 8]]], "float32")
    det = np.full((2, 4, 6), -1.0, "float32")
    det[:, :2, 0], det[:, :2, 1], det[:, :2, 2:] = lab[..., 0], 0.9, \
        lab[..., 1:]
    mixed = det.copy()
    mixed[0, 2] = [1, 0.95, 40, 40, 50, 50]         # a false positive
    mixed[1, 1, 2:] += 3.0                          # IoU under 0.5

    def build(pkg):
        L = pkg.layers
        d = L.data("det", [2, 4, 6], append_batch_size=False)
        lb = L.data("lab", [2, 2, 5], append_batch_size=False)
        return [L.detection_map(d, lb, class_num=3)]

    jres, tres, _, _ = run_both(build, [{"det": det, "lab": lab},
                                        {"det": mixed, "lab": lab}])
    np.testing.assert_allclose(tres[0][0], 1.0, rtol=1e-6)
    assert float(jres[1][0][0]) < 1.0
    np.testing.assert_allclose(tres[1][0], jres[1][0], rtol=1e-6)


def test_rpn_target_assign_layer_gathers_the_sampled_predictions():
    """``layers.rpn_target_assign`` in the port (tests/test_ssd_stack.py's
    program): the labels' properties, and its predicted scores and
    boxes are the inputs' rows at the sampled anchors (pads at anchor
    0)."""
    B, A, G, K = 1, 3 * 4 * 4, 2, 16
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        feat = L.data("feat", [B, 8, 4, 4], append_batch_size=False)
        anc, var = L.anchor_generator(feat, anchor_sizes=[8.0, 16.0, 32.0],
                                      aspect_ratios=[1.0], stride=[8.0, 8.0])
        bp = L.data("bp", [B, A, 4], append_batch_size=False)
        cl = L.data("cl", [B, A], append_batch_size=False)
        gtb = L.data("gtb", [B, G, 4], append_batch_size=False)
        outs = L.rpn_target_assign(bp, cl, anc, var, gtb,
                                   rpn_batch_size_per_im=K)
    # the sampled anchors, pads (-1) at 0: the gathers' Index
    idx = main.global_block().ops[-1].input("Index")[0]
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    feed = {"feat": np.zeros((B, 8, 4, 4), "float32"),
            "bp": rs.randn(B, A, 4).astype("float32"),
            "cl": rs.randn(B, A).astype("float32"),
            "gtb": np.array([[[2, 2, 14, 14], [16, 16, 30, 30]]], "float32")}
    sc, loc, lbl, tgt, inw, sel = exe.run(
        main, feed=feed, fetch_list=list(outs) + [idx], scope=scope)
    assert sc.shape == (B, K) and loc.shape == (B, K, 4)
    assert set(np.unique(lbl)) <= {-1, 0, 1} and (lbl == 1).sum() >= 1
    assert (inw[lbl == 1] == 1).all() and (inw[lbl != 1] == 0).all()
    np.testing.assert_array_equal(sc, feed["cl"][0][sel])
    np.testing.assert_array_equal(loc, feed["bp"][0][sel])


# ---------------------------------------------------------- the grads
def _grads_match(build, feed):
    """Both packages' loss and the grads of every param of ``build``'s
    program (``append_backward``), on the JAX startup's weights, within
    1e-5 (plus a relative 1e-5)."""
    def with_grads(pkg):
        loss = build(pkg)
        params = pkg.default_main_program().global_block().all_parameters()
        import_module(pkg.__name__ + ".core.backward").append_backward(loss)
        return [loss] + [pkg.default_main_program().global_block().var(
            p.name + "@GRAD") for p in params]

    jres, tres, _, _ = run_both(with_grads, [feed])
    assert len(jres[0]) >= 2
    for a, b in zip(jres[0], tres[0]):
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


def test_ssd_loss_grads_match_jax():
    rs = np.random.RandomState(1)
    ins = _ssd_inputs(rs, B=2, P=24, C=4, G=3)

    def build(pkg):
        L = pkg.layers
        h = L.data("h", [2, 24, 6], append_batch_size=False)
        loc = L.fc(h, 4, num_flatten_dims=2)
        conf = L.fc(h, 4, num_flatten_dims=2)
        gtb = L.data("gtb", [2, 3, 4], append_batch_size=False)
        gtl = L.data("gtl", [2, 3], dtype="int32", append_batch_size=False)
        pri = L.data("pri", [24, 4], append_batch_size=False)
        return L.reduce_mean(L.ssd_loss(loc, conf, gtb, gtl, pri))

    _grads_match(build, {"h": _f(rs, 2, 24, 6), "gtb": ins["GTBox"][0],
                         "gtl": ins["GTLabel"][0],
                         "pri": ins["PriorBox"][0]})


def test_yolov3_loss_grads_match_jax():
    rs = np.random.RandomState(2)
    ins, attrs = _yolo_inputs(rs, H=4, W=4)

    def build(pkg):
        L = pkg.layers
        img = L.data("img", [2, 3, 4, 4], append_batch_size=False)
        x = L.conv2d(img, num_filters=16, filter_size=1)
        gtb = L.data("gtb", [2, 4, 4], append_batch_size=False)
        gtl = L.data("gtl", [2, 4], dtype="int32", append_batch_size=False)
        return L.reduce_mean(L.yolov3_loss(
            x, gtb, gtl, attrs["anchors"], attrs["anchor_mask"],
            attrs["class_num"], attrs["ignore_thresh"], 32))

    _grads_match(build, {"img": _f(rs, 2, 3, 4, 4), "gtb": ins["GTBox"][0],
                         "gtl": ins["GTLabel"][0]})


@pytest.mark.parametrize("layer", ["roi_align", "roi_pool"])
def test_roi_pool_grads_match_jax(layer):
    """The pooled map is a param of small integers and the rois are
    integer boxes inside it with even sides, so every bilinear weight is
    a multiple of 1/8 and every sample exact in f32: the JAX package's
    fused program otherwise rounds a sample apart from its own max in
    the last place and sends that max's grad elsewhere (its eager
    lowering agrees with the port's to 5e-7)."""
    fmap = np.random.RandomState(3).randint(-4, 5, (2, 3, 7, 8)).astype(
        "float32")
    rois = np.array([[1, 1, 4, 4], [2, 1, 5, 4], [1, 1, 2, 2],
                     [3, 1, 6, 4]], "float32")

    def build(pkg):
        L = pkg.layers
        x = L.create_parameter(
            [2, 3, 7, 8], "float32", name="fmap",
            default_initializer=pkg.initializer.NumpyArrayInitializer(fmap))
        r = L.data("rois", [4, 4], append_batch_size=False)
        rb = L.data("rb", [4], dtype="int32", append_batch_size=False)
        out = getattr(L, layer)(x, r, pooled_height=2, pooled_width=2,
                                rois_batch=rb)
        return L.reduce_sum(L.square(out))

    _grads_match(build, {"rois": rois,
                         "rb": np.array([1, 0, 1, 0], "int32")})


# ------------------------------------------- test_ssd_pipeline_trains
def _ssd_pipeline(pkg):
    """tests/test_ssd_stack.py::test_ssd_pipeline_trains's program."""
    L = pkg.layers
    B, C = 2, 4
    img = L.data("img", [B, 3, 64, 64], append_batch_size=False)
    f1 = L.conv2d(img, num_filters=8, filter_size=3, stride=8, padding=1)
    f2 = L.conv2d(f1, num_filters=8, filter_size=3, stride=2, padding=1)
    locs, confs, pri, pvar = L.multi_box_head(
        [f1, f2], img, base_size=64, num_classes=C,
        aspect_ratios=[[2.0], [2.0]], min_sizes=[12.0, 24.0],
        max_sizes=[24.0, 48.0], flip=True)
    gtb = L.data("gtb", [B, 3, 4], append_batch_size=False)
    gtl = L.data("gtl", [B, 3], dtype="int64", append_batch_size=False)
    loss = L.reduce_mean(L.ssd_loss(locs, confs, gtb, gtl, pri, pvar))
    pkg.optimizer.Adam(1e-3).minimize(loss)
    dets = L.detection_output(locs, L.softmax(confs), pri, pvar,
                              keep_top_k=10)
    return loss, dets


def test_ssd_pipeline_trains_at_parity():
    B, C = 2, 4
    rs = np.random.RandomState(0)
    gt = np.zeros((B, 3, 4), "float32")
    gt[:, :2] = rs.rand(B, 2, 4).astype("float32") * 0.4
    gt[:, :2, 2:] = gt[:, :2, :2] + 0.3
    feed = {"img": rs.randn(B, 3, 64, 64).astype("float32"), "gtb": gt,
            "gtl": rs.randint(1, C, (B, 3)).astype("int64")}
    jres, tres, _, _ = run_both(_ssd_pipeline, [feed] * 9)
    jl = [float(r[0]) for r in jres[:8]]
    tl = [float(r[0]) for r in tres[:8]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    # the 9th run's detections (after 8 steps): [B, 10, 6] rows, class
    # and keep exactly, scores and boxes within 1e-5
    jd, td = jres[8][1], tres[8][1]
    assert td.shape == jd.shape == (B, 10, 6)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    np.testing.assert_allclose(td, jd, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------- SSD300
def _ssd_programs():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import ssd_programs

    return ssd_programs


def test_ssd300_has_8732_priors_trains_and_detects():
    """tools/ssd_programs.py's SSD300 at 1/16 width in the port on the
    CPU: 8732 priors, two Adam steps of finite loss, then the
    inference program on the trained scope gives [2, 200, 6] rows,
    sorted by score, their classes in 1-20 or -1."""
    sp = _ssd_programs()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 7
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, priors = sp.build(pt, 2, width=16)
    infer = pt.Program()
    with pt.program_guard(infer, pt.Program()), pt.unique_name.guard():
        dets, _ = sp.build(pt, 2, train=False, width=16)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    losses = []
    for step in range(2):
        lv, pv = exe.run(main, feed=sp.batch_feed(2, step),
                         fetch_list=[loss, priors], scope=scope)
        losses.append(float(lv))
    assert pv.shape == (sp.N_PRIORS, 4) and np.isfinite(losses).all()
    (d,) = exe.run(infer, feed=sp.batch_feed(2, 9, train=False),
                   fetch_list=[dets], scope=scope)
    assert d.shape == (2, 200, 6)
    cls = d[..., 0]
    assert set(np.unique(cls)) <= set(range(-1, 21)) - {0}
    kept = cls >= 0
    assert kept.sum() > 0
    for b in range(2):
        s = d[b, kept[b], 1]
        assert (np.diff(s) <= 0).all() and (s >= 0.01).all()


def test_ssd300_builds_the_same_full_width_program_in_both_packages():
    """At its published widths (built only, not run): the same ops and
    attrs in both packages, and the prior reshapes' static rows sum to
    8732 (conv4_3's 38 x 38 x 4 first)."""
    from torch_parity import build_both

    sp = _ssd_programs()
    progs = build_both(lambda pkg: sp.build(pkg, 8, train=False))
    ops = {k: [(op.type, {a: v for a, v in op.attrs.items()
                          if not a.startswith("__")})
               for op in progs[k][0].global_block().ops]
           for k in progs}
    assert ops["port"] == ops["jax"]
    rows = [a["shape"][0] for t, a in ops["port"] if t == "reshape2"
            and a["shape"][-1] == 4 and len(a["shape"]) == 2]
    assert rows[::2] == [5776, 2166, 600, 150, 36, 4]
    assert sum(rows[::2]) == sp.N_PRIORS


@pytest.mark.slow
def test_ssd300_at_parity_with_jax():
    """The SSD300 at 1/16 width built by both packages: two Adam steps'
    losses within a relative 1e-5 (the priors within 1e-6: the JAX
    package's fused program rounds some in the last place), then the
    detections of the inference
    program (its classes exactly, scores and boxes within 1e-5)."""
    sp = _ssd_programs()
    jres, tres, _, _ = run_both(lambda pkg: sp.build(pkg, 2, width=16),
                                [sp.batch_feed(2, s) for s in range(2)])
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        np.testing.assert_allclose(t[1], j[1], **BOX)
    jres, tres, _, _ = run_both(
        lambda pkg: sp.build(pkg, 2, train=False, width=16)[:1],
        [sp.batch_feed(2, 7, train=False)])
    np.testing.assert_array_equal(tres[0][0][..., 0], jres[0][0][..., 0])
    np.testing.assert_allclose(tres[0][0], jres[0][0], atol=1e-5, rtol=1e-5)


def test_chip_smoke_holds_card_detections_to_the_cpus():
    """chip_smoke.py phase 19's comparison of the card's detections with
    the CPU's, driven on the CPU with the NMS inputs moved as the card's
    rounding moves them: within 1e-5 every departing NMS lane is
    explained and the rows agree; a changed class, or inputs moved by
    1e-3, are refused."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cs = import_module("chip_smoke")
    sp = _ssd_programs()
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 3
    with pt.program_guard(main, startup), pt.unique_name.guard():
        dets, _ = sp.build(pt, 2, train=False, width=16)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    wide, cpu_in, attrs = cs._cpu_detections(
        pt, main, dets, sp.batch_feed(2, 5, train=False), scope)
    assert wide.shape == (2, 8400, 6)

    def card(eps):
        rs = np.random.RandomState(0)
        ins = tuple((x + rs.uniform(-eps, eps, x.shape)).astype("float32")
                    for x in cpu_in)
        out = cs._op_on(CPU, "multiclass_nms", {"BBoxes": [ins[0]],
                                                "Scores": [ins[1]]}, attrs)
        return ins, out["Out"][0].numpy()

    ins, got = card(1e-5)
    flipped, kinds = cs._nms_flips(ins, cpu_in, attrs)
    assert kinds and {k[3] for k in kinds} <= {"score", "cut", "iou",
                                               "order"}
    assert cs._det_against_cpu(got, wide, flipped)[0] <= 1e-4
    assert cs._det_against_cpu(wide[:, :200], wide, {}) == (0.0, 0, 0, 0)
    bad = wide[:, :200].copy()
    bad[1, 7, 0] += 1.0
    with pytest.raises(AssertionError, match="no CPU row"):
        cs._det_against_cpu(bad, wide, {})
    with pytest.raises(AssertionError, match="rounding cannot turn it"):
        cs._nms_flips(card(1e-3)[0], cpu_in, attrs)
