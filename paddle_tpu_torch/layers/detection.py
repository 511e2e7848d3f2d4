"""Detection layers (reference: python/paddle/fluid/layers/detection.py —
prior_box:~140, box_coder, iou_similarity, multiclass_nms, roi ops live in
nn.py there). Lowerings in ops/detection_ops.py; multiclass_nms returns a
fixed-size padded tensor instead of a LoD tensor (static shapes)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "prior_box",
    "box_coder",
    "iou_similarity",
    "multiclass_nms",
    "roi_align",
    "roi_pool",
    "yolov3_loss",
    "anchor_generator",
    "density_prior_box",
    "generate_proposals",
    "bipartite_match",
    "target_assign",
    "box_clip",
    "polygon_box_transform",
    "ssd_loss",
    "multi_box_head",
    "detection_output",
    "distribute_fpn_proposals",
    "box_decoder_and_assign",
    "rpn_target_assign",
    "generate_proposal_labels",
    "detection_map",
    "roi_perspective_transform",
    "generate_mask_labels",
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference("float32",
                                                      stop_gradient=True)
    var = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [var]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": steps[0], "step_h": steps[1], "offset": offset})
    return boxes, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="box_coder", inputs=ins,
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized})
    return out


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={})
    return out


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=-1, name=None):
    """Fixed-size output [keep_top_k, 6] padded with class=-1 (static-shape
    redesign of the reference's LoD output)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "background_label": background_label,
               "normalized": normalized, "nms_eta": nms_eta})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch=None,
              name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        ins["RoisBatch"] = [rois_batch]
    helper.append_op(type="roi_align", inputs=ins, outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": (sampling_ratio
                                               if sampling_ratio > 0 else 2)})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch=None, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        ins["RoisBatch"] = [rois_batch]
    helper.append_op(type="roi_pool", inputs=ins,
                     outputs={"Out": [out], "Argmax": [None]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def yolov3_loss(x, gtbox, gtlabel, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, name=None):
    """reference detection.py:510; lowering in ops/detection_ops.py
    (vectorized yolov3_loss_op.h). Returns per-image loss [N]."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference(x.dtype)
    obj_mask = helper.create_variable_for_type_inference("float32",
                                                         stop_gradient=True)
    match = helper.create_variable_for_type_inference("int32",
                                                      stop_gradient=True)
    helper.append_op(
        type="yolov3_loss",
        inputs={"X": [x], "GTBox": [gtbox], "GTLabel": [gtlabel]},
        outputs={"Loss": [loss], "ObjectnessMask": [obj_mask],
                 "GTMatchMask": [match]},
        attrs={"anchors": list(anchors), "anchor_mask": list(anchor_mask),
               "class_num": int(class_num),
               "ignore_thresh": float(ignore_thresh),
               "downsample_ratio": int(downsample_ratio)})
    loss.shape = (x.shape[0],)
    return loss


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    """reference detection.py:1603. Anchors/Variances [H, W, A, 4]."""
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    vars_ = helper.create_variable_for_type_inference("float32",
                                                      stop_gradient=True)
    anchor_sizes = list(anchor_sizes or [64.0, 128.0, 256.0, 512.0])
    aspect_ratios = list(aspect_ratios or [0.5, 1.0, 2.0])
    stride = list(stride or [16.0, 16.0])
    helper.append_op(
        type="anchor_generator",
        inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [vars_]},
        attrs={"anchor_sizes": anchor_sizes, "aspect_ratios": aspect_ratios,
               "variances": list(variance), "stride": stride,
               "offset": float(offset)})
    A = len(anchor_sizes) * len(aspect_ratios)
    h, w = input.shape[2], input.shape[3]
    anchors.shape = vars_.shape = (h, w, A, 4)
    return anchors, vars_


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """reference detection.py:1231. Boxes/Variances [H, W, P, 4] (or
    [H*W*P, 4] flattened)."""
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference("float32",
                                                      stop_gradient=True)
    vars_ = helper.create_variable_for_type_inference("float32",
                                                      stop_gradient=True)
    densities = [int(d) for d in (densities or [])]
    fixed_sizes = [float(s) for s in (fixed_sizes or [])]
    fixed_ratios = [float(r) for r in (fixed_ratios or [1.0])]
    if len(fixed_sizes) != len(densities):
        raise ValueError(
            "density_prior_box: fixed_sizes (%d) and densities (%d) must "
            "pair up one-to-one" % (len(fixed_sizes), len(densities)))
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [vars_]},
        attrs={"densities": densities, "fixed_sizes": fixed_sizes,
               "fixed_ratios": fixed_ratios, "variances": list(variance),
               "clip": bool(clip), "step_w": float(steps[0]),
               "step_h": float(steps[1]), "offset": float(offset),
               "flatten_to_2d": bool(flatten_to_2d)})
    P = sum(len(fixed_ratios) * d * d for d in densities)
    h, w = input.shape[2], input.shape[3]
    if flatten_to_2d:
        boxes.shape = vars_.shape = (h * w * P, 4)
    else:
        boxes.shape = vars_.shape = (h, w, P, 4)
    return boxes, vars_


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """reference detection.py:1975. Dense divergence: fixed-shape
    [N, post_nms_top_n, 4] rois + [N, post_nms_top_n, 1] probs,
    zero-padded (valid rows have prob > 0), instead of ragged LoD."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(scores.dtype,
                                                     stop_gradient=True)
    probs = helper.create_variable_for_type_inference(scores.dtype,
                                                      stop_gradient=True)
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [probs]},
        attrs={"pre_nms_topN": int(pre_nms_top_n),
               "post_nms_topN": int(post_nms_top_n),
               "nms_thresh": float(nms_thresh), "min_size": float(min_size),
               "eta": float(eta)})
    n = scores.shape[0]
    rois.shape = (n, int(post_nms_top_n), 4)
    probs.shape = (n, int(post_nms_top_n), 1)
    return rois, probs


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    """reference detection.py bipartite_match: [B, G, P] (dense batch)
    -> (match_indices [B, P], match_distance [B, P])."""
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    dist = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    helper.append_op(type="bipartite_match",
                     inputs={"DistMat": [dist_matrix]},
                     outputs={"ColToRowMatchIndices": [idx],
                              "ColToRowMatchDist": [dist]},
                     attrs={"match_type": match_type,
                            "dist_threshold": float(dist_threshold)})
    if dist_matrix.shape and len(dist_matrix.shape) == 3:
        idx.shape = dist.shape = (dist_matrix.shape[0],
                                  dist_matrix.shape[2])
    return idx, dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0.0, name=None):
    """reference detection.py target_assign -> (out, out_weight)."""
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    w = helper.create_variable_for_type_inference("float32",
                                                  stop_gradient=True)
    helper.append_op(type="target_assign",
                     inputs={"X": [input],
                             "MatchIndices": [matched_indices]},
                     outputs={"Out": [out], "OutWeight": [w]},
                     attrs={"mismatch_value": float(mismatch_value)})
    if input.shape and matched_indices.shape:
        out.shape = (matched_indices.shape[0], matched_indices.shape[1],
                     input.shape[2])
        w.shape = out.shape[:2] + (1,)
    return out, w


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="box_clip",
                     inputs={"Input": [input], "ImInfo": [im_info]},
                     outputs={"Output": [out]})
    out.shape = input.shape
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": [input]}, outputs={"Output": [out]})
    out.shape = input.shape
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """reference detection.py:877, fused lowering (ops/detection_ops.py
    ssd_loss): dense gt [B, G, 4]/[B, G] with zero-area padding rows.
    Returns the per-image normalized loss [B]."""
    helper = LayerHelper("ssd_loss")
    loss = helper.create_variable_for_type_inference("float32")
    inputs = {"Location": [location], "Confidence": [confidence],
              "GTBox": [gt_box], "GTLabel": [gt_label],
              "PriorBox": [prior_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="ssd_loss", inputs=inputs,
                     outputs={"Loss": [loss]},
                     attrs={"background_label": int(background_label),
                            "overlap_threshold": float(overlap_threshold),
                            "neg_pos_ratio": float(neg_pos_ratio),
                            "loc_loss_weight": float(loc_loss_weight),
                            "conf_loss_weight": float(conf_loss_weight)})
    loss.shape = (location.shape[0],) if location.shape else None
    return loss


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """reference detection.py:1357: per-feature-map prior boxes + conv
    loc/conf heads, concatenated over maps. Returns
    (mbox_locs [B,P,4], mbox_confs [B,P,C], prior_boxes [P,4],
    variances [P,4])."""
    from . import nn as _nn
    from .tensor import concat

    n_maps = len(inputs)
    if min_sizes is None:
        # the reference's min_ratio/max_ratio interpolation
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_maps - 2)) if n_maps > 2 \
            else 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:n_maps - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:n_maps - 1]

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) \
            else [aspect_ratios[i]]
        stp = steps[i] if steps else 0.0
        mins_l = [mins] if not isinstance(mins, list) else mins
        maxs_l = ([maxs] if maxs and not isinstance(maxs, list)
                  else (maxs or []))
        boxes, var = prior_box(
            feat, image, min_sizes=mins_l, max_sizes=maxs_l or None,
            aspect_ratios=ar, variance=list(variance), flip=flip,
            clip=clip, steps=(stp, stp), offset=offset)
        # P_i anchors per cell (same expansion as the prior_box op)
        ars = [1.0]
        for r in ar:
            if all(abs(r - a) > 1e-6 for a in ars):
                ars.append(r)
                if flip:
                    ars.append(1.0 / r)
        p_i = len(mins_l) * len(ars) + (len(maxs_l) if maxs_l else 0)
        fh, fw = feat.shape[2], feat.shape[3]
        num_loc = p_i * 4
        loc = _nn.conv2d(feat, num_filters=num_loc,
                         filter_size=kernel_size, padding=pad,
                         stride=stride)
        loc = _nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = _nn.reshape(loc, shape=[loc.shape[0], -1, 4])
        num_conf = p_i * num_classes
        conf = _nn.conv2d(feat, num_filters=num_conf,
                          filter_size=kernel_size, padding=pad,
                          stride=stride)
        conf = _nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = _nn.reshape(conf, shape=[conf.shape[0], -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_all.append(_nn.reshape(boxes, shape=[fh * fw * p_i, 4]))
        vars_all.append(_nn.reshape(var, shape=[fh * fw * p_i, 4]))

    mbox_locs = concat(locs, axis=1)
    mbox_confs = concat(confs, axis=1)
    prior_boxes = concat(boxes_all, axis=0)
    box_vars = concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, prior_boxes, box_vars


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """reference detection.py:206: decode loc against priors then
    multiclass NMS. Returns the fixed-size padded [B, keep_top_k, 6]
    result of multiclass_nms (class, score, box)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    from . import nn as _nn

    scores_t = _nn.transpose(scores, perm=[0, 2, 1])  # [B, C, P]
    return multiclass_nms(decoded, scores_t,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label,
                          nms_eta=nms_eta)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    """reference detection.py distribute_fpn_proposals (dense: each level
    keeps the roi count with zero padding; RestoreIndex maps back)."""
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    n = max_level - min_level + 1
    outs = [helper.create_variable_for_type_inference(fpn_rois.dtype,
                                                      stop_gradient=True)
            for _ in range(n)]
    restore = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(type="distribute_fpn_proposals",
                     inputs={"FpnRois": [fpn_rois]},
                     outputs={"MultiFpnRois": outs,
                              "RestoreIndex": [restore]},
                     attrs={"min_level": int(min_level),
                            "max_level": int(max_level),
                            "refer_level": int(refer_level),
                            "refer_scale": float(refer_scale)})
    for o in outs:
        o.shape = fpn_rois.shape
    restore.shape = (fpn_rois.shape[0], 1) if fpn_rois.shape else None
    return outs, restore


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    """reference detection.py box_decoder_and_assign."""
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = helper.create_variable_for_type_inference(
        target_box.dtype, stop_gradient=True)
    assigned = helper.create_variable_for_type_inference(
        target_box.dtype, stop_gradient=True)
    helper.append_op(type="box_decoder_and_assign",
                     inputs={"PriorBox": [prior_box],
                             "TargetBox": [target_box],
                             "BoxScore": [box_score]},
                     outputs={"DecodeBox": [decoded],
                              "OutputAssignBox": [assigned]},
                     attrs={"box_clip": float(box_clip)})
    decoded.shape = target_box.shape
    if prior_box.shape:
        assigned.shape = (prior_box.shape[0], 4)
    return decoded, assigned


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """reference detection.py:59, dense redesign: returns
    (predicted_cls [B,K], predicted_loc [B,K,4], target_label [B,K],
    target_bbox [B,K,4], bbox_inside_weight [B,K,4]) at fixed
    K = rpn_batch_size_per_im (pad label -1 / weight 0). gt_boxes is the
    dense [B, G, 4] batch with zero-area padding rows."""
    from . import nn as _nn

    helper = LayerHelper("rpn_target_assign")
    idx = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    lbl = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    tgt = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    inw = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    helper.append_op(
        type="rpn_target_assign",
        inputs={"Anchor": [anchor_box], "GtBoxes": [gt_boxes]},
        outputs={"ScoreIndex": [idx], "LocIndex": [idx],
                 "TargetLabel": [lbl], "TargetBBox": [tgt],
                 "BBoxInsideWeight": [inw]},
        attrs={"rpn_batch_size_per_im": int(rpn_batch_size_per_im),
               "rpn_fg_fraction": float(rpn_fg_fraction),
               "rpn_positive_overlap": float(rpn_positive_overlap),
               "rpn_negative_overlap": float(rpn_negative_overlap)})
    B = gt_boxes.shape[0]
    K = int(rpn_batch_size_per_im)
    idx.shape = lbl.shape = (B, K)
    tgt.shape = inw.shape = (B, K, 4)

    # gather predictions at the sampled anchor indices (pad idx -1 -> 0;
    # padded rows carry label -1 / weight 0 so their values are inert)
    from . import ops as _ops

    flat_scores = _nn.reshape(cls_logits, shape=[B, -1])
    flat_loc = _nn.reshape(bbox_pred, shape=[B, -1, 4])
    safe = _ops.relu(idx)
    sel_scores = _take_rows(flat_scores, safe)
    sel_loc = _take_rows(flat_loc, safe)
    return sel_scores, sel_loc, lbl, tgt, inw


def _take_rows(x, idx):
    """take_along_axis on dim 1 as a tiny op composition."""
    helper = LayerHelper("take_rows")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="take_along_axis1",
                     inputs={"X": [x], "Index": [idx]},
                     outputs={"Out": [out]})
    if x.shape and idx.shape:
        out.shape = (x.shape[0], idx.shape[1]) + tuple(x.shape[2:])
    return out


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True):
    """reference detection.py:1746, dense contract (see the op)."""
    helper = LayerHelper("generate_proposal_labels")
    rois = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    labels = helper.create_variable_for_type_inference("int32",
                                                       stop_gradient=True)
    tgt = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    inw = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    outw = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                "GtBoxes": [gt_boxes]},
        outputs={"Rois": [rois], "LabelsInt32": [labels],
                 "BboxTargets": [tgt], "BboxInsideWeights": [inw],
                 "BboxOutsideWeights": [outw]},
        attrs={"batch_size_per_im": int(batch_size_per_im),
               "fg_fraction": float(fg_fraction),
               "fg_thresh": float(fg_thresh),
               "bg_thresh_hi": float(bg_thresh_hi),
               "bg_thresh_lo": float(bg_thresh_lo),
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": int(class_nums)})
    B = gt_boxes.shape[0]
    K = int(batch_size_per_im)
    rois.shape = (B, K, 4)
    labels.shape = (B, K)
    tgt.shape = inw.shape = outw.shape = (B, K, 4 * int(class_nums))
    return rois, labels, tgt, inw, outw


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral", difficult=None):
    """reference detection.py:613 mAP metric, dense contract: detect_res
    [B, D, 6] (class, score, box; class < 0 pads — multiclass_nms's
    output), label [B, G, 5] (class, box; zero-area pads), optional
    difficult [B, G] 0/1. With evaluate_difficult=False, difficult GT
    boxes are excluded from the recall denominator and detections
    matching them count as neither TP nor FP (VOC semantics). Computed
    by an in-step host callback (metric, no gradients)."""
    import numpy as np

    from .decode import py_func

    def _ap(rec, prec):
        if ap_version == "11point":
            return float(np.mean([
                max([p for r, p in zip(rec, prec) if r >= t] or [0.0])
                for t in np.linspace(0, 1, 11)]))
        ap = 0.0
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        for i in range(len(mrec) - 1):
            ap += (mrec[i + 1] - mrec[i]) * mpre[i + 1]
        return float(ap)

    def _map(dets, labels, diff=None):
        aps = []
        for c in range(class_num):
            if c == background_label:
                continue
            records = []          # (score, image, box)
            n_gt = 0
            gt_by_img = []
            diff_by_img = []
            for b in range(labels.shape[0]):
                g = labels[b]
                valid = (g[:, 0].astype(int) == c) & \
                    ((g[:, 3] - g[:, 1]) > 0)
                gt_by_img.append(g[valid, 1:5])
                d_mask = (diff[b][valid].astype(bool)
                          if diff is not None
                          else np.zeros(int(valid.sum()), bool))
                diff_by_img.append(d_mask)
                # difficult GT leaves the recall denominator under VOC
                # semantics (evaluate_difficult=False)
                n_gt += int(valid.sum()) if evaluate_difficult \
                    else int((valid.sum() - d_mask.sum()))
                d = dets[b]
                for row in d[d[:, 0].astype(int) == c]:
                    records.append((float(row[1]), b, row[2:6]))
            if n_gt == 0:
                continue
            records.sort(key=lambda r: -r[0])
            used = [np.zeros(len(g), bool) for g in gt_by_img]
            tp = np.zeros(len(records))
            fp = np.zeros(len(records))
            for i, (s, b, box) in enumerate(records):
                g = gt_by_img[b]
                best, bi = 0.0, -1
                for j in range(len(g)):
                    gx = g[j]
                    ix = max(0, min(box[2], gx[2]) - max(box[0], gx[0]))
                    iy = max(0, min(box[3], gx[3]) - max(box[1], gx[1]))
                    inter = ix * iy
                    ua = ((box[2] - box[0]) * (box[3] - box[1])
                          + (gx[2] - gx[0]) * (gx[3] - gx[1]) - inter)
                    iou = inter / ua if ua > 0 else 0.0
                    if iou > best:
                        best, bi = iou, j
                if best >= overlap_threshold and bi >= 0:
                    if not evaluate_difficult and diff_by_img[b][bi]:
                        continue  # matched a difficult GT: ignored
                    if not used[b][bi]:
                        tp[i] = 1
                        used[b][bi] = True
                    else:
                        fp[i] = 1
                else:
                    fp[i] = 1
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            rec = ctp / n_gt
            prec = ctp / np.maximum(ctp + cfp, 1e-10)
            aps.append(_ap(rec, prec))
        return (np.float32(np.mean(aps) if aps else 0.0),)

    helper = LayerHelper("detection_map")
    out = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    out.shape = (1,)
    xs = [detect_res, label] + ([difficult] if difficult is not None else [])
    py_func(_map, xs, [out])
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_batch=None, name=None):
    """reference detection.py roi_perspective_transform: quadrilateral
    ROIs ([N, 8]) warped to fixed patches via their homography."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        ins["RoisBatch"] = [rois_batch]
    helper.append_op(type="roi_perspective_transform", inputs=ins,
                     outputs={"Out": [out]},
                     attrs={"transformed_height": int(transformed_height),
                            "transformed_width": int(transformed_width),
                            "spatial_scale": float(spatial_scale)})
    if rois.shape and input.shape:
        out.shape = (rois.shape[0], input.shape[1],
                     int(transformed_height), int(transformed_width))
    return out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes=None, resolution=14,
                         gt_boxes=None):
    """reference detection.py generate_mask_labels, dense bitmap
    contract: gt_segms [B, G, Hm, Wm] bitmaps (polygon rasterization is
    the data pipeline's job here); rois/labels from
    generate_proposal_labels. Returns (mask_rois, roi_has_mask_int32,
    mask_int32 [B, K, resolution^2], -1 rows for non-fg)."""
    helper = LayerHelper("generate_mask_labels")
    mrois = helper.create_variable_for_type_inference("float32",
                                                      stop_gradient=True)
    has = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    masks = helper.create_variable_for_type_inference("int32",
                                                      stop_gradient=True)
    helper.append_op(type="generate_mask_labels",
                     inputs={"Rois": [rois],
                             "LabelsInt32": [labels_int32],
                             "GtBoxes": [gt_boxes],
                             "GtSegms": [gt_segms]},
                     outputs={"MaskRois": [mrois],
                              "RoiHasMaskInt32": [has],
                              "MaskInt32": [masks]},
                     attrs={"resolution": int(resolution)})
    if rois.shape:
        B, K = rois.shape[0], rois.shape[1]
        mrois.shape = rois.shape
        has.shape = (B, K)
        masks.shape = (B, K, int(resolution) ** 2)
    return mrois, has, masks
