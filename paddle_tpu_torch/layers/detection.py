"""Detection layers (counterpart of paddle_tpu/layers/detection.py, its
15 public functions, with the same signatures, defaults and Program
text): prior_box, box_coder, iou_similarity, multiclass_nms,
detection_output, bipartite_match, target_assign, anchor_generator,
ssd_loss, roi_align, roi_pool, generate_proposals, rpn_target_assign,
detection_map and multi_box_head. The ops are ops/detection_ops.py's,
static-shape as the JAX package's: multiclass_nms gives [B, keep_top_k,
6] padded with label -1 and a valid count, ssd_loss takes gt boxes and
labels as padded batches (label -1)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ['prior_box', 'box_coder', 'iou_similarity', 'multiclass_nms',
           'detection_output', 'bipartite_match', 'target_assign',
           'anchor_generator', 'ssd_loss', 'roi_align', 'roi_pool',
           'generate_proposals', 'rpn_target_assign',
           'detection_map', 'multi_box_head']


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None):
    helper = LayerHelper('prior_box', name=name)
    boxes = helper.create_variable_for_type_inference('float32')
    var = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='prior_box',
        inputs={'Input': [input], 'Image': [image]},
        outputs={'Boxes': [boxes], 'Variances': [var]},
        attrs={'min_sizes': list(min_sizes),
               'max_sizes': list(max_sizes or []),
               'aspect_ratios': list(aspect_ratios),
               'variances': list(variance), 'flip': flip, 'clip': clip,
               'step_w': steps[0], 'step_h': steps[1], 'offset': offset})
    boxes.stop_gradient = True
    var.stop_gradient = True
    return boxes, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type='encode_center_size', box_normalized=True,
              name=None):
    helper = LayerHelper('box_coder', name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {'PriorBox': [prior_box], 'TargetBox': [target_box]}
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = [prior_box_var]
    helper.append_op(type='box_coder', inputs=inputs,
                     outputs={'OutputBox': [out]},
                     attrs={'code_type': code_type,
                            'box_normalized': box_normalized})
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper('iou_similarity', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='iou_similarity',
                     inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'box_normalized': box_normalized})
    return out


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k,
                   keep_top_k, nms_threshold=0.3, normalized=True,
                   background_label=0, return_index=False, name=None):
    """bboxes [B, N, 4], scores [B, C, N] -> ([B, keep_top_k, 6]
    (label, score, x1, y1, x2, y2; empty slots label=-1),
    valid_count [B])."""
    helper = LayerHelper('multiclass_nms', name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    count = helper.create_variable_for_type_inference('int32')
    helper.append_op(
        type='multiclass_nms',
        inputs={'BBoxes': [bboxes], 'Scores': [scores]},
        outputs={'Out': [out], 'ValidCount': [count]},
        attrs={'score_threshold': score_threshold,
               'nms_threshold': nms_threshold, 'nms_top_k': nms_top_k,
               'keep_top_k': keep_top_k, 'normalized': normalized,
               'background_label': background_label})
    out.stop_gradient = True
    count.stop_gradient = True
    return out, count


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, name=None):
    """(reference detection.py:186) decode predicted offsets against the
    priors, then batched multiclass NMS. loc: [B, M, 4] deltas; scores:
    [B, C, M] class probabilities (already softmaxed)."""
    dec = box_coder(prior_box, prior_box_var, loc,
                    code_type='decode_center_size')
    out, count = multiclass_nms(
        dec, scores, score_threshold=score_threshold,
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=nms_threshold, background_label=background_label)
    return out, count


def bipartite_match(dist_matrix, match_type='bipartite',
                    dist_threshold=0.5, name=None):
    """(reference detection.py:392) Greedy max matching of rows (ground
    truths) to columns (priors); -1 for unmatched columns."""
    helper = LayerHelper('bipartite_match', name=name)
    idx = helper.create_variable_for_type_inference('int32')
    dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(type='bipartite_match',
                     inputs={'DistMat': [dist_matrix]},
                     outputs={'ColToRowMatchIndices': [idx],
                              'ColToRowMatchDist': [dist]},
                     attrs={'match_type': match_type or 'bipartite',
                            'dist_threshold': dist_threshold})
    idx.stop_gradient = True
    dist.stop_gradient = True
    return idx, dist


def target_assign(input, matched_indices, mismatch_value=0, name=None):
    """(reference target_assign_op) Gather per-prior targets by match
    indices; weight 0 where unmatched."""
    helper = LayerHelper('target_assign', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    w = helper.create_variable_for_type_inference('float32')
    helper.append_op(type='target_assign',
                     inputs={'X': [input],
                             'MatchIndices': [matched_indices]},
                     outputs={'Out': [out], 'OutWeight': [w]},
                     attrs={'mismatch_value': mismatch_value})
    return out, w


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """(reference anchor_generator_op) Absolute-pixel anchors."""
    helper = LayerHelper('anchor_generator', name=name)
    anchors = helper.create_variable_for_type_inference('float32')
    var = helper.create_variable_for_type_inference('float32')
    helper.append_op(type='anchor_generator', inputs={'Input': [input]},
                     outputs={'Anchors': [anchors], 'Variances': [var]},
                     attrs={'anchor_sizes': list(anchor_sizes),
                            'aspect_ratios': list(aspect_ratios),
                            'variances': list(variance),
                            'stride': list(stride), 'offset': offset})
    anchors.stop_gradient = True
    var.stop_gradient = True
    return anchors, var


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0,
             loc_loss_weight=1.0, conf_loss_weight=1.0, normalize=True,
             name=None):
    """(reference detection.py:563) SSD multibox loss: bipartite +
    per-prediction matching, hard negative mining at neg_pos_ratio,
    smooth-l1 localization + softmax confidence losses, normalized by
    the matched count. Static-shape contract: gt_box [B, G, 4] and
    gt_label [B, G] padded with label -1 (the LoD gt lists of the
    reference become fixed-G padded batches). Returns [B, 1]."""
    helper = LayerHelper('ssd_loss', name=name)
    out = helper.create_variable_for_type_inference('float32')
    inputs = {'Location': [location], 'Confidence': [confidence],
              'GtBox': [gt_box], 'GtLabel': [gt_label],
              'PriorBox': [prior_box]}
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = [prior_box_var]
    helper.append_op(type='ssd_loss', inputs=inputs,
                     outputs={'Loss': [out]},
                     attrs={'background_label': background_label,
                            'overlap_threshold': overlap_threshold,
                            'neg_pos_ratio': neg_pos_ratio,
                            'loc_loss_weight': loc_loss_weight,
                            'conf_loss_weight': conf_loss_weight,
                            'normalize': normalize})
    return out


def _roi_layer(op_type, input, rois, pooled_height, pooled_width,
               spatial_scale, sampling_ratio, rois_batch_idx, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {'X': [input], 'ROIs': [rois]}
    if rois_batch_idx is not None:
        inputs['RoisBatchIdx'] = [rois_batch_idx]
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={'Out': [out]},
                     attrs={'pooled_height': pooled_height,
                            'pooled_width': pooled_width,
                            'spatial_scale': spatial_scale,
                            'sampling_ratio': sampling_ratio})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1,
              rois_batch_idx=None, name=None):
    """(reference roi_align_op) Bilinear region features [R, C, ph, pw].
    rois: [R, 4] in input-image coordinates; rois_batch_idx: [R] image
    index per roi (the reference's LoD roi batching, made explicit)."""
    return _roi_layer('roi_align', input, rois, pooled_height,
                      pooled_width, spatial_scale, sampling_ratio,
                      rois_batch_idx, name)


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_batch_idx=None, name=None):
    """(reference roi_pool_op) Max-pooled region features."""
    return _roi_layer('roi_pool', input, rois, pooled_height,
                      pooled_width, spatial_scale, 1, rois_batch_idx,
                      name)


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, name=None):
    """(reference generate_proposals_op; fluid API default
    nms_thresh=0.5) RPN proposals: decode the per-anchor deltas (clamped
    at log(1000/16) like the reference), clip to the image, drop boxes
    smaller than min_size * im_info scale, NMS, keep post_nms_top_n.
    `scores` must be post-sigmoid probabilities in [0, 1]. Static shape:
    ([N, post_n, 4], [N, post_n], counts)."""
    helper = LayerHelper('generate_proposals', name=name)
    rois = helper.create_variable_for_type_inference('float32')
    probs = helper.create_variable_for_type_inference('float32')
    num = helper.create_variable_for_type_inference('int32')
    helper.append_op(
        type='generate_proposals',
        inputs={'Scores': [scores], 'BboxDeltas': [bbox_deltas],
                'ImInfo': [im_info], 'Anchors': [anchors],
                'Variances': [variances]},
        outputs={'RpnRois': [rois], 'RpnRoiProbs': [probs],
                 'RpnRoisNum': [num]},
        attrs={'pre_nms_topN': pre_nms_top_n,
               'post_nms_topN': post_nms_top_n,
               'nms_thresh': nms_thresh, 'min_size': min_size})
    for v in (rois, probs, num):
        v.stop_gradient = True
    return rois, probs, num


def rpn_target_assign(anchor_box, gt_boxes, gt_valid=None,
                      rpn_batch_size_per_im=256, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, name=None):
    """(reference rpn_target_assign_op) Label anchors fg(1)/bg(0)/
    ignore(-1) by IoU against the gts and randomly subsample a fixed
    minibatch; returns (labels [N, M], target_boxes [N, M, 4])."""
    helper = LayerHelper('rpn_target_assign', name=name)
    labels = helper.create_variable_for_type_inference('int32')
    tgt = helper.create_variable_for_type_inference('float32')
    inputs = {'Anchor': [anchor_box], 'GtBoxes': [gt_boxes]}
    if gt_valid is not None:
        inputs['GtValid'] = [gt_valid]
    helper.append_op(
        type='rpn_target_assign', inputs=inputs,
        outputs={'Labels': [labels], 'TargetBBox': [tgt]},
        attrs={'rpn_batch_size_per_im': rpn_batch_size_per_im,
               'rpn_fg_fraction': rpn_fg_fraction,
               'rpn_positive_overlap': rpn_positive_overlap,
               'rpn_negative_overlap': rpn_negative_overlap})
    labels.stop_gradient = True
    tgt.stop_gradient = True
    return labels, tgt


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version='integral'):
    """Per-batch mAP (reference layers/detection.py detection_map ->
    detection_map_op; the cross-batch accumulator state lives in
    metrics-side averaging here, see ops/detection_ops.py)."""
    helper = LayerHelper('detection_map')
    m = helper.create_variable_for_type_inference('float32')
    helper.append_op(type='detection_map',
                     inputs={'DetectRes': [detect_res], 'Label': [label]},
                     outputs={'MAP': [m]},
                     attrs={'class_num': class_num,
                            'overlap_threshold': overlap_threshold,
                            'ap_type': ap_version,
                            'background_label': background_label,
                            'evaluate_difficult': evaluate_difficult})
    return m


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """SSD detection head over multiple feature maps (reference
    layers/detection.py multi_box_head): per-map 3x3/1x1 convs predict
    box offsets and class scores per prior; prior_box generates the
    anchor grid per map; everything concatenates into
    (mbox_locs [N, P, 4], mbox_confs [N, P, C], boxes [P, 4],
    variances [P, 4])."""
    from .nn import conv2d, transpose, reshape
    from .tensor import concat

    n_maps = len(inputs)
    if min_sizes is None:
        # the reference's ratio interpolation (detection.py multi_box_head)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_maps - 2)) if n_maps > 2 \
            else 0
        min_sizes.append(base_size * 0.1)
        max_sizes.append(base_size * 0.2)
        ratio = min_ratio
        for _ in range(n_maps - 1):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
            ratio += step
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i],
                                            (list, tuple)) \
            else [aspect_ratios[i]]
        step_pair = (steps[i] if steps else
                     (step_w[i] if step_w else 0.0,
                      step_h[i] if step_h else 0.0))
        if not isinstance(step_pair, (list, tuple)):
            step_pair = (step_pair, step_pair)
        boxes, var = prior_box(
            feat, image,
            min_sizes=mins if isinstance(mins, (list, tuple)) else [mins],
            max_sizes=(maxs if isinstance(maxs, (list, tuple))
                       else [maxs]) if maxs else None,
            aspect_ratios=ar, variance=variance, flip=flip, clip=clip,
            steps=step_pair, offset=offset)
        # prior_box emits [H, W, P, 4]; P = priors per cell
        p_cell = boxes.shape[2]
        loc = conv2d(feat, num_filters=p_cell * 4,
                     filter_size=kernel_size, padding=pad, stride=stride)
        conf = conv2d(feat, num_filters=p_cell * num_classes,
                      filter_size=kernel_size, padding=pad, stride=stride)
        # NCHW -> [N, H*W*P, 4 / C]
        loc = transpose(loc, perm=[0, 2, 3, 1])
        conf = transpose(conf, perm=[0, 2, 3, 1])
        locs.append(reshape(loc, shape=[0, -1, 4]))
        confs.append(reshape(conf, shape=[0, -1, num_classes]))
        boxes_all.append(reshape(boxes, shape=[-1, 4]))
        vars_all.append(reshape(var, shape=[-1, 4]))
    mbox_locs = concat(locs, axis=1) if len(locs) > 1 else locs[0]
    mbox_confs = concat(confs, axis=1) if len(confs) > 1 else confs[0]
    box = concat(boxes_all, axis=0) if len(boxes_all) > 1 else boxes_all[0]
    var = concat(vars_all, axis=0) if len(vars_all) > 1 else vars_all[0]
    box.stop_gradient = True
    var.stop_gradient = True
    return mbox_locs, mbox_confs, box, var
