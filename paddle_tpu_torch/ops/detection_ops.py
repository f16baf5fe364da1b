"""Detection ops (counterpart of paddle_tpu/ops/detection_ops.py:
iou_similarity :30, prior_box :70-148, box_coder :151-208,
multiclass_nms :211-306, bipartite_match :309-386, target_assign :389,
anchor_generator :425-470, ssd_loss :473-568, roi_align / roi_pool
:571-697, generate_proposals :700-790, rpn_target_assign :793-868,
polygon_box_transform :871, mine_hard_examples :889-950,
detection_map :953-1051).

Every op keeps the JAX package's static shapes: multiclass_nms gives
[B, keep_top_k, 6] padded with label -1 and a valid count, the gt lists
are padded batches (label -1), generate_proposals gives post_nms_topN
rows. No op reads a value back to the host, so a segment of them
captures. Where the JAX package breaks ties by index, so does the port:

- sorts are stable (torch.sort(stable=True)): multiclass_nms's final
  order, ssd_loss's and mine_hard_examples' mining, detection_map's
  ranking; generate_proposals' top-k is a stable descending sort, the
  lower index first as lax.top_k takes it;
- an argmax takes the first maximum (torch.argmax, as jnp.argmax): NMS's
  winner, bipartite_match's greedy rounds.

NMS runs its nms_top_k rounds as a loop of a few batched ops over every
(image, class); each round computes the winner's IoU row, by the same
formula as the full [N, N] matrix the JAX package builds (at SSD300's
8732 priors, batch 8 and 21 classes that matrix would take 51 GB).
prior_box and anchor_generator build their grid on the host once, on
the op's first run at a shape, and keep it on the device (a copy from
the host on every run would break the capture).

Gradients come from recorded forwards (iou_similarity X and Y,
box_coder TargetBox, ssd_loss Location and Confidence, roi_align and
roi_pool X). None of their backwards scatters with atomics: ssd_loss
gathers by advanced indexing (its backward is index_put_ with
accumulate, which sums in one order), roi_align is two products with
interpolation weights (a matmul each way), and roi_pool reads each
bin's maximum by advanced indexing at its argmax. roi_pool's argmax is
the first maximum of the bin in row-major order, found with a sparse
table of window maxima over the map; its grad goes to that one cell
(the JAX package's max spreads a tie's grad evenly).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..registry import (register_op, op_emitter, register_vjp_grad,
                        same_shape_infer)


# -- iou_similarity -------------------------------------------------------------

def _iou(a, b, normalized=True):
    """IoU of boxes a [..., 4] and b [..., 4], broadcast: the JAX
    package's _iou_matrix, element by element."""
    off = 0.0 if normalized else 1.0
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + off,
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + off,
                     min=0.0)
    inter = iw * ih
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                       torch.zeros_like(union))


def _iou_matrix(a, b, normalized=True):
    """a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    return _iou(a.unsqueeze(-2), b.unsqueeze(-3), normalized)


@op_emitter('iou_similarity')
def _iou_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            _iou_matrix(ctx.get(op.single_input('X')),
                        ctx.get(op.single_input('Y')),
                        op.attr('box_normalized', True)))


def _iou_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_input('Y'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [x.shape[0], y.shape[0]]
    out.dtype = x.dtype


register_op('iou_similarity', infer_shape=_iou_infer)
register_vjp_grad('iou_similarity', in_slots=('X', 'Y'))


# -- prior_box, anchor_generator: grids built once per shape ---------------------

def _prior_box_np(h, w, img_h, img_w, min_sizes, max_sizes, aspect_ratios,
                  flip, step_h, step_w, offset, clip):
    """The prior lattice [h, w, P, 4] (the JAX package's)."""
    ratios = list(aspect_ratios)
    if flip:
        ratios += [1.0 / r for r in aspect_ratios if r != 1.0]
    whs = []
    for ms in min_sizes:
        whs.append((ms, ms))
        for r in ratios:
            if r == 1.0:
                continue
            whs.append((ms * np.sqrt(r), ms / np.sqrt(r)))
    for Ms, ms in zip(max_sizes or [], min_sizes):
        whs.append((np.sqrt(ms * Ms), np.sqrt(ms * Ms)))
    sh = step_h or img_h / h
    sw = step_w or img_w / w
    cy = (np.arange(h) + offset) * sh
    cx = (np.arange(w) + offset) * sw
    cxg, cyg = np.meshgrid(cx, cy)
    boxes = np.zeros((h, w, len(whs), 4), np.float32)
    for k, (bw, bh) in enumerate(whs):
        boxes[:, :, k, 0] = (cxg - bw / 2.) / img_w
        boxes[:, :, k, 1] = (cyg - bh / 2.) / img_h
        boxes[:, :, k, 2] = (cxg + bw / 2.) / img_w
        boxes[:, :, k, 3] = (cyg + bh / 2.) / img_h
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    return boxes


def _anchors_np(h, w, sizes, ratios, stride, offset):
    """The anchors [h, w, A, 4] in pixels (the JAX package's)."""
    whs = []
    for r in ratios:
        for s in sizes:
            bw = np.sqrt(s * s / r)
            whs.append((bw, bw * r))
    cx = (np.arange(w) + offset) * stride[0]
    cy = (np.arange(h) + offset) * stride[1]
    cxg, cyg = np.meshgrid(cx, cy)
    out = np.zeros((h, w, len(whs), 4), np.float32)
    for k, (bw, bh) in enumerate(whs):
        out[:, :, k] = np.stack([cxg - bw / 2., cyg - bh / 2.,
                                 cxg + bw / 2., cyg + bh / 2.], -1)
    return out


def _device_constant(ctx, op, key, make):
    """make()'s numpy arrays as tensors on the context's device, built on
    the op's first run with this key and kept on the op."""
    kept = op.__dict__.setdefault('_device_constants', {})
    key = key + (str(ctx.device),)
    if key not in kept:
        kept[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            ctx.device) for a in make())
    return kept[key]


def _variances(op, shape):
    return np.tile(np.asarray(op.attr('variances', [0.1, 0.1, 0.2, 0.2]),
                              np.float32), shape[:3] + (1,))


@op_emitter('prior_box')
def _prior_box_emit(ctx, op):
    feat = ctx.get(op.single_input('Input'))
    img = ctx.get(op.single_input('Image'))
    attrs = (tuple(op.attr('min_sizes')), tuple(op.attr('max_sizes', [])),
             tuple(op.attr('aspect_ratios', [1.0])), op.attr('flip', False),
             op.attr('step_h', 0.0), op.attr('step_w', 0.0),
             op.attr('offset', 0.5), op.attr('clip', False),
             tuple(op.attr('variances', [0.1, 0.1, 0.2, 0.2])))
    h, w, img_h, img_w = (feat.shape[2], feat.shape[3], img.shape[2],
                          img.shape[3])

    def make():
        boxes = _prior_box_np(h, w, img_h, img_w, list(attrs[0]),
                              list(attrs[1]), list(attrs[2]), *attrs[3:8])
        return boxes, _variances(op, boxes.shape)
    boxes, var = _device_constant(ctx, op, (h, w, img_h, img_w) + attrs,
                                  make)
    ctx.set(op.single_output('Boxes'), boxes)
    ctx.set(op.single_output('Variances'), var)


def _num_priors(op):
    ratios = list(op.attr('aspect_ratios', [1.0]))
    if op.attr('flip', False):
        ratios += [1.0 / r for r in op.attr('aspect_ratios', [1.0])
                   if r != 1.0]
    n = 0
    for _ in op.attr('min_sizes'):
        n += 1 + sum(1 for r in ratios if r != 1.0)
    n += len(op.attr('max_sizes', []) or [])
    return n


def _prior_box_infer(op, block):
    feat = block.var_recursive(op.single_input('Input'))
    n = _num_priors(op)
    for slot in ('Boxes', 'Variances'):
        v = block.var_recursive(op.single_output(slot))
        v.shape = [feat.shape[2], feat.shape[3], n, 4]
        v.dtype = 'float32'


register_op('prior_box', infer_shape=_prior_box_infer)


@op_emitter('anchor_generator')
def _anchor_generator_emit(ctx, op):
    feat = ctx.get(op.single_input('Input'))
    attrs = (tuple(op.attr('anchor_sizes')), tuple(op.attr('aspect_ratios')),
             tuple(op.attr('stride')), op.attr('offset', 0.5),
             tuple(op.attr('variances', [0.1, 0.1, 0.2, 0.2])))
    h, w = feat.shape[2], feat.shape[3]

    def make():
        anchors = _anchors_np(h, w, list(attrs[0]), list(attrs[1]),
                              list(attrs[2]), attrs[3])
        return anchors, _variances(op, anchors.shape)
    anchors, var = _device_constant(ctx, op, (h, w) + attrs, make)
    ctx.set(op.single_output('Anchors'), anchors)
    ctx.set(op.single_output('Variances'), var)


def _anchor_generator_infer(op, block):
    feat = block.var_recursive(op.single_input('Input'))
    n = len(op.attr('anchor_sizes')) * len(op.attr('aspect_ratios'))
    for slot in ('Anchors', 'Variances'):
        v = block.var_recursive(op.single_output(slot))
        v.shape = [feat.shape[2], feat.shape[3], n, 4]
        v.dtype = 'float32'


register_op('anchor_generator', infer_shape=_anchor_generator_infer)


# -- box_coder -------------------------------------------------------------------

def _center_size(boxes, off):
    w = boxes[:, 2] - boxes[:, 0] + off
    h = boxes[:, 3] - boxes[:, 1] + off
    return w, h, boxes[:, 0] + w * 0.5, boxes[:, 1] + h * 0.5


@op_emitter('box_coder')
def _box_coder_emit(ctx, op):
    prior = ctx.get(op.single_input('PriorBox')).reshape(-1, 4)
    pvar = (ctx.get(op.single_input('PriorBoxVar')).reshape(-1, 4)
            if op.input('PriorBoxVar') else torch.ones_like(prior))
    target = ctx.get(op.single_input('TargetBox'))
    off = 0.0 if op.attr('box_normalized', True) else 1.0
    pw, ph, pcx, pcy = _center_size(prior, off)
    if op.attr('code_type', 'encode_center_size') == 'encode_center_size':
        # target [N, 4] ground truths -> [N, M, 4] offsets from M priors
        tw, th, tcx, tcy = _center_size(target, off)
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :] / pvar[None, :, 0],
            (tcy[:, None] - pcy[None, :]) / ph[None, :] / pvar[None, :, 1],
            torch.log(tw[:, None] / pw[None, :]) / pvar[None, :, 2],
            torch.log(th[:, None] / ph[None, :]) / pvar[None, :, 3],
        ], dim=-1)
    else:
        # decode_center_size: target [N, M, 4] deltas -> boxes
        dcx = target[..., 0] * pvar[None, :, 0] * pw[None, :] + pcx[None, :]
        dcy = target[..., 1] * pvar[None, :, 1] * ph[None, :] + pcy[None, :]
        dw = torch.exp(target[..., 2] * pvar[None, :, 2]) * pw[None, :]
        dh = torch.exp(target[..., 3] * pvar[None, :, 3]) * ph[None, :]
        out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                           dcx + dw * 0.5 - off, dcy + dh * 0.5 - off],
                          dim=-1)
    ctx.set(op.single_output('OutputBox'), out)


def _box_coder_infer(op, block):
    t = block.var_recursive(op.single_input('TargetBox'))
    p = block.var_recursive(op.single_input('PriorBox'))
    out = block.var_recursive(op.single_output('OutputBox'))
    out.shape = [t.shape[0], int(np.prod(p.shape)) // 4, 4]
    out.dtype = t.dtype


register_op('box_coder', infer_shape=_box_coder_infer)
register_vjp_grad('box_coder', in_slots=('TargetBox',),
                  out_slots=('OutputBox',),
                  nondiff_slots=('PriorBox', 'PriorBoxVar'))


# -- NMS: a static number of masked-argmax rounds ---------------------------------

def nms(boxes, scores, score_threshold, nms_threshold, top_k, normalized):
    """Greedy NMS of each of the K score rows of an image over its boxes:
    boxes [B, N, 4], scores [B, K, N] (K classes, or 1). Returns (scores
    [B, K, top_k], indices [B, K, top_k] int64); an empty slot holds
    score -1 and index -1. Each round takes the first maximum of the
    alive scores, then drops it and every box whose IoU with it is at
    least nms_threshold (the JAX package's _nms_single_class; the
    winner's IoU row by _iou's formula, the boxes' side computed once)."""
    B, K, N = scores.shape
    off = 0.0 if normalized else 1.0
    bx1, by1, bx2, by2 = (t.unsqueeze(1) for t in boxes.unbind(-1))
    area_b = (bx2 - bx1 + off) * (by2 - by1 + off)             # [B, 1, N]
    neg = torch.full_like(scores, -1.0)
    alive = scores >= score_threshold
    scores = torch.where(alive, scores, neg)
    cols = torch.arange(N, device=scores.device)
    out_s, out_i = [], []
    for _ in range(top_k):
        masked = torch.where(alive, scores, neg)
        best = torch.argmax(masked, dim=2, keepdim=True)        # [B, K, 1]
        best_score = masked.gather(2, best)
        take = best_score > -1.0
        out_s.append(torch.where(take, best_score, -1.0))
        out_i.append(torch.where(take, best, -1))
        w = boxes.gather(1, best.reshape(B, K, 1).expand(B, K, 4))
        ax1, ay1, ax2, ay2 = (t.unsqueeze(-1) for t in w.unbind(-1))
        area_a = (ax2 - ax1 + off) * (ay2 - ay1 + off)         # [B, K, 1]
        iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)
                         + off, min=0.0)
        ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1)
                         + off, min=0.0)
        inter = iw * ih
        union = area_a + area_b - inter
        iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-10),
                          0.0)
        suppress = (iou >= nms_threshold) | (cols == best)
        alive = alive & ~(suppress & take)
    return torch.cat(out_s, 2), torch.cat(out_i, 2)


@op_emitter('multiclass_nms')
def _multiclass_nms_emit(ctx, op):
    boxes = ctx.get(op.single_input('BBoxes'))    # [B, N, 4]
    scores = ctx.get(op.single_input('Scores'))   # [B, C, N]
    top_k = op.attr('nms_top_k', 64)
    keep_top_k = op.attr('keep_top_k', 16)
    background = op.attr('background_label', 0)
    B, C, N = scores.shape
    bg = background if 0 <= background < C else None
    # the background class's rows end as -1 slots whatever NMS keeps, so
    # its rounds are not run
    sc = scores if bg is None else torch.cat([scores[:, :bg],
                                              scores[:, bg + 1:]], 1)
    ks, ki = nms(boxes, sc, op.attr('score_threshold', 0.0),
                 op.attr('nms_threshold', 0.3), top_k,
                 op.attr('normalized', True))
    if bg is not None:
        ks = torch.cat([ks[:, :bg], ks.new_full((B, 1, top_k), -1.0),
                        ks[:, bg:]], 1)
        ki = torch.cat([ki[:, :bg], ki.new_full((B, 1, top_k), -1),
                        ki[:, bg:]], 1)
    labels = torch.arange(C, device=scores.device).view(C, 1).expand(
        C, top_k).reshape(1, C * top_k).expand(B, C * top_k)
    flat_s = ks.reshape(B, C * top_k)
    flat_i = ki.reshape(B, C * top_k)
    if C * top_k < keep_top_k:
        # keep Out's static [keep_top_k] rows: pad with empty slots
        pad = keep_top_k - C * top_k
        flat_s = torch.cat([flat_s, flat_s.new_full((B, pad), -1.0)], 1)
        flat_i = torch.cat([flat_i, flat_i.new_full((B, pad), -1)], 1)
        labels = torch.cat([labels, labels.new_full((B, pad), -1)], 1)
    order = torch.sort(-flat_s, dim=1, stable=True)[1][:, :keep_top_k]
    sel_s = flat_s.gather(1, order)
    kept = sel_s > -1.0
    sel_l = torch.where(kept, labels.gather(1, order), -1)
    idx = torch.clamp(flat_i.gather(1, order), min=0)
    sel_b = boxes.gather(1, idx.unsqueeze(-1).expand(B, keep_top_k, 4))
    sel_b = torch.where(kept.unsqueeze(-1), sel_b, -1.0)
    out = torch.cat([sel_l.unsqueeze(-1).to(boxes.dtype),
                     sel_s.unsqueeze(-1), sel_b], dim=2)
    ctx.set(op.single_output('Out'), out)
    if op.output('ValidCount'):
        ctx.set(op.single_output('ValidCount'),
                kept.sum(1).to(torch.int32))


def _nms_infer(op, block):
    b = block.var_recursive(op.single_input('BBoxes'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [b.shape[0], op.attr('keep_top_k', 16), 6]
    out.dtype = b.dtype
    if op.output('ValidCount'):
        v = block.var_recursive(op.single_output('ValidCount'))
        v.shape = [b.shape[0]]
        v.dtype = 'int32'


register_op('multiclass_nms', infer_shape=_nms_infer)


# -- bipartite_match, target_assign ------------------------------------------------

_MATCH_NEG = -1e9


def _bipartite_match(dist):
    """dist [B, N, M] (N ground truths x M priors) -> (col_to_row [B, M]
    int32, col_dist [B, M]); unmatched columns -1 / 0. N greedy rounds
    each take the first global maximum, then retire its row and
    column."""
    B, N, M = dist.shape
    d = dist.float()
    rows = torch.arange(N, device=d.device).view(1, N, 1)
    cols = torch.arange(M, device=d.device).view(1, 1, M)
    c2r = torch.full((B, M), -1, dtype=torch.int32, device=d.device)
    cdist = torch.zeros((B, M), dtype=dist.dtype, device=d.device)
    for _ in range(N):
        flat = torch.argmax(d.reshape(B, N * M), dim=1)
        r, c = flat // M, flat % M
        best = d.reshape(B, N * M).gather(1, flat[:, None])[:, 0]
        take = best > _MATCH_NEG / 2
        hit = (cols[0] == c[:, None]) & take[:, None]           # [B, M]
        c2r = torch.where(hit, r[:, None].to(torch.int32), c2r)
        cdist = torch.where(hit, best[:, None].to(cdist.dtype), cdist)
        retire = ((rows == r.view(B, 1, 1)) | (cols == c.view(B, 1, 1))) \
            & take.view(B, 1, 1)
        d = torch.where(retire, _MATCH_NEG, d)
    return c2r, cdist


def _per_prediction_topup(d, c2r, cdist, thresh):
    """Columns still unmatched take their first-maximum row where it
    reaches the threshold (SSD's per-prediction matching)."""
    best_val, best_row = torch.max(d, dim=1)
    extra = (c2r < 0) & (best_val >= thresh)
    return (torch.where(extra, best_row.to(torch.int32), c2r),
            torch.where(extra, best_val.to(cdist.dtype), cdist))


@op_emitter('bipartite_match')
def _bipartite_match_emit(ctx, op):
    dist = ctx.get(op.single_input('DistMat'))     # [B, N, M] or [N, M]
    batched = dist.ndim == 3
    d3 = dist if batched else dist[None]
    c2r, cdist = _bipartite_match(d3)
    if op.attr('match_type', 'bipartite') == 'per_prediction':
        c2r, cdist = _per_prediction_topup(d3, c2r, cdist,
                                           op.attr('dist_threshold', 0.5))
    if not batched:
        c2r, cdist = c2r[0], cdist[0]
    ctx.set(op.single_output('ColToRowMatchIndices'), c2r)
    ctx.set(op.single_output('ColToRowMatchDist'), cdist)


def _bipartite_infer(op, block):
    d = block.var_recursive(op.single_input('DistMat'))
    shape = [d.shape[0], d.shape[-1]] if len(d.shape) == 3 \
        else [d.shape[-1]]
    idx = block.var_recursive(op.single_output('ColToRowMatchIndices'))
    idx.shape = shape
    idx.dtype = 'int32'
    dv = block.var_recursive(op.single_output('ColToRowMatchDist'))
    dv.shape = shape
    dv.dtype = d.dtype


register_op('bipartite_match', infer_shape=_bipartite_infer, no_grad=True)


@op_emitter('target_assign')
def _target_assign_emit(ctx, op):
    x = ctx.get(op.single_input('X'))                   # [B, N, K]
    match = ctx.get(op.single_input('MatchIndices'))    # [B, M]
    safe = torch.clamp(match, min=0).long()
    gathered = x.gather(1, safe.unsqueeze(-1).expand(
        safe.shape + (x.shape[-1],)))
    matched = (match >= 0).unsqueeze(-1)
    out = torch.where(matched, gathered, torch.full_like(
        gathered, op.attr('mismatch_value', 0)))
    ctx.set(op.single_output('Out'), out)
    ctx.set(op.single_output('OutWeight'), matched.to(torch.float32))


def _target_assign_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    m = block.var_recursive(op.single_input('MatchIndices'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [m.shape[0], m.shape[1], x.shape[-1]]
    out.dtype = x.dtype
    w = block.var_recursive(op.single_output('OutWeight'))
    w.shape = [m.shape[0], m.shape[1], 1]
    w.dtype = 'float32'


register_op('target_assign', infer_shape=_target_assign_infer, no_grad=True)


# -- ssd_loss ------------------------------------------------------------------

def _rank_of(order):
    """The inverse permutation of each row of `order` (a stable sort's
    indices): rank[i] is where i landed."""
    return torch.argsort(order, dim=1)


@op_emitter('ssd_loss')
def _ssd_loss_emit(ctx, op):
    loc = ctx.get(op.single_input('Location'))        # [B, M, 4]
    conf = ctx.get(op.single_input('Confidence'))     # [B, M, C]
    gt_box = ctx.get(op.single_input('GtBox'))        # [B, G, 4]
    gt_label = ctx.get(op.single_input('GtLabel'))    # [B, G] (-1 pad)
    prior = ctx.get(op.single_input('PriorBox')).reshape(-1, 4)
    pvar = (ctx.get(op.single_input('PriorBoxVar')).reshape(-1, 4)
            if op.input('PriorBoxVar') else torch.ones_like(prior))
    background = op.attr('background_label', 0)
    B, M = loc.shape[0], prior.shape[0]
    gt_label = gt_label.reshape(gt_label.shape[0], -1)
    dev = loc.device

    pw, ph, pcx, pcy = _center_size(prior, 0.0)
    with torch.no_grad():
        # matching: padded gt rows take the match sentinel, so they never
        # win a round (-1 would, and turn padding into positives)
        valid_gt = gt_label >= 0
        iou = _iou_matrix(gt_box, prior.expand(B, M, 4))          # [B, G, M]
        iou = torch.where(valid_gt.unsqueeze(-1), iou, _MATCH_NEG)
        c2r, cdist = _bipartite_match(iou)
        c2r, _ = _per_prediction_topup(iou, c2r, cdist,
                                       op.attr('overlap_threshold', 0.5))
        matched = c2r >= 0
        safe = torch.clamp(c2r, min=0).long()
        tgt_label = torch.where(matched, gt_label.gather(1, safe),
                                background).long()
    b_idx = torch.arange(B, device=dev).view(B, 1).expand(B, M)
    m_idx = torch.arange(M, device=dev).view(1, M).expand(B, M)
    logp = torch.log_softmax(conf.float(), dim=-1)
    # advanced indexing: its backward sums with index_put_ in one order
    ce = -logp[b_idx, m_idx, tgt_label]                          # [B, M]
    with torch.no_grad():
        # hard negative mining: the neg_pos_ratio x npos negatives of
        # largest CE (a stable sort: equal CEs in index order)
        npos = matched.sum(1)
        n_neg = torch.minimum(
            (op.attr('neg_pos_ratio', 3.0) * npos.float()).to(torch.int64),
            M - npos)
        neg_ce = torch.where(matched, -math.inf, ce)
        order = torch.sort(-neg_ce, dim=1, stable=True)[1]
        neg_keep = ~matched & (_rank_of(order) < n_neg[:, None])
    conf_loss = torch.where(matched | neg_keep, ce, 0.0).sum(1)

    g = gt_box[b_idx, safe]                                      # [B, M, 4]
    gw = g[..., 2] - g[..., 0]
    gh = g[..., 3] - g[..., 1]
    gcx = g[..., 0] + gw * 0.5
    gcy = g[..., 1] + gh * 0.5
    eps = 1e-8
    pwc, phc = torch.clamp(pw, min=eps), torch.clamp(ph, min=eps)
    tgt = torch.stack([
        (gcx - pcx) / pwc / pvar[:, 0],
        (gcy - pcy) / phc / pvar[:, 1],
        torch.log(torch.clamp(gw, min=eps) / pwc) / pvar[:, 2],
        torch.log(torch.clamp(gh, min=eps) / phc) / pvar[:, 3]], dim=-1)
    d = loc.float() - tgt
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)
    loc_loss = torch.where(matched, sl1, 0.0).sum(1)

    total = op.attr('loc_loss_weight', 1.0) * loc_loss + \
        op.attr('conf_loss_weight', 1.0) * conf_loss
    if op.attr('normalize', True):
        total = total / torch.clamp(npos.float(), min=1.0)
    ctx.set(op.single_output('Loss'), total.unsqueeze(1))


def _ssd_loss_infer(op, block):
    loc = block.var_recursive(op.single_input('Location'))
    out = block.var_recursive(op.single_output('Loss'))
    out.shape = [loc.shape[0], 1]
    out.dtype = 'float32'


register_op('ssd_loss', infer_shape=_ssd_loss_infer)
register_vjp_grad('ssd_loss', in_slots=('Location', 'Confidence'),
                  out_slots=('Loss',),
                  nondiff_slots=('GtBox', 'GtLabel', 'PriorBox',
                                 'PriorBoxVar'))


# -- roi_align, roi_pool ----------------------------------------------------------

def _roi_batch_idx(ctx, op, rois):
    if op.input('RoisBatchIdx'):
        return ctx.get(op.single_input('RoisBatchIdx')).reshape(-1).long()
    return torch.zeros((rois.shape[0],), dtype=torch.int64,
                       device=rois.device)


def _axis_weights(lo, hi, pooled, samples, size):
    """roi_align's interpolation along one axis: [R, pooled, size] weights
    whose row p averages the bilinear weights of the bin's `samples`
    sample points (the JAX package's _roi_grid and _bilinear: a point in
    [-1, size] clamps to the edge cell, one beyond it weighs 0)."""
    bin_len = torch.clamp(hi - lo, min=1e-3) / pooled
    i = torch.arange(pooled * samples, device=lo.device)
    pts = lo[:, None] + (i + 0.5) * bin_len[:, None] / samples  # [R, P*S]
    out = (pts < -1.0) | (pts > size)
    pts = torch.clamp(pts, 0.0, size - 1.0)
    p0 = torch.floor(pts)
    w1 = pts - p0
    p0 = p0.long()
    p1 = torch.clamp(p0 + 1, max=size - 1)
    cells = torch.arange(size, device=lo.device)
    w = ((p0[..., None] == cells) * (1 - w1)[..., None] +
         (p1[..., None] == cells) * w1[..., None])
    w = torch.where(out[..., None], 0.0, w)
    return w.reshape(-1, pooled, samples, size).mean(2)


# rois a roi_align product takes at once: bounds its [C, rois*ph, W]
# intermediate (at Faster R-CNN's C4 map, 1024 x 50 x 84, 1.2 MB a roi)
_ALIGN_ELEMENTS = 1 << 28


def _roi_align(x, rois, bidx, ph, pw, scale, samples):
    """[R, C, ph, pw]: out[r] = Wy[r] @ x[bidx[r]] @ Wx[r]^T with the
    axes' averaged interpolation weights. The products take the grad to
    x with no scatter."""
    N, C, H, W = x.shape
    feat = x.float()
    x1, y1, x2, y2 = (rois[:, k] * scale - 0.5 for k in range(4))
    wy = _axis_weights(y1, y2, ph, samples, H)          # [R, ph, H]
    wx = _axis_weights(x1, x2, pw, samples, W)          # [R, pw, W]
    R = rois.shape[0]
    step = max(1, _ALIGN_ELEMENTS // max(1, C * ph * W))
    parts = []
    for s in range(0, R, step):
        wy_c, wx_c = wy[s:s + step], wx[s:s + step]
        r = wy_c.shape[0]
        out = None
        for n in range(N):
            # [C, r*ph, W] = Wy (as [r*ph, H]) @ x[n] ([C, H, W]), then
            # one product a roi: [C*ph, W] @ Wx[r]^T
            t = torch.matmul(wy_c.reshape(r * ph, H), feat[n])
            t = t.reshape(C, r, ph, W).transpose(0, 1).reshape(r, C * ph, W)
            o = torch.bmm(t, wx_c.transpose(1, 2)).reshape(r, C, ph, pw)
            if N == 1:
                out = o
            else:
                hit = (bidx[s:s + step] == n).view(r, 1, 1, 1)
                out = torch.where(hit, o, 0.0 if out is None else out)
        parts.append(out)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _window_max_table(v):
    """Sparse table of window maxima over v [N, H, W, C]: level (ky, kx)
    holds, for each cell, the maximum over the 2^ky x 2^kx window it
    starts and the first position (y * W + x, row-major) holding it.
    Windows past the map's edge are never read."""
    N, H, W, C = v.shape
    ly, lx = H.bit_length(), W.bit_length()
    vals = v.new_empty((ly, lx, N, H, W, C))
    idxs = torch.empty((ly, lx, N, H, W, C), dtype=torch.int32,
                       device=v.device)
    vals[0, 0] = v
    idxs[0, 0] = torch.arange(H * W, device=v.device,
                              dtype=torch.int32).view(1, H, W, 1)

    def level(dst, src, axis, k):
        # dst = combine(src, src shifted by k along axis); the last k
        # entries keep src's own (never read)
        sv, si = vals[src], idxs[src]
        n = sv.shape[axis] - k
        a, ia = sv.narrow(axis, 0, n), si.narrow(axis, 0, n)
        b, ib = sv.narrow(axis, k, n), si.narrow(axis, k, n)
        vals[dst].narrow(axis, 0, n).copy_(torch.maximum(a, b))
        idxs[dst].narrow(axis, 0, n).copy_(torch.where(
            a > b, ia, torch.where(b > a, ib, torch.minimum(ia, ib))))
        vals[dst].narrow(axis, n, k).copy_(sv.narrow(axis, n, k))
        idxs[dst].narrow(axis, n, k).copy_(si.narrow(axis, n, k))
    for ky in range(ly):
        if ky:
            level((ky, 0), (ky - 1, 0), 1, 1 << (ky - 1))
        for kx in range(1, lx):
            level((ky, kx), (ky, kx - 1), 2, 1 << (kx - 1))
    return vals, idxs


def _floor_log2(n, levels):
    """floor(log2(n)) of positive integers n, by comparisons."""
    k = torch.zeros_like(n)
    for j in range(1, levels):
        k = k + (n >= (1 << j)).to(n.dtype)
    return k


def _roi_pool(x, rois, bidx, ph, pw, scale):
    """[R, C, ph, pw]: each bin's exact maximum over its integer cells
    (cell y in bin i iff floor(start_i) <= y < ceil(end_i), the JAX
    package's rule); an empty bin gives 0. The maximum is read from x by
    advanced indexing at its first row-major position, so the grad goes
    to that cell."""
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    with torch.no_grad():
        xl = x.detach().float().permute(0, 2, 3, 1)         # [N, H, W, C]
        vals, idxs = _window_max_table(xl)
        ly, lx = vals.shape[0], vals.shape[1]
        x1, y1, x2, y2 = (rois[:, k] * scale for k in range(4))
        rw = torch.clamp(x2 - x1, min=1.0)
        rh = torch.clamp(y2 - y1, min=1.0)
        by = y1[:, None] + rh[:, None] / ph * torch.arange(ph + 1,
                                                           device=dev)
        bx = x1[:, None] + rw[:, None] / pw * torch.arange(pw + 1,
                                                           device=dev)
        ys = torch.clamp(torch.floor(by[:, :-1]), 0, H).long()  # [R, ph]
        ye = torch.clamp(torch.ceil(by[:, 1:]), 0, H).long()
        xs = torch.clamp(torch.floor(bx[:, :-1]), 0, W).long()  # [R, pw]
        xe = torch.clamp(torch.ceil(bx[:, 1:]), 0, W).long()
        empty = ((ye <= ys)[:, :, None] | (xe <= xs)[:, None, :])
        ky = _floor_log2(torch.clamp(ye - ys, min=1), ly)
        kx = _floor_log2(torch.clamp(xe - xs, min=1), lx)
        y_a = torch.clamp(ys, max=H - 1)
        y_b = torch.clamp(ye - (1 << ky), min=0)
        x_a = torch.clamp(xs, max=W - 1)
        x_b = torch.clamp(xe - (1 << kx), min=0)
        b = bidx.view(R, 1, 1)
        kyv, kxv = ky.view(R, ph, 1), kx.view(R, 1, pw)
        best_v = best_i = None
        for yy in (y_a, y_b):
            for xx in (x_a, x_b):
                v = vals[kyv, kxv, b, yy.view(R, ph, 1), xx.view(R, 1, pw)]
                i = idxs[kyv, kxv, b, yy.view(R, ph, 1), xx.view(R, 1, pw)]
                if best_v is None:
                    best_v, best_i = v, i
                else:
                    best_i = torch.where(
                        v > best_v, i, torch.where(
                            best_v > v, best_i, torch.minimum(best_i, i)))
                    best_v = torch.maximum(best_v, v)
        # [R, ph, pw, C] -> a flat index into x's [N, C, H*W] layout
        chan = torch.arange(C, device=dev).view(1, 1, 1, C)
        flat = (b.unsqueeze(-1) * C + chan) * (H * W) + best_i.long()
    out = x.reshape(-1)[flat]
    out = torch.where(empty.unsqueeze(-1), 0.0, out.float())
    return out.permute(0, 3, 1, 2)


def _roi_emit(ctx, op, mode):
    x = ctx.get(op.single_input('X'))            # [N, C, H, W]
    rois = ctx.get(op.single_input('ROIs'))      # [R, 4]
    bidx = _roi_batch_idx(ctx, op, rois)
    ph, pw = op.attr('pooled_height'), op.attr('pooled_width')
    scale = op.attr('spatial_scale', 1.0)
    if mode == 'align':
        # the JAX package fixes sampling_ratio -1 / 0 (adaptive upstream)
        # at 2 x 2 a bin: a static count
        out = _roi_align(x, rois.float(), bidx, ph, pw, scale,
                         max(op.attr('sampling_ratio', 2), 2))
    else:
        out = _roi_pool(x, rois.float(), bidx, ph, pw, scale)
    ctx.set(op.single_output('Out'), out.to(x.dtype))


@op_emitter('roi_align')
def _roi_align_emit(ctx, op):
    _roi_emit(ctx, op, 'align')


@op_emitter('roi_pool')
def _roi_pool_emit(ctx, op):
    _roi_emit(ctx, op, 'pool')


def _roi_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    rois = block.var_recursive(op.single_input('ROIs'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [rois.shape[0], x.shape[1],
                 op.attr('pooled_height'), op.attr('pooled_width')]
    out.dtype = x.dtype


register_op('roi_align', infer_shape=_roi_infer)
register_vjp_grad('roi_align', in_slots=('X',),
                  nondiff_slots=('ROIs', 'RoisBatchIdx'))
register_op('roi_pool', infer_shape=_roi_infer)
register_vjp_grad('roi_pool', in_slots=('X',),
                  nondiff_slots=('ROIs', 'RoisBatchIdx'))


# -- generate_proposals ----------------------------------------------------------

@op_emitter('generate_proposals')
def _generate_proposals_emit(ctx, op):
    # Scores are probabilities in [0, 1] (post-sigmoid): the sentinels
    # live below 0
    scores = ctx.get(op.single_input('Scores'))       # [N, A, H, W]
    deltas = ctx.get(op.single_input('BboxDeltas'))   # [N, 4A, H, W]
    im_info = ctx.get(op.single_input('ImInfo'))      # [N, 3] (h, w, scale)
    anchors = ctx.get(op.single_input('Anchors')).reshape(-1, 4)
    variances = ctx.get(op.single_input('Variances')).reshape(-1, 4)
    N, A, H, W = scores.shape
    M = A * H * W
    pre_n = min(op.attr('pre_nms_topN', 6000), M)
    post_n = op.attr('post_nms_topN', 1000)
    s = scores.permute(0, 2, 3, 1).reshape(N, M)                  # HWA
    d = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(
        N, M, 4)
    # a stable descending sort: the lower index first among equal
    # scores, as lax.top_k
    top_s, top_i = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :pre_n], top_i[:, :pre_n]
    d = d.gather(1, top_i.unsqueeze(-1).expand(N, pre_n, 4))
    a = anchors[top_i]                                            # [N, P, 4]
    v = variances[top_i]
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    acx = a[..., 0] + aw * 0.5
    acy = a[..., 1] + ah * 0.5
    dcx = d[..., 0] * v[..., 0] * aw + acx
    dcy = d[..., 1] * v[..., 1] * ah + acy
    # clamped at log(1000/16) as upstream: an untrained head's deltas
    # would overflow exp
    clip_v = float(np.log(1000.0 / 16.0))
    dw = torch.exp(torch.clamp(d[..., 2] * v[..., 2], max=clip_v)) * aw
    dh = torch.exp(torch.clamp(d[..., 3] * v[..., 3], max=clip_v)) * ah
    boxes = torch.stack([dcx - dw / 2, dcy - dh / 2,
                         dcx + dw / 2, dcy + dh / 2], -1)
    hi = torch.stack([im_info[:, 1], im_info[:, 0],
                      im_info[:, 1], im_info[:, 0]], -1).unsqueeze(1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi)
    ms = (op.attr('min_size', 0.0) * im_info[:, 2]).unsqueeze(1)
    keep = ((boxes[..., 2] - boxes[..., 0]) >= ms) & \
        ((boxes[..., 3] - boxes[..., 1]) >= ms)
    ks, ki = nms(boxes, torch.where(keep, top_s, -1.0).unsqueeze(1), -0.5,
                 op.attr('nms_thresh', 0.7), post_n, True)
    ks, ki = ks[:, 0], ki[:, 0]
    out_boxes = boxes.gather(1, torch.clamp(ki, min=0).unsqueeze(-1).expand(
        N, post_n, 4))
    kept = ks > -1.0
    ctx.set(op.single_output('RpnRois'),
            torch.where(kept.unsqueeze(-1), out_boxes, 0.0))
    ctx.set(op.single_output('RpnRoiProbs'), torch.clamp(ks, min=0.0))
    if op.output('RpnRoisNum'):
        ctx.set(op.single_output('RpnRoisNum'), kept.sum(1).to(torch.int32))


def _generate_proposals_infer(op, block):
    s = block.var_recursive(op.single_input('Scores'))
    post_n = op.attr('post_nms_topN', 1000)
    rois = block.var_recursive(op.single_output('RpnRois'))
    rois.shape = [s.shape[0], post_n, 4]
    rois.dtype = 'float32'
    probs = block.var_recursive(op.single_output('RpnRoiProbs'))
    probs.shape = [s.shape[0], post_n]
    probs.dtype = 'float32'
    if op.output('RpnRoisNum'):
        n = block.var_recursive(op.single_output('RpnRoisNum'))
        n.shape = [s.shape[0]]
        n.dtype = 'int32'


register_op('generate_proposals', infer_shape=_generate_proposals_infer,
            no_grad=True)


# -- rpn_target_assign: labels drawn from the executor's generator ---------------

def _ranks(keys):
    """Each element's place in a stable ascending sort of its row."""
    return _rank_of(torch.sort(keys, dim=1, stable=True)[1])


@op_emitter('rpn_target_assign', stateful=True)
def _rpn_target_assign_emit(ctx, op):
    """Anchors labelled fg (1) where their best IoU reaches
    rpn_positive_overlap or they are a gt's best anchor, bg (0) below
    rpn_negative_overlap, then subsampled to rpn_batch_size_per_im with
    at most rpn_fg_fraction fg; the rest -1. The subsample ranks uniform
    noise from the executor's generator (the JAX package draws from
    jax.random), so the two pick other anchors by the same rule."""
    anchors = ctx.get(op.single_input('Anchor')).reshape(-1, 4)
    gt_boxes = ctx.get(op.single_input('GtBoxes'))    # [N, G, 4]
    N, G = gt_boxes.shape[:2]
    M = anchors.shape[0]
    valid = (ctx.get(op.single_input('GtValid')) if op.input('GtValid')
             else torch.ones((N, G), device=gt_boxes.device))
    batch_per_im = op.attr('rpn_batch_size_per_im', 256)
    n_fg = int(batch_per_im * op.attr('rpn_fg_fraction', 0.5))
    iou = _iou_matrix(gt_boxes, anchors.expand(N, M, 4))         # [N, G, M]
    iou = torch.where(valid.unsqueeze(-1) > 0, iou, _MATCH_NEG)
    best_iou, best_gt = torch.max(iou, dim=1)                    # [N, M]
    gt_best_val, gt_best_anchor = torch.max(iou, dim=2)          # [N, G]
    cols = torch.arange(M, device=iou.device)
    is_best = ((gt_best_anchor.unsqueeze(-1) == cols) &
               (gt_best_val > 0).unsqueeze(-1)).any(1)
    fg = (best_iou >= op.attr('rpn_positive_overlap', 0.7)) | is_best
    # anchors with no valid gt's overlap (an object-free image's) are bg
    bg = (best_iou < op.attr('rpn_negative_overlap', 0.3)) & ~fg
    gen = ctx.generator(op)
    noise = torch.rand((2, N, M), generator=gen, device=iou.device)
    two = torch.full_like(noise[0], 2.0)
    fg_keep = fg & (_ranks(torch.where(fg, noise[0], two)) < n_fg)
    n_bg = batch_per_im - fg_keep.sum(1, keepdim=True)
    bg_keep = bg & (_ranks(torch.where(bg, noise[1], two)) < n_bg)
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1))
    tgt = gt_boxes.gather(1, best_gt.unsqueeze(-1).expand(N, M, 4))
    ctx.set(op.single_output('Labels'), labels.to(torch.int32))
    ctx.set(op.single_output('TargetBBox'), tgt)


def _rpn_target_assign_infer(op, block):
    a = block.var_recursive(op.single_input('Anchor'))
    g = block.var_recursive(op.single_input('GtBoxes'))
    M = int(np.prod(a.shape)) // 4
    lab = block.var_recursive(op.single_output('Labels'))
    lab.shape = [g.shape[0], M]
    lab.dtype = 'int32'
    t = block.var_recursive(op.single_output('TargetBBox'))
    t.shape = [g.shape[0], M, 4]
    t.dtype = 'float32'


register_op('rpn_target_assign', infer_shape=_rpn_target_assign_infer,
            no_grad=True)


# -- polygon_box_transform -----------------------------------------------------------

@op_emitter('polygon_box_transform')
def _polygon_box_transform_emit(ctx, op):
    """Even geometry channels become w_index - value, odd ones h_index -
    value (EAST's quad decoding)."""
    x = ctx.get(op.single_input('Input'))        # [N, G, H, W]
    _, g, h, w = x.shape
    wi = torch.arange(w, dtype=x.dtype, device=x.device).view(1, 1, 1, w)
    hi = torch.arange(h, dtype=x.dtype, device=x.device).view(1, 1, h, 1)
    even = (torch.arange(g, device=x.device) % 2 == 0).view(1, g, 1, 1)
    ctx.set(op.single_output('Output'), torch.where(even, wi - x, hi - x))


register_op('polygon_box_transform',
            infer_shape=same_shape_infer('Input', 'Output'), no_grad=True)


# -- mine_hard_examples --------------------------------------------------------------

@op_emitter('mine_hard_examples')
def _mine_hard_examples_emit(ctx, op):
    """Static-shape OHEM: a [B, P] 0/1 mask of the mined negatives (the
    hardest first, equal losses in index order) and UpdatedMatchIndices
    with the unmined negatives at -2 (the JAX package's contract)."""
    loss = ctx.get(op.single_input('ClsLoss'))                 # [B, P]
    match = ctx.get(op.single_input('MatchIndices'))           # [B, P]
    if op.input('LocLoss'):
        loss = loss + ctx.get(op.single_input('LocLoss'))
    is_neg = match < 0
    if op.input('MatchDist'):
        is_neg = is_neg & (ctx.get(op.single_input('MatchDist')) <
                           op.attr('neg_dist_threshold', 0.5))
    num_pos = (match >= 0).sum(1)
    sample_size = op.attr('sample_size', 0)
    if op.attr('mining_type', 'max_negative') == 'hard_example' and \
            sample_size:
        budget = torch.full_like(num_pos, int(sample_size))
    else:
        budget = (num_pos.float() * op.attr('neg_pos_ratio', 3.0)).long()
    neg_loss = torch.where(is_neg, loss, -math.inf)
    order = torch.sort(-neg_loss, dim=1, stable=True)[1]
    selected = (_rank_of(order) < budget[:, None]) & is_neg
    ctx.set(op.single_output('NegMask'), selected.to(torch.int32))
    if op.output('UpdatedMatchIndices'):
        ctx.set(op.single_output('UpdatedMatchIndices'),
                torch.where((match < 0) & ~selected, -2, match).to(
                    match.dtype))


def _mine_hard_examples_infer(op, block):
    cls = block.var_recursive(op.single_input('ClsLoss'))
    m = block.var_recursive(op.single_output('NegMask'))
    m.shape = cls.shape
    m.dtype = 'int32'
    if op.output('UpdatedMatchIndices'):
        u = block.var_recursive(op.single_output('UpdatedMatchIndices'))
        u.shape = cls.shape
        u.dtype = 'int32'


register_op('mine_hard_examples', infer_shape=_mine_hard_examples_infer,
            no_grad=True)


# -- detection_map -----------------------------------------------------------------

@op_emitter('detection_map')
def _detection_map_emit(ctx, op):
    """mAP of one batch of padded detections [B, K, 6] (label, score,
    box) against padded gts [B, M, 5 or 6], every class at once (the JAX
    package vmaps over classes): a detection is a TP where its best
    same-class IoU reaches overlap_threshold and no higher-scored
    detection took that gt; the ranked list is a stable sort by score;
    AP is '11point' or 'integral'. Stateless: the JAX package's metrics
    average across batches."""
    det = ctx.get(op.single_input('DetectRes'))
    gt = ctx.get(op.single_input('Label'))
    class_num = int(op.attr('class_num'))
    thr = op.attr('overlap_threshold', 0.5)
    background = op.attr('background_label', 0)
    evaluate_difficult = op.attr('evaluate_difficult', True)
    dev = det.device
    B, K, _ = det.shape
    M = gt.shape[1]
    det_label = det[:, :, 0].to(torch.int32)
    det_score = det[:, :, 1]
    det_valid = det_label >= 0
    gt_label = gt[:, :, 0].to(torch.int32)
    if gt.shape[2] == 6:
        gt_difficult = gt[:, :, 1] > 0
        gt_box = gt[:, :, 2:6]
    else:
        gt_difficult = torch.zeros(gt.shape[:2], dtype=torch.bool,
                                   device=dev)
        gt_box = gt[:, :, 1:5]
    gt_valid = torch.abs(gt_box).sum(2) > 0
    gt_counted = gt_valid & (evaluate_difficult | ~gt_difficult)
    iou = _iou_matrix(det[:, :, 2:6], gt_box)                   # [B, K, M]
    cls = torch.arange(class_num, dtype=torch.int32, device=dev)
    if 0 <= background < class_num:
        cls = torch.cat([cls[:background], cls[background + 1:]])
    Q = cls.shape[0]
    c = cls.view(Q, 1, 1)
    d_mask = det_valid & (det_label == c)                       # [Q, B, K]
    g_mask = gt_valid & (gt_label == c)                         # [Q, B, M]
    g_counted = gt_counted & (gt_label == c)
    npos = g_counted.sum((1, 2))                                # [Q]
    iou_c = torch.where(g_mask.unsqueeze(2), iou, 0.0)          # [Q, B, K, M]
    best_iou = torch.clamp(iou_c.amax(3), min=0.0)
    best_gt = torch.argmax(iou_c, dim=3)                        # [Q, B, K]
    cand_tp = d_mask & (best_iou >= thr)
    matched_ignored = cand_tp & ~g_counted.gather(2, best_gt)
    d_mask = d_mask & ~matched_ignored
    cand_tp = cand_tp & ~matched_ignored
    neg_inf = -math.inf
    score_masked = torch.where(cand_tp, det_score, neg_inf)     # [Q, B, K]
    onehot = (best_gt.unsqueeze(-1) == torch.arange(M, device=dev)) & \
        cand_tp.unsqueeze(-1)                                   # [Q, B, K, M]
    best_per_gt = torch.where(onehot, score_masked.unsqueeze(-1),
                              neg_inf).amax(2)                  # [Q, B, M]
    is_tp = cand_tp & (score_masked >=
                       best_per_gt.gather(2, best_gt) - 1e-12)
    is_fp = d_mask & ~is_tp
    flat_score = torch.where(d_mask, det_score, neg_inf).reshape(Q, B * K)
    order = torch.sort(-flat_score, dim=1, stable=True)[1]
    tp_sorted = is_tp.reshape(Q, B * K).gather(1, order).float()
    fp_sorted = is_fp.reshape(Q, B * K).gather(1, order).float()
    tp_cum = torch.cumsum(tp_sorted, 1)
    fp_cum = torch.cumsum(fp_sorted, 1)
    precision = tp_cum / torch.clamp(tp_cum + fp_cum, min=1e-12)
    recall = tp_cum / torch.clamp(npos.float(), min=1e-12).unsqueeze(1)
    in_list = (tp_sorted + fp_sorted) > 0
    if op.attr('ap_type', 'integral') == '11point':
        # jnp.linspace's points, i * 0.1 in fp32
        pts = torch.arange(11, dtype=torch.float32, device=dev) * \
            torch.full((), 0.1, dtype=torch.float32, device=dev)
        hit = in_list.unsqueeze(1) & (recall.unsqueeze(1) >=
                                      pts.view(1, 11, 1))
        pmax = torch.clamp(torch.where(hit, precision.unsqueeze(1),
                                       0.0).amax(2), min=0.0)
        ap = pmax.mean(1)
    else:
        prev = torch.cat([torch.zeros_like(recall[:, :1]), recall[:, :-1]],
                         1)
        ap = torch.where(in_list, precision * (recall - prev), 0.0).sum(1)
    has_gt = npos > 0
    aps = torch.where(has_gt, ap, 0.0)
    m_ap = aps.sum() / torch.clamp(has_gt.float().sum(), min=1.0)
    ctx.set(op.single_output('MAP'), m_ap.reshape(1))


def _detection_map_infer(op, block):
    out = block.var_recursive(op.single_output('MAP'))
    out.shape = (1,)
    out.dtype = 'float32'


register_op('detection_map', infer_shape=_detection_map_infer, no_grad=True)
