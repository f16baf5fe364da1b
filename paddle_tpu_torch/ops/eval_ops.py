"""Evaluation ops (counterpart of paddle_tpu/ops/eval_ops.py):
chunk_eval (:80-137), auc (:140-204), precision_recall (:207-292) and
positive_negative_pair (:295-381).

- chunk_eval is a host op by design, as in the JAX package: the chunk
  state machine (_get_segments, copied) walks each tag sequence in turn.
  On the card it is a host step between captured segments: it reads its
  inputs back to the host and puts its six [1] outputs on the device.
- auc, precision_recall and positive_negative_pair are device ops. auc
  and precision_recall add the batch's counts to persistable state
  (TP/FP/TN/FN, StatesInfo) that they write out of place under the same
  name; on the card the captured graph copies each write back into the
  scope's tensor (executor.rebound_persistables), so the state builds
  up under replay exactly as op by op. Their counts are sums of 0/1
  (or weights) in fp32, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..registry import register_op

_SCHEMES = {
    # scheme -> (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    'plain': (1, -1, -1, -1, 0),
    'IOB': (2, 0, 1, -1, -1),
    'IOE': (2, -1, 0, 1, -1),
    'IOBES': (4, 0, 1, 2, 3),
}


def _get_segments(tags, scheme, num_chunk_types, excluded):
    """(begin, end, type) chunks of one tag sequence: upstream Fluid's
    GetSegments state machine (chunk_eval_op.h:41-80)."""
    num_tag, t_begin, t_inside, t_end, t_single = _SCHEMES[scheme]
    other = num_chunk_types

    def chunk_end(prev_tag, prev_type, tag, type_):
        if prev_type == other:
            return False
        if type_ == other:
            return True
        if type_ != prev_type:
            return True
        if prev_tag == t_begin or prev_tag == t_inside:
            return tag == t_begin or tag == t_single
        if prev_tag == t_end or prev_tag == t_single:
            return True
        return False

    def chunk_begin(prev_tag, prev_type, tag, type_):
        if prev_type == other:
            return type_ != other
        if type_ == other:
            return False
        if type_ != prev_type:
            return True
        if tag == t_begin or tag == t_single:
            return True
        if tag == t_inside or tag == t_end:
            return prev_tag in (t_end, t_single)
        return False

    segments = []
    in_chunk = False
    chunk_start = 0
    tag, type_ = -1, other
    for i, label in enumerate(tags):
        prev_tag, prev_type = tag, type_
        if label == num_chunk_types * num_tag:
            tag, type_ = -1, other
        else:
            tag = label % num_tag
            type_ = label // num_tag
        if in_chunk and chunk_end(prev_tag, prev_type, tag, type_):
            if prev_type not in excluded:
                segments.append((chunk_start, i - 1, prev_type))
            in_chunk = False
        if chunk_begin(prev_tag, prev_type, tag, type_):
            chunk_start = i
            in_chunk = True
    if in_chunk and type_ not in excluded:
        segments.append((chunk_start, len(tags) - 1, type_))
    return segments


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)


def _chunk_eval_emit(ctx, op):
    inference = _host(ctx.get(op.single_input('Inference')))
    label = _host(ctx.get(op.single_input('Label')))
    if inference.ndim == 3:
        inference = inference[:, :, 0]
    if label.ndim == 3:
        label = label[:, :, 0]
    B, T = inference.shape
    if op.input('SeqLens'):
        lens = _host(ctx.get(op.single_input('SeqLens'))).reshape(-1)
    else:
        lens = np.full((B,), T, np.int64)
    scheme = op.attr('chunk_scheme', 'IOB')
    num_chunk_types = int(op.attr('num_chunk_types'))
    excluded = set(op.attr('excluded_chunk_types', []) or [])
    num_infer = num_label = num_correct = 0
    for b in range(B):
        n = int(lens[b])
        infer_segs = _get_segments(inference[b, :n].tolist(), scheme,
                                   num_chunk_types, excluded)
        label_segs = set(_get_segments(label[b, :n].tolist(), scheme,
                                       num_chunk_types, excluded))
        num_infer += len(infer_segs)
        num_label += len(label_segs)
        num_correct += sum(1 for s in infer_segs if s in label_segs)
    precision = num_correct / num_infer if num_infer else 0.0
    recall = num_correct / num_label if num_label else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if num_correct else 0.0)
    for slot, value, dtype in (
            ('Precision', precision, torch.float32),
            ('Recall', recall, torch.float32),
            ('F1-Score', f1, torch.float32),
            ('NumInferChunks', num_infer, torch.int64),
            ('NumLabelChunks', num_label, torch.int64),
            ('NumCorrectChunks', num_correct, torch.int64)):
        if op.output(slot):
            ctx.set(op.single_output(slot),
                    torch.tensor([value], dtype=dtype, device=ctx.device))


def _chunk_eval_infer(op, block):
    for slot, dtype in (('Precision', 'float32'), ('Recall', 'float32'),
                        ('F1-Score', 'float32'),
                        ('NumInferChunks', 'int64'),
                        ('NumLabelChunks', 'int64'),
                        ('NumCorrectChunks', 'int64')):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = (1,)
            v.dtype = dtype


register_op('chunk_eval', emit=_chunk_eval_emit,
            infer_shape=_chunk_eval_infer, host=True, no_grad=True)


def _state(ctx, op, slot):
    return ctx.get(op.single_input(slot)).reshape(-1) if op.input(slot) \
        else None


def _auc_emit(ctx, op):
    """Streaming AUC over num_thresholds buckets: each score's bucket
    int(p * n) (clipped), the positives and negatives at or above each
    bucket added to the TP/FP/FN/TN state, and the trapezoid under the
    ROC (or PR) curve."""
    probs = ctx.get(op.single_input('Predict'))
    labels = ctx.get(op.single_input('Label')).reshape(-1)
    num_t = int(op.attr('num_thresholds', 200))
    pos_prob = probs[:, -1] if probs.ndim == 2 else probs.reshape(-1)
    pos = (labels > 0).to(torch.float32)
    idx = torch.clamp((pos_prob * num_t).to(torch.int32), 0, num_t - 1)
    onehot = (idx[:, None] == torch.arange(
        num_t, device=idx.device)[None, :]).to(torch.float32)
    pos_hist = torch.sum(onehot * pos[:, None], 0)
    neg_hist = torch.sum(onehot * (1.0 - pos)[:, None], 0)
    ge = torch.flip(torch.cumsum(torch.flip(pos_hist, [0]), 0), [0])
    ge_n = torch.flip(torch.cumsum(torch.flip(neg_hist, [0]), 0), [0])
    counts = {'TP': ge, 'FP': ge_n, 'FN': torch.sum(pos_hist) - ge,
              'TN': torch.sum(neg_hist) - ge_n}
    for slot in counts:
        prev = _state(ctx, op, slot)
        if prev is not None:
            counts[slot] = counts[slot] + prev
    tp, fp, fn, tn = (counts[s] for s in ('TP', 'FP', 'FN', 'TN'))
    eps = 1e-6
    if op.attr('curve', 'ROC') == 'PR':
        x = tp / torch.clamp(tp + fn, min=eps)
        y = tp / torch.clamp(tp + fp, min=eps)
    else:
        x = fp / torch.clamp(fp + tn, min=eps)
        y = tp / torch.clamp(tp + fn, min=eps)
    auc_val = torch.sum((x[:-1] - x[1:]) * (y[:-1] + y[1:]) * 0.5)
    ctx.set(op.single_output('AUC'), auc_val.reshape(1).to(torch.float32))
    for slot, val in (('TPOut', tp), ('FPOut', fp), ('TNOut', tn),
                      ('FNOut', fn)):
        if op.output(slot):
            ctx.set(op.single_output(slot), val.to(torch.float32))


def _auc_infer(op, block):
    num_t = int(op.attr('num_thresholds', 200))
    a = block.var_recursive(op.single_output('AUC'))
    a.shape = (1,)
    a.dtype = 'float32'
    for slot in ('TPOut', 'FPOut', 'TNOut', 'FNOut'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = (num_t,)
            v.dtype = 'float32'


register_op('auc', emit=_auc_emit, infer_shape=_auc_infer, no_grad=True)


def _pr_metrics(states):
    """[macro P, R, F1, micro P, R, F1] of a [classes, 4] TP/FP/TN/FN
    table; an empty denominator gives 1.0 (precision_recall_op.h:102)."""
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]

    def ratio(a, b):
        return torch.where(a + b > 0, a / torch.clamp(a + b, min=1e-30),
                           torch.ones_like(a))

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r,
                                                               min=1e-30),
                           torch.zeros_like(p))
    macro_p, macro_r = torch.mean(ratio(tp, fp)), torch.mean(ratio(tp, fn))
    micro_p = ratio(torch.sum(tp), torch.sum(fp))
    micro_r = ratio(torch.sum(tp), torch.sum(fn))
    return torch.stack([macro_p, macro_r, f1(macro_p, macro_r),
                        micro_p, micro_r, f1(micro_p, micro_r)])


def _precision_recall_emit(ctx, op):
    """Per-class TP/FP/TN/FN of the batch (one-hot sums), added to
    StatesInfo; macro and micro P/R/F1 of the batch and of the sum. An
    id or label outside [0, class_number) makes every metric NaN, as in
    the JAX package (a device op cannot raise on data)."""
    ids = ctx.get(op.single_input('Indices')).reshape(-1)
    labels = ctx.get(op.single_input('Labels')).reshape(-1)
    cls_num = int(op.attr('class_number'))
    if op.input('Weights'):
        w = ctx.get(op.single_input('Weights')).reshape(-1).to(torch.float32)
    else:
        w = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    in_range = (torch.all((ids >= 0) & (ids < cls_num)) &
                torch.all((labels >= 0) & (labels < cls_num)))
    poison = torch.where(in_range, 0.0, float('nan')).to(torch.float32)
    classes = torch.arange(cls_num, device=ids.device)[None, :]
    idx_oh = (ids[:, None] == classes).to(torch.float32)
    lab_oh = (labels[:, None] == classes).to(torch.float32)
    correct = (ids == labels).to(torch.float32)
    wrong = 1.0 - correct
    tp = torch.sum((w * correct)[:, None] * idx_oh, 0)
    fp = torch.sum((w * wrong)[:, None] * idx_oh, 0)
    fn = torch.sum((w * wrong)[:, None] * lab_oh, 0)
    tn = torch.sum(w[:, None] * (1.0 - idx_oh - wrong[:, None] * lab_oh), 0)
    batch_states = torch.stack([tp, fp, tn, fn], 1)
    ctx.set(op.single_output('BatchMetrics'),
            _pr_metrics(batch_states) + poison)
    accum = batch_states + poison
    if op.input('StatesInfo'):
        accum = accum + ctx.get(op.single_input('StatesInfo')).to(
            torch.float32)
    ctx.set(op.single_output('AccumMetrics'), _pr_metrics(accum) + poison)
    ctx.set(op.single_output('AccumStatesInfo'), accum)


def _precision_recall_infer(op, block):
    cls_num = int(op.attr('class_number'))
    for slot, shape in (('BatchMetrics', (6,)), ('AccumMetrics', (6,)),
                        ('AccumStatesInfo', (cls_num, 4))):
        v = block.var_recursive(op.single_output(slot))
        v.shape = shape
        v.dtype = 'float32'


register_op('precision_recall', emit=_precision_recall_emit,
            infer_shape=_precision_recall_infer, no_grad=True)


def _positive_negative_pair_emit(ctx, op):
    """For every pair of one query with different labels, weighted by the
    mean of their weights: concordant pairs (positive), the rest
    (negative, score ties included, as upstream counts them) and score
    ties (neutral). Rows in blocks of 256 against all rows, summed in
    the JAX package's order."""
    score = ctx.get(op.single_input('Score'))
    label = ctx.get(op.single_input('Label')).reshape(-1).to(torch.float32)
    query = ctx.get(op.single_input('QueryID')).reshape(-1)
    column = int(op.attr('column', 0))
    s = (score[:, column] if score.ndim == 2
         else score.reshape(-1)).to(torch.float32)
    B = s.shape[0]
    if op.input('Weight'):
        w = ctx.get(op.single_input('Weight')).reshape(-1).to(torch.float32)
    else:
        w = torch.ones((B,), dtype=torch.float32, device=s.device)
    blk = min(B, 256)
    gidx = torch.arange(B, device=s.device)
    pos = neg = neu = torch.zeros((), dtype=torch.float32, device=s.device)
    for start in range(0, B, blk):
        stop = min(start + blk, B)
        si, li, qi, wi = s[start:stop], label[start:stop], \
            query[start:stop], w[start:stop]
        ii = gidx[start:stop]
        valid = ((qi[:, None] == query[None, :]) &
                 (li[:, None] != label[None, :]) &
                 (ii[:, None] < gidx[None, :]))
        prod = (si[:, None] - s[None, :]) * (li[:, None] - label[None, :])
        vw = 0.5 * (wi[:, None] + w[None, :]) * valid.to(torch.float32)
        pos = pos + torch.sum(vw * (prod > 0))
        neg = neg + torch.sum(vw * (prod <= 0))
        neu = neu + torch.sum(vw * (si[:, None] == s[None, :]))
    if op.input('AccumulatePositivePair'):
        pos = pos + ctx.get(op.single_input('AccumulatePositivePair')) \
            .reshape(())
        neg = neg + ctx.get(op.single_input('AccumulateNegativePair')) \
            .reshape(())
        neu = neu + ctx.get(op.single_input('AccumulateNeutralPair')) \
            .reshape(())
    for slot, val in (('PositivePair', pos), ('NegativePair', neg),
                      ('NeutralPair', neu)):
        ctx.set(op.single_output(slot), val.reshape(1).to(torch.float32))


def _positive_negative_pair_infer(op, block):
    for slot in ('PositivePair', 'NegativePair', 'NeutralPair'):
        v = block.var_recursive(op.single_output(slot))
        v.shape = (1,)
        v.dtype = 'float32'


register_op('positive_negative_pair', emit=_positive_negative_pair_emit,
            infer_shape=_positive_negative_pair_infer, no_grad=True)
