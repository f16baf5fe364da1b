"""Numpy-side metric accumulators (counterpart of paddle_tpu/metrics.py,
copied: it is numpy only): MetricBase, CompositeMetric, Precision,
Recall, Accuracy, ChunkEvaluator, EditDistance, Auc, DetectionMAP. Their
update() takes the numpy arrays an Executor's fetch returns."""
from __future__ import annotations

import numpy as np

__all__ = ['MetricBase', 'CompositeMetric', 'Precision', 'Recall', 'Accuracy',
           'ChunkEvaluator', 'EditDistance', 'Auc', 'DetectionMAP']


def _is_number_(v):
    return isinstance(v, (int, float)) or (
        isinstance(v, np.ndarray) and v.shape == (1,))


def _is_number_or_matrix_(v):
    return _is_number_(v) or isinstance(v, np.ndarray)


class MetricBase(object):
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith('_'):
                continue
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, dict):
                setattr(self, attr, {})

    def get_config(self):
        return {attr: value for attr, value in self.__dict__.items()
                if not attr.startswith('_')}

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise TypeError('expected MetricBase')
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype('int32').flatten()
        labels = np.asarray(labels).astype('int32').flatten()
        for p, l in zip(preds, labels):
            if p == 1:
                if l == 1:
                    self.tp += 1
                else:
                    self.fp += 1

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype('int32').flatten()
        labels = np.asarray(labels).astype('int32').flatten()
        for p, l in zip(preds, labels):
            if l == 1:
                if p == 1:
                    self.tp += 1
                else:
                    self.fn += 1

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    """Weighted running accuracy over batches (reference metrics.py Accuracy)."""

    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).flatten()[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError('accuracy has no data; call update first')
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (float(self.num_correct_chunks) / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (float(self.num_correct_chunks) / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError('no data in EditDistance')
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    def __init__(self, name=None, curve='ROC', num_thresholds=200):
        super(Auc, self).__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def reset(self):
        n = self._num_thresholds
        self.tp_list = np.zeros((n,))
        self.fn_list = np.zeros((n,))
        self.tn_list = np.zeros((n,))
        self.fp_list = np.zeros((n,))

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).flatten()
        kepsilon = 1e-7
        thresholds = [(i + 1) * 1.0 / (self._num_thresholds - 1)
                      for i in range(self._num_thresholds - 2)]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] >= 2 \
            else preds.flatten()
        for i, t in enumerate(thresholds):
            pred_pos = pos_prob >= t
            self.tp_list[i] += int(np.sum(pred_pos & (labels == 1)))
            self.fp_list[i] += int(np.sum(pred_pos & (labels == 0)))
            self.fn_list[i] += int(np.sum(~pred_pos & (labels == 1)))
            self.tn_list[i] += int(np.sum(~pred_pos & (labels == 0)))

    def eval(self):
        epsilon = 1e-6
        tpr = (self.tp_list.astype('float64')
               / (self.tp_list + self.fn_list + epsilon))
        fpr = (self.fp_list.astype('float64')
               / (self.fp_list + self.tn_list + epsilon))
        auc = 0.0
        for i in range(self._num_thresholds - 1):
            dx = fpr[i] - fpr[i + 1]
            y = (tpr[i] + tpr[i + 1]) / 2.0
            auc += dx * y
        return auc


class DetectionMAP(MetricBase):
    """Mean-average-precision accumulator (reference metrics.py
    DetectionMAP): update() takes the per-batch mAP value the
    detection_map op computed (plus the batch's image count as weight)
    and eval() returns the weighted mean. The reference carries the
    accumulation inside its op's AccumPosCount state; here the op is
    stateless per batch (ops/detection_ops.py) and the metric does the
    cross-batch averaging — evaluator.DetectionMAP wires both ends."""

    def __init__(self, name=None):
        super(DetectionMAP, self).__init__(name)
        self.total_map = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        if not _is_number_or_matrix_(value):
            raise ValueError(
                'The parameter value must be a number or a numpy ndarray.')
        if not _is_number_(weight):
            raise ValueError('The parameter weight must be a number.')
        self.total_map += float(np.asarray(value).sum()) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError(
                'There is no data in DetectionMAP Metrics. '
                'Please check layers.detection_map output has added to '
                'DetectionMAP.')
        return self.total_map / self.weight
