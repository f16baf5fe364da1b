"""Graph-state evaluators (counterpart of paddle_tpu/evaluator.py).

Each evaluator owns persistable state vars that accumulate across
mini-batches through ops appended to the main program (cast +
elementwise_add written back under the state's name, or the
precision_recall op's own StatesInfo). On the card those ops run inside
the step's captured graph, whose out-of-place writes of persistables
are copied back into the scope's tensors (executor.rebound_persistables),
so the states build up under replay as they do op by op. reset() zeroes
the states through a small reset program; eval() reads them from the
scope (back to the host).

metrics.py holds the numpy accumulators; these classes are the
graph-side API for scripts that use it.
"""
from __future__ import annotations

import numpy as np

from . import layers
from .executor import _to_numpy, global_scope
from .framework import Program, default_main_program, \
    default_startup_program, program_guard
from .initializer import Constant
from . import unique_name

__all__ = ['Accuracy', 'ChunkEvaluator', 'EditDistance', 'DetectionMAP',
           'PrecisionRecall', 'Evaluator']


class Evaluator(object):
    """Base: the state vars and the reset program."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper_name = unique_name.generate(name)

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                block = reset_program.global_block()
                # mirror the state var, then fill it with zeros
                reset_program.global_block().create_var(
                    name=var.name, shape=var.shape, dtype=var.dtype,
                    persistable=True)
                block.append_op(
                    type='fill_constant', inputs={},
                    outputs={'Out': [var.name]},
                    attrs={'shape': list(var.shape),
                           'dtype': var.dtype, 'value': 0.0})
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def _create_state(self, suffix, dtype, shape):
        var = default_main_program().global_block().create_var(
            name='_'.join([self.helper_name, suffix]),
            shape=list(shape), dtype=dtype, persistable=True)
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=var.name, shape=list(shape),
                                dtype=dtype, persistable=True)
        Constant(0.0)(sv, startup)
        self.states.append(var)
        return var

    def _accumulate(self, state, batch_value):
        """state += batch_value, written back to the persistable var."""
        block = default_main_program().global_block()
        cast = block.create_var(
            name=unique_name.generate(state.name + '_cast'),
            dtype=state.dtype)
        block.append_op(type='cast', inputs={'X': [batch_value.name]},
                        outputs={'Out': [cast.name]},
                        attrs={'out_dtype': state.dtype})
        block.append_op(type='elementwise_add',
                        inputs={'X': [state.name], 'Y': [cast.name]},
                        outputs={'Out': [state.name]},
                        attrs={'axis': -1})
        return state

    def _read_state(self, var):
        return np.asarray(_to_numpy(global_scope().find_var(var.name)))


class Accuracy(Evaluator):
    """Accumulated top-k accuracy: states = correct, total."""

    def __init__(self, input, label, k=1, **kwargs):
        super(Accuracy, self).__init__('accuracy', **kwargs)
        block = default_main_program().global_block()
        correct = block.create_var(
            name=unique_name.generate('acc_correct'), dtype='int32')
        total = block.create_var(
            name=unique_name.generate('acc_total'), dtype='int32')
        acc = layers.accuracy(input, label, k=k, correct=correct,
                              total=total)
        self.total_state = self._create_state('total', 'int64', (1,))
        self.correct_state = self._create_state('correct', 'int64', (1,))
        self._accumulate(self.total_state, total)
        self._accumulate(self.correct_state, correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        total = float(self._read_state(self.total_state).sum())
        correct = float(self._read_state(self.correct_state).sum())
        return np.array(correct / total if total else 0.0, 'float32')


class ChunkEvaluator(Evaluator):
    """Accumulated chunk P/R/F1: states = the infer, label and correct
    chunk counts."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super(ChunkEvaluator, self).__init__('chunk_eval', **kwargs)
        (precision, recall, f1, num_infer, num_label,
         num_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self.num_infer_chunks = self._create_state(
            'num_infer_chunks', 'int64', (1,))
        self.num_label_chunks = self._create_state(
            'num_label_chunks', 'int64', (1,))
        self.num_correct_chunks = self._create_state(
            'num_correct_chunks', 'int64', (1,))
        self._accumulate(self.num_infer_chunks, num_infer)
        self._accumulate(self.num_label_chunks, num_label)
        self._accumulate(self.num_correct_chunks, num_correct)
        self.metrics.extend((precision, recall, f1))

    def eval(self, executor, eval_program=None):
        num_infer = float(self._read_state(self.num_infer_chunks).sum())
        num_label = float(self._read_state(self.num_label_chunks).sum())
        num_correct = float(self._read_state(self.num_correct_chunks).sum())
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if num_correct else 0.0)
        return (np.float32(precision), np.float32(recall),
                np.float32(f1))


class PrecisionRecall(Evaluator):
    """Accumulated multi-class precision/recall/F1 through the
    precision_recall op: state = the [class_number, 4] TP/FP/TN/FN
    table, which the op reads and writes back each step."""

    def __init__(self, input, label, class_number, weights=None,
                 **kwargs):
        super(PrecisionRecall, self).__init__('precision_recall',
                                              **kwargs)
        self.states_info = self._create_state(
            'states_info', 'float32', (class_number, 4))
        batch_metrics, accum_metrics, _ = layers.precision_recall(
            input, label, class_number, weights=weights,
            states_info=self.states_info)
        self.accum_metrics = accum_metrics
        self.metrics.extend((batch_metrics, accum_metrics))

    def eval(self, executor, eval_program=None):
        """(macro_p, macro_r, macro_f1, micro_p, micro_r, micro_f1)
        from the accumulated states."""
        states = self._read_state(self.states_info)
        tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]

        def _p(t, f):
            return float(t / (t + f)) if (t + f) > 0 else 1.0

        prec = [_p(t, f) for t, f in zip(tp, fp)]
        rec = [_p(t, f) for t, f in zip(tp, fn)]
        macro_p = sum(prec) / len(prec)
        macro_r = sum(rec) / len(rec)
        micro_p = _p(tp.sum(), fp.sum())
        micro_r = _p(tp.sum(), fn.sum())

        def _f1(p, r):
            return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

        return np.asarray([macro_p, macro_r, _f1(macro_p, macro_r),
                           micro_p, micro_r, _f1(micro_p, micro_r)],
                          np.float32)


class EditDistance(Evaluator):
    """Accumulated average edit distance and instance error rate."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super(EditDistance, self).__init__('edit_distance', **kwargs)
        if ignored_tokens:
            # strip the ignored ids first (sequence_erase before the
            # distance op)
            input = layers.sequence_erase(input, ignored_tokens)
            label = layers.sequence_erase(label, ignored_tokens)
        distances, seq_num = layers.edit_distance(input, label)
        dist_sum = layers.reduce_sum(distances)
        # instance error = count of nonzero distances
        nz = layers.cast(layers.sign(distances), 'float32')
        err_sum = layers.reduce_sum(nz)
        self.total_distance = self._create_state(
            'total_distance', 'float32', (1,))
        self.seq_num = self._create_state('seq_num', 'int64', (1,))
        self.instance_error = self._create_state(
            'instance_error', 'float32', (1,))
        self._accumulate(self.total_distance, dist_sum)
        self._accumulate(self.seq_num, seq_num)
        self._accumulate(self.instance_error, err_sum)
        self.metrics.append(distances)

    def eval(self, executor, eval_program=None):
        total = float(self._read_state(self.total_distance).sum())
        n = float(self._read_state(self.seq_num).sum())
        errs = float(self._read_state(self.instance_error).sum())
        avg = total / n if n else 0.0
        err_rate = errs / n if n else 0.0
        return np.float32(avg), np.float32(err_rate)


class DetectionMAP(Evaluator):
    """Accumulated mean average precision: the per-batch mAP
    (ops/detection_ops.py detection_map) summed in a state with the
    batch count, and eval() their ratio (the mean over batches), as in
    the JAX package."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version='integral', **kwargs):
        super(DetectionMAP, self).__init__('detection_map', **kwargs)
        if gt_difficult is not None:
            label = layers.concat([layers.cast(gt_label, 'float32'),
                                   layers.cast(gt_difficult, 'float32'),
                                   gt_box], axis=-1)
        else:
            label = layers.concat([layers.cast(gt_label, 'float32'),
                                   gt_box], axis=-1)
        m = layers.detection_map(
            input, label, class_num, background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult,
            ap_version=ap_version)
        self.map_sum = self._create_state('map_sum', 'float32', (1,))
        self.batches = self._create_state('batches', 'int64', (1,))
        self._accumulate(self.map_sum, m)
        block = default_main_program().global_block()
        one = block.create_var(name=unique_name.generate('map_one'),
                               dtype='int64')
        block.append_op(type='fill_constant', inputs={},
                        outputs={'Out': [one.name]},
                        attrs={'shape': [1], 'dtype': 'int64',
                               'value': 1.0})
        self._accumulate(self.batches, block.var(one.name))
        self.metrics.append(m)
        self.cur_map = m

    def get_map_var(self):
        return self.cur_map

    def eval(self, executor, eval_program=None):
        s = float(self._read_state(self.map_sum).sum())
        n = float(self._read_state(self.batches).sum())
        return np.float32(s / n if n else 0.0)
