"""Optimizers: build per-param update ops into the program (counterpart
of paddle_tpu/optimizer.py: Optimizer :30, minimize :97, SGD :132,
Momentum :148). The other optimizers of the JAX package (Adam, Adagrad,
...) are not ported yet (ROADMAP.md, Queue 1).

The update ops are part of the same block as forward and backward; the
Executor runs them last, in place on the Scope's parameters
(ops/optimizer_ops.py).
"""
from __future__ import annotations

from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .framework import default_startup_program, Variable, program_guard
from .initializer import Constant
from .layer_helper import LayerHelper
from . import clip as clip_mod
from . import regularizer as regularizer_mod

__all__ = ['SGD', 'Momentum', 'Optimizer']


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError('learning_rate must be float or Variable')
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        # accumulators: {name: {param_name: var}}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self, program):
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr_name = unique_name.generate('learning_rate')
        lr_var = program.global_block().create_var(
            name=lr_name, shape=(1,), dtype='float32', persistable=True)
        self.helper.set_variable_initializer(
            lr_var, Constant(float(self._learning_rate)))
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program):
        return self._learning_rate_map[program]

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = param.optimize_attr.get('learning_rate', 1.0)
        lr = self._global_learning_rate(param.block.program)
        if param_lr == 1.0:
            return lr
        helper = LayerHelper('scale')
        out = helper.create_variable_for_type_inference(dtype=lr.dtype)
        helper.append_op(type='scale', inputs={'X': [lr]},
                         outputs={'Out': [out]},
                         attrs={'scale': float(param_lr), 'bias': 0.0,
                                'bias_after_scale': True})
        return out

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        block = param.block.program.global_block()
        var = block.create_var(
            name=unique_name.generate('%s_%s' % (param.name, name)),
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype, persistable=True)
        self.helper.set_variable_initializer(
            var, Constant(float(fill_value)))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- main entry --------------------------------------------------------
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        optimize_ops = self.apply_gradients(loss, params_grads,
                                            startup_program)
        return optimize_ops, params_grads

    def apply_gradients(self, loss, params_grads, startup_program=None):
        prog = loss.block.program
        startup = startup_program or default_startup_program()
        with program_guard(prog, startup):
            self.helper = LayerHelper(self.__class__.__name__)
            # error clip + grad clip + regularization (reference
            # optimizer.py:38 _create_optimization_pass preamble)
            params_grads = clip_mod.append_gradient_clip_ops(params_grads)
            params_grads = regularizer_mod.append_regularization_ops(
                params_grads, self.regularization)
            self._create_global_learning_rate(prog)
            block = loss.block
            self._create_accumulators(
                block, [p for p, g in params_grads if g is not None])
            optimize_ops = []
            for param_and_grad in params_grads:
                if param_and_grad[1] is None:
                    continue
                if not param_and_grad[0].trainable:
                    continue
                op = self._append_optimize_op(block, param_and_grad)
                op.attrs['op_role'] = 'optimize'
                optimize_ops.append(op)
            self._finish_update(block)
        return optimize_ops


class SGD(Optimizer):
    """(reference optimizer.py:279 SGDOptimizer -> sgd_op.cc)"""

    def __init__(self, learning_rate, **kwargs):
        super(SGD, self).__init__(learning_rate, **kwargs)
        self.type = 'sgd'

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type='sgd',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]]})


class Momentum(Optimizer):
    _velocity_acc_str = 'velocity'

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super(Momentum, self).__init__(learning_rate, **kwargs)
        self.type = 'momentum'
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type='momentum',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Velocity': [velocity],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'VelocityOut': [velocity]},
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov})


