"""Optimizers: build per-param update ops into the program (counterpart
of paddle_tpu/optimizer.py: Optimizer :30, minimize :97, SGD :132,
Momentum :148, Adagrad :187, Adam :212, Adamax :255, DecayedAdagrad
:303, Adadelta :329, RMSProp :357, Ftrl :390, ModelAverage :423 (a
constructor only, as there), ProximalGD :437, ProximalAdagrad :457 and
the *Optimizer aliases :485-495).

The update ops are part of the same block as forward and backward; the
Executor runs them last, in place on the Scope's parameters and
accumulators (ops/optimizer_ops.py). A Variable learning rate (a
layers.learning_rate_scheduler schedule) is computed by ops in the same
block, so the schedule moves with the step counter.
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

__all__ = ['SGD', 'Momentum', 'Adagrad', 'Adam', 'Adamax', 'DecayedAdagrad',
           'Adadelta', 'RMSProp', 'Ftrl', 'ProximalGD', 'ProximalAdagrad',
           'SGDOptimizer', 'MomentumOptimizer', 'AdagradOptimizer',
           'AdamOptimizer', 'AdamaxOptimizer', 'DecayedAdagradOptimizer',
           'AdadeltaOptimizer', 'RMSPropOptimizer', 'FtrlOptimizer',
           'Optimizer', 'ModelAverage']


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
        from .flags import get_flag
        # FLAGS_bf16_momentum: the velocity is CREATED bf16, so its dtype
        # is the same from the first step; the update math still runs in
        # the parameter's dtype and stores back in bf16
        # (ops/optimizer_ops.py)
        bf16 = get_flag('bf16_momentum')
        for p in parameters:
            self._add_accumulator(
                self._velocity_acc_str, p,
                dtype='bfloat16' if (bf16 and str(p.dtype) == 'float32')
                else None)

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


class Adagrad(Optimizer):
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super(Adagrad, self).__init__(learning_rate, **kwargs)
        self.type = 'adagrad'
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type='adagrad',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]], 'MomentOut': [moment]},
            attrs={'epsilon': self._epsilon})


class Adam(Optimizer):
    _moment1_acc_str = 'moment1'
    _moment2_acc_str = 'moment2'
    _beta1_pow_acc_str = 'beta1_pow_acc'
    _beta2_pow_acc_str = 'beta2_pow_acc'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super(Adam, self).__init__(learning_rate, **kwargs)
        self.type = 'adam'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=(1,),
                                  fill_value=self._beta1)
            self._add_accumulator(self._beta2_pow_acc_str, p, shape=(1,),
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment1 = self._get_accumulator(self._moment1_acc_str, p)
        moment2 = self._get_accumulator(self._moment2_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type='adam',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'Moment1': [moment1], 'Moment2': [moment2],
                    'LearningRate': [self._create_param_lr(param_and_grad)],
                    'Beta1Pow': [beta1_pow], 'Beta2Pow': [beta2_pow]},
            outputs={'ParamOut': [p], 'Moment1Out': [moment1],
                     'Moment2Out': [moment2], 'Beta1PowOut': [beta1_pow],
                     'Beta2PowOut': [beta2_pow]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon, 'lazy_mode': self._lazy_mode})


class Adamax(Optimizer):
    _moment_acc_str = 'moment'
    _inf_norm_acc_str = 'inf_norm'
    _beta1_pow_acc_str = 'beta1_pow_acc'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(Adamax, self).__init__(learning_rate, **kwargs)
        self.type = 'adamax'
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=(1,),
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        op = block.append_op(
            type='adamax',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'Moment': [moment], 'InfNorm': [inf_norm],
                    'LearningRate': [self._create_param_lr(param_and_grad)],
                    'Beta1Pow': [beta1_pow]},
            outputs={'ParamOut': [p], 'MomentOut': [moment],
                     'InfNormOut': [inf_norm]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon})
        return op

    def _finish_update(self, block):
        """Update beta1^t accumulators once per step (reference
        optimizer.py Adamax._finish_update)."""
        for param_name, beta1_pow in \
                self._accumulators[self._beta1_pow_acc_str].items():
            op = block.append_op(
                type='scale', inputs={'X': [beta1_pow]},
                outputs={'Out': [beta1_pow]},
                attrs={'scale': self._beta1, 'op_role': 'optimize'})


class DecayedAdagrad(Optimizer):
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super(DecayedAdagrad, self).__init__(learning_rate, **kwargs)
        self.type = 'decayed_adagrad'
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        return block.append_op(
            type='decayed_adagrad',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]], 'MomentOut': [moment]},
            attrs={'decay': self._decay, 'epsilon': self._epsilon})


class Adadelta(Optimizer):
    _avg_squared_grad_acc_str = '_avg_squared_grad'
    _avg_squared_update_acc_str = '_avg_squared_update'

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super(Adadelta, self).__init__(learning_rate, **kwargs)
        self.type = 'adadelta'
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, p)
        asu = self._get_accumulator(self._avg_squared_update_acc_str, p)
        return block.append_op(
            type='adadelta',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'AvgSquaredGrad': [asg], 'AvgSquaredUpdate': [asu]},
            outputs={'ParamOut': [p], 'AvgSquaredGradOut': [asg],
                     'AvgSquaredUpdateOut': [asu]},
            attrs={'epsilon': self._epsilon, 'rho': self._rho})


class RMSProp(Optimizer):
    _momentum_acc_str = 'momentum'
    _mean_square_acc_str = 'mean_square'

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super(RMSProp, self).__init__(learning_rate, **kwargs)
        self.type = 'rmsprop'
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        momentum_acc = self._get_accumulator(self._momentum_acc_str, p)
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str, p)
        return block.append_op(
            type='rmsprop',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'Moment': [momentum_acc],
                    'MeanSquare': [mean_square_acc],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [p], 'MomentOut': [momentum_acc],
                     'MeanSquareOut': [mean_square_acc]},
            attrs={'epsilon': self._epsilon, 'decay': self._rho,
                   'momentum': self._momentum})


class Ftrl(Optimizer):
    _squared_acc_str = 'squared'
    _linear_acc_str = 'linear'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(Ftrl, self).__init__(learning_rate, **kwargs)
        self.type = 'ftrl'
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        squared_acc = self._get_accumulator(self._squared_acc_str, p)
        linear_acc = self._get_accumulator(self._linear_acc_str, p)
        return block.append_op(
            type='ftrl',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'SquaredAccumulator': [squared_acc],
                    'LinearAccumulator': [linear_acc],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [p], 'SquaredAccumOut': [squared_acc],
                     'LinearAccumOut': [linear_acc]},
            attrs={'l1': self._l1, 'l2': self._l2,
                   'lr_power': self._lr_power})


class ModelAverage(Optimizer):
    """Running average of parameters for evaluation: the constructor only,
    as in the JAX package, so minimize() raises NotImplementedError
    (Optimizer._append_optimize_op)."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super(ModelAverage, self).__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window


class ProximalGD(Optimizer):
    """Proximal gradient descent (the proximal_gd op)."""

    def __init__(self, learning_rate, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kwargs):
        super(ProximalGD, self).__init__(learning_rate, **kwargs)
        self.type = 'proximal_gd'
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        return block.append_op(
            type='proximal_gd',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [p]},
            attrs={'l1': self._l1, 'l2': self._l2})


class ProximalAdagrad(Optimizer):
    """Proximal Adagrad (the proximal_adagrad op)."""
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, **kwargs):
        super(ProximalAdagrad, self).__init__(learning_rate, **kwargs)
        self.type = 'proximal_adagrad'
        self._l1 = l1_regularization_strength
        self._l2 = l2_regularization_strength

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        return block.append_op(
            type='proximal_adagrad',
            inputs={'Param': [p], 'Grad': [param_and_grad[1]],
                    'Moment': [moment],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [p], 'MomentOut': [moment]},
            attrs={'l1': self._l1, 'l2': self._l2})


# the Fluid aliases (fluid.optimizer.SGDOptimizer etc.)
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
DecayedAdagradOptimizer = DecayedAdagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
FtrlOptimizer = Ftrl
ProximalGDOptimizer = ProximalGD
ProximalAdagradOptimizer = ProximalAdagrad
