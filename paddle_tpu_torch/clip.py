"""Gradient clipping (counterpart of paddle_tpu/clip.py:
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
set_gradient_clip, append_gradient_clip_ops)."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ['GradientClipByValue', 'GradientClipByNorm',
           'GradientClipByGlobalNorm', 'set_gradient_clip',
           'append_gradient_clip_ops', 'ErrorClipByValue']


class BaseErrorClipAttr(object):
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        helper = LayerHelper('gradient_clip')
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(
            type='clip', inputs={'X': [grad]}, outputs={'Out': [out]},
            attrs={'min': self.min, 'max': self.max, 'op_role': 'backward'})
        return param, grad.block.var(out.name)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        helper = LayerHelper('gradient_clip')
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(
            type='clip_by_norm', inputs={'X': [grad]},
            outputs={'Out': [out]},
            attrs={'max_norm': self.clip_norm, 'op_role': 'backward'})
        return param, grad.block.var(out.name)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """All grads scaled by clip_norm / max(global_norm, clip_norm)
    (reference clip.py:GradientClipByGlobalNorm)."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        ctx = context.setdefault(self.group_name,
                                 {'grads': [], 'clip_norm': self.clip_norm})
        ctx['grads'].append(grad)

    def _create_operators(self, param, grad):
        # the scale var was computed once per group in _finalize_group
        helper = LayerHelper('gradient_clip')
        out = helper.create_variable_for_type_inference(dtype=grad.dtype)
        grad.block.append_op(
            type='elementwise_mul',
            inputs={'X': [grad], 'Y': [self._scale_var]},
            outputs={'Out': [out]},
            attrs={'axis': -1, 'op_role': 'backward'})
        return param, grad.block.var(out.name)

    def _finalize_group(self, context):
        ctx = context[self.group_name]
        helper = LayerHelper('gradient_clip')
        block = ctx['grads'][0].block

        def op(type, inputs, dtype, attrs=None):
            out = helper.create_variable_for_type_inference(dtype=dtype)
            block.append_op(type=type, inputs=inputs,
                            outputs={'Out': [out]},
                            attrs=dict(attrs or {}, op_role='backward'))
            return block.var(out.name)

        sq_norms = [op('squared_l2_norm', {'X': [g]}, g.dtype)
                    for g in ctx['grads']]
        total = op('sum', {'X': sq_norms}, sq_norms[0].dtype)
        global_norm = op('sqrt', {'X': [total]}, total.dtype)
        clip_const = op('fill_constant', {}, 'float32',
                        {'shape': [], 'dtype': 'float32',
                         'value': self.clip_norm})
        denom = op('elementwise_max', {'X': [global_norm],
                                       'Y': [clip_const]}, 'float32',
                   {'axis': -1})
        self._scale_var = op('elementwise_div', {'X': [clip_const],
                                                 'Y': [denom]}, 'float32',
                             {'axis': -1})


def set_gradient_clip(clip, param_list=None, program=None):
    """Set clip attr on params (reference clip.py set_gradient_clip).

    Scoped to the given program's parameters (the reference semantics) —
    NOT a process-global default, so one program's clip policy never leaks
    into another program built later in the same process.
    """
    from .framework import default_main_program, Parameter
    program = program or default_main_program()
    if param_list is None:
        param_list = [v for v in program.global_block().vars.values()
                      if isinstance(v, Parameter)]
    else:
        param_list = [program.global_block().var(p) if isinstance(p, str)
                      else p for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    context = {}
    clips = []
    for p, g in param_grads:
        if g is None:
            clips.append(None)
            continue
        clip_attr = getattr(p, 'gradient_clip_attr', None)
        if clip_attr is None:
            clip_attr = NullGradientClipAttr()
        clip_attr._process_context(context, p, g)
        clips.append(clip_attr)
    finalized_groups = set()
    res = []
    for (p, g), clip_attr in zip(param_grads, clips):
        if g is None:
            res.append((p, g))
            continue
        if isinstance(clip_attr, GradientClipByGlobalNorm) and \
                clip_attr.group_name not in finalized_groups:
            clip_attr._finalize_group(context)
            finalized_groups.add(clip_attr.group_name)
        res.append(clip_attr._create_operators(p, g))
    return res
