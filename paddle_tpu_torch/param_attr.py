"""Parameter attributes (counterpart of paddle_tpu/param_attr.py)."""
from __future__ import annotations

from .initializer import Initializer

__all__ = ['ParamAttr', 'WeightNormParamAttr']


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError('cannot convert %r to ParamAttr' % (arg,))

    def to_kwargs(self):
        return {
            'name': self.name,
            'optimize_attr': {'learning_rate': self.learning_rate},
            'regularizer': self.regularizer,
            'trainable': self.trainable,
            'gradient_clip_attr': self.gradient_clip,
            'do_model_average': self.do_model_average,
        }


class WeightNormParamAttr(ParamAttr):
    """A parameter built as w = g * v / ||v|| (weight normalization): v
    has the parameter's shape, g one value per index of `dim` (one value
    when dim is None); LayerHelper makes both parameters and the ops."""

    def __init__(self, dim=None, **kwargs):
        super(WeightNormParamAttr, self).__init__(**kwargs)
        self.dim = dim
