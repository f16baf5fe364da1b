"""Generated layer functions of the activation ops, cumsum, increment,
gaussian_random and sum (counterpart of paddle_tpu/layers/ops.py; the
*_batch_size_like random layers are not ported)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__activations__ = [
    'sigmoid', 'logsigmoid', 'exp', 'tanh', 'tanh_shrink', 'softshrink',
    'sqrt', 'rsqrt', 'abs', 'ceil', 'floor', 'cos', 'sin', 'round',
    'reciprocal', 'square', 'softplus', 'softsign', 'brelu', 'leaky_relu',
    'soft_relu', 'elu', 'relu6', 'pow', 'stanh', 'hard_sigmoid', 'swish',
    'gelu', 'thresholded_relu', 'hard_shrink', 'logit',
]

__all__ = list(__activations__) + ['cumsum', 'increment']


def _make_unary(op_type, attr_names=()):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        attrs = {k: kwargs[k] for k in attr_names if k in kwargs}
        helper.append_op(type=op_type, inputs={'X': [x]},
                         outputs={'Out': [out]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


_ATTRS = {
    'softshrink': ('lambda',),
    'leaky_relu': ('alpha',),
    'elu': ('alpha',),
    'pow': ('factor',),
    'stanh': ('scale_a', 'scale_b'),
    'hard_sigmoid': ('slope', 'offset'),
    'swish': ('beta',),
    'thresholded_relu': ('threshold',),
    'hard_shrink': ('threshold',),
    'brelu': ('t_min', 't_max'),
}

for _name in __activations__:
    if _name == 'soft_relu':
        continue
    globals()[_name] = _make_unary(_name, _ATTRS.get(_name, ()))


def soft_relu(x, threshold=40.0, name=None):
    # ln(1+exp(min(x, threshold))) via clip + softplus composition
    helper = LayerHelper('soft_relu', name=name)
    clipped = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='clip', inputs={'X': [x]},
                     outputs={'Out': [clipped]},
                     attrs={'min': -float(threshold), 'max': float(threshold)})
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='softplus', inputs={'X': [clipped]},
                     outputs={'Out': [out]})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    helper = LayerHelper('cumsum', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='cumsum', inputs={'X': [x]},
                     outputs={'Out': [out]},
                     attrs={'axis': axis, 'exclusive': exclusive,
                            'reverse': reverse})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper('increment')
    out = x if in_place else helper.create_variable_for_type_inference(
        dtype=x.dtype)
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype='float32'):
    helper = LayerHelper('gaussian_random')
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='gaussian_random', inputs={},
                     outputs={'Out': [out]},
                     attrs={'shape': list(shape), 'mean': mean, 'std': std,
                            'dtype': dtype})
    return out


def sum(x):
    """Elementwise sum of a list of tensors (the sum op, which backward.py
    also uses for fan-out grads)."""
    helper = LayerHelper('sum')
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op(type='sum', inputs={'X': list(xs)},
                     outputs={'Out': [out]})
    return out


__all__ += ['gaussian_random', 'sum']
