"""Raw-operator creation helpers for tests (counterpart of
paddle_tpu/op.py): OperatorFactory over the port's op registry, which
stands where OpProtos would, so the factory validates slot names loosely
and builds framework.Operator specs directly."""
from __future__ import annotations

from .registry import _REGISTRY

__all__ = ['Operator']


class OpInfo(object):
    def __init__(self, name):
        self.name = name
        self.type = name


class OperatorFactory(object):
    """`Operator('scale', X='x', Out='out', scale=2.0)` — builds the
    (type, inputs, outputs, attrs) spec for Block.append_op. Slot vs
    attr is decided by value type: strings / string-lists are variable
    slots, everything else is an attribute (the registry has no OpProto
    to consult)."""

    def types(self):
        return list(_REGISTRY.keys())

    def get_op_info(self, t):
        if t not in _REGISTRY:
            raise ValueError('op type %r is not registered' % t)
        return OpInfo(t)

    def __call__(self, type, **kwargs):
        self.get_op_info(type)
        inputs, outputs, attrs = {}, {}, {}

        def is_names(v):
            return isinstance(v, str) or (
                isinstance(v, (list, tuple)) and v and
                all(isinstance(x, str) for x in v))

        for key, value in kwargs.items():
            if is_names(value):
                names = [value] if isinstance(value, str) else list(value)
                # convention: output slots start uppercase and are
                # produced; grad slots end with @GRAD. Heuristic-free
                # split: ops name outputs 'Out*'/'Y'/'*Out' — callers
                # can force with out__/in__ prefixes.
                if key.startswith('out__'):
                    outputs[key[5:]] = names
                elif key.startswith('in__'):
                    inputs[key[4:]] = names
                elif key in ('Out', 'Output', 'Y', 'Outs', 'OutLens',
                             'Loss', 'Hidden', 'Cell', 'MAP'):
                    outputs[key] = names
                else:
                    inputs[key] = names
            else:
                attrs[key] = value
        return dict(type=type, inputs=inputs, outputs=outputs,
                    attrs=attrs)


Operator = OperatorFactory()
