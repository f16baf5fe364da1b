"""Op registry: shape/dtype inference + PyTorch emitters.

Counterpart of paddle_tpu/registry.py:41-96. Every op registers an
*emitter*, fn(ctx, op), that reads its inputs from the context as
tensors, computes with PyTorch and writes its outputs back; the
Executor (executor.py) calls the emitters of a block one by one. There
is no gradient machinery here: this package serves, it does not train
yet.
"""
from __future__ import annotations

__all__ = ['OpDef', 'register_op', 'get_op', 'infer_shape', 'op_emitter',
           'same_shape_infer']


class OpDef(object):
    __slots__ = ('type', 'infer_shape', 'emit')

    def __init__(self, type):
        self.type = type
        self.infer_shape = None   # fn(op, block) -> None (fills output vars)
        self.emit = None          # fn(ctx, op) -> None (reads/writes ctx)


_REGISTRY = {}


def register_op(type, infer_shape=None, emit=None):
    opdef = _REGISTRY.get(type)
    if opdef is None:
        opdef = _REGISTRY[type] = OpDef(type)
    if infer_shape is not None:
        opdef.infer_shape = infer_shape
    if emit is not None:
        opdef.emit = emit
    return opdef


def get_op(type):
    opdef = _REGISTRY.get(type)
    if opdef is None:
        raise KeyError('op %r is not registered' % type)
    return opdef


def op_emitter(type):
    def deco(fn):
        register_op(type, emit=fn)
        return fn
    return deco


def infer_shape(op, block):
    """Run shape/dtype inference for one op, if registered."""
    opdef = _REGISTRY.get(op.type)
    if opdef is not None and opdef.infer_shape is not None:
        opdef.infer_shape(op, block)


def same_shape_infer(in_slot='X', out_slot='Out'):
    """Output has the same shape/dtype as the input."""
    def fn(op, block):
        x = block.var_recursive(op.single_input(in_slot))
        out = block.var_recursive(op.single_output(out_slot))
        out.shape = x.shape
        if out.dtype is None:
            out.dtype = x.dtype
        out.lod_level = x.lod_level
    return fn
