"""Sharding annotations (counterpart of paddle_tpu/parallel/api.py:62).

Only the single-device case is ported: a sharding_constraint op is the
identity, so programs that carry the constraints (every cached serving
program does) run unchanged on one card."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..registry import register_op, same_shape_infer

__all__ = ['sharding_constraint']


def _sharding_constraint_emit(ctx, op):
    ctx.set(op.single_output('Out'), ctx.get(op.single_input('X')))


register_op('sharding_constraint', infer_shape=same_shape_infer(),
            emit=_sharding_constraint_emit)


def sharding_constraint(x, spec, name=None):
    helper = LayerHelper('sharding_constraint', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='sharding_constraint', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'spec': list(spec)})
    return out
