"""Sharding annotations (counterpart of paddle_tpu/parallel/api.py:21-71).

shard_tensor records a spec on a Variable (a parameter or a feed), as
the JAX package does; a ParallelExecutor over ranks stores the value by
it (each rank its shard). A sharding_constraint op pins a value's
layout: on a mesh it redistributes the value to its spec (the layout
rule in parallel/layout.py: gathers and chunks over the mesh's axes),
off the mesh it is the identity, so programs that carry the annotations
(the LM built with use_tp / use_sp, every cached serving program) run
unchanged on one card. pipeline_stage_guard waits for the pipeline
engine (ROADMAP.md Queue 1 item 8's pipeline bullet)."""
from __future__ import annotations

from ..framework import grad_var_name
from ..layer_helper import LayerHelper
from ..registry import register_op, same_shape_infer

__all__ = ['shard_tensor', 'sharding_constraint']


def shard_tensor(var, spec):
    """Annotate a Variable with a dim -> mesh-axis spec, e.g.
    shard_tensor(w, (None, 'tp')). Nothing reads it on one device."""
    var.dist_attr = tuple(spec)
    return var


def _sharding_constraint_emit(ctx, op):
    """Off a mesh: the identity (on a mesh the layout rule runs)."""
    ctx.set(op.single_output('Out'), ctx.get(op.single_input('X')))


def _sharding_constraint_grad(op, block):
    """The grad passes through the same constraint (the JAX package's
    grad maker, so both packages append the same grad op)."""
    return [dict(type='sharding_constraint',
                 inputs={'X': [grad_var_name(op.single_output('Out'))]},
                 outputs={'Out': [grad_var_name(op.single_input('X'))]},
                 attrs=dict(op.attrs))]


register_op('sharding_constraint', infer_shape=same_shape_infer(),
            emit=_sharding_constraint_emit, grad=_sharding_constraint_grad)


def sharding_constraint(x, spec, name=None):
    helper = LayerHelper('sharding_constraint', name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='sharding_constraint', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'spec': list(spec)})
    return out
