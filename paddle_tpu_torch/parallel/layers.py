"""Model-parallel layers, one-device forms (counterpart of
paddle_tpu/parallel/layers.py:43-103): the same ops, parameter names and
sharding annotations as the JAX package builds, so a program built with
TransformerConfig(use_tp=True, use_sp=True) is the same Program in both
packages. On one card the annotations are inert (api.py).

moe_layer and ring_attention raise NotImplementedError: expert and
context parallelism are not ported (ROADMAP.md, Queue 1 item 7).
"""
from __future__ import annotations

from .. import layers as L
from .. import unique_name
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .api import shard_tensor, sharding_constraint

__all__ = ['column_parallel_fc', 'row_parallel_fc',
           'vocab_parallel_embedding', 'sequence_parallel_scope',
           'moe_layer', 'ring_attention']

_NOT_PORTED = ('%s is not ported: expert and context parallelism wait '
               '(ROADMAP.md, Queue 1 item 7)')


def _fc(input, size, param_spec, act=None, param_attr=None, bias_attr=None,
        num_flatten_dims=None, name=None):
    """L.fc over the last dim with its weight named `<name>_<n>.w` and
    annotated param_spec; the bias stays replicated."""
    if num_flatten_dims is None:
        num_flatten_dims = max(len(input.shape) - 1, 1)
    if param_attr is None:
        param_attr = ParamAttr(
            name=unique_name.generate(name or 'parallel_fc') + '.w')
    out = L.fc(input=input, size=size, act=act,
               num_flatten_dims=num_flatten_dims, param_attr=param_attr,
               bias_attr=bias_attr, name=name)
    shard_tensor(input.block.program.global_block().var(param_attr.name),
                 param_spec)
    return out


def column_parallel_fc(input, size, act=None, param_attr=None,
                       bias_attr=None, axis='tp', name=None):
    """Output-feature-sharded linear: y[:, shard] = x @ W[:, shard]."""
    out = _fc(input, size, (None, axis), act=act, param_attr=param_attr,
              bias_attr=bias_attr, name=name)
    return sharding_constraint(out, ('dp', axis))


def row_parallel_fc(input, size, act=None, param_attr=None,
                    bias_attr=None, axis='tp', name=None):
    """Input-feature-sharded linear (a mesh completes it with a psum)."""
    out = _fc(input, size, (axis, None), act=act, param_attr=param_attr,
              bias_attr=bias_attr, name=name)
    return sharding_constraint(out, ('dp', None))


def vocab_parallel_embedding(input, size, param_attr=None, dtype='float32',
                             axis='tp', name=None):
    """Embedding with the table annotated as sharded over vocab rows."""
    helper = LayerHelper('embedding', param_attr=param_attr, name=name)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype)
    shard_tensor(w, (axis, None))
    tmp = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='lookup_table',
                     inputs={'Ids': [input], 'W': [w]},
                     outputs={'Out': [tmp]}, attrs={'padding_idx': -1})
    return tmp


def sequence_parallel_scope(x, axis='sp'):
    """Pin the time axis of [B, T, D] activations to the sp mesh axis."""
    return sharding_constraint(x, ('dp', axis, None))


def moe_layer(input, num_experts, hidden_size, *args, **kwargs):
    raise NotImplementedError(_NOT_PORTED % 'moe_layer')


def ring_attention(q, k, v, causal=True, sm_scale=None, name=None):
    raise NotImplementedError(_NOT_PORTED % 'ring_attention')
