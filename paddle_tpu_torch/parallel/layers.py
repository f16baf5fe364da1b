"""Model-parallel layers (counterpart of paddle_tpu/parallel/layers.py:
26-150): the same ops, parameter names and sharding annotations as the
JAX package builds, so a program built with TransformerConfig(use_tp=
True, use_sp=True, ring_attention=, moe_experts=) is the same Program
in both packages. On one card the annotations are inert; on a mesh
(ParallelExecutor over ranks) the weights are stored by them and the
ops run by their layout rules (parallel/layout.py): column- and
row-parallel products with their all-reduces, a vocab-sharded lookup,
the sequence split, the ring, and MoE's experts over 'ep'
(parallel/moe.py).
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


def moe_layer(input, num_experts, hidden_size, act='gelu', k=1,
              dispatch='topk', capacity_factor=2.0, aux_loss=False,
              param_attr=None, axis='ep', name=None):
    """A mixture-of-experts FFN (ops/moe_ops.py): a softmax gate fc over
    the last dim, then moe_ffn over experts stacked [E, D, H] and
    [E, H, D], annotated as sharded over `axis` (inert on one card).
    dispatch 'topk' routes each token to its top k experts within a
    capacity of ceil(S * k * capacity_factor / E) tokens an expert;
    'dense' runs every expert on every token. aux_loss=True also returns
    GShard's load-balance loss (add it to the objective, typically
    weighted 1e-2)."""
    helper = LayerHelper('moe', param_attr=param_attr, name=name)
    D = input.shape[-1]
    dtype = input.dtype
    gate = L.fc(input=input, size=num_experts, act='softmax',
                num_flatten_dims=max(len(input.shape) - 1, 1))
    w_up = helper.create_parameter(
        attr=helper.param_attr, shape=[num_experts, D, hidden_size],
        dtype=dtype)
    shard_tensor(w_up, (axis, None, None))
    w_down = helper.create_parameter(
        attr=helper.param_attr, shape=[num_experts, hidden_size, D],
        dtype=dtype)
    shard_tensor(w_down, (axis, None, None))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='moe_ffn',
        inputs={'X': [input], 'Gate': [gate], 'WUp': [w_up],
                'WDown': [w_down]},
        outputs={'Out': [out]},
        attrs={'act': act, 'k': k, 'dispatch': dispatch,
               'capacity_factor': capacity_factor})
    out.lod_level = input.lod_level
    if not aux_loss:
        return out
    aux = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='moe_aux_loss', inputs={'Gate': [gate]},
                     outputs={'Out': [aux]})
    return out, aux


def ring_attention(q, k, v, causal=True, sm_scale=None, name=None):
    """Context-parallel attention (parallel/ring_attention.py): q, k, v
    [B, H, T, dh] with T sharded over 'sp'; the K/V blocks travel the
    ring and each is folded into the result. Exactly full softmax
    attention. Off the mesh it is ordinary attention."""
    helper = LayerHelper('ring_attention', name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(
        type='ring_attention',
        inputs={'Q': [q], 'K': [k], 'V': [v]},
        outputs={'Out': [out]},
        attrs={'causal': causal, 'sm_scale': sm_scale})
    out.lod_level = q.lod_level
    return out
