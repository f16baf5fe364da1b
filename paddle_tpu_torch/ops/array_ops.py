"""Tensor-array ops (counterpart of paddle_tpu/ops/array_ops.py):
write_to_array, read_from_array, lod_array_length, array_to_lod_tensor,
lod_tensor_to_array, max_sequence_len.

A LOD_TENSOR_ARRAY's run-time value is a Python list of tensors. Its
indices are folded from the Program at build time, as the JAX package
folds them (:20-58): an index var made by fill_constant, increment,
assign and cast chains is a constant, anything else raises the JAX
package's RuntimeError. No index is read back from the card. The fold
of an op is kept on the op, so it walks the Program once.
"""
from __future__ import annotations

import torch

from ..registry import register_op, op_emitter
from .tensor_ops import device_constant


def _block_pos(block, op):
    """op's index in block.ops (by identity)."""
    for i, o in enumerate(block.ops):
        if o is op:
            return i
    return len(block.ops)


def _parent_pos(block):
    """The index, in its parent block, of the control-flow op that owns
    `block` (the op whose sub_block attr names it): only the parent's
    ops before it have run."""
    parent = block.parent_block
    for i, o in enumerate(parent.ops):
        if o.has_attr('sub_block') and o.attr('sub_block') == block.idx:
            return i
    return len(parent.ops)


def concrete_index(op, block, slot='I'):
    """The constant value of op's index input, folded over the IR: the
    ops of its own block before it, then the ops of each enclosing block
    before the control-flow op that holds the inner one."""
    kept = op.__dict__.setdefault('_folded_index', {})
    if slot in kept:
        return kept[slot]
    name = op.single_input(slot)

    def fold(b, n, limit):
        for idx in range(min(limit, len(b.ops)) - 1, -1, -1):
            o = b.ops[idx]
            if n not in o.output_arg_names():
                continue
            if o.type == 'fill_constant':
                return int(o.attr('value'))
            if o.type == 'increment':
                return fold(b, o.single_input('X'), idx) + \
                    int(o.attr('step', 1.0))
            if o.type in ('assign', 'cast'):
                return fold(b, o.single_input('X'), idx)
            raise RuntimeError(
                '%s index %r is data-dependent (produced by %r); XLA needs '
                'compile-time-constant array indices outside scan-based '
                'recurrences. Use StaticRNN/DynamicRNN for in-loop arrays.'
                % (op.type, n, o.type))
        if b.parent_block is not None:
            return fold(b.parent_block, n, _parent_pos(b))
        raise RuntimeError(
            '%s index %r has no constant producer in this block (is it a '
            'feed?)' % (op.type, n))

    kept[slot] = fold(block, name, _block_pos(block, op))
    return kept[slot]


def _array_of(ctx, name):
    """The list bound to an array var, or None before its first write."""
    if name in ctx.local:
        return ctx.local[name]
    return ctx.scope.find_var(name)


@op_emitter('write_to_array')
def _array_write_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    i = concrete_index(op, ctx.block)
    out_name = op.single_output('Out')
    arr = _array_of(ctx, out_name)
    arr = [] if arr is None else list(arr)
    while len(arr) <= i:
        arr.append(None)
    arr[i] = x
    ctx.set(out_name, arr)


@op_emitter('read_from_array')
def _array_read_emit(ctx, op):
    arr = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'), arr[concrete_index(op, ctx.block)])


@op_emitter('lod_array_length')
def _array_length_emit(ctx, op):
    arr = _array_of(ctx, op.single_input('X')) or []
    # declared int64; the JAX package's value is int32 (x64 is off)
    ctx.set(op.single_output('Out'), device_constant(
        ctx, op, len(arr), lambda: torch.tensor([len(arr)],
                                                dtype=torch.int32)))


def _array_len_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (1,)
    out.dtype = 'int64'


register_op('write_to_array', infer_shape=lambda op, block: None,
            no_grad=True)
register_op('read_from_array', infer_shape=lambda op, block: None,
            no_grad=True)
register_op('lod_array_length', infer_shape=_array_len_infer, no_grad=True)


# -- array <-> tensor: in the padded, batch-major representation an array
# over time is the leading axis ----------------------------------------------

@op_emitter('array_to_lod_tensor')
def _array_to_lod_tensor_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.stack(list(ctx.get(op.single_input('X'))), dim=0))


@op_emitter('lod_tensor_to_array')
def _lod_tensor_to_array_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'), [x[t] for t in range(x.shape[0])])


register_op('array_to_lod_tensor', infer_shape=lambda op, block: None,
            no_grad=True)
register_op('lod_tensor_to_array', infer_shape=lambda op, block: None,
            no_grad=True)


@op_emitter('max_sequence_len')
def _max_seq_len_emit(ctx, op):
    # RankTable is a [B] lengths vector here, the padded-batch analog of
    # the reference's LoDRankTable
    lens = ctx.get(op.single_input('RankTable'))
    ctx.set(op.single_output('Out'), torch.amax(lens).reshape((1,)))


def _max_seq_len_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (1,)
    out.dtype = 'int64'


register_op('max_sequence_len', infer_shape=_max_seq_len_infer, no_grad=True)
