"""The dense ops of paddle_tpu/ops/misc_ops.py that the book chapters
reach: argmin (:328), fill_constant_batch_size_like (:445),
uniform/gaussian_random_batch_size_like (:558-596), and lod_rank_table
and reorder_lod_tensor_by_rank (:606-652), which the control-flow
layers build. The random ones draw from the executor's torch.Generator
(tensor_ops.py's random initializers), so they do not reproduce
jax.random's numbers."""
from __future__ import annotations

import torch

from ..executor import torch_dtype
from ..framework import convert_np_dtype
from ..registry import register_op, op_emitter, register_vjp_grad


@op_emitter('argmin')
def _argmin_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'),
            torch.argmin(x, dim=op.attr('axis', -1)).to(torch.int32))


def _argmin_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    shape = list(x.shape)
    if shape:
        del shape[op.attr('axis', -1)]
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(shape)
    out.dtype = 'int32'


register_op('argmin', infer_shape=_argmin_infer, no_grad=True)


def _bsl_shape(op, x):
    """The shape attr with one dim taken from Input's batch size."""
    shape = list(op.attr('shape'))
    shape[op.attr('output_dim_idx', 0)] = x.shape[op.attr('input_dim_idx', 0)]
    return shape


def _bsl_dtype(op):
    return torch_dtype(convert_np_dtype(op.attr('dtype', 'float32')))


@op_emitter('fill_constant_batch_size_like')
def _fill_cbsl_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))
    ctx.set(op.single_output('Out'),
            torch.full(_bsl_shape(op, x), op.attr('value', 0.0),
                       dtype=_bsl_dtype(op), device=ctx.device))


@op_emitter('uniform_random_batch_size_like')
def _uniform_random_bsl_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))
    out = torch.empty(_bsl_shape(op, x), dtype=torch.float32,
                      device=ctx.device).uniform_(
        op.attr('min', -1.0), op.attr('max', 1.0),
        generator=ctx.generator(op))
    ctx.set(op.single_output('Out'), out.to(_bsl_dtype(op)))


@op_emitter('gaussian_random_batch_size_like')
def _gaussian_random_bsl_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))
    out = torch.empty(_bsl_shape(op, x), dtype=torch.float32,
                      device=ctx.device).normal_(
        op.attr('mean', 0.0), op.attr('std', 1.0),
        generator=ctx.generator(op))
    ctx.set(op.single_output('Out'), out.to(_bsl_dtype(op)))


def _bsl_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(_bsl_shape(op, x))
    out.dtype = op.attr('dtype', 'float32')


for _t in ('fill_constant_batch_size_like', 'uniform_random_batch_size_like',
           'gaussian_random_batch_size_like'):
    register_op(_t, infer_shape=_bsl_infer, no_grad=True)


# -- lod_rank_table / reorder_lod_tensor_by_rank: in the padded contract the
# rank table is the batch permutation that sorts rows by descending length
# (stable), one argsort on the device ------------------------------------------

@op_emitter('lod_rank_table')
def _lod_rank_table_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    B = x.shape[0]
    if op.input('SeqLens'):
        lens = ctx.get(op.single_input('SeqLens')).reshape(-1)
    else:
        lens = torch.full((B,), x.shape[1] if x.ndim > 1 else 1,
                          dtype=torch.int32, device=x.device)
    # the key (-len, index): unique, so the order is the stable one
    key = -lens.to(torch.int64) * B + torch.arange(B, device=x.device)
    ctx.set(op.single_output('Out'), torch.argsort(key).to(torch.int32))


def _lod_rank_table_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0],)
    out.dtype = 'int32'


register_op('lod_rank_table', infer_shape=_lod_rank_table_infer,
            no_grad=True)


@op_emitter('reorder_lod_tensor_by_rank')
def _reorder_lod_tensor_by_rank_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    perm = ctx.get(op.single_input('RankTable')).reshape(-1).long()
    ctx.set(op.single_output('Out'), x[perm])
    if op.input('SeqLens') and op.output('OutLens'):
        lens = ctx.get(op.single_input('SeqLens')).reshape(-1)
        ctx.set(op.single_output('OutLens'), lens[perm])


def _reorder_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = x.lod_level
    if op.output('OutLens'):
        ol = block.var_recursive(op.single_output('OutLens'))
        ol.shape = (x.shape[0],)
        ol.dtype = 'int32'


register_op('reorder_lod_tensor_by_rank', infer_shape=_reorder_infer)
register_vjp_grad('reorder_lod_tensor_by_rank', in_slots=('X',),
                  nondiff_slots=('RankTable', 'SeqLens'))
