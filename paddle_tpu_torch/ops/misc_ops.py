"""Counterpart of paddle_tpu/ops/misc_ops.py, every op type of it:
sign, minus, multiplex, rank_loss, modified_huber_loss, l1_norm, norm,
mean_iou (:31-212), flatten, crop, pad_constant_like, unstack, argmin
(:219-346), bilinear_tensor_product, bilinear_interp (:353-422), fill,
fill_constant_batch_size_like, random_crop, lod_reset (:429-550),
uniform/gaussian_random_batch_size_like (:558-596), and lod_rank_table
and reorder_lod_tensor_by_rank (:606-652), which the control-flow
layers build.

Grads come from the recorded forwards (registry.register_vjp_grad).
Gathers are advanced indexing, whose backward (index_put_ with
accumulate) sums in one order on the card. The random ops draw from the
executor's torch.Generator (tensor_ops.py's random initializers), so
they do not reproduce jax.random's numbers; random_crop's offsets
follow the JAX package's rule (a draw in [0, 2^30) modulo the room).
fill and lod_reset's target_lod build their tensor from an attribute
once per op and keep it on the device (detection_ops._device_constant).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..executor import torch_dtype
from ..framework import convert_np_dtype
from ..registry import (register_op, op_emitter, same_shape_infer,
                        register_vjp_grad)
from .detection_ops import _device_constant


# -- elementwise and simple math (misc_ops.py:31-212) --------------------------

@op_emitter('sign')
def _sign_emit(ctx, op):
    ctx.set(op.single_output('Out'),
            torch.sign(ctx.get(op.single_input('X'))))


register_op('sign', infer_shape=same_shape_infer(), no_grad=True)


@op_emitter('minus')
def _minus_emit(ctx, op):
    ctx.set(op.single_output('Out'), ctx.get(op.single_input('X')) -
            ctx.get(op.single_input('Y')))


register_op('minus', infer_shape=same_shape_infer())
register_vjp_grad('minus', in_slots=('X', 'Y'))


@op_emitter('multiplex')
def _multiplex_emit(ctx, op):
    """Row-wise select: Out[i] = X[Ids[i]][i]."""
    ids = ctx.get(op.single_input('Ids'))
    stacked = torch.stack([ctx.get(n) for n in op.input('X')], 0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    ctx.set(op.single_output('Out'), stacked[ids.reshape(-1).long(), rows])


def _multiplex_infer(op, block):
    x0 = block.var_recursive(op.input('X')[0])
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x0.shape
    out.dtype = x0.dtype


register_op('multiplex', infer_shape=_multiplex_infer)
register_vjp_grad('multiplex', in_slots=('X',), nondiff_slots=('Ids',))


@op_emitter('rank_loss')
def _rank_loss_emit(ctx, op):
    """RankNet's pairwise loss: -label * o + softplus(o), o = left - right
    (softplus as log(exp(o) + 1), jax.nn.softplus's logaddexp)."""
    label = ctx.get(op.single_input('Label'))
    o = ctx.get(op.single_input('Left')) - ctx.get(op.single_input('Right'))
    ctx.set(op.single_output('Out'),
            -label * o + torch.logaddexp(o, torch.zeros_like(o)))


register_op('rank_loss', infer_shape=same_shape_infer('Left', 'Out'))
register_vjp_grad('rank_loss', in_slots=('Left', 'Right'),
                  nondiff_slots=('Label',))


@op_emitter('modified_huber_loss')
def _modified_huber_loss_emit(ctx, op):
    """Labels {0, 1} -> {-1, 1}; z = x * y: -4z below -1, (1 - z)^2 up to
    1, 0 above."""
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.square(torch.clamp(1.0 - z, min=0.0)))
    if op.output('IntermediateVal'):
        ctx.set(op.single_output('IntermediateVal'), z)
    ctx.set(op.single_output('Out'), loss)


def _mhl_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    for slot in ('Out', 'IntermediateVal'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = x.shape
            v.dtype = x.dtype


register_op('modified_huber_loss', infer_shape=_mhl_infer)
register_vjp_grad('modified_huber_loss', in_slots=('X',),
                  nondiff_slots=('Y',), out_slots=('Out',))


@op_emitter('l1_norm')
def _l1_norm_emit(ctx, op):
    """sum |X|, with |x| spelled so its grad at 0 is +1, as jnp.abs's."""
    x = ctx.get(op.single_input('X'))
    ctx.set(op.single_output('Out'), torch.sum(torch.where(x >= 0, x, -x)))


def _scalar_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (1,)
    out.dtype = x.dtype


register_op('l1_norm', infer_shape=_scalar_infer)
register_vjp_grad('l1_norm')


@op_emitter('norm')
def _norm_emit(ctx, op):
    """L2-normalise along axis: Out = X / sqrt(sum(X^2) + eps)."""
    x = ctx.get(op.single_input('X'))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=op.attr('axis', 1),
                                keepdim=True) + op.attr('epsilon', 1e-10))
    if op.output('Norm'):
        ctx.set(op.single_output('Norm'), norm)
    ctx.set(op.single_output('Out'), x / norm)


def _norm_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    if op.output('Norm'):
        nv = block.var_recursive(op.single_output('Norm'))
        shape = list(x.shape)
        if shape:
            shape[op.attr('axis', 1)] = 1
        nv.shape = tuple(shape)
        nv.dtype = x.dtype


register_op('norm', infer_shape=_norm_infer)
register_vjp_grad('norm', in_slots=('X',), out_slots=('Out',))


def _one_hot(ids, depth):
    """[N] ids -> [N, depth] fp32 (an id outside [0, depth) is a zero
    row, as jax.nn.one_hot gives)."""
    return (ids.reshape(-1, 1) == torch.arange(
        depth, device=ids.device)).to(torch.float32)


@op_emitter('mean_iou')
def _mean_iou_emit(ctx, op):
    """Mean IoU over the classes present in predictions or labels; the
    confusion diagonal and margins as one-hot sums."""
    c = int(op.attr('num_classes'))
    p1 = _one_hot(ctx.get(op.single_input('Predictions')), c)
    l1 = _one_hot(ctx.get(op.single_input('Labels')), c)
    inter = torch.sum(p1 * l1, 0)
    pred_cnt = torch.sum(p1, 0)
    union = pred_cnt + torch.sum(l1, 0) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.where(valid, union, 1.0), 0.0)
    mean = torch.sum(iou) / torch.clamp(torch.sum(valid.to(torch.float32)),
                                        min=1.0)
    ctx.set(op.single_output('OutMeanIou'), mean.reshape(1))
    if op.output('OutWrong'):
        ctx.set(op.single_output('OutWrong'),
                (pred_cnt - inter).to(torch.int32))
    if op.output('OutCorrect'):
        ctx.set(op.single_output('OutCorrect'), inter.to(torch.int32))


def _mean_iou_infer(op, block):
    out = block.var_recursive(op.single_output('OutMeanIou'))
    out.shape = (1,)
    out.dtype = 'float32'
    for slot in ('OutWrong', 'OutCorrect'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = (int(op.attr('num_classes')),)
            v.dtype = 'int32'


register_op('mean_iou', infer_shape=_mean_iou_infer, no_grad=True)


# -- shapes (misc_ops.py:219-324) ----------------------------------------------

@op_emitter('flatten')
def _flatten_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    axis = op.attr('axis', 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    ctx.set(op.single_output('Out'), x.reshape(lead, -1))


def _flatten_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    axis = op.attr('axis', 1)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    tail = int(np.prod(x.shape[axis:])) if axis < len(x.shape) else 1
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (lead, tail)
    out.dtype = x.dtype


register_op('flatten', infer_shape=_flatten_infer)
register_vjp_grad('flatten')


def _crop_shape(op, x, y):
    if y is not None:
        return list(y.shape)
    shape = list(op.attr('shape'))
    if any(s < 0 for s in shape):
        if op.input('Offsets'):
            raise ValueError(
                'crop: a -1 dim in `shape` cannot be combined with a runtime '
                'Offsets input (the slice size must be static); pass static '
                'shape dims or attr offsets')
        off = op.attr('offsets', None) or [0] * x.ndim
        shape = [x.shape[i] - off[i] if s < 0 else s
                 for i, s in enumerate(shape)]
    return shape


@op_emitter('crop')
def _crop_emit(ctx, op):
    """A slice of a static shape: at the offsets attr, or at a runtime
    Offsets tensor (clamped into range, as lax.dynamic_slice does; read
    by advanced indexing, no host read)."""
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y')) if op.input('Y') else None
    shape = _crop_shape(op, x, y)
    if op.input('Offsets'):
        off = ctx.get(op.single_input('Offsets')).reshape(-1).long()
        idx = []
        for i, s in enumerate(shape):
            start = torch.clamp(off[i], 0, x.shape[i] - s)
            view = [1] * len(shape)
            view[i] = s
            idx.append((start + torch.arange(s, device=x.device))
                       .reshape(view))
        out = x[tuple(idx)]
    else:
        off = op.attr('offsets', [0] * len(shape))
        out = x[tuple(slice(o, o + s) for o, s in zip(off, shape))]
    ctx.set(op.single_output('Out'), out)


def _crop_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    if op.input('Y'):
        shape = block.var_recursive(op.single_input('Y')).shape
    else:
        shape = tuple(op.attr('shape'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(shape)
    out.dtype = x.dtype


register_op('crop', infer_shape=_crop_infer)
register_vjp_grad('crop', in_slots=('X',), nondiff_slots=('Y', 'Offsets'))


@op_emitter('pad_constant_like')
def _pad_constant_like_emit(ctx, op):
    """Y padded at the end of each dim up to X's shape with pad_value."""
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    pads = []
    for xd, yd in reversed(list(zip(x.shape, y.shape))):
        pads += [0, xd - yd]
    ctx.set(op.single_output('Out'),
            F.pad(y, pads, value=float(op.attr('pad_value', 0.0))))


register_op('pad_constant_like', infer_shape=same_shape_infer('X', 'Out'))
register_vjp_grad('pad_constant_like', in_slots=('Y',), nondiff_slots=('X',))


@op_emitter('unstack')
def _unstack_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    for name, part in zip(op.output('Y'),
                          torch.unbind(x, dim=op.attr('axis', 0))):
        ctx.set(name, part)


def _unstack_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    shape = list(x.shape)
    del shape[op.attr('axis', 0)]
    for name in op.output('Y'):
        v = block.var_recursive(name)
        v.shape = tuple(shape)
        v.dtype = x.dtype


register_op('unstack', infer_shape=_unstack_infer)
register_vjp_grad('unstack', in_slots=('X',), out_slots=('Y',))


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


@op_emitter('uniform_random_batch_size_like', stateful=True)
def _uniform_random_bsl_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))
    out = torch.empty(_bsl_shape(op, x), dtype=torch.float32,
                      device=ctx.device).uniform_(
        op.attr('min', -1.0), op.attr('max', 1.0),
        generator=ctx.generator(op))
    ctx.set(op.single_output('Out'), out.to(_bsl_dtype(op)))


@op_emitter('gaussian_random_batch_size_like', stateful=True)
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


# -- bilinear ops (misc_ops.py:353-422) ----------------------------------------

@op_emitter('bilinear_tensor_product')
def _bilinear_tensor_product_emit(ctx, op):
    """out[:, i] = x W_i y^T (+ b), accumulated in fp32 and cast to x's
    dtype, as the JAX package's einsum with preferred_element_type."""
    x = ctx.get(op.single_input('X'))
    w = ctx.get(op.single_input('Weight'))
    y = ctx.get(op.single_input('Y'))
    out = torch.einsum('nd,ode,ne->no', x.float(), w.float(),
                       y.float()).to(x.dtype)
    if op.input('Bias'):
        out = out + ctx.get(op.single_input('Bias'))
    ctx.set(op.single_output('Out'), out)


def _btp_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    w = block.var_recursive(op.single_input('Weight'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0], w.shape[0])
    out.dtype = x.dtype


register_op('bilinear_tensor_product', infer_shape=_btp_infer)
register_vjp_grad('bilinear_tensor_product',
                  in_slots=('X', 'Y', 'Weight', 'Bias'))


def _interp_axis(in_sz, out_sz, device):
    """Align-corners sample positions of one axis: (lo, hi, frac), the
    position i * (in - 1) / (out - 1) with lo clamped to in - 2
    (misc_ops.py:393-402); a size of 1 on either side samples index 0."""
    if out_sz == 1 or in_sz == 1:
        zero = torch.zeros(out_sz, dtype=torch.long, device=device)
        return zero, zero, torch.zeros(out_sz, device=device)
    ratio = (in_sz - 1.0) / (out_sz - 1.0)
    pos = torch.arange(out_sz, dtype=torch.float32, device=device) * ratio
    lo = torch.clamp(torch.floor(pos).long(), 0, in_sz - 2)
    return lo, lo + 1, pos - lo.to(torch.float32)


@op_emitter('bilinear_interp')
def _bilinear_interp_emit(ctx, op):
    """NCHW bilinear resize to the static (out_h, out_w) attrs with the
    JAX package's align-corners formula (not F.interpolate's default).
    OutSize only sets the shape at build time, as in the JAX package."""
    x = ctx.get(op.single_input('X'))
    h0, h1, fh = _interp_axis(x.shape[2], op.attr('out_h'), x.device)
    w0, w1, fw = _interp_axis(x.shape[3], op.attr('out_w'), x.device)
    fh = fh.to(x.dtype)[:, None]
    fw = fw.to(x.dtype)[None, :]
    rows0, rows1 = x[:, :, h0], x[:, :, h1]
    top = rows0[:, :, :, w0] * (1 - fw) + rows0[:, :, :, w1] * fw
    bot = rows1[:, :, :, w0] * (1 - fw) + rows1[:, :, :, w1] * fw
    ctx.set(op.single_output('Out'), top * (1 - fh) + bot * fh)


def _bilinear_interp_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0], x.shape[1], op.attr('out_h'), op.attr('out_w'))
    out.dtype = x.dtype


register_op('bilinear_interp', infer_shape=_bilinear_interp_infer)
register_vjp_grad('bilinear_interp', in_slots=('X',),
                  nondiff_slots=('OutSize',))


# -- fill, random_crop, lod_reset (misc_ops.py:429-550) ------------------------

@op_emitter('fill')
def _fill_emit(ctx, op):
    """The value attr as a tensor of the shape attr: built on the op's
    first run and kept on the device; each run hands out a copy."""
    dtype = op.attr('dtype', 'float32')
    shape = tuple(op.attr('shape'))
    value, = _device_constant(
        ctx, op, ('fill', shape, dtype),
        lambda: (np.asarray(op.attr('value'), dtype=dtype).reshape(shape),))
    ctx.set(op.single_output('Out'), value.clone())


def _fill_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(op.attr('shape'))
    out.dtype = op.attr('dtype', 'float32')


register_op('fill', infer_shape=_fill_infer, no_grad=True)


@op_emitter('random_crop', stateful=True)
def _random_crop_emit(ctx, op):
    """Crop the trailing len(shape) dims of each example at its own random
    offsets: a draw in [0, 2^30) from the executor's generator modulo the
    room + 1 (the JAX package's rule), gathered by advanced indexing."""
    x = ctx.get(op.single_input('X'))
    shape = list(op.attr('shape'))
    k = len(shape)
    batch_dims = tuple(x.shape[:x.ndim - k])
    n = int(np.prod(batch_dims)) if batch_dims else 1
    flat = x.reshape((n,) + tuple(x.shape[x.ndim - k:]))
    room = tuple(max(flat.shape[1 + i] - shape[i] + 1, 1) for i in range(k))
    room_t, = _device_constant(ctx, op, ('random_crop', room),
                               lambda: (np.asarray(room, np.int64),))
    offs = torch.randint(0, 1 << 30, (n, k), generator=ctx.generator(op),
                         device=x.device) % room_t
    idx = [torch.arange(n, device=x.device).reshape((n,) + (1,) * k)]
    for i, s in enumerate(shape):
        view = [n] + [1] * k
        view[1 + i] = s
        idx.append((offs[:, i:i + 1] + torch.arange(
            s, device=x.device)).reshape(view))
    out = flat[tuple(idx)]
    ctx.set(op.single_output('Out'), out.reshape(batch_dims + tuple(shape)))


def _random_crop_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    shape = list(op.attr('shape'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(x.shape[:len(x.shape) - len(shape)]) + tuple(shape)
    out.dtype = x.dtype


register_op('random_crop', infer_shape=_random_crop_infer, no_grad=True)


@op_emitter('lod_reset')
def _lod_reset_emit(ctx, op):
    """New sequence boundaries: the data passes through and only the
    lengths companion changes, to TargetLens (lengths, or offsets with
    target_is_offsets) or to the target_lod attr's lengths (built once
    and kept on the device)."""
    ctx.set(op.single_output('Out'), ctx.get(op.single_input('X')))
    if op.input('TargetLens'):
        lens = ctx.get(op.single_input('TargetLens')).reshape(-1)
        if op.attr('target_is_offsets', False):
            lens = lens[1:] - lens[:-1]
        lens = lens.to(torch.int32)
    else:
        target = tuple(op.attr('target_lod'))
        lens, = _device_constant(
            ctx, op, ('lod_reset', target),
            lambda: (np.diff(np.asarray(target)).astype(np.int32),))
    ctx.set(op.single_output('OutLens'), lens)


def _lod_reset_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = 1
    lens = block.var_recursive(op.single_output('OutLens'))
    if op.input('TargetLens'):
        t = block.var_recursive(op.single_input('TargetLens'))
        if all(d >= 0 for d in t.shape):
            n = int(np.prod([d for d in t.shape if d != 1] or [1]))
            lens.shape = (n - 1,) if op.attr('target_is_offsets',
                                             False) else (n,)
        else:
            lens.shape = (-1,)
    else:
        lens.shape = (len(op.attr('target_lod')) - 1,)
    lens.dtype = 'int32'


register_op('lod_reset', infer_shape=_lod_reset_infer)
register_vjp_grad('lod_reset', in_slots=('X',),
                  nondiff_slots=('TargetLens',))


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
