"""Volumetric and indexed pooling and convolution (counterpart of
paddle_tpu/ops/nn3d_ops.py): conv3d, conv3d_transpose,
depthwise_conv2d_transpose (:35-145), pool3d (:152-209),
max_pool2d_with_index, max_pool3d_with_index, unpool (:216-382), spp
(:389-429) and conv_shift (:436-461).

Grads come from the recorded forwards (registry.register_vjp_grad).

- The convolutions go to F.conv3d / F.conv_transpose{2,3}d (cuDNN on
  the card; the JAX package calls lax.conv_general_dilated, outside any
  Pallas kernel). On the CPU bf16 operands are widened to fp32, as the
  JAX package does off the TPU (:44-46).
- pool3d and spp pool over explicit (lo, hi) pads, -inf for max, as
  nn_ops.pool2d does; a max's grad goes to the first maximum of its
  window (torch's pooling and XLA's select_and_scatter alike).
- *_with_index read each window as a strided view of the -inf-padded
  input (Tensor.unfold): the value is the window's amax, whose grad
  splits a tied maximum evenly, as jnp.max's does; Mask is the first
  maximum's flat index into the unpadded plane (or volume).
- unpool is a scatter-add by index_put_ with accumulate, which sums
  overlapping windows in one order (no atomics); conv_shift's circular
  index table is built on the device from aranges each run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..registry import register_op, op_emitter, register_vjp_grad, amp_cast
from .nn_ops import _conv_out_size, _pool_spatial_pads


def _widened(x, w):
    """(x, w, dtype of the result): bf16 operands on the CPU computed in
    fp32."""
    out_dtype = x.dtype
    if x.dtype == torch.bfloat16 and x.device.type == 'cpu':
        x, w = x.float(), w.float()
    return x, w, out_dtype


# -- conv3d / conv3d_transpose / depthwise_conv2d_transpose --------------------

@op_emitter('conv3d')
def _conv3d_emit(ctx, op):
    x, w = amp_cast(ctx, ctx.get(op.single_input('Input')),
                    ctx.get(op.single_input('Filter')))
    x, w, out_dtype = _widened(x, w)
    out = F.conv3d(x, w, None, stride=tuple(op.attr('strides', [1, 1, 1])),
                   padding=tuple(op.attr('paddings', [0, 0, 0])),
                   dilation=tuple(op.attr('dilations', [1, 1, 1])),
                   groups=op.attr('groups', 1) or 1)
    ctx.set(op.single_output('Output'), out.to(out_dtype))


def _conv3d_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    w = block.var_recursive(op.single_input('Filter'))
    strides = op.attr('strides', [1, 1, 1])
    paddings = op.attr('paddings', [0, 0, 0])
    dilations = op.attr('dilations', [1, 1, 1])
    spatial = [_conv_out_size(x.shape[2 + i], w.shape[2 + i], paddings[i],
                              strides[i], dilations[i]) for i in range(3)]
    out = block.var_recursive(op.single_output('Output'))
    out.shape = (x.shape[0], w.shape[0]) + tuple(spatial)
    out.dtype = x.dtype


register_op('conv3d', infer_shape=_conv3d_infer)
register_vjp_grad('conv3d', in_slots=('Input', 'Filter'),
                  out_slots=('Output',))


def _transpose_out_size(i, k, p, s, d):
    return -1 if i < 0 else (i - 1) * s - 2 * p + d * (k - 1) + 1


@op_emitter('conv3d_transpose')
def _conv3d_transpose_emit(ctx, op):
    """The filter is [C_in, C_out / groups, kd, kh, kw], the layout
    F.conv_transpose3d takes; out = (i - 1)s - 2p + d(k - 1) + 1."""
    x, w = amp_cast(ctx, ctx.get(op.single_input('Input')),
                    ctx.get(op.single_input('Filter')))
    x, w, out_dtype = _widened(x, w)
    out = F.conv_transpose3d(
        x, w, None, stride=tuple(op.attr('strides', [1, 1, 1])),
        padding=tuple(op.attr('paddings', [0, 0, 0])),
        groups=op.attr('groups', 1) or 1,
        dilation=tuple(op.attr('dilations', [1, 1, 1])))
    ctx.set(op.single_output('Output'), out.to(out_dtype))


def _conv3d_transpose_infer(op, block):
    """The JAX package's shape: C_out as the filter's second dim."""
    x = block.var_recursive(op.single_input('Input'))
    w = block.var_recursive(op.single_input('Filter'))
    strides = op.attr('strides', [1, 1, 1])
    paddings = op.attr('paddings', [0, 0, 0])
    dilations = op.attr('dilations', [1, 1, 1])
    spatial = [_transpose_out_size(x.shape[2 + i], w.shape[2 + i],
                                   paddings[i], strides[i], dilations[i])
               for i in range(3)]
    out = block.var_recursive(op.single_output('Output'))
    out.shape = (x.shape[0], w.shape[1]) + tuple(spatial)
    out.dtype = x.dtype


register_op('conv3d_transpose', infer_shape=_conv3d_transpose_infer)
register_vjp_grad('conv3d_transpose', in_slots=('Input', 'Filter'),
                  out_slots=('Output',))


@op_emitter('depthwise_conv2d_transpose')
def _depthwise_conv2d_transpose_emit(ctx, op):
    """A transpose conv with one group per channel; the filter is
    [C, 1, kh, kw]."""
    x, w = amp_cast(ctx, ctx.get(op.single_input('Input')),
                    ctx.get(op.single_input('Filter')))
    x, w, out_dtype = _widened(x, w)
    out = F.conv_transpose2d(
        x, w, None, stride=tuple(op.attr('strides', [1, 1])),
        padding=tuple(op.attr('paddings', [0, 0])), groups=x.shape[1],
        dilation=tuple(op.attr('dilations', [1, 1])))
    ctx.set(op.single_output('Output'), out.to(out_dtype))


def _dw_conv2d_transpose_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    w = block.var_recursive(op.single_input('Filter'))
    strides = op.attr('strides', [1, 1])
    paddings = op.attr('paddings', [0, 0])
    dilations = op.attr('dilations', [1, 1])
    out = block.var_recursive(op.single_output('Output'))
    out.shape = (x.shape[0], x.shape[1]) + tuple(
        _transpose_out_size(x.shape[2 + i], w.shape[2 + i], paddings[i],
                            strides[i], dilations[i]) for i in range(2))
    out.dtype = x.dtype


register_op('depthwise_conv2d_transpose',
            infer_shape=_dw_conv2d_transpose_infer)
register_vjp_grad('depthwise_conv2d_transpose',
                  in_slots=('Input', 'Filter'), out_slots=('Output',))


# -- pool3d ----------------------------------------------------------------------

def _flat_pads(spatial_pads):
    """[(lo, hi)] per spatial dim -> F.pad's list, last dim first."""
    out = []
    for lo, hi in reversed(spatial_pads):
        out += [lo, hi]
    return out


@op_emitter('pool3d')
def _pool3d_emit(ctx, op):
    """Max or average pooling over explicit pads (ceil_mode pads the far
    side); an exclusive average divides by the count of cells inside the
    input."""
    x = ctx.get(op.single_input('X'))
    ksize = list(op.attr('ksize'))
    strides = list(op.attr('strides', [1, 1, 1]))
    paddings = list(op.attr('paddings', [0, 0, 0]))
    if op.attr('global_pooling', False):
        ksize, strides, paddings = list(x.shape[2:]), [1, 1, 1], [0, 0, 0]
    pad = _flat_pads(_pool_spatial_pads(list(x.shape[2:]), ksize, strides,
                                        paddings, op.attr('ceil_mode', False)))
    padded = any(pad)
    if op.attr('pooling_type', 'max') == 'max':
        xp = F.pad(x, pad, value=float('-inf')) if padded else x
        out = F.max_pool3d(xp, ksize, strides)
    else:
        xp = F.pad(x, pad) if padded else x
        summed = F.avg_pool3d(xp, ksize, strides, divisor_override=1)
        if op.attr('exclusive', True) and padded:
            ones = F.pad(torch.ones_like(x[:1, :1]), pad)
            out = summed / F.avg_pool3d(ones, ksize, strides,
                                        divisor_override=1)
        else:
            out = summed / float(math.prod(ksize))
    ctx.set(op.single_output('Out'), out.to(x.dtype))


def _pool3d_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    if op.attr('global_pooling', False):
        out.shape = x.shape[:2] + (1, 1, 1)
    else:
        ksize = op.attr('ksize')
        strides = op.attr('strides', [1, 1, 1])
        paddings = op.attr('paddings', [0, 0, 0])

        def osz(i, k, p, s):
            if i < 0:
                return -1
            if op.attr('ceil_mode', False):
                return (i - k + 2 * p + s - 1) // s + 1
            return (i - k + 2 * p) // s + 1
        out.shape = x.shape[:2] + tuple(
            osz(x.shape[2 + i], ksize[i], paddings[i], strides[i])
            for i in range(3))
    out.dtype = x.dtype


register_op('pool3d', infer_shape=_pool3d_infer)
register_vjp_grad('pool3d')


# -- max pooling with index, unpool ----------------------------------------------

def _pool_with_index(x, ksize, strides, paddings):
    """(values, Mask) of a max pool over the trailing len(ksize) dims:
    windows as strided views of the -inf-padded input; the value is the
    window's amax (a tied maximum's grad split evenly, as jnp.max's),
    the Mask the first maximum's flat index into the unpadded dims."""
    nd = len(ksize)
    pad = _flat_pads([(p, p) for p in paddings])
    xp = F.pad(x, pad, value=float('-inf')) if any(pad) else x
    win = xp
    for i in range(nd):
        win = win.unfold(2 + i, ksize[i], strides[i])
    outs = win.shape[2:2 + nd]
    win = win.reshape(win.shape[:2 + nd] + (-1,))
    vals = win.amax(dim=-1)
    rest = torch.argmax(win, dim=-1)           # the first maximum
    cells = []
    for i in reversed(range(nd)):
        cells.insert(0, rest % ksize[i])
        rest = rest // ksize[i]
    flat = None
    for i in range(nd):
        view = [1] * nd
        view[i] = outs[i]
        coord = (torch.arange(outs[i], device=x.device) * strides[i] -
                 paddings[i]).reshape(view) + cells[i]
        flat = coord if flat is None else flat * x.shape[2 + i] + coord
    return vals, flat.to(torch.int32)


def _with_index_emit(ctx, op, nd):
    x = ctx.get(op.single_input('X'))
    ksize = list(op.attr('ksize'))
    strides = list(op.attr('strides', [1] * nd))
    paddings = list(op.attr('paddings', [0] * nd))
    if op.attr('global_pooling', False):
        ksize, strides, paddings = list(x.shape[2:]), [1] * nd, [0] * nd
    vals, mask = _pool_with_index(x, ksize, strides, paddings)
    ctx.set(op.single_output('Out'), vals)
    ctx.set(op.single_output('Mask'), mask)


def _with_index_infer(nd):
    def infer(op, block):
        x = block.var_recursive(op.single_input('X'))
        if op.attr('global_pooling', False):
            oshape = tuple(x.shape[:2]) + (1,) * nd
        else:
            ksize = op.attr('ksize')
            strides = op.attr('strides', [1] * nd)
            paddings = op.attr('paddings', [0] * nd)
            oshape = tuple(x.shape[:2]) + tuple(
                (x.shape[2 + i] - ksize[i] + 2 * paddings[i]) // strides[i]
                + 1 for i in range(nd))
        out = block.var_recursive(op.single_output('Out'))
        out.shape = oshape
        out.dtype = x.dtype
        mask = block.var_recursive(op.single_output('Mask'))
        mask.shape = oshape
        mask.dtype = 'int32'
    return infer


for _nd in (2, 3):
    _t = 'max_pool%dd_with_index' % _nd
    register_op(_t, emit=lambda ctx, op, nd=_nd: _with_index_emit(ctx, op, nd),
                infer_shape=_with_index_infer(_nd))
    register_vjp_grad(_t, in_slots=('X',), out_slots=('Out',))


@op_emitter('unpool')
def _unpool_emit(ctx, op):
    """Max-unpool: each pooled value added at its Indices position of the
    [unpooled_height x unpooled_width] plane (index_put with accumulate:
    overlapping windows sum in one order)."""
    x = ctx.get(op.single_input('X'))
    idx = ctx.get(op.single_input('Indices'))
    n, c = x.shape[0], x.shape[1]
    out_h, out_w = op.attr('unpooled_height'), op.attr('unpooled_width')
    rows = torch.arange(n, device=x.device).reshape(n, 1, 1)
    chans = torch.arange(c, device=x.device).reshape(1, c, 1)
    flat = torch.zeros((n, c, out_h * out_w), dtype=x.dtype, device=x.device)
    flat = flat.index_put((rows, chans, idx.reshape(n, c, -1).long()),
                          x.reshape(n, c, -1), accumulate=True)
    ctx.set(op.single_output('Out'), flat.reshape(n, c, out_h, out_w))


def _unpool_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0], x.shape[1], op.attr('unpooled_height'),
                 op.attr('unpooled_width'))
    out.dtype = x.dtype


register_op('unpool', infer_shape=_unpool_infer)
register_vjp_grad('unpool', in_slots=('X',), nondiff_slots=('Indices',))


# -- spp ---------------------------------------------------------------------------

@op_emitter('spp')
def _spp_emit(ctx, op):
    """Spatial pyramid pooling: level l pools a 2^l x 2^l grid of
    ceil(h / 2^l) x ceil(w / 2^l) windows over centred pads (the average
    divides by the window size); the levels' [N, C * 4^l] concatenated."""
    x = ctx.get(op.single_input('X'))
    n, c, h, w = x.shape
    is_max = op.attr('pooling_type', 'max') == 'max'
    outs = []
    for lv in range(op.attr('pyramid_height')):
        bins = 2 ** lv
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pad = [pw, kw * bins - w - pw, ph, kh * bins - h - ph]
        if is_max:
            xp = F.pad(x, pad, value=float('-inf')) if any(pad) else x
            pooled = F.max_pool2d(xp, (kh, kw), (kh, kw))
        else:
            xp = F.pad(x, pad) if any(pad) else x
            pooled = F.avg_pool2d(xp, (kh, kw), (kh, kw),
                                  divisor_override=1) / float(kh * kw)
        outs.append(pooled.reshape(n, -1))
    ctx.set(op.single_output('Out'), torch.cat(outs, 1).to(x.dtype))


def _spp_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    total = sum(x.shape[1] * (2 ** lv) ** 2
                for lv in range(op.attr('pyramid_height')))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0], total)
    out.dtype = x.dtype


register_op('spp', infer_shape=_spp_infer)
register_vjp_grad('spp')


# -- conv_shift ----------------------------------------------------------------------

@op_emitter('conv_shift')
def _conv_shift_emit(ctx, op):
    """Circular correlation: Out[i, j] = sum_k X[i, (j + k - M // 2) mod W]
    * Y[i, k]."""
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    wdim, m = x.shape[1], y.shape[1]
    idx = (torch.arange(wdim, device=x.device)[:, None] +
           torch.arange(m, device=x.device)[None, :] - m // 2) % wdim
    ctx.set(op.single_output('Out'), torch.einsum('bwm,bm->bw', x[:, idx], y))


def _conv_shift_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


register_op('conv_shift', infer_shape=_conv_shift_infer)
register_vjp_grad('conv_shift', in_slots=('X', 'Y'))
