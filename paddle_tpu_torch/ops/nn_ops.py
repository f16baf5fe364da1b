"""NN ops (counterpart of paddle_tpu/ops/nn_ops.py: conv2d /
depthwise_conv2d :28-92, pool2d :156-243, batch_norm :246-511,
layer_norm :518, softmax :563, cross_entropy :577,
softmax_with_cross_entropy :607, sigmoid_cross_entropy_with_logits
:643, square_error_cost :688, dropout :737-787, lookup_table :794 (grad
:822-866), accuracy :878, causal_mask :965, position_embedding :982).

Grads: recorded forwards (registry.register_vjp_grad), except
lookup_table, whose grad op is a plain scatter-add (index_add_),
batch_norm, whose grad op is the JAX package's closed form, and
dropout, whose grad op multiplies by the forward's Mask output.

Convolutions go to F.conv2d (the JAX package leaves them to
lax.conv, outside any Pallas kernel). On the card bf16 operands go to
cuDNN, which accumulates in fp32, as the TPU's MXU does; on the CPU
bf16 operands are widened to fp32 first, as the JAX package does off
the TPU.

NHWC (data_format / data_layout 'NHWC'; filters stay OIHW): a contiguous
NHWC tensor permuted to NCHW order is a channels-last view, which
F.conv2d and the pooling ops take as it is and answer in channels-last
memory, so permuting the result back gives a contiguous NHWC tensor
with no copy of the activations. The conv's filter is handed over in
channels-last memory too, so cuDNN runs channels-last even where the
input view is not (the stem, whose NCHW feed is transposed by a view).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework import grad_var_name
from ..registry import (register_op, op_emitter, same_shape_infer,
                        register_vjp_grad, amp_cast)


def _nhwc(op):
    return op.attr('data_format', 'NCHW') == 'NHWC'


def _nchw_view(x, nhwc):
    """The NCHW-ordered view of an NHWC tensor (channels-last memory)."""
    return x.permute(0, 3, 1, 2) if nhwc else x


def _nhwc_view(y, nhwc):
    """An NCHW-ordered result back in NHWC order (a view)."""
    return y.permute(0, 2, 3, 1) if nhwc else y


# -- conv2d / depthwise_conv2d ------------------------------------------------

def _conv2d_common_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))
    w = ctx.get(op.single_input('Filter'))
    x, w = amp_cast(ctx, x, w)
    nhwc = _nhwc(op)
    x = _nchw_view(x, nhwc)
    if nhwc:
        w = w.contiguous(memory_format=torch.channels_last)
    groups = op.attr('groups', 1) or 1
    if op.type == 'depthwise_conv2d':
        groups = x.shape[1]
    out_dtype = x.dtype
    if x.dtype == torch.bfloat16 and x.device.type == 'cpu':
        x, w = x.float(), w.float()
    out = F.conv2d(x, w, None, stride=tuple(op.attr('strides', [1, 1])),
                   padding=tuple(op.attr('paddings', [0, 0])),
                   dilation=tuple(op.attr('dilations', [1, 1])),
                   groups=groups)
    ctx.set(op.single_output('Output'), _nhwc_view(out.to(out_dtype), nhwc))


def _conv_out_size(in_size, k, pad, stride, dilation):
    if in_size < 0:
        return -1
    eff_k = dilation * (k - 1) + 1
    return (in_size + 2 * pad - eff_k) // stride + 1


def _conv2d_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    w = block.var_recursive(op.single_input('Filter'))
    strides = op.attr('strides', [1, 1])
    paddings = op.attr('paddings', [0, 0])
    dilations = op.attr('dilations', [1, 1])
    nhwc = op.attr('data_format', 'NCHW') == 'NHWC'
    if nhwc:
        n, h, wd, _ = x.shape
    else:
        n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    oh = _conv_out_size(h, kh, paddings[0], strides[0], dilations[0])
    ow = _conv_out_size(wd, kw, paddings[1], strides[1], dilations[1])
    out = block.var_recursive(op.single_output('Output'))
    out.shape = (n, oh, ow, oc) if nhwc else (n, oc, oh, ow)
    out.dtype = x.dtype


for _conv_type in ('conv2d', 'depthwise_conv2d'):
    register_op(_conv_type, emit=_conv2d_common_emit,
                infer_shape=_conv2d_infer)
    register_vjp_grad(_conv_type, in_slots=('Input', 'Filter'),
                      out_slots=('Output',))


# -- pool2d -------------------------------------------------------------------

def _pool_spatial_pads(in_sizes, ksize, strides, paddings, ceil_mode):
    """(lo, hi) pads per spatial dim; ceil_mode adds asymmetric right
    padding so the window count is the ceil formula's."""
    pads = []
    for i, n in enumerate(in_sizes):
        if ceil_mode:
            out = (n - ksize[i] + 2 * paddings[i] + strides[i] - 1) \
                // strides[i] + 1
        else:
            out = (n - ksize[i] + 2 * paddings[i]) // strides[i] + 1
        extra = (out - 1) * strides[i] + ksize[i] - (n + 2 * paddings[i])
        pads.append((paddings[i], paddings[i] + max(extra, 0)))
    return pads


@op_emitter('pool2d')
def _pool2d_emit(ctx, op):
    """Max or average pooling over explicit (lo, hi) pads: -inf pads for
    max; for avg the window sum over zero pads, divided by the count of
    real elements (exclusive, when padded) or by the window size."""
    nhwc = _nhwc(op)
    x = _nchw_view(ctx.get(op.single_input('X')), nhwc)
    ptype = op.attr('pooling_type', 'max')
    ksize = list(op.attr('ksize'))
    strides = list(op.attr('strides', [1, 1]))
    paddings = list(op.attr('paddings', [0, 0]))
    if op.attr('global_pooling', False):
        ksize = [x.shape[2], x.shape[3]]
        strides = [1, 1]
        paddings = [0, 0]
    (hlo, hhi), (wlo, whi) = _pool_spatial_pads(
        [x.shape[2], x.shape[3]], ksize, strides, paddings,
        op.attr('ceil_mode', False))
    pad = (wlo, whi, hlo, hhi)
    padded = any(pad)
    if ptype == 'max':
        xp = F.pad(x, pad, value=float('-inf')) if padded else x
        out = F.max_pool2d(xp, ksize, strides)
    else:
        xp = F.pad(x, pad) if padded else x
        summed = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
        if op.attr('exclusive', True) and padded:
            ones = F.pad(torch.ones_like(x[:1, :1]), pad)
            counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
            out = summed / counts
        else:
            out = summed / (ksize[0] * ksize[1])
    ctx.set(op.single_output('Out'), _nhwc_view(out.to(x.dtype), nhwc))


def _pool2d_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    nhwc = op.attr('data_format', 'NCHW') == 'NHWC'
    if nhwc:
        n, h, w, c = x.shape
    else:
        n, c, h, w = x.shape
    out = block.var_recursive(op.single_output('Out'))
    if op.attr('global_pooling', False):
        out.shape = (n, 1, 1, c) if nhwc else (n, c, 1, 1)
    else:
        ksize = op.attr('ksize')
        strides = op.attr('strides', [1, 1])
        paddings = op.attr('paddings', [0, 0])

        def osz(i, k, p, s):
            if i < 0:
                return -1
            if op.attr('ceil_mode', False):
                return (i - k + 2 * p + s - 1) // s + 1
            return (i - k + 2 * p) // s + 1
        oh = osz(h, ksize[0], paddings[0], strides[0])
        ow = osz(w, ksize[1], paddings[1], strides[1])
        out.shape = (n, oh, ow, c) if nhwc else (n, c, oh, ow)
    out.dtype = x.dtype


register_op('pool2d', infer_shape=_pool2d_infer)
register_vjp_grad('pool2d')


# -- batch_norm ---------------------------------------------------------------
# MeanOut/VarianceOut are written as new tensors under the same
# persistable names as Mean/Variance (ctx.set rebinds them in the Scope);
# nothing is updated in place, so no autograd record that holds the old
# tensor can see it change.

def _bn_axes(x, layout):
    """(reduced axes, per-channel broadcast shape) for NCHW or NHWC."""
    ch = 1 if layout == 'NCHW' else x.ndim - 1
    ch_shape = [1] * x.ndim
    ch_shape[ch] = -1
    return tuple(i for i in range(x.ndim) if i != ch), ch_shape


def _bn_batch_stats(x, axes):
    """Single-pass batch statistics in fp32: sum and sum of squares, with
    the clamp that guards E[x²] - E[x]² against cancellation."""
    xf = x.float()
    m = 1
    for i in axes:
        m *= x.shape[i]
    mean = torch.sum(xf, dim=axes) / m
    var = torch.clamp(torch.sum(xf * xf, dim=axes) / m - mean * mean,
                      min=0.0)
    return mean, var


@op_emitter('batch_norm')
def _batch_norm_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    scale = ctx.get(op.single_input('Scale'))
    bias = ctx.get(op.single_input('Bias'))
    mean = ctx.get(op.single_input('Mean'))
    var = ctx.get(op.single_input('Variance'))
    eps = op.attr('epsilon', 1e-5)
    momentum = op.attr('momentum', 0.9)
    is_test = op.attr('is_test', False) or ctx.is_test
    axes, ch_shape = _bn_axes(x, op.attr('data_layout', 'NCHW'))
    if is_test:
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        use_mean, use_var = _bn_batch_stats(x, axes)
        mean_out = mean * momentum + use_mean * (1 - momentum)
        var_out = var * momentum + use_var * (1 - momentum)
    # the affine folded into one per-channel (a, b): y = x·a + b
    inv_std = torch.rsqrt(use_var.float() + eps)
    a = scale.float() * inv_std
    b = bias.float() - use_mean.float() * a
    y = x.float() * a.reshape(ch_shape) + b.reshape(ch_shape)
    ctx.set(op.single_output('Y'), y.to(x.dtype))
    for slot, val in (('MeanOut', mean_out), ('VarianceOut', var_out),
                      ('SavedMean', use_mean), ('SavedVariance', use_var)):
        if op.output(slot):
            ctx.set(op.single_output(slot), val)


def _batch_norm_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    layout = op.attr('data_layout', 'NCHW')
    c = x.shape[1] if layout == 'NCHW' else x.shape[-1]
    y = block.var_recursive(op.single_output('Y'))
    y.shape = x.shape
    y.dtype = x.dtype
    for slot in ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = (c,)
            v.dtype = 'float32'


def _batch_norm_grad(op, block):
    """Grads of X, Scale and Bias only (the running statistics are
    state); the grad op reads the saved batch statistics."""
    attrs = dict(op.attrs)
    attrs['__fwd_inputs__'] = {k: list(v) for k, v in op.inputs.items()}
    attrs['__fwd_outputs__'] = {k: list(v) for k, v in op.outputs.items()}
    inputs = {'X': list(op.input('X')), 'Scale': list(op.input('Scale')),
              'Bias': list(op.input('Bias')), 'Mean': list(op.input('Mean')),
              'Variance': list(op.input('Variance')),
              'Y@GRAD': [grad_var_name(op.single_output('Y'))]}
    if op.output('SavedMean'):
        inputs['SavedMean'] = list(op.output('SavedMean'))
    if op.output('SavedVariance'):
        inputs['SavedVariance'] = list(op.output('SavedVariance'))
    outputs = {'X@GRAD': [grad_var_name(op.single_input('X'))],
               'Scale@GRAD': [grad_var_name(op.single_input('Scale'))],
               'Bias@GRAD': [grad_var_name(op.single_input('Bias'))]}
    return [dict(type='batch_norm_grad', inputs=inputs, outputs=outputs,
                 attrs=attrs)]


@op_emitter('batch_norm_grad')
def _batch_norm_grad_emit(ctx, op):
    """Closed-form BN backward, in fp32. Training mode (the batch
    statistics carry gradient):
        dx     = scale·inv_std/m · (m·dy - Σdy - x̂·Σ(dy·x̂))
        dscale = Σ(dy·x̂),  dbias = Σdy
    Test mode (running statistics are constants): dx = dy·scale·inv_std."""
    fwd_inputs = op.attr('__fwd_inputs__')
    x = ctx.get(fwd_inputs['X'][0])
    scale = ctx.get(fwd_inputs['Scale'][0])
    bias = ctx.get(fwd_inputs['Bias'][0])
    gy = ctx.get(op.single_input('Y@GRAD'))
    eps = op.attr('epsilon', 1e-5)
    is_test = op.attr('is_test', False) or ctx.is_test
    axes, ch_shape = _bn_axes(x, op.attr('data_layout', 'NCHW'))
    m = 1
    for i in axes:
        m *= x.shape[i]
    xf, gyf, scale_f = x.float(), gy.float(), scale.float()
    if is_test:
        mean = ctx.get(fwd_inputs['Mean'][0]).float()
        var = ctx.get(fwd_inputs['Variance'][0]).float()
    elif op.input('SavedMean') and op.input('SavedVariance'):
        mean = ctx.get(op.single_input('SavedMean')).float()
        var = ctx.get(op.single_input('SavedVariance')).float()
    else:
        mean, var = _bn_batch_stats(x, axes)
    inv_std = torch.rsqrt(var + eps)
    xhat = (xf - mean.reshape(ch_shape)) * inv_std.reshape(ch_shape)
    sum_dy = torch.sum(gyf, dim=axes)
    sum_dy_xhat = torch.sum(gyf * xhat, dim=axes)
    if is_test:
        gx = gyf * (scale_f * inv_std).reshape(ch_shape)
    else:
        coef = (scale_f * inv_std) / m
        gx = coef.reshape(ch_shape) * (m * gyf - sum_dy.reshape(ch_shape)
                                       - xhat * sum_dy_xhat.reshape(ch_shape))
    ctx.set(op.single_output('X@GRAD'), gx.to(x.dtype))
    ctx.set(op.single_output('Scale@GRAD'), sum_dy_xhat.to(scale.dtype))
    ctx.set(op.single_output('Bias@GRAD'), sum_dy.to(bias.dtype))


register_op('batch_norm', infer_shape=_batch_norm_infer, grad=_batch_norm_grad)


@op_emitter('layer_norm')
def _layer_norm_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    eps = op.attr('epsilon', 1e-5)
    begin = op.attr('begin_norm_axis', 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = [1] * begin + list(x.shape[begin:])
    if op.input('Scale'):
        y = y * ctx.get(op.single_input('Scale')).reshape(norm_shape)
    if op.input('Bias'):
        y = y + ctx.get(op.single_input('Bias')).reshape(norm_shape)
    ctx.set(op.single_output('Y'), y.to(x.dtype))
    if op.output('Mean'):
        ctx.set(op.single_output('Mean'), mean.reshape(x.shape[:begin]))
    if op.output('Variance'):
        ctx.set(op.single_output('Variance'), var.reshape(x.shape[:begin]))


def _layer_norm_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    begin = op.attr('begin_norm_axis', 1)
    y = block.var_recursive(op.single_output('Y'))
    y.shape = x.shape
    y.dtype = x.dtype
    for slot in ('Mean', 'Variance'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = tuple(x.shape[:begin])
            v.dtype = 'float32'


register_op('layer_norm', infer_shape=_layer_norm_infer)
register_vjp_grad('layer_norm', in_slots=('X', 'Scale', 'Bias'),
                  out_slots=('Y',))


@op_emitter('softmax')
def _softmax_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    # reduce in fp32, as the JAX package does for every dtype; under AMP
    # the probabilities stay fp32
    out = torch.softmax(x.float(), dim=-1)
    ctx.set(op.single_output('Out'), out if ctx.amp else out.to(x.dtype))


register_op('softmax', infer_shape=same_shape_infer())
register_vjp_grad('softmax')


@op_emitter('cross_entropy')
def _cross_entropy_emit(ctx, op):
    x = ctx.get(op.single_input('X'))          # probabilities
    label = ctx.get(op.single_input('Label'))
    eps = 1e-8
    if op.attr('soft_label', False):
        loss = -torch.sum(label * torch.log(torch.clamp(x, min=eps)),
                          dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        lbl = lbl.long()
        picked = torch.gather(x, -1, lbl[..., None])
        loss = -torch.log(torch.clamp(picked, min=eps))
        loss = loss.masked_fill(lbl[..., None] == op.attr('ignore_index',
                                                          -100), 0.0)
    ctx.set(op.single_output('Y'), loss)


def _cross_entropy_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_output('Y'))
    y.shape = tuple(x.shape[:-1]) + (1,)
    y.dtype = x.dtype


register_op('cross_entropy', infer_shape=_cross_entropy_infer)
register_vjp_grad('cross_entropy', in_slots=('X',), out_slots=('Y',),
                  nondiff_slots=('Label',))


@op_emitter('softmax_with_cross_entropy')
def _swce_emit(ctx, op):
    logits = ctx.get(op.single_input('Logits'))
    label = ctx.get(op.single_input('Label'))
    # normalised in fp32 whatever the stream's dtype, as the JAX package
    # does: a 32k-way logsumexp loses precision in bf16
    log_sm = F.log_softmax(logits.float(), dim=-1)
    ctx.set(op.single_output('Softmax'), torch.exp(log_sm).to(logits.dtype))
    if op.attr('soft_label', False):
        loss = -torch.sum(label * log_sm, dim=-1, keepdim=True)
    else:
        lbl = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 \
            else label
        ignored = (lbl == op.attr('ignore_index', -100))[..., None]
        picked = torch.gather(log_sm, -1,
                              lbl.long().masked_fill(
                                  ignored[..., 0], 0)[..., None])
        loss = (-picked).masked_fill(ignored, 0.0)
    ctx.set(op.single_output('Loss'), loss)


def _swce_infer(op, block):
    x = block.var_recursive(op.single_input('Logits'))
    loss = block.var_recursive(op.single_output('Loss'))
    loss.shape = tuple(x.shape[:-1]) + (1,)
    loss.dtype = x.dtype
    sm = block.var_recursive(op.single_output('Softmax'))
    sm.shape = x.shape
    sm.dtype = x.dtype


register_op('softmax_with_cross_entropy', infer_shape=_swce_infer)
register_vjp_grad('softmax_with_cross_entropy', in_slots=('Logits',),
                  out_slots=('Loss',), nondiff_slots=('Label',))


@op_emitter('sigmoid_cross_entropy_with_logits')
def _sce_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    label = ctx.get(op.single_input('Label'))
    # the numerically stable form of binary cross-entropy on logits
    loss = torch.clamp(x, min=0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    ctx.set(op.single_output('Out'),
            loss.masked_fill(label == op.attr('ignore_index', -100), 0.0))


register_op('sigmoid_cross_entropy_with_logits',
            infer_shape=same_shape_infer())
register_vjp_grad('sigmoid_cross_entropy_with_logits', in_slots=('X',),
                  nondiff_slots=('Label',))


@op_emitter('square_error_cost')
def _square_error_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    ctx.set(op.single_output('Out'), torch.square(x - y))


register_op('square_error_cost', infer_shape=same_shape_infer())
register_vjp_grad('square_error_cost', in_slots=('X', 'Y'))


# -- dropout: the mask comes from the executor's generator -------------------

@op_emitter('dropout')
def _dropout_emit(ctx, op):
    """Out and Mask (grad = dOut·Mask). downgrade_in_infer: Out = x·keep
    in training, x·(1 − p) in test; upscale_in_train: Out = x·keep/(1 −
    p) in training, x in test, and the Mask carries the 1/(1 − p)."""
    x = ctx.get(op.single_input('X'))
    p = op.attr('dropout_prob', 0.5)
    upscale = op.attr('dropout_implementation',
                      'downgrade_in_infer') == 'upscale_in_train'
    if op.attr('is_test', False) or ctx.is_test:
        out = x if upscale else x * (1.0 - p)
        mask = torch.ones_like(x)
    else:
        keep = torch.rand(x.shape, generator=ctx.generator(op),
                          device=x.device) < (1.0 - p)
        mask = keep.to(x.dtype)
        kept = x
        if upscale:
            mask = mask / (1.0 - p)
            kept = x / (1.0 - p)
        out = torch.where(keep, kept, torch.zeros_like(x))
    ctx.set(op.single_output('Out'), out)
    if op.output('Mask'):
        ctx.set(op.single_output('Mask'), mask)


def _dropout_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    for slot in ('Out', 'Mask'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = x.shape
            v.dtype = x.dtype


def _dropout_grad(op, block):
    return [dict(type='dropout_grad',
                 inputs={'Mask': list(op.output('Mask')),
                         'Out@GRAD': [grad_var_name(op.single_output('Out'))]},
                 outputs={'X@GRAD': [grad_var_name(op.single_input('X'))]},
                 attrs=dict(op.attrs))]


@op_emitter('dropout_grad')
def _dropout_grad_emit(ctx, op):
    ctx.set(op.single_output('X@GRAD'),
            ctx.get(op.single_input('Out@GRAD')) *
            ctx.get(op.single_input('Mask')))


register_op('dropout', infer_shape=_dropout_infer, grad=_dropout_grad)


@op_emitter('lookup_table')
def _lookup_table_emit(ctx, op):
    w = ctx.get(op.single_input('W'))
    ids = ctx.get(op.single_input('Ids'))
    squeeze_last = ids.ndim > 1 and ids.shape[-1] == 1
    flat = ids.reshape(ids.shape[:-1]) if squeeze_last else ids
    out = w[flat.long()]
    pad = op.attr('padding_idx', -1)
    if pad != -1:
        out = out.masked_fill((flat == pad).unsqueeze(-1), 0.0)
    # under AMP the embedding starts the bf16 activation stream
    ctx.set(op.single_output('Out'), amp_cast(ctx, out))


def _lookup_table_infer(op, block):
    w = block.var_recursive(op.single_input('W'))
    ids = block.var_recursive(op.single_input('Ids'))
    out = block.var_recursive(op.single_output('Out'))
    ids_shape = tuple(ids.shape)
    if ids_shape and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    out.shape = ids_shape + (w.shape[-1],)
    out.dtype = w.dtype
    out.lod_level = ids.lod_level


def _lookup_table_grad_maker(op, block):
    inputs = {'Ids': list(op.input('Ids')), 'W': list(op.input('W')),
              'Out@GRAD': [grad_var_name(op.single_output('Out'))]}
    outputs = {'W@GRAD': [grad_var_name(op.single_input('W'))]}
    return [dict(type='lookup_table_grad', inputs=inputs, outputs=outputs,
                 attrs=dict(op.attrs))]


@op_emitter('lookup_table_grad')
def _lookup_table_grad_emit(ctx, op):
    """Dense scatter-add of the upstream rows into a zero table. The JAX
    package's is_sparse=True SelectedRows grad is not ported: its dense
    form (the merged rows) is computed instead."""
    w = ctx.get(op.single_input('W'))
    ids = ctx.get(op.single_input('Ids'))
    gout = ctx.get(op.single_input('Out@GRAD'))
    squeeze_last = ids.ndim > 1 and ids.shape[-1] == 1
    flat = (ids.reshape(ids.shape[:-1]) if squeeze_last else ids)
    flat = flat.reshape(-1).long()
    rows_g = gout.reshape((flat.numel(),) + tuple(w.shape[1:])).to(w.dtype)
    pad = op.attr('padding_idx', -1)
    if pad != -1:
        rows_g = rows_g.masked_fill((flat == pad).unsqueeze(-1), 0.0)
    gw = torch.zeros_like(w).index_add_(0, flat, rows_g)
    ctx.set(op.single_output('W@GRAD'), gw)


register_op('lookup_table', infer_shape=_lookup_table_infer,
            grad=_lookup_table_grad_maker)


# -- accuracy -----------------------------------------------------------------

@op_emitter('accuracy')
def _accuracy_emit(ctx, op):
    pred_idx = ctx.get(op.single_input('Indices'))   # [N, k] top-k indices
    label = ctx.get(op.single_input('Label'))        # [N, 1]
    n = pred_idx.shape[0]
    correct = torch.sum(torch.any(pred_idx == label.reshape(-1, 1), dim=1))
    ctx.set(op.single_output('Accuracy'),
            (correct.float() / n).to(torch.float32))
    if op.output('Correct'):
        ctx.set(op.single_output('Correct'), correct.to(torch.int32))
    if op.output('Total'):
        ctx.set(op.single_output('Total'),
                torch.full((), n, dtype=torch.int32, device=pred_idx.device))


def _accuracy_infer(op, block):
    acc = block.var_recursive(op.single_output('Accuracy'))
    acc.shape = ()
    acc.dtype = 'float32'
    for slot in ('Correct', 'Total'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = ()
            v.dtype = 'int32'


register_op('accuracy', infer_shape=_accuracy_infer, no_grad=True)


@op_emitter('causal_mask')
def _causal_mask_emit(ctx, op):
    """Set future positions of [..., Tq, Tk] scores to -1e9 (not -inf):
    masked lanes underflow to exact zeros after the softmax's exp."""
    s = ctx.get(op.single_input('X'))
    Tq, Tk = s.shape[-2], s.shape[-1]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=s.device).tril()
    ctx.set(op.single_output('Out'), s.masked_fill(~mask, -1e9))


register_op('causal_mask', infer_shape=same_shape_infer())
register_vjp_grad('causal_mask')


@op_emitter('position_embedding')
def _position_embedding_emit(ctx, op):
    x = ctx.get(op.single_input('X'))          # [B, T, D]
    pos = ctx.get(op.single_input('Pos'))      # [max_len, D]
    T = x.shape[1]
    ctx.set(op.single_output('Out'),
            pos[None, :T, :].expand(x.shape).to(x.dtype))


def _position_embedding_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


register_op('position_embedding', infer_shape=_position_embedding_infer)
register_vjp_grad('position_embedding', in_slots=('Pos',),
                  nondiff_slots=('X',))
