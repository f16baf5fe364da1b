"""The fused conv2d_bn op (counterpart of paddle_tpu/ops/fused_ops.py
:27-133): convolution + batch normalization + activation as ONE op.

- 1x1 convolutions (no padding) are a matrix product over the
  NHWC-flattened activations: x [N, C, H, W] is strided, laid out as
  [M = N·Ho·Wo, C], and multiplied by the filter through
  kernels.conv_bn.matmul_bn_stats, which also returns the column sums of
  y and y² in fp32. The batch statistics come from those sums
  (var = q/M - mean², no clamp), so the normalisation needs no second
  read of the conv output. y is rounded to the stream dtype by the
  kernel and widened to fp32 for the normalisation, as in the JAX
  package. is_test takes a plain fp32 product and the running
  statistics.
- k x k convolutions take the composite path: F.conv2d, then two-pass
  fp32 mean and variance.
- act is any activation the JAX package takes from jax.nn by name
  (ACTIVATIONS), applied in fp32 before y is cast to the stream dtype.

FLAGS_use_pallas_fused_ops is read when the op runs: set, CUDA tensors
launch the hand-written kernel K6 (and a failed build or launch
raises); cleared, or on CPU tensors, the plain PyTorch version runs.
The running statistics are written as new tensors under the Mean and
Variance names (nothing is updated in place), detached from the
recorded forward so no autograd graph outlives the step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..flags import get_flag
from ..kernels.conv_bn import matmul_bn_stats
from ..registry import register_op, op_emitter, register_vjp_grad, amp_cast
from .nn_ops import _conv_out_size

# The activations a Fluid program names in conv2d_bn's act, each as the
# jax.nn function of that name computes it, with its defaults: gelu's
# tanh approximation, leaky_relu's slope 0.01, elu and celu at alpha 1,
# hard_sigmoid = relu6(x + 3) / 6.
ACTIVATIONS = {
    'relu': torch.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    'elu': F.elu,
    'softplus': lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    'silu': F.silu,
    'swish': F.silu,
    'relu6': F.relu6,
    'leaky_relu': lambda x: F.leaky_relu(x, 0.01),
    'hard_tanh': F.hardtanh,
    'soft_sign': F.softsign,
    'log_sigmoid': F.logsigmoid,
    'selu': F.selu,
    'celu': F.celu,
    'hard_sigmoid': F.hardsigmoid,
    'hard_swish': F.hardswish,
}


def _activation(act):
    """conv2d_bn's act by name; an unknown name raises, as the JAX
    package's getattr(jax.nn, act) does."""
    try:
        return ACTIVATIONS[act]
    except KeyError:
        raise ValueError('conv2d_bn act=%r: not an activation of jax.nn '
                         'that the port knows (%s)'
                         % (act, ', '.join(sorted(ACTIVATIONS)))) from None


@op_emitter('conv2d_bn')
def _conv2d_bn_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))      # NCHW
    w = ctx.get(op.single_input('Filter'))     # OIHW
    scale = ctx.get(op.single_input('Scale'))
    bias = ctx.get(op.single_input('Bias'))
    mean = ctx.get(op.single_input('Mean'))
    var = ctx.get(op.single_input('Variance'))
    x, w = amp_cast(ctx, x, w)
    strides = list(op.attr('strides', [1, 1]))
    paddings = list(op.attr('paddings', [0, 0]))
    eps = op.attr('epsilon', 1e-5)
    momentum = op.attr('momentum', 0.9)
    act = op.attr('act', None)
    is_test = op.attr('is_test', False) or ctx.is_test
    out_dtype = x.dtype

    O, I, kh, kw = w.shape
    if kh == 1 and kw == 1 and paddings == [0, 0]:
        xs = x[:, :, ::strides[0], ::strides[1]]
        N, C, Ho, Wo = xs.shape
        M = N * Ho * Wo
        x2d = xs.permute(0, 2, 3, 1).reshape(M, C)
        w2d = w.reshape(O, I).t()
        if is_test:
            y2d = torch.matmul(x2d.float(), w2d.float())
            use_mean, use_var = mean, var
        else:
            y2d, s, q = matmul_bn_stats(
                x2d, w2d, force_plain=not get_flag('use_pallas_fused_ops'))
            y2d = y2d.float()
            use_mean = s / M
            use_var = q / M - use_mean * use_mean
        yn = (y2d - use_mean) * torch.rsqrt(use_var.float() + eps)
        yn = yn * scale.float() + bias.float()
        y = yn.reshape(N, Ho, Wo, O).permute(0, 3, 1, 2)
    else:
        cx, cw = x, w
        if x.dtype == torch.bfloat16 and x.device.type == 'cpu':
            cx, cw = x.float(), w.float()
        conv = F.conv2d(cx, cw, None, stride=tuple(strides),
                        padding=tuple(paddings))
        cf = conv.float()
        if is_test:
            use_mean, use_var = mean, var
        else:
            use_var, use_mean = torch.var_mean(cf, dim=(0, 2, 3),
                                               correction=0)
        ch = [1, -1, 1, 1]
        y = ((cf - use_mean.reshape(ch))
             * torch.rsqrt(use_var.float() + eps).reshape(ch)
             * scale.float().reshape(ch) + bias.float().reshape(ch))

    if act:
        y = _activation(act)(y)
    ctx.set(op.single_output('Y'), y.to(out_dtype))

    if is_test:
        mean_out, var_out = mean, var
        saved_mean, saved_var = mean, var
    else:
        saved_mean = use_mean.detach().float()
        saved_var = use_var.detach().float()
        mean_out = mean * momentum + saved_mean * (1 - momentum)
        var_out = var * momentum + saved_var * (1 - momentum)
    for slot, val in (('MeanOut', mean_out), ('VarianceOut', var_out),
                      ('SavedMean', saved_mean),
                      ('SavedVariance', saved_var)):
        if op.output(slot):
            ctx.set(op.single_output(slot), val)


def _conv2d_bn_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    w = block.var_recursive(op.single_input('Filter'))
    strides = op.attr('strides', [1, 1])
    paddings = op.attr('paddings', [0, 0])
    n, _, h, wd = x.shape
    o, _, kh, kw = w.shape
    y = block.var_recursive(op.single_output('Y'))
    y.shape = [n, o, _conv_out_size(h, kh, paddings[0], strides[0], 1),
               _conv_out_size(wd, kw, paddings[1], strides[1], 1)]
    y.dtype = x.dtype
    for slot in ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = (o,)
            v.dtype = 'float32'


register_op('conv2d_bn', infer_shape=_conv2d_bn_infer)
register_vjp_grad('conv2d_bn',
                  in_slots=('Input', 'Filter', 'Scale', 'Bias'),
                  out_slots=('Y',))
