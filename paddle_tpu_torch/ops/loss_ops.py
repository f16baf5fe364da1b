"""The loss ops of paddle_tpu/ops/loss_ops.py: hinge_loss :34, log_loss
:49, margin_rank_loss :64, squared_l2_distance :83, maxout :198,
sampling_id :224, nce :247, hierarchical_sigmoid :319 and
fused_softmax_cross_entropy, the LM-head loss without a logits tensor
in device memory across the step (:126-191).

sampling_id and nce draw from the Executor's generators (registered
with the CUDA graph of their segment, as dropout's are), so they do not
reproduce jax.random's numbers. nce's grad differentiates the recorded
forward, so it sees the negatives its forward drew; the JAX package
keys its draw on the op's rng_tag for that.

fused_softmax_cross_entropy:

The head product and the loss are one op, computed over chunks of
`chunk` tokens. The JAX package scans the chunks with a jax.checkpoint
body, so XLA recomputes each chunk's [chunk, V] logits in the backward.
Here one torch.autograd.Function does the same by hand: its forward
keeps only x, W, the bias and the labels, and its backward recomputes
each chunk's logits, forms softmax - onehot, and accumulates
dX = dlogits·Wᵀ, dW = Σ xᵀ·dlogits and dBias = Σ dlogits. A saved
autograd graph would instead keep every chunk's fp32 logits alive until
the grad op runs (0.54 GB per 4096-token chunk at vocab 32768).

inputs:  X [..., D] features, W [D, V], optional Bias [V], Label [..., 1]
outputs: Loss [..., 1] fp32 (0 where Label == ignore_index)
attrs:   chunk (tokens per chunk, default 1024), ignore_index
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import (register_op, op_emitter, register_vjp_grad,
                        same_shape_infer, amp_cast)


def _chunk_logits(x, w, bias):
    logits = torch.matmul(x, w).float()
    if bias is not None:
        logits = logits + bias.float()
    return logits


class FusedHeadLoss(torch.autograd.Function):
    """loss[n] = logsumexp(x[n]·W + b) - (x[n]·W + b)[label[n]], 0 for
    ignored rows; x [N, D] and W [D, V] in one dtype (bf16 under AMP),
    logits and loss in fp32."""

    @staticmethod
    def forward(ctx, x, w, bias, label, chunk, ignore_index):
        N = x.shape[0]
        valid = label != ignore_index
        safe = torch.where(valid, label, torch.zeros_like(label))
        loss = torch.empty((N,), dtype=torch.float32, device=x.device)
        for s in range(0, N, chunk):
            e = min(s + chunk, N)
            logits = _chunk_logits(x[s:e], w, bias)
            picked = logits.gather(1, safe[s:e, None])[:, 0]
            loss[s:e] = torch.where(valid[s:e],
                                    torch.logsumexp(logits, dim=-1) - picked,
                                    torch.zeros_like(picked))
        ctx.save_for_backward(x, w, bias, safe, valid)
        ctx.chunk = chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, bias, safe, valid = ctx.saved_tensors
        N = x.shape[0]
        coef = torch.where(valid, g.float(), torch.zeros_like(g.float()))
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = None if bias is None else torch.zeros(
            bias.shape, dtype=torch.float32, device=bias.device)
        for s in range(0, N, ctx.chunk):
            e = min(s + ctx.chunk, N)
            # recompute the chunk's logits: softmax - onehot, scaled by
            # the incoming grad of each row's loss
            dlog = torch.softmax(_chunk_logits(x[s:e], w, bias), dim=-1)
            rows = torch.arange(e - s, device=x.device)
            dlog[rows, safe[s:e]] -= 1.0
            dlog *= coef[s:e, None]
            dl = dlog.to(w.dtype)
            dx[s:e] = torch.matmul(dl, w.t())
            dw += torch.matmul(x[s:e].t(), dl).float()
            if db is not None:
                db += dlog.sum(dim=0)
        return (dx, dw.to(w.dtype),
                None if db is None else db.to(bias.dtype), None, None, None)


@op_emitter('fused_softmax_cross_entropy')
def _fused_swce_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    w = ctx.get(op.single_input('W'))
    bias = ctx.get(op.single_input('Bias')) if op.input('Bias') else None
    label = ctx.get(op.single_input('Label'))
    lead = tuple(x.shape[:-1])
    x2, wc = amp_cast(ctx, x.reshape(-1, x.shape[-1]), w)
    loss = FusedHeadLoss.apply(x2, wc, bias, label.reshape(-1).long(),
                               max(1, int(op.attr('chunk', 1024))),
                               int(op.attr('ignore_index', -100)))
    ctx.set(op.single_output('Loss'), loss.reshape(lead + (1,)))


def _fused_swce_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    loss = block.var_recursive(op.single_output('Loss'))
    loss.shape = tuple(x.shape[:-1]) + (1,)
    loss.dtype = 'float32'


register_op('fused_softmax_cross_entropy', infer_shape=_fused_swce_infer)
register_vjp_grad('fused_softmax_cross_entropy',
                  in_slots=('X', 'W', 'Bias'), out_slots=('Loss',),
                  nondiff_slots=('Label',))


# -- element-wise losses --------------------------------------------------------

@op_emitter('hinge_loss')
def _hinge_loss_emit(ctx, op):
    logits = ctx.get(op.single_input('Logits'))
    labels = ctx.get(op.single_input('Labels'))   # {0, 1}
    sign = 2.0 * labels.to(logits.dtype) - 1.0
    ctx.set(op.single_output('Loss'), torch.clamp_min(1.0 - sign * logits,
                                                      0.0))


register_op('hinge_loss', infer_shape=same_shape_infer('Logits', 'Loss'))
register_vjp_grad('hinge_loss', in_slots=('Logits',), out_slots=('Loss',),
                  nondiff_slots=('Labels',))


@op_emitter('log_loss')
def _log_loss_emit(ctx, op):
    p = ctx.get(op.single_input('Predicted'))
    y = ctx.get(op.single_input('Labels'))
    eps = op.attr('epsilon', 1e-4)
    ctx.set(op.single_output('Loss'),
            -y * torch.log(p + eps) - (1.0 - y) * torch.log(1.0 - p + eps))


register_op('log_loss', infer_shape=same_shape_infer('Predicted', 'Loss'))
register_vjp_grad('log_loss', in_slots=('Predicted',), out_slots=('Loss',),
                  nondiff_slots=('Labels',))


@op_emitter('margin_rank_loss')
def _margin_rank_loss_emit(ctx, op):
    x1 = ctx.get(op.single_input('X1'))
    x2 = ctx.get(op.single_input('X2'))
    label = ctx.get(op.single_input('Label'))     # +1: x1 ranks higher
    out = torch.clamp_min(-label * (x1 - x2) + op.attr('margin', 0.0), 0.0)
    ctx.set(op.single_output('Out'), out)
    if op.output('Activated'):
        ctx.set(op.single_output('Activated'), (out > 0).to(x1.dtype))


register_op('margin_rank_loss', infer_shape=same_shape_infer('X1', 'Out'))
register_vjp_grad('margin_rank_loss', in_slots=('X1', 'X2'),
                  out_slots=('Out',), nondiff_slots=('Label',))


@op_emitter('squared_l2_distance')
def _squared_l2_distance_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))             # may broadcast as [1, D]
    sub = (x - y).expand(x.shape)
    ctx.set(op.single_output('sub_result'), sub)
    ctx.set(op.single_output('Out'),
            torch.sum(sub * sub, dim=tuple(range(1, sub.ndim)),
                      keepdim=True))


def _sql2_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    sub = block.var_recursive(op.single_output('sub_result'))
    sub.shape = x.shape
    sub.dtype = x.dtype
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [x.shape[0], 1]
    out.dtype = x.dtype


register_op('squared_l2_distance', infer_shape=_sql2_infer)
register_vjp_grad('squared_l2_distance', in_slots=('X', 'Y'),
                  out_slots=('Out',))


# -- maxout: NCHW channel groups reduced by their max ---------------------------

@op_emitter('maxout')
def _maxout_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    groups = op.attr('groups')
    n, c, h, w = x.shape
    ctx.set(op.single_output('Out'),
            x.reshape(n, c // groups, groups, h, w).amax(dim=2))


def _maxout_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    groups = op.attr('groups')
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [x.shape[0], x.shape[1] // groups, x.shape[2], x.shape[3]]
    out.dtype = x.dtype


register_op('maxout', infer_shape=_maxout_infer)
register_vjp_grad('maxout', in_slots=('X',))


# -- sampling_id: one categorical draw per row ----------------------------------

@op_emitter('sampling_id', stateful=True)
def _sampling_id_emit(ctx, op):
    """The Gumbel-max draw jax.random.categorical makes: argmax of
    log(p) plus Gumbel noise, from the executor's generator (no host
    read, so it captures)."""
    x = ctx.get(op.single_input('X'))             # [B, C] probabilities
    u = torch.rand(x.shape, generator=ctx.generator(op), device=x.device,
                   dtype=x.dtype).clamp_min(torch.finfo(x.dtype).tiny)
    gumbel = -torch.log(-torch.log(u))
    ids = torch.argmax(torch.log(torch.clamp_min(x, 1e-30)) + gumbel, dim=-1)
    ctx.set(op.single_output('Out'), ids.to(torch.int64))


def _sampling_id_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [x.shape[0]]
    out.dtype = 'int64'


register_op('sampling_id', infer_shape=_sampling_id_infer, no_grad=True)


# -- nce: noise-contrastive estimation with uniform noise -----------------------

@op_emitter('nce', stateful=True)
def _nce_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))         # [B, D]
    label = ctx.get(op.single_input('Label'))     # [B] or [B, 1]
    w = ctx.get(op.single_input('Weight'))        # [C, D]
    bias = ctx.get(op.single_input('Bias')) if op.input('Bias') else None
    num_neg = op.attr('num_neg_samples', 10)
    num_classes = op.attr('num_total_classes')
    label = label.reshape(label.shape[0]).long()
    negs = torch.randint(0, num_classes, (x.shape[0], num_neg),
                         generator=ctx.generator(op), device=x.device)

    def logit(classes):
        rows = w[classes]                          # [B, ..., D]
        s = (x.reshape((x.shape[0],) + (1,) * (rows.ndim - 2) +
                       (x.shape[1],)) * rows).sum(-1)
        if bias is not None:
            s = s + bias[classes]
        return s

    # uniform noise q = 1/C: the logits are corrected by log(num_neg * q)
    log_nq = float(np.log(np.float32(num_neg / num_classes)))
    s_pos = logit(label) - log_nq                 # [B]
    s_neg = logit(negs) - log_nq                  # [B, S]
    # a binary logistic: the true class target 1, the sampled ones 0
    cost = F.softplus(-s_pos) + F.softplus(s_neg).sum(1)
    if op.input('SampleWeight'):
        sw = ctx.get(op.single_input('SampleWeight')).reshape(-1)
        cost = cost * sw.to(cost.dtype)
    ctx.set(op.single_output('Cost'), cost[:, None])


def _nce_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    out = block.var_recursive(op.single_output('Cost'))
    out.shape = [x.shape[0], 1]
    out.dtype = x.dtype


register_op('nce', infer_shape=_nce_infer)
register_vjp_grad('nce', in_slots=('Input', 'Weight', 'Bias'),
                  out_slots=('Cost',), nondiff_slots=('Label', 'SampleWeight'))


# -- hierarchical_sigmoid over a complete binary code tree ----------------------

@op_emitter('hierarchical_sigmoid')
def _hsigmoid_emit(ctx, op):
    """Leaf label + C of a complete binary heap: its ancestors (the
    internal nodes, root 1) by static shift counts, each a binary
    logistic toward the side the path takes."""
    x = ctx.get(op.single_input('X'))             # [B, D]
    label = ctx.get(op.single_input('Label'))     # [B] or [B, 1]
    w = ctx.get(op.single_input('W'))             # [C - 1, D]
    bias = ctx.get(op.single_input('Bias')) if op.input('Bias') else None
    num_classes = op.attr('num_classes')
    depth = max(1, int(math.ceil(math.log2(num_classes))) + 1)
    code = label.reshape(label.shape[0]).long() + num_classes
    ks = torch.arange(1, depth + 1, device=x.device)
    anc = code[:, None] >> ks
    bits = (code[:, None] >> (ks - 1)) & 1
    nodes = (anc - 1).clamp(0, num_classes - 2)
    s = torch.einsum('bd,bkd->bk', x, w[nodes])
    if bias is not None:
        s = s + bias.reshape(-1)[nodes]
    losses = F.softplus(s) - bits.to(s.dtype) * s
    cost = torch.where(anc >= 1, losses, torch.zeros((), dtype=s.dtype,
                                                     device=s.device))
    ctx.set(op.single_output('Out'), cost.sum(1)[:, None])


def _hsigmoid_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [x.shape[0], 1]
    out.dtype = x.dtype


register_op('hierarchical_sigmoid', infer_shape=_hsigmoid_infer)
register_vjp_grad('hierarchical_sigmoid', in_slots=('X', 'W', 'Bias'),
                  out_slots=('Out',), nondiff_slots=('Label',))
