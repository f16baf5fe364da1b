"""fused_softmax_cross_entropy: the LM-head loss without a logits tensor
in device memory across the step (counterpart of
paddle_tpu/ops/loss_ops.py:126-191).

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

import torch

from ..registry import register_op, op_emitter, register_vjp_grad, amp_cast


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
