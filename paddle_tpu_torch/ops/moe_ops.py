"""Mixture-of-experts FFN ops on one device (counterpart of
paddle_tpu/ops/moe_ops.py): moe_ffn (:77-121) and moe_aux_loss
(:124-147).

moe_ffn routes each token by its gate probabilities:
- `topk` (default): GShard-style capacity dispatch. The top-k mask keeps
  every expert whose gate is at least the k-th largest (ties beyond k
  included), renormalised. Each token's k choices, in slot-major order
  (every first choice before any second), claim slots of a per-expert
  buffer of C = ceil(S * min(k, E) * capacity_factor / E) tokens (C
  static, from the input's shape); a choice past C is dropped. The
  dispatch (0/1) and combine (weighted) lattices are [S, E, C]; the
  expert FFN runs on [E, C, D]. Expert compute is E * C * D * H with
  E * C = k * S * capacity_factor, independent of E.
- `dense`: every token through every expert, weighted by the masked gate.

As in the JAX package:
- the k choices are a stable descending sort of the routing weights, so
  among equal weights the lower expert index comes first (lax.top_k's
  order; torch.topk promises none on the card);
- slot positions are counted in int32 whatever the dtype (in bf16,
  counts past 256 would round);
- nothing is cast: each product runs in the promoted dtype of its
  operands, as jnp.einsum promotes them (under AMP the JAX package
  feeds a bf16 X, an fp32 Gate and fp32 expert weights, so the expert
  products run in fp32 and Out is fp32);
- the gate's grad reaches it only through the combine weights (the
  dispatch lattice is built from comparisons).
The lattice products are plain products (cuBLAS on the card); the JAX
package computes them outside any Pallas kernel too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..registry import register_op, op_emitter, register_vjp_grad

_ACT = {'gelu': lambda v: F.gelu(v, approximate='tanh'), 'relu': F.relu,
        'tanh': torch.tanh, 'sigmoid': torch.sigmoid,
        '': lambda v: v, None: lambda v: v}


def _einsum(eq, *ops):
    """torch.einsum in the promoted dtype of its operands (jnp.einsum's
    promotion; torch.einsum refuses mixed dtypes)."""
    dtype = ops[0].dtype
    for t in ops[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(eq, *(t.to(dtype) for t in ops))


def topk_route(gate, k):
    """The top-k mask of the gate, renormalised; every gate at least the
    k-th largest is kept."""
    E = gate.shape[-1]
    if k >= E:
        return gate
    thresh = torch.sort(gate, dim=-1).values[..., E - k:E - k + 1]
    route = gate * (gate >= thresh).to(gate.dtype)
    return route / torch.clamp(torch.sum(route, -1, keepdim=True), min=1e-9)


def dispatch_combine(route, k, capacity):
    """The [S, E, C] dispatch (0/1) and combine (weighted) lattices of the
    renormalised routing weights [S, E] (module docstring)."""
    S, E = route.shape
    top_i = torch.sort(route, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    rows = torch.arange(S, device=route.device)[:, None]
    top_w = route[rows, top_i]
    flat_e = top_i.t().reshape(-1)                       # [kS] slot-major
    flat_w = top_w.t().reshape(-1)
    e_hit = flat_e[:, None] == torch.arange(E, device=route.device)[None, :]
    e_cnt = e_hit.to(torch.int32)
    # how many earlier choices picked the same expert
    pos = torch.sum((torch.cumsum(e_cnt, 0, dtype=torch.int32) - e_cnt) *
                    e_cnt, -1)
    c_oh = (pos[:, None] == torch.arange(
        capacity, device=route.device)[None, :]).to(route.dtype)
    choice = e_hit.to(route.dtype)[:, :, None] * c_oh[:, None, :]
    dispatch = choice.reshape(k, S, E, capacity).sum(0)
    combine = (choice * flat_w[:, None, None]).reshape(
        k, S, E, capacity).sum(0)
    return dispatch, combine


def capacity(S, k, E, capacity_factor):
    return max(1, int(math.ceil(S * min(k, E) * float(capacity_factor) / E)))


@op_emitter('moe_ffn')
def _moe_ffn_emit(ctx, op):
    x = ctx.get(op.single_input('X'))           # [..., D]
    gate = ctx.get(op.single_input('Gate'))     # [..., E]
    w_up = ctx.get(op.single_input('WUp'))      # [E, D, H]
    w_down = ctx.get(op.single_input('WDown'))  # [E, H, D]
    act = _ACT[op.attr('act', 'gelu')]
    k = op.attr('k', 1)
    E = gate.shape[-1]
    route = topk_route(gate, k)
    if op.attr('dispatch', 'topk') == 'dense':
        h = act(_einsum('...d,edh->...eh', x, w_up))
        y = _einsum('...eh,ehd->...ed', h, w_down)
        out = _einsum('...ed,...e->...d', y, route)
    else:
        D = x.shape[-1]
        S = int(math.prod(x.shape[:-1]))
        C = capacity(S, k, E, op.attr('capacity_factor', 2.0))
        dispatch, combine = dispatch_combine(route.reshape(S, E), min(k, E),
                                             C)
        ein = _einsum('sec,sd->ecd', dispatch, x.reshape(S, D))
        h = act(_einsum('ecd,edh->ech', ein, w_up))
        y = _einsum('ech,ehd->ecd', h, w_down)
        out = _einsum('sec,ecd->sd', combine, y).reshape(
            tuple(x.shape[:-1]) + (y.shape[-1],))
    ctx.set(op.single_output('Out'), out)


def _moe_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = x.lod_level


register_op('moe_ffn', infer_shape=_moe_infer)
register_vjp_grad('moe_ffn', in_slots=('X', 'Gate', 'WUp', 'WDown'))


@op_emitter('moe_aux_loss')
def _moe_aux_loss_emit(ctx, op):
    """GShard's load-balance loss E * sum_e f_e * P_e: f_e the share of
    tokens whose first maximum is expert e (no grad), P_e the mean gate
    probability (the grad's path)."""
    gate = ctx.get(op.single_input('Gate'))
    E = gate.shape[-1]
    flat = gate.reshape(-1, E)
    top1 = (torch.argmax(flat, -1)[:, None] == torch.arange(
        E, device=flat.device)[None, :]).to(gate.dtype)
    ctx.set(op.single_output('Out'),
            E * torch.sum(torch.mean(top1, 0) * torch.mean(flat, 0)))


def _aux_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = []
    out.dtype = block.var_recursive(op.single_input('Gate')).dtype
    out.lod_level = 0


register_op('moe_aux_loss', infer_shape=_aux_infer)
register_vjp_grad('moe_aux_loss', in_slots=('Gate',))
