"""Expert parallelism: moe_ffn and moe_aux_loss on a mesh (the JAX
package shards the experts [E, D, H] over 'ep' and lets GSPMD partition
paddle_tpu/ops/moe_ops.py:77-147; parallel/layers.py:104-150).

The routing is the one-device op's (ops/moe_ops.py) over the GLOBAL
token order, whatever the ranks hold:
- the tokens of a dp row are split over 'ep', so each rank routes a
  share of them; slot positions count every earlier choice of the same
  expert in slot-major, global-token order, so the per-(choice, expert)
  counts of the ranks before this one are all-gathered first and the
  capacity C is that of all S tokens;
- dispatch: each rank builds its [E, C, D] buffer (its own tokens'
  slots) and an all-to-all over 'ep' sends each expert group's part to
  the rank holding those experts; the parts of the dp rows are summed
  over dp (their slots are disjoint);
- the rank runs its E/ep experts on [E/ep, C, D];
- combine: the expert outputs are all-gathered over 'ep' and each rank
  combines its tokens, which are then gathered back over 'ep'.
dispatch='dense' runs each rank's experts on every token and sums the
experts' parts over 'ep'.
"""
from __future__ import annotations

import math

import torch

from ..ops import moe_ops as M
from . import collectives as C
from .layout import REPL, factor

__all__ = ['moe_ffn_rule', 'moe_aux_rule']


def _token_layout(io, names):
    """Put the token tensors on a layout sharded on dim 0 only (by the
    axes other than 'ep'); returns those axes."""
    xs = io.spec(names[0])
    tok = tuple(a for a in xs[0] if a != 'ep')
    for n in names:
        nd = io.val(n).ndim
        want = (tok,) + (REPL,) * (nd - 1)
        if io.spec(n) != want:
            io.use(n, want)
    return tok


def _gather_order(t, axes, io):
    """All-gather a small tensor (dim 0 = 1 per rank) over `axes`, outer
    axis first in the result."""
    for a in reversed(axes):
        t = C.gather(t, 0, io.ax(a))
    return t


def moe_ffn_rule(io):
    op = io.op
    xn, gn = op.single_input('X'), op.single_input('Gate')
    un, dn = op.single_input('WUp'), op.single_input('WDown')
    ws = io.spec(un)
    if any(ws[1:]) or any(a != 'ep' for a in ws[0]) or \
            io.spec(dn) != ws:
        from .layout import replicated
        return replicated(io)
    ep = io.ax('ep') if ws[0] else None
    tok = _token_layout(io, (xn, gn))
    x, gate = io.val(xn), io.val(gn)
    w_up, w_down = io.val(un), io.val(dn)
    act = M._ACT[op.attr('act', 'gelu')]
    k = op.attr('k', 1)
    E = gate.shape[-1]
    D = x.shape[-1]
    out_name = op.single_output('Out')
    n_ep = ep.size if ep is not None else 1
    e_lo = (ep.index if ep is not None else 0) * (E // n_ep)
    if op.attr('dispatch', 'topk') == 'dense':
        route = M.topk_route(gate, k)[..., e_lo:e_lo + w_up.shape[0]]
        h = act(M._einsum('...d,edh->...eh', x, w_up))
        y = M._einsum('...eh,ehd->...ed', h, w_down)
        out = M._einsum('...ed,...e->...d', y, route)
        if ep is not None:
            out = C.all_reduce_sum(out, ep)
        io.ctx.set(out_name, out)
        io.out(out_name, (tok,) + (REPL,) * (out.ndim - 1))
        return
    S_loc = int(math.prod(x.shape[:-1]))
    x2, g2 = x.reshape(S_loc, D), gate.reshape(S_loc, E)
    if ep is not None:
        if S_loc % n_ep:
            raise ValueError('moe_ffn: %d tokens a rank do not split over '
                             "'ep' of size %d" % (S_loc, n_ep))
        x2, g2 = C.chunk(x2, 0, ep), C.chunk(g2, 0, ep)
    S = S_loc * factor(tok, io.mesh)
    cap = M.capacity(S, k, E, op.attr('capacity_factor', 2.0))
    kk = min(k, E)
    route = M.topk_route(g2, k)
    Sc = route.shape[0]
    dev = route.device
    top_i = torch.sort(route, dim=-1, descending=True,
                       stable=True).indices[:, :kk]            # [Sc, kk]
    rows = torch.arange(Sc, device=dev)[:, None]
    top_w = route[rows, top_i]
    e_hit = (top_i.t()[:, :, None] ==
             torch.arange(E, device=dev)[None, None, :])       # [kk, Sc, E]
    cnt = e_hit.to(torch.int32)
    mine = cnt.sum(1)                                           # [kk, E]
    order = tuple(tok) + (('ep',) if ep is not None else ())
    with torch.no_grad():
        every = _gather_order(mine[None], order, io)           # [R, kk, E]
    me = 0
    for a in order:
        ax = io.ax(a)
        me = me * ax.size + ax.index
    total = every.sum(0)                                        # [kk, E]
    offset = (torch.cumsum(total, 0, dtype=torch.int32) - total) + \
        every[:me].sum(0)                                       # [kk, E]
    before = torch.cumsum(cnt, 1, dtype=torch.int32) - cnt      # [kk, Sc, E]
    pos = torch.sum((before + offset[:, None, :]) * cnt, -1)    # [kk, Sc]
    c_oh = (pos[..., None] == torch.arange(cap, device=dev)).to(route.dtype)
    choice = e_hit.to(route.dtype)[..., None] * c_oh[:, :, None, :]
    dispatch = choice.sum(0)                                    # [Sc, E, C]
    combine = (choice * top_w.t()[:, :, None, None]).sum(0)
    ein = M._einsum('sec,sd->ecd', dispatch, x2)                # [E, C, D]
    if ep is not None:
        ein = C.all_to_all(ein.reshape((n_ep, E // n_ep) + ein.shape[1:]),
                           ep).sum(0)                           # [E/ep, C, D]
    for a in tok:
        ein = C.sync_sum(ein, io.ax(a))
    h = act(M._einsum('ecd,edh->ech', ein, w_up))
    y = M._einsum('ech,ehd->ecd', h, w_down)                    # [E/ep, C, D]
    if ep is not None:
        y = C.gather_summed(y, 0, ep)                           # [E, C, D]
    out = M._einsum('sec,ecd->sd', combine, y)
    if ep is not None:
        out = C.gather(out, 0, ep)
    out = out.reshape(tuple(x.shape[:-1]) + (y.shape[-1],))
    io.ctx.set(out_name, out)
    io.out(out_name, (tok,) + (REPL,) * (out.ndim - 1))


def moe_aux_rule(io):
    op = io.op
    gn = op.single_input('Gate')
    tok = _token_layout(io, (gn,))
    gate = io.val(gn)
    E = gate.shape[-1]
    flat = gate.reshape(-1, E)
    top1 = (torch.argmax(flat, -1)[:, None] == torch.arange(
        E, device=flat.device)[None, :]).to(gate.dtype)
    f, p = torch.sum(top1, 0), torch.sum(flat, 0)
    n = flat.shape[0]
    for a in tok:
        ax = io.ax(a)
        f = C.all_reduce_sum(f, ax)
        p = C.all_reduce_sum(p, ax)
        n *= ax.size
    out = op.single_output('Out')
    io.ctx.set(out, E * torch.sum((f / n) * (p / n)))
    io.out(out, ())
