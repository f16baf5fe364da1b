"""Beam search ops (counterpart of paddle_tpu/ops/beam_search_ops.py):
beam_search, beam_search_decode, beam_gather.

Static shapes throughout, as in the JAX package: every step keeps the
full [batch, beam] lattice, finished beams re-emit end_id at no cost,
so a decode of T steps is one captured segment. beam_search_decode
backtracks the parent lattice with a loop over the static time axis.

Ties. Finished beams add NEG_INF to every id but end_id, and a decode's
first step gives NEG_INF to every beam but the first; in fp32, NEG_INF
plus a log-probability above about -32 rounds back to NEG_INF, so such
rows tie exactly. lax.top_k takes the lower flat index first among
equal scores; torch.topk on CUDA promises no order among them. The
selection here is a stable descending sort, which keeps the lower index
first, so both packages (and the card and the CPU) pick the same beams.
"""
from __future__ import annotations

import torch

from ..registry import register_op, op_emitter, register_vjp_grad

NEG_INF = -1e9


def top_k_lower_index_first(x, k):
    """(values, indices) of the k largest entries along the last axis,
    equal values in ascending index order (lax.top_k's order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@op_emitter('beam_search')
def _beam_search_emit(ctx, op):
    """One expansion step. PreIds [B, beam] int, PreScores [B, beam]
    (cumulative log-probs), Scores [B, beam, V] (this step's log-probs)
    -> SelectedIds, SelectedScores, ParentIdx [B, beam] (the source beam
    each winner extends)."""
    pre_ids = ctx.get(op.single_input('PreIds'))
    pre_scores = ctx.get(op.single_input('PreScores'))
    logprobs = ctx.get(op.single_input('Scores'))
    beam = int(op.attr('beam_size'))
    end_id = int(op.attr('end_id'))
    B, K, V = logprobs.shape
    finished = pre_ids == end_id                          # [B, K]
    # a finished beam extends only with end_id, at zero added cost
    only_end = torch.where(
        torch.arange(V, device=logprobs.device) == end_id,
        torch.zeros((), dtype=logprobs.dtype, device=logprobs.device),
        torch.full((), NEG_INF, dtype=logprobs.dtype,
                   device=logprobs.device))
    step = torch.where(finished[..., None], only_end, logprobs)
    total = pre_scores[..., None] + step                  # [B, K, V]
    top_scores, top_idx = top_k_lower_index_first(total.reshape(B, K * V),
                                                  beam)
    ctx.set(op.single_output('SelectedIds'),
            (top_idx % V).to(pre_ids.dtype))
    ctx.set(op.single_output('SelectedScores'), top_scores)
    ctx.set(op.single_output('ParentIdx'),
            torch.div(top_idx, V, rounding_mode='floor').to(torch.int32))


def _beam_search_infer(op, block):
    pre = block.var_recursive(op.single_input('PreIds'))
    for slot, dtype in (('SelectedIds', pre.dtype),
                        ('SelectedScores', 'float32'),
                        ('ParentIdx', 'int32')):
        v = block.var_recursive(op.single_output(slot))
        v.shape = pre.shape
        v.dtype = dtype


register_op('beam_search', infer_shape=_beam_search_infer, no_grad=True)


@op_emitter('beam_search_decode')
def _beam_search_decode_emit(ctx, op):
    """Ids, ParentIdx [T, B, beam] and the final Scores [B, beam] ->
    SentenceIds [B, beam, T] (each end beam's path through the lattice)
    and SentenceScores [B, beam]."""
    ids = ctx.get(op.single_input('Ids'))
    parents = ctx.get(op.single_input('ParentIdx')).long()
    T, B, K = ids.shape
    seq = [None] * T
    cursor = torch.arange(K, device=ids.device)[None, :].expand(B, K)
    for t in range(T - 1, -1, -1):
        seq[t] = torch.gather(ids[t], 1, cursor)
        cursor = torch.gather(parents[t], 1, cursor)
    ctx.set(op.single_output('SentenceIds'), torch.stack(seq, dim=-1))
    ctx.set(op.single_output('SentenceScores'),
            ctx.get(op.single_input('Scores')))


def _beam_search_decode_infer(op, block):
    ids = block.var_recursive(op.single_input('Ids'))
    out = block.var_recursive(op.single_output('SentenceIds'))
    if ids.shape is not None and len(ids.shape) == 3:
        T, B, K = ids.shape
        out.shape = (B, K, T)
    out.dtype = ids.dtype
    sc = block.var_recursive(op.single_output('SentenceScores'))
    in_sc = block.var_recursive(op.single_input('Scores'))
    sc.shape = in_sc.shape
    sc.dtype = in_sc.dtype


register_op('beam_search_decode', infer_shape=_beam_search_decode_infer,
            no_grad=True)


@op_emitter('beam_gather')
def _beam_gather_emit(ctx, op):
    """Out[b, j] = X[b, Indices[b, j]]: beam states follow their parents
    (the contrib decoder's state shuffle)."""
    x = ctx.get(op.single_input('X'))             # [B, beam, ...]
    idx = ctx.get(op.single_input('Indices')).long()
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.ndim - 2))
    ctx.set(op.single_output('Out'),
            torch.gather(x, 1, idx.expand(tuple(idx.shape[:2]) +
                                          tuple(x.shape[2:]))))


def _beam_gather_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


register_op('beam_gather', infer_shape=_beam_gather_infer)
register_vjp_grad('beam_gather', in_slots=('X',), nondiff_slots=('Indices',))
