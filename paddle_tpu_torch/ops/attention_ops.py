"""Attention and KV-cache ops (counterpart of
paddle_tpu/ops/attention_ops.py: ring_attention :20, flash_attention :57,
kv_cache_write :84,
kv_cache_append :96, decode_mask :113, position_embedding_at :134,
gather_time :149, and the paged-cache ops :177-315: kv_page_cow,
kv_page_write, kv_page_append, kv_page_gather, paged_decode_mask,
spec_verify_mask, paged_prefill_mask).

The cache and pool ops update the Scope's tensor IN PLACE and return
that same tensor: the JAX package rebuilt the array functionally and
relied on buffer donation (paddle_tpu/executor.py:907) to reuse the
memory, and a captured CUDA graph reads and writes the addresses it
captured. Every shape is fixed when the programs are built; slot
positions and page tables are feeds and validity is masking, never a
dynamic shape. Masked scores are set to -1e9 (as in causal_mask), so
they underflow to exact zeros in the softmax; the pools are zeroed when
they are made, so a masked lane reads finite garbage and 0 x garbage
stays 0.
"""
from __future__ import annotations

import torch

from ..flags import get_flag
from ..kernels import flash_attention as fa
from ..registry import register_op, op_emitter, register_vjp_grad, amp_cast


@op_emitter('ring_attention')
def _ring_attention_emit(ctx, op):
    """Context-parallel attention. On a mesh with an 'sp' axis the op
    runs by its layout rule (parallel/layout.py): the ring of
    parallel/ring_attention.py, through K1 and the backward arm per
    block with FLAGS_use_flash_attention, else the plain ring fold.
    Off the mesh (or where sp does not divide T) it is ordinary
    attention: the flash path (fa.flash_attention) with the flag, else
    plain fp32 softmax attention in q's dtype."""
    q, k, v = amp_cast(ctx, ctx.get(op.single_input('Q')),
                       ctx.get(op.single_input('K')),
                       ctx.get(op.single_input('V')))
    causal = op.attr('causal', True)
    sm_scale = op.attr('sm_scale', None)
    if get_flag('use_flash_attention'):
        out = fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    else:
        scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if causal:
            T = q.shape[-2]
            mask = torch.ones((T, T), dtype=torch.bool,
                              device=q.device).tril()
            s = s.masked_fill(~mask, -1e30)
        out = torch.matmul(torch.softmax(s, -1), v.float()).to(q.dtype)
    ctx.set(op.single_output('Out'), out)


def _ring_infer(op, block):
    q = block.var_recursive(op.single_input('Q'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = q.shape
    out.dtype = q.dtype
    out.lod_level = q.lod_level


register_op('ring_attention', infer_shape=_ring_infer)
register_vjp_grad('ring_attention', in_slots=('Q', 'K', 'V'))


@op_emitter('flash_attention')
def _flash_attention_emit(ctx, op):
    """Blockwise online-softmax attention (bf16 under AMP): the
    hand-written CUDA kernels in both passes where fa.kernel_takes(q)
    (a CUDA tensor, fp32 or bf16, head dim 64 or 128), their plain
    versions for every other shape, dtype or device, or with
    FLAGS_use_flash_attention=False; fa.FlashAttention.plain_cuda_calls
    counts the plain forwards on a CUDA tensor."""
    q, k, v = amp_cast(ctx, ctx.get(op.single_input('Q')),
                       ctx.get(op.single_input('K')),
                       ctx.get(op.single_input('V')))
    out = fa.flash_attention(q, k, v, causal=op.attr('causal', True),
                             sm_scale=op.attr('sm_scale', None),
                             force_plain=not get_flag('use_flash_attention'))
    ctx.set(op.single_output('Out'), out)


def _flash_infer(op, block):
    q = block.var_recursive(op.single_input('Q'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = q.shape
    out.dtype = q.dtype
    out.lod_level = q.lod_level


register_op('flash_attention', infer_shape=_flash_infer)
register_vjp_grad('flash_attention', in_slots=('Q', 'K', 'V'))


@op_emitter('kv_cache_write')
def _kv_cache_write_emit(ctx, op):
    """Prefill: write whole prompts' K or V rows into their slots, in
    place. Cache [slots, T, H, dk], X [pb, T, H, dk], Slots [pb]; the
    entire [T] row is overwritten, so a slot's previous occupant never
    leaks into a new request."""
    cache = ctx.get(op.single_input('Cache'))
    x = ctx.get(op.single_input('X'))
    slots = ctx.get(op.single_input('Slots')).long()
    cache[slots] = x.to(cache.dtype)
    ctx.set(op.single_output('Out'), cache)


@op_emitter('kv_cache_append')
def _kv_cache_append_emit(ctx, op):
    """Decode: per-slot ring write of one K or V row, in place.
    Cache [slots, T, H, dk], X [slots, 1, H, dk], StepIdx [slots] (the
    absolute position of the incoming token; the row lands at
    StepIdx % T). Idle slots write too; decode_mask hides those rows and
    the next prefill of the slot overwrites them."""
    cache = ctx.get(op.single_input('Cache'))
    x = ctx.get(op.single_input('X'))
    step = ctx.get(op.single_input('StepIdx')).long()
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, step % cache.shape[1]] = x[:, 0].to(cache.dtype)
    ctx.set(op.single_output('Out'), cache)


@op_emitter('decode_mask')
def _decode_mask_emit(ctx, op):
    """Ring-aware validity mask for decode scores X [slots, H, 1, T]:
    ring index j holds absolute position step - ((step - j) mod T) and is
    valid iff that is >= 0. Masked scores are set to -1e9, as in
    causal_mask, so they underflow to exact zeros in the softmax."""
    x = ctx.get(op.single_input('X'))
    step = ctx.get(op.single_input('StepIdx')).long()
    T = x.shape[-1]
    j = torch.arange(T, device=x.device)
    s = step[:, None]
    valid = (s - torch.remainder(s - j[None, :], T)) >= 0   # [slots, T]
    ctx.set(op.single_output('Out'),
            x.masked_fill(~valid[:, None, None, :], -1e9))


@op_emitter('position_embedding_at')
def _position_embedding_at_emit(ctx, op):
    """One positional row per slot: Pos [max_len, D], Index [slots] ->
    [slots, 1, D] (row Index % max_len); a 2-D Index [slots, R] gives
    [slots, R, D]."""
    pos = ctx.get(op.single_input('Pos'))
    idx = ctx.get(op.single_input('Index')).long()
    out = pos[torch.remainder(idx, pos.shape[0])]
    if idx.ndim == 1:
        out = out[:, None, :]
    ctx.set(op.single_output('Out'), out)


@op_emitter('gather_time')
def _gather_time_emit(ctx, op):
    """Per-row gather along time: X [B, T, ...], Index [B] -> [B, ...].
    Prefill picks each prompt's last real position before the lm_head."""
    x = ctx.get(op.single_input('X'))
    idx = ctx.get(op.single_input('Index')).long().clamp(0, x.shape[1] - 1)
    rows = torch.arange(x.shape[0], device=x.device)
    ctx.set(op.single_output('Out'), x[rows, idx])


# ---------------------------------------------------------------------------
# Paged KV-cache ops (serving/paging.py + serving/paged.py)
#
# One [num_pages, page_tokens, H, dk] pool per layer and K/V, and a
# per-slot page TABLE (a feed) mapping logical position j to
# pool[table[j // pt], j % pt]. Physical page 0 is the null page: never
# allocated, the target of dead rows and of unpopulated table entries,
# always masked on read. Validity is absolute (j <= position): pages are
# allocated on demand, not wrapped, so exhaustion is a typed host-side
# error. Dead rows go to the null page by torch.where, never by a
# boolean index (a data-dependent shape).
# ---------------------------------------------------------------------------

@op_emitter('kv_page_cow')
def _kv_page_cow_emit(ctx, op):
    """Copy-on-write page copies, in place: Pool [N, pt, H, dk], Src [n],
    Dst [n] -> pool[dst[i]] = pool[src[i]]. Every source is gathered
    before any destination is written, so a page freed and reallocated
    within the same step still gives its pre-step contents. (0, 0)
    pairs are the no-op padding (the null page onto itself)."""
    pool = ctx.get(op.single_input('Pool'))
    src = ctx.get(op.single_input('Src')).long()
    dst = ctx.get(op.single_input('Dst')).long()
    pool.index_copy_(0, dst, pool.index_select(0, src))
    ctx.set(op.single_output('Out'), pool)


@op_emitter('kv_page_write')
def _kv_page_write_emit(ctx, op):
    """Chunked prefill: write a chunk's K or V rows through one page
    table, in place. Pool [N, pt, H, dk], X [1, C, H, dk], Table [1, P],
    Positions [C] (absolute position of each chunk row), Len [1] (live
    rows; rows >= Len are padding). Row i lands at
    pool[table[positions[i] // pt], positions[i] % pt]; dead rows go to
    the null page at offset 0, which is never read unmasked."""
    pool = ctx.get(op.single_input('Pool'))
    x = ctx.get(op.single_input('X'))
    table = ctx.get(op.single_input('Table')).long().reshape(-1)
    positions = ctx.get(op.single_input('Positions')).long()
    length = ctx.get(op.single_input('Len')).long().reshape(-1)
    pt, P = pool.shape[1], table.shape[0]
    live = torch.arange(positions.shape[0], device=pool.device) < length[0]
    page = torch.where(live, table[(positions // pt).clamp(0, P - 1)], 0)
    off = torch.where(live, positions % pt, 0)
    pool[page, off] = x.reshape((-1,) + tuple(x.shape[2:])).to(pool.dtype)
    ctx.set(op.single_output('Out'), pool)


@op_emitter('kv_page_append')
def _kv_page_append_emit(ctx, op):
    """Decode: append one K or V row per slot through its page table, in
    place. Pool [N, pt, H, dk], X [slots, 1, H, dk], Table [slots, P],
    Positions [slots] (absolute position of the incoming token). Idle or
    mid-prefill slots are fed an all-zero table row and position 0, so
    their writes land in the null page. With 2-D Positions [slots, R]
    and X [slots, R, H, dk], R rows a slot are appended at once (the
    speculative verify pass); a padding row carries a position
    >= P * pt and goes to the null page."""
    pool = ctx.get(op.single_input('Pool'))
    x = ctx.get(op.single_input('X'))
    table = ctx.get(op.single_input('Table')).long()
    positions = ctx.get(op.single_input('Positions')).long()
    pt, P = pool.shape[1], table.shape[1]
    rows = torch.arange(table.shape[0], device=pool.device)
    if positions.ndim == 2:
        idx = positions // pt
        live = idx < P
        page = torch.where(live, table[rows[:, None], idx.clamp(0, P - 1)],
                           0)
        off = torch.where(live, positions % pt, 0)
        pool[page, off] = x.to(pool.dtype)
    else:
        page = table[rows, (positions // pt).clamp(0, P - 1)]
        pool[page, positions % pt] = x[:, 0].to(pool.dtype)
    ctx.set(op.single_output('Out'), pool)


@op_emitter('kv_page_gather')
def _kv_page_gather_emit(ctx, op):
    """Each row's logical K or V sequence from the pool: Pool
    [N, pt, H, dk], Table [B, P] -> [B, P*pt, H, dk]. Unpopulated table
    entries gather the null page, which the paged masks hide."""
    pool = ctx.get(op.single_input('Pool'))
    table = ctx.get(op.single_input('Table')).long()
    B, P = table.shape
    ctx.set(op.single_output('Out'),
            pool[table].reshape(B, P * pool.shape[1], pool.shape[2],
                                pool.shape[3]))


def _masked_beyond(x, positions, valid_shape):
    """x with -1e9 wherever logical index j > the row's position;
    `valid_shape` broadcasts [.., J] validity against x."""
    j = torch.arange(x.shape[-1], device=x.device)
    valid = (j <= positions[..., None]).reshape(valid_shape)
    return x.masked_fill(~valid, -1e9)


@op_emitter('paged_decode_mask')
def _paged_decode_mask_emit(ctx, op):
    """Paged decode scores X [slots, H, 1, J], Positions [slots]: logical
    index j holds the token at position j and is valid iff
    j <= positions[s] (this step's own token included)."""
    x = ctx.get(op.single_input('X'))
    positions = ctx.get(op.single_input('Positions')).long()
    ctx.set(op.single_output('Out'),
            _masked_beyond(x, positions, (x.shape[0], 1, 1, x.shape[-1])))


@op_emitter('spec_verify_mask')
def _spec_verify_mask_emit(ctx, op):
    """Speculative verify scores X [slots, H, K1, J], Positions
    [slots, K1]: row r of slot s sees j iff j <= positions[s, r]."""
    x = ctx.get(op.single_input('X'))
    positions = ctx.get(op.single_input('Positions')).long()
    ctx.set(op.single_output('Out'),
            _masked_beyond(x, positions,
                           (x.shape[0], 1, x.shape[2], x.shape[-1])))


@op_emitter('paged_prefill_mask')
def _paged_prefill_mask_emit(ctx, op):
    """A prefill chunk's scores X [1, H, C, J] against the gathered
    history, Positions [C]: chunk row i sees j iff j <= positions[i]."""
    x = ctx.get(op.single_input('X'))
    positions = ctx.get(op.single_input('Positions')).long()
    ctx.set(op.single_output('Out'),
            _masked_beyond(x, positions, (1, 1, x.shape[2], x.shape[-1])))


def _kv_cache_update_infer(op, block):
    cache = block.var_recursive(op.single_input('Cache'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = cache.shape
    out.dtype = cache.dtype


def _decode_mask_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype


def _position_embedding_at_infer(op, block):
    pos = block.var_recursive(op.single_input('Pos'))
    idx = block.var_recursive(op.single_input('Index'))
    out = block.var_recursive(op.single_output('Out'))
    if len(idx.shape) == 2:
        out.shape = (idx.shape[0], idx.shape[1], pos.shape[-1])
    else:
        out.shape = (idx.shape[0], 1, pos.shape[-1])
    out.dtype = pos.dtype


def _gather_time_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (x.shape[0],) + tuple(x.shape[2:])
    out.dtype = x.dtype


def _kv_pool_update_infer(op, block):
    pool = block.var_recursive(op.single_input('Pool'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = pool.shape
    out.dtype = pool.dtype


def _kv_page_gather_infer(op, block):
    pool = block.var_recursive(op.single_input('Pool'))
    table = block.var_recursive(op.single_input('Table'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = (table.shape[0], table.shape[1] * pool.shape[1],
                 pool.shape[2], pool.shape[3])
    out.dtype = pool.dtype


register_op('kv_cache_write', infer_shape=_kv_cache_update_infer)
register_op('kv_cache_append', infer_shape=_kv_cache_update_infer)
register_op('decode_mask', infer_shape=_decode_mask_infer)
register_op('position_embedding_at',
            infer_shape=_position_embedding_at_infer)
register_op('gather_time', infer_shape=_gather_time_infer)
for _type in ('kv_page_cow', 'kv_page_write', 'kv_page_append'):
    register_op(_type, infer_shape=_kv_pool_update_infer, no_grad=True)
register_op('kv_page_gather', infer_shape=_kv_page_gather_infer,
            no_grad=True)
for _type in ('paged_decode_mask', 'spec_verify_mask', 'paged_prefill_mask'):
    register_op(_type, infer_shape=_decode_mask_infer, no_grad=True)
