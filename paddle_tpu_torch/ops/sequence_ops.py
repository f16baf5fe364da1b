"""Sequence ops over padded batches and their lengths (counterpart of
paddle_tpu/ops/sequence_ops.py, its 21 op types).

A sequence tensor is a padded [B, T, ...] tensor with a [B] int32
lengths input ('SeqLens'; absent: every row has length T), never a
ragged one, so a segment's shapes stay static and it can be captured as
a CUDA graph. Padding never leaks: pools mask it out, convolutions zero
it, recurrences freeze a finished row and their outputs are zero past
each length. The LSTM, GRU and CRF recurrences are Python loops over
the static T axis of plain PyTorch ops on the card (the JAX package
scans them with lax.scan); each step's work is tiny, so the captured
graph's replay is what makes them cheap. Every op keeps its values on
the device: none reads a length back to the host (edit_distance's row
recurrence is a cummin, crf_decoding's backtrack a gather per step).

Grads come from recorded forwards (registry.register_vjp_grad), with
the JAX package's slots. Under AMP the LSTM's and GRU's recurrent
weight and bias are cast down to the activation dtype, as in the JAX
package, so the per-step product runs in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register_op, op_emitter, register_vjp_grad

_NEG = -3.4e38      # the JAX package's stand-in for -inf in masked maxima


def _lens(ctx, op, T, B, device):
    if op.input('SeqLens'):
        return ctx.get(op.single_input('SeqLens'))
    return torch.full((B,), T, dtype=torch.int32, device=device)


def _time_mask(lens, T, extra_dims=0):
    """[B, T] (and trailing 1s) bool mask of the valid positions."""
    m = torch.arange(T, device=lens.device)[None, :] < lens.reshape(-1, 1)
    return m.reshape(tuple(m.shape) + (1,) * extra_dims)


def _zero_past(x, mask):
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _take_time(x, idx):
    """x[b, idx[b, t]] along axis 1: idx [B, T'] -> [B, T', ...]."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2]) +
                                         tuple(x.shape[2:])))


def _same_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = x.lod_level


def _lens_out_infer(op, block, x):
    if op.output('OutLens'):
        ln = block.var_recursive(op.single_output('OutLens'))
        ln.shape = [x.shape[0]]
        ln.dtype = 'int32'


# -- sequence_pool: X [B, T, D...] -> Out [B, D...] ---------------------------

@op_emitter('sequence_pool')
def _sequence_pool_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    B, T = x.shape[0], x.shape[1]
    lens = _lens(ctx, op, T, B, x.device)
    mask = _time_mask(lens, T, extra_dims=x.ndim - 2)
    per_row = (B,) + (1,) * (x.ndim - 2)
    pooltype = op.attr('pooltype', 'AVERAGE').upper()
    if pooltype == 'SUM':
        out = _zero_past(x, mask).sum(1)
    elif pooltype == 'AVERAGE':
        denom = lens.clamp(min=1).reshape(per_row).to(x.dtype)
        out = _zero_past(x, mask).sum(1) / denom
    elif pooltype == 'SQRT':
        denom = torch.sqrt(lens.clamp(min=1).to(x.dtype)).reshape(per_row)
        out = _zero_past(x, mask).sum(1) / denom
    elif pooltype == 'MAX':
        out = torch.where(mask, x, _NEG).amax(1)
    elif pooltype == 'LAST':
        idx = (lens - 1).clamp(min=0).reshape(B, 1)
        out = _take_time(x, idx)[:, 0]
    elif pooltype == 'FIRST':
        out = x[:, 0]
    else:
        raise ValueError('unknown pooltype %r' % pooltype)
    ctx.set(op.single_output('Out'), out)
    if op.output('MaxIndex'):
        ctx.set(op.single_output('MaxIndex'),
                torch.where(mask, x, _NEG).argmax(1).to(torch.int32))


def _sequence_pool_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape  # the declared row shape [-1, D] stays
    out.dtype = x.dtype
    out.lod_level = 0


register_op('sequence_pool', infer_shape=_sequence_pool_infer)
register_vjp_grad('sequence_pool', in_slots=('X',),
                  nondiff_slots=('SeqLens',))


# -- sequence_softmax: over the time axis, padding excluded -------------------

@op_emitter('sequence_softmax')
def _sequence_softmax_emit(ctx, op):
    x = ctx.get(op.single_input('X'))  # [B, T] or [B, T, 1]
    squeeze = x.ndim == 3 and x.shape[-1] == 1
    v = x.reshape(x.shape[:2]) if squeeze else x
    B, T = v.shape
    mask = _time_mask(_lens(ctx, op, T, B, x.device), T)
    out = torch.softmax(torch.where(mask, v, _NEG), dim=1)
    ctx.set(op.single_output('Out'), _zero_past(out, mask).reshape(x.shape))


register_op('sequence_softmax', infer_shape=_same_infer)
register_vjp_grad('sequence_softmax', in_slots=('X',),
                  nondiff_slots=('SeqLens',))


# -- sequence_expand: row b of X broadcast along Y's time axis ----------------

@op_emitter('sequence_expand')
def _sequence_expand_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    T = ctx.get(op.single_input('Y')).shape[1]
    if x.ndim == 2:
        out = x[:, None, :].expand(x.shape[0], T, x.shape[1])
    else:
        out = x.expand((x.shape[0], T) + tuple(x.shape[2:]))
    ctx.set(op.single_output('Out'), out)


def _sequence_expand_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_input('Y'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = x.shape
    out.dtype = x.dtype
    out.lod_level = max(1, y.lod_level)


register_op('sequence_expand', infer_shape=_sequence_expand_infer)
register_vjp_grad('sequence_expand', in_slots=('X',), nondiff_slots=('Y',))


# -- sequence_conv: a context window within each sequence, projected ----------

@op_emitter('sequence_conv')
def _sequence_conv_emit(ctx, op):
    """Out[b, t] = concat_k(x[b, t + start + k]) @ Filter for the window
    k < contextLength, rows outside the sequence taken as zeros."""
    x = ctx.get(op.single_input('X'))          # [B, T, D]
    w = ctx.get(op.single_input('Filter'))     # [len * D, H]
    clen = op.attr('contextLength', 3)
    cstart = op.attr('contextStart', -((clen - 1) // 2))
    B, T, D = x.shape
    mask = _time_mask(_lens(ctx, op, T, B, x.device), T, 1)
    left, right = max(0, -cstart), max(0, cstart + clen - 1)
    xp = F.pad(_zero_past(x, mask), (0, 0, left, right))
    cols = [xp[:, left + cstart + k:left + cstart + k + T]
            for k in range(clen)]
    dt = torch.promote_types(x.dtype, w.dtype)
    out = torch.matmul(torch.cat(cols, dim=-1).to(dt), w.to(dt))
    ctx.set(op.single_output('Out'), _zero_past(out.to(x.dtype), mask))


def _sequence_conv_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    w = block.var_recursive(op.single_input('Filter'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    out.dtype = x.dtype
    out.lod_level = max(1, x.lod_level)


register_op('sequence_conv', infer_shape=_sequence_conv_infer)
register_vjp_grad('sequence_conv', in_slots=('X', 'Filter'),
                  nondiff_slots=('SeqLens',))


# -- lstm and gru over pre-projected inputs -----------------------------------

_ACT = {
    'sigmoid': torch.sigmoid, 'tanh': torch.tanh, 'relu': torch.relu,
    'identity': lambda v: v, '': lambda v: v,
}


def _time_order(T, is_reverse):
    """The steps a recurrence takes: t = T-1 ... 0 when reversed, so
    each row runs backwards within its own length (a step t >= len
    leaves the state as it is)."""
    return range(T - 1, -1, -1) if is_reverse else range(T)


def _stack_steps(states, is_reverse):
    """The per-step states in time order, [B, T, H]."""
    if is_reverse:
        states = states[::-1]
    return torch.stack(states, dim=1)


@op_emitter('lstm')
def _lstm_emit(ctx, op):
    """Input [B, T, 4H] (x @ W_x, the caller's fc), Weight [H, 4H], Bias
    [1, 4H] or, with peepholes, [1, 7H] (w_ic, w_fc, w_oc after the
    gate bias). Gate order: candidate, input, forget, output."""
    x = ctx.get(op.single_input('Input'))
    w = ctx.get(op.single_input('Weight'))
    b = ctx.get(op.single_input('Bias'))
    B, T, H4 = x.shape
    H = H4 // 4
    mask = _time_mask(_lens(ctx, op, T, B, x.device), T)
    peep = op.attr('use_peepholes', False)
    act_g = _ACT[op.attr('gate_activation', 'sigmoid')]
    act_c = _ACT[op.attr('cell_activation', 'tanh')]
    act_h = _ACT[op.attr('candidate_activation', 'tanh')]
    # AMP: the fp32 parameters are cast down to the activation dtype
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    gate_b = b[:, :4 * H]
    if peep:
        w_ic, w_fc, w_oc = b[:, 4 * H:5 * H], b[:, 5 * H:6 * H], \
            b[:, 6 * H:7 * H]
    h = ctx.get(op.single_input('H0')).to(x.dtype) if op.input('H0') \
        else x.new_zeros((B, H))
    c = ctx.get(op.single_input('C0')).to(x.dtype) if op.input('C0') \
        else x.new_zeros((B, H))
    is_reverse = op.attr('is_reverse', False)
    hs, cs = [], []
    for t in _time_order(T, is_reverse):
        gates = x[:, t] + torch.matmul(h, w) + gate_b
        gc = gates[:, :H]
        if peep:
            gi = act_g(gates[:, H:2 * H] + c * w_ic)
            gf = act_g(gates[:, 2 * H:3 * H] + c * w_fc)
            c_new = gf * c + gi * act_c(gc)
            go = act_g(gates[:, 3 * H:] + c_new * w_oc)
        else:
            ifo = act_g(gates[:, H:])
            gi, gf, go = ifo[:, :H], ifo[:, H:2 * H], ifo[:, 2 * H:]
            c_new = gf * c + gi * act_c(gc)
        h_new = go * act_h(c_new)
        active = mask[:, t:t + 1]
        h = torch.where(active, h_new, h)
        c = torch.where(active, c_new, c)
        hs.append(h)
        cs.append(c)
    m3 = mask[:, :, None]
    ctx.set(op.single_output('Hidden'),
            _zero_past(_stack_steps(hs, is_reverse), m3))
    ctx.set(op.single_output('Cell'),
            _zero_past(_stack_steps(cs, is_reverse), m3))


def _lstm_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    H = x.shape[-1] // 4
    for slot in ('Hidden', 'Cell'):
        out = block.var_recursive(op.single_output(slot))
        out.shape = tuple(x.shape[:-1]) + (H,)
        out.dtype = x.dtype
        out.lod_level = max(1, x.lod_level)


register_op('lstm', infer_shape=_lstm_infer)
register_vjp_grad('lstm', in_slots=('Input', 'Weight', 'Bias', 'H0', 'C0'),
                  out_slots=('Hidden', 'Cell'), nondiff_slots=('SeqLens',))


@op_emitter('gru')
def _gru_emit(ctx, op):
    """Input [B, T, 3H] (update | reset | candidate), Weight [H, 3H] =
    [W_u | W_r | W_c], Bias [1, 3H]; h = (1 - u) * h_prev + u * c."""
    x = ctx.get(op.single_input('Input'))
    w = ctx.get(op.single_input('Weight')).to(x.dtype)
    B, T, H3 = x.shape
    H = H3 // 3
    mask = _time_mask(_lens(ctx, op, T, B, x.device), T)
    act_g = _ACT[op.attr('gate_activation', 'sigmoid')]
    act_c = _ACT[op.attr('activation', 'tanh')]
    if op.input('Bias'):
        x = x + ctx.get(op.single_input('Bias')).to(x.dtype)
    w_g, w_c = w[:, :2 * H], w[:, 2 * H:]
    h = ctx.get(op.single_input('H0')).to(x.dtype) if op.input('H0') \
        else x.new_zeros((B, H))
    is_reverse = op.attr('is_reverse', False)
    hs = []
    for t in _time_order(T, is_reverse):
        xt = x[:, t]
        g = act_g(xt[:, :2 * H] + torch.matmul(h, w_g))
        u, r = g[:, :H], g[:, H:]
        cand = act_c(xt[:, 2 * H:] + torch.matmul(r * h, w_c))
        h = torch.where(mask[:, t:t + 1], (1.0 - u) * h + u * cand, h)
        hs.append(h)
    ctx.set(op.single_output('Hidden'),
            _zero_past(_stack_steps(hs, is_reverse), mask[:, :, None]))


def _gru_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    out = block.var_recursive(op.single_output('Hidden'))
    out.shape = tuple(x.shape[:-1]) + (x.shape[-1] // 3,)
    out.dtype = x.dtype
    out.lod_level = max(1, x.lod_level)


register_op('gru', infer_shape=_gru_infer)
register_vjp_grad('gru', in_slots=('Input', 'Weight', 'Bias', 'H0'),
                  out_slots=('Hidden',), nondiff_slots=('SeqLens',))


# -- cos_sim ------------------------------------------------------------------

@op_emitter('cos_sim')
def _cos_sim_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    y = ctx.get(op.single_input('Y'))
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    ctx.set(op.single_output('Out'), dot / (xn * yn + 1e-12))


def _cos_sim_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = tuple(x.shape[:-1]) + (1,)
    out.dtype = x.dtype


register_op('cos_sim', infer_shape=_cos_sim_infer)
register_vjp_grad('cos_sim', in_slots=('X', 'Y'))


# -- linear_chain_crf and crf_decoding ----------------------------------------
# Emission [B, T, N]; Transition [N + 2, N]: row 0 the start scores, row
# 1 the stop scores, rows 2.. trans[i, j] for i -> j; Label [B, T, 1].
# Log domain throughout.

def _crf_log_alpha(emission, transition, mask):
    start, trans = transition[0], transition[2:]
    alpha = start[None, :] + emission[:, 0]            # [B, N]
    for t in range(1, emission.shape[1]):
        scores = alpha[:, :, None] + trans[None, :, :]
        new_alpha = torch.logsumexp(scores, dim=1) + emission[:, t]
        alpha = torch.where(mask[:, t:t + 1], new_alpha, alpha)
    return alpha


def _labels(label):
    return (label[..., 0] if label.ndim == 3 else label).long()


@op_emitter('linear_chain_crf')
def _linear_chain_crf_emit(ctx, op):
    """LogLikelihood [B, 1]: each sequence's negative log-likelihood,
    log Z minus the gold path's score."""
    emission = ctx.get(op.single_input('Emission'))
    transition = ctx.get(op.single_input('Transition'))
    label = _labels(ctx.get(op.single_input('Label')))
    B, T, N = emission.shape
    lens = _lens(ctx, op, T, B, emission.device)
    mask = _time_mask(lens, T)
    start, end, trans = transition[0], transition[1], transition[2:]
    alpha = _crf_log_alpha(emission, transition, mask)
    log_z = torch.logsumexp(alpha + end[None, :], dim=1)
    emit = torch.gather(emission, 2, label[..., None])[..., 0]   # [B, T]
    emit_sum = _zero_past(emit, mask).sum(1)
    trans_sum = _zero_past(trans[label[:, :-1], label[:, 1:]],
                           mask[:, 1:]).sum(1)
    last = (lens.long() - 1).clamp(min=0)[:, None]
    gold = start[label[:, 0]] + emit_sum + trans_sum + \
        end[torch.gather(label, 1, last)[:, 0]]
    ctx.set(op.single_output('LogLikelihood'), (log_z - gold)[:, None])
    if op.output('Alpha'):
        ctx.set(op.single_output('Alpha'), alpha)
    if op.output('EmissionExps'):
        ctx.set(op.single_output('EmissionExps'), torch.exp(emission))
    if op.output('TransitionExps'):
        ctx.set(op.single_output('TransitionExps'), torch.exp(transition))


def _crf_infer(op, block):
    e = block.var_recursive(op.single_input('Emission'))
    ll = block.var_recursive(op.single_output('LogLikelihood'))
    ll.shape = (-1, 1)
    ll.dtype = e.dtype
    for slot in ('Alpha', 'EmissionExps'):
        if op.output(slot):
            v = block.var_recursive(op.single_output(slot))
            v.shape = e.shape
            v.dtype = e.dtype
    if op.output('TransitionExps'):
        t = block.var_recursive(op.single_input('Transition'))
        v = block.var_recursive(op.single_output('TransitionExps'))
        v.shape = t.shape
        v.dtype = t.dtype


register_op('linear_chain_crf', infer_shape=_crf_infer)
register_vjp_grad('linear_chain_crf', in_slots=('Emission', 'Transition'),
                  out_slots=('LogLikelihood',),
                  nondiff_slots=('Label', 'SeqLens'))


def viterbi(emission, transition, mask):
    """The best path [B, T] (int64, zero past each length): a max-product
    pass keeping each step's argmax, then a backtrack of one gather per
    step, all on the device. Ties go to the lowest label."""
    T, N = emission.shape[1], emission.shape[2]
    start, end, trans = transition[0], transition[1], transition[2:]
    stay = torch.arange(N, device=emission.device)[None, :]
    delta = start[None, :] + emission[:, 0]
    backptrs = []
    for t in range(1, T):
        scores = delta[:, :, None] + trans[None, :, :]       # [B, N, N]
        active = mask[:, t:t + 1]
        delta = torch.where(active, scores.amax(1) + emission[:, t], delta)
        backptrs.append(torch.where(active, scores.argmax(1), stay))
    nxt = (delta + end[None, :]).argmax(1)
    path = [nxt]
    for bp in reversed(backptrs):
        nxt = torch.gather(bp, 1, nxt[:, None])[:, 0]
        path.append(nxt)
    return _zero_past(torch.stack(path[::-1], dim=1), mask)


@op_emitter('crf_decoding')
def _crf_decoding_emit(ctx, op):
    emission = ctx.get(op.single_input('Emission'))
    transition = ctx.get(op.single_input('Transition'))
    B, T, _ = emission.shape
    mask = _time_mask(_lens(ctx, op, T, B, emission.device), T)
    path = viterbi(emission, transition, mask)
    if op.input('Label'):
        label = _labels(ctx.get(op.single_input('Label')))
        path = (path == label) & mask
    ctx.set(op.single_output('ViterbiPath'), path[..., None].to(torch.int32))


def _crf_decoding_infer(op, block):
    e = block.var_recursive(op.single_input('Emission'))
    out = block.var_recursive(op.single_output('ViterbiPath'))
    out.shape = tuple(e.shape[:-1]) + (1,)
    out.dtype = 'int32'
    out.lod_level = max(1, e.lod_level)


register_op('crf_decoding', infer_shape=_crf_decoding_infer, no_grad=True)


# -- sequence_concat: axis 0 joins each row's sequences in time ---------------

@op_emitter('sequence_concat')
def _sequence_concat_emit(ctx, op):
    """axis 0: row b is x0[b, :len0] ++ x1[b, :len1] ++ ..., the lengths
    add (OutLens), Out padded to the sum of the inputs' T; axis >= 1:
    the features are concatenated."""
    xs = [ctx.get(n) for n in op.input('X')]
    seq_lens = op.input('SeqLens')
    B = xs[0].shape[0]
    dev = xs[0].device
    lens_list = [ctx.get(seq_lens[i]) if i < len(seq_lens)
                 else torch.full((B,), x.shape[1], dtype=torch.int32,
                                 device=dev)
                 for i, x in enumerate(xs)]
    if op.attr('axis', 0) != 0:
        ctx.set(op.single_output('Out'), torch.cat(xs, dim=-1))
        if op.output('OutLens'):
            ctx.set(op.single_output('OutLens'), lens_list[0])
        return
    T_out = sum(x.shape[1] for x in xs)
    t_idx = torch.arange(T_out, device=dev)[None, :]
    out = xs[0].new_zeros((B, T_out) + tuple(xs[0].shape[2:]))
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    for x, lens in zip(xs, lens_list):
        rel = t_idx - offset[:, None]                          # [B, Tout]
        valid = (rel >= 0) & (rel < lens[:, None])
        gathered = _take_time(x, rel.clamp(0, x.shape[1] - 1))
        vmask = valid.reshape((B, T_out) + (1,) * (x.ndim - 2))
        out = torch.where(vmask, gathered, out)
        offset = offset + lens
    ctx.set(op.single_output('Out'), out)
    if op.output('OutLens'):
        ctx.set(op.single_output('OutLens'), offset)


def _sequence_concat_infer(op, block):
    x0 = block.var_recursive(op.input('X')[0])
    out = block.var_recursive(op.single_output('Out'))
    if op.attr('axis', 0) != 0:
        last = sum(block.var_recursive(n).shape[-1] for n in op.input('X'))
        out.shape = tuple(x0.shape[:-1]) + (last,)
    else:
        out.shape = x0.shape
    out.dtype = x0.dtype
    out.lod_level = max(1, x0.lod_level)
    if op.output('OutLens'):
        lv = block.var_recursive(op.single_output('OutLens'))
        lv.shape = (-1,)
        lv.dtype = 'int32'


register_op('sequence_concat', infer_shape=_sequence_concat_infer)
register_vjp_grad('sequence_concat', in_slots=('X',),
                  nondiff_slots=('SeqLens',))


# -- sequence_first_step / sequence_last_step: one row of each sequence -------
# The JAX package registers emitters alone (paddle_tpu/ops/sequence_ops.py:
# 613-627): no shape inference and no grad op, so backward stops at them.
# The layers of these names build sequence_pool instead.

@op_emitter('sequence_first_step')
def _sequence_first_step_emit(ctx, op):
    ctx.set(op.single_output('Out'), ctx.get(op.single_input('X'))[:, 0])


@op_emitter('sequence_last_step')
def _sequence_last_step_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    B, T = x.shape[0], x.shape[1]
    idx = (_lens(ctx, op, T, B, x.device) - 1).clamp(min=0).reshape(B, 1)
    ctx.set(op.single_output('Out'), _take_time(x, idx)[:, 0])


# -- sequence_mask: lengths -> [B, maxlen] ------------------------------------

_MASK_DTYPES = {'int64': torch.int64, 'int32': torch.int32,
                'float32': torch.float32, 'bool': torch.bool}


@op_emitter('sequence_mask')
def _sequence_mask_emit(ctx, op):
    lens = ctx.get(op.single_input('X'))
    maxlen = op.attr('maxlen', -1)
    if maxlen <= 0:
        raise ValueError('sequence_mask needs a static maxlen (a shape '
                         'that depends on the data cannot be captured)')
    mask = torch.arange(maxlen, device=lens.device)[None, :] < \
        lens.reshape(-1, 1)
    ctx.set(op.single_output('Y'),
            mask.to(_MASK_DTYPES[op.attr('out_dtype', 'int64')]))


def _sequence_mask_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    y = block.var_recursive(op.single_output('Y'))
    y.shape = [x.shape[0], op.attr('maxlen', -1)]
    y.dtype = op.attr('out_dtype', 'int64')


register_op('sequence_mask', infer_shape=_sequence_mask_infer, no_grad=True)


# -- sequence_pad / sequence_unpad: the pad value past each length ------------

@op_emitter('sequence_pad')
def _sequence_pad_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    pad_value = ctx.get(op.single_input('PadValue'))
    B, T = x.shape[0], x.shape[1]
    lens = _lens(ctx, op, T, B, x.device)
    padded_len = op.attr('padded_length', -1)
    if padded_len > 0 and padded_len != T:
        if padded_len > T:
            x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, padded_len - T))
        else:
            x = x[:, :padded_len]
        T = padded_len
    mask = _time_mask(lens, T, extra_dims=x.ndim - 2)
    ctx.set(op.single_output('Out'),
            torch.where(mask, x, pad_value.to(x.dtype)))
    ctx.set(op.single_output('Length'), lens.to(torch.int64))


def _sequence_pad_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    out = block.var_recursive(op.single_output('Out'))
    padded = op.attr('padded_length', -1)
    shape = list(x.shape)
    if padded > 0 and len(shape) >= 3:
        shape[1] = padded
    out.shape = shape
    out.dtype = x.dtype
    ln = block.var_recursive(op.single_output('Length'))
    ln.shape = [x.shape[0]]
    ln.dtype = 'int64'


register_op('sequence_pad', infer_shape=_sequence_pad_infer)
register_vjp_grad('sequence_pad', in_slots=('X',), out_slots=('Out',),
                  nondiff_slots=('PadValue', 'SeqLens'))


@op_emitter('sequence_unpad')
def _sequence_unpad_emit(ctx, op):
    """The tensor stays padded: zeros past each length, and the lengths
    ride along as the output's companion."""
    x = ctx.get(op.single_input('X'))
    lens = ctx.get(op.single_input('Length'))
    mask = _time_mask(lens.reshape(-1), x.shape[1], extra_dims=x.ndim - 2)
    ctx.set(op.single_output('Out'), _zero_past(x, mask))


def _sequence_unpad_infer(op, block):
    _same_infer(op, block)
    block.var_recursive(op.single_output('Out')).lod_level = 1


register_op('sequence_unpad', infer_shape=_sequence_unpad_infer)
register_vjp_grad('sequence_unpad', in_slots=('X',),
                  nondiff_slots=('Length',))


# -- sequence_erase: drop listed tokens, shift the rest left ------------------

@op_emitter('sequence_erase')
def _sequence_erase_emit(ctx, op):
    x = ctx.get(op.single_input('X'))            # [B, T] or [B, T, 1]
    squeeze = x.ndim == 3
    ids = x[..., 0] if squeeze else x
    B, T = ids.shape
    keep = _time_mask(_lens(ctx, op, T, B, x.device), T)
    for tok in op.attr('tokens', []):
        keep = keep & (ids != tok)
    # a stable left shift of the kept tokens: order by (dropped, position)
    pos = torch.arange(T, device=x.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, T + 1), dim=1, stable=True)
    new_lens = keep.sum(1).to(torch.int32)
    shifted = _zero_past(torch.gather(ids, 1, order),
                         pos < new_lens[:, None])
    ctx.set(op.single_output('Out'), shifted[..., None] if squeeze
            else shifted)
    if op.output('OutLens'):
        ctx.set(op.single_output('OutLens'), new_lens)


def _sequence_erase_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    _same_infer(op, block)
    block.var_recursive(op.single_output('Out')).lod_level = 1
    _lens_out_infer(op, block, x)


register_op('sequence_erase', infer_shape=_sequence_erase_infer,
            no_grad=True)


# -- sequence_reshape: refold the time axis to a new last dim -----------------

@op_emitter('sequence_reshape')
def _sequence_reshape_emit(ctx, op):
    x = ctx.get(op.single_input('X'))            # [B, T, D]
    new_dim = op.attr('new_dim')
    B, T, D = x.shape
    ctx.set(op.single_output('Out'), x.reshape(B, T * D // new_dim, new_dim))
    if op.output('OutLens'):
        lens = _lens(ctx, op, T, B, x.device)
        ctx.set(op.single_output('OutLens'),
                (lens * D // new_dim).to(torch.int32))


def _sequence_reshape_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    new_dim = op.attr('new_dim')
    out = block.var_recursive(op.single_output('Out'))
    if len(x.shape) >= 3:
        out.shape = [x.shape[0], x.shape[1] * x.shape[2] // new_dim, new_dim]
    else:
        # a declared sequence shape [-1, D]: the time axis exists only at
        # run time, so only the feature dim is known here
        out.shape = list(x.shape[:-1]) + [new_dim]
    out.dtype = x.dtype
    out.lod_level = 1
    _lens_out_infer(op, block, x)


register_op('sequence_reshape', infer_shape=_sequence_reshape_infer)
register_vjp_grad('sequence_reshape', in_slots=('X',),
                  nondiff_slots=('SeqLens',))


# -- sequence_slice: [offset, offset + length) of each sequence ---------------

@op_emitter('sequence_slice')
def _sequence_slice_emit(ctx, op):
    x = ctx.get(op.single_input('X'))            # [B, T, ...]
    offset = ctx.get(op.single_input('Offset')).reshape(-1)
    length = ctx.get(op.single_input('Length')).reshape(-1)
    T = x.shape[1]
    pos = offset[:, None] + torch.arange(T, device=x.device)[None, :]
    out = _take_time(x, pos.clamp(0, T - 1))
    mask = _time_mask(length, T, extra_dims=x.ndim - 2)
    ctx.set(op.single_output('Out'), _zero_past(out, mask))
    if op.output('OutLens'):
        ctx.set(op.single_output('OutLens'), length.to(torch.int32))


def _sequence_slice_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    _same_infer(op, block)
    block.var_recursive(op.single_output('Out')).lod_level = 1
    _lens_out_infer(op, block, x)


register_op('sequence_slice', infer_shape=_sequence_slice_infer)
register_vjp_grad('sequence_slice', in_slots=('X',),
                  nondiff_slots=('Offset', 'Length', 'SeqLens'))


# -- row_conv: out[b, t, d] = sum_k x[b, t + k, d] * W[k, d] ------------------

@op_emitter('row_conv')
def _row_conv_emit(ctx, op):
    x = ctx.get(op.single_input('X'))            # [B, T, D]
    w = ctx.get(op.single_input('Filter'))       # [K, D]
    B, T, _ = x.shape
    K = w.shape[0]
    mask = _time_mask(_lens(ctx, op, T, B, x.device), T, extra_dims=1)
    padded = F.pad(_zero_past(x, mask), (0, 0, 0, K - 1))
    out = torch.zeros_like(x)
    for k in range(K):                           # K is small and static
        out = out + padded[:, k:k + T, :] * w[k][None, None, :]
    ctx.set(op.single_output('Out'), _zero_past(out, mask))


def _row_conv_infer(op, block):
    _same_infer(op, block)
    block.var_recursive(op.single_output('Out')).lod_level = 1


register_op('row_conv', infer_shape=_row_conv_infer)
register_vjp_grad('row_conv', in_slots=('X', 'Filter'),
                  nondiff_slots=('SeqLens',))


# -- im2sequence: [N, C, H, W] -> [N, out_h * out_w, C * kh * kw] -------------

@op_emitter('im2sequence')
def _im2sequence_emit(ctx, op):
    x = ctx.get(op.single_input('X'))
    kernels = op.attr('kernels')
    strides = op.attr('strides', [1, 1])
    p = op.attr('paddings', [0, 0, 0, 0])     # top, left, bottom, right
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    patches = F.unfold(xp, kernel_size=tuple(kernels), stride=tuple(strides))
    ctx.set(op.single_output('Out'), patches.transpose(1, 2))
    if op.output('OutLens'):
        ctx.set(op.single_output('OutLens'),
                torch.full((x.shape[0],), patches.shape[-1],
                           dtype=torch.int32, device=x.device))


def _im2seq_out_hw(in_size, k, p0, p1, s):
    return (in_size + p0 + p1 - k) // s + 1


def _im2sequence_infer(op, block):
    x = block.var_recursive(op.single_input('X'))
    kernels = op.attr('kernels')
    strides = op.attr('strides', [1, 1])
    paddings = op.attr('paddings', [0, 0, 0, 0])
    n, c, h, w = x.shape
    oh = _im2seq_out_hw(h, kernels[0], paddings[0], paddings[2], strides[0])
    ow = _im2seq_out_hw(w, kernels[1], paddings[1], paddings[3], strides[1])
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [n, oh * ow, c * kernels[0] * kernels[1]]
    out.dtype = x.dtype
    out.lod_level = 1
    _lens_out_infer(op, block, x)


register_op('im2sequence', infer_shape=_im2sequence_infer)
register_vjp_grad('im2sequence', in_slots=('X',))


# -- edit_distance: batched Levenshtein distance ------------------------------

@op_emitter('edit_distance')
def _edit_distance_emit(ctx, op):
    """One DP row over the reference's prefixes per hypothesis token,
    all rows of the batch at once. Within a row new[j] = min(base[j],
    new[j - 1] + 1) with base[j] = min(prev[j] + 1, prev[j - 1] + sub),
    which is j + cummin_k(base[k] - k): exact integer arithmetic, no
    loop over j."""
    hyp = ctx.get(op.single_input('Hyps'))
    ref = ctx.get(op.single_input('Refs'))
    hyp = hyp[..., 0] if hyp.ndim == 3 else hyp        # [B, T1]
    ref = ref[..., 0] if ref.ndim == 3 else ref        # [B, T2]
    B, T1 = hyp.shape
    T2 = ref.shape[1]
    dev = hyp.device

    def lens(slot, T):
        if op.input(slot):
            return ctx.get(op.single_input(slot)).reshape(-1).long()
        return torch.full((B,), T, dtype=torch.int64, device=dev)

    hyp_lens, ref_lens = lens('HypLens', T1), lens('RefLens', T2)
    j = torch.arange(T2 + 1, device=dev)[None, :]      # [1, T2 + 1]
    big = torch.full((), 10 ** 6, dtype=torch.int64, device=dev)
    prev = torch.where(j <= ref_lens[:, None], j, big)  # [B, T2 + 1]
    for i in range(T1):
        sub = (ref != hyp[:, i:i + 1]).long()            # [B, T2]
        base = torch.cat([prev[:, :1] + 1,
                          torch.minimum(prev[:, 1:] + 1,
                                        prev[:, :-1] + sub)], dim=1)
        new = j + torch.cummin(base - j, dim=1).values
        prev = torch.where((i < hyp_lens)[:, None], new, prev)
    d = torch.gather(prev, 1, ref_lens.clamp(0, T2)[:, None])[:, 0]
    d = d.to(torch.float32)
    if op.attr('normalized', False):
        d = d / ref_lens.to(torch.float32).clamp(min=1.0)
    ctx.set(op.single_output('Out'), d[:, None])
    if op.output('SequenceNum'):
        ctx.set(op.single_output('SequenceNum'),
                torch.full((), B, dtype=torch.int32, device=dev))


def _edit_distance_infer(op, block):
    h = block.var_recursive(op.single_input('Hyps'))
    out = block.var_recursive(op.single_output('Out'))
    out.shape = [h.shape[0], 1]
    out.dtype = 'float32'
    if op.output('SequenceNum'):
        sn = block.var_recursive(op.single_output('SequenceNum'))
        sn.shape = []
        sn.dtype = 'int32'


register_op('edit_distance', infer_shape=_edit_distance_infer, no_grad=True)
