"""CTC and the single-step and projected RNN units (counterpart of
paddle_tpu/ops/ctc_rnn_ops.py): warpctc, ctc_align, lstm_unit, gru_unit,
lstmp, with the JAX package's vjp slots (:64-66, 112, 142-145, 194-200,
293-298).

- warpctc is the log-space CTC forward recursion over the padded label
  alphabet (blank and label states kept apart), a Python loop over T of
  PyTorch ops like the sequence recurrences: the JAX package's
  optax.ctc_loss step for step, log(0) stood in by -1e5. Its gradient
  comes from autograd through the recursion. torch's ctc_loss is not
  used: its CUDA backward is nondeterministic, and its padding and
  norm_by_times contract is not this op's.
- ctc_align collapses repeats and drops blanks with a cumsum-indexed
  scatter into a static [B, T] output, as the JAX package does.
- lstmp is an LSTM whose carried hidden state is the projected r_t.
  Under AMP its weights and its H0 projection run in the stream dtype,
  as the lstm op's do; the JAX package keeps the H0 projection fp32
  (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register_op, op_emitter, register_vjp_grad
from .sequence_ops import (_ACT, _lens, _time_mask, _time_order,
                           _stack_steps, _zero_past)

_LOG_EPS = -1e5     # optax.ctc_loss's log_epsilon: log(+0)


def _matmul_to(a, b, dtype):
    """a @ b in the promoted dtype of a and b, cast to `dtype` (jnp.matmul
    with preferred_element_type)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt)).to(dtype)


# -- warpctc ------------------------------------------------------------------

def ctc_loss(logits, logit_pad, labels, label_pad, blank):
    """Per-sequence CTC negative log-likelihood [B]: optax.ctc_loss's
    recursion. logits [B, T, K]; logit_pad [B, T] and label_pad [B, N]
    1.0 at padded positions; labels [B, N] int, right-padded."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(1).to(torch.int64)
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype),
                   (0, 1))
    lp_phi = logprobs[:, :, blank]                       # [B, T]
    # the one-hot product of optax: a label outside [0, K) emits 0
    in_range = (labels >= 0) & (labels < K)
    emit = torch.gather(logprobs, 2, labels.clamp(0, K - 1)[:, None, :]
                        .expand(B, T, N))
    emit = torch.where(in_range[:, None, :], emit,
                       torch.zeros((), dtype=emit.dtype,
                                   device=emit.device))
    phi = torch.cat([logits.new_zeros((B, 1)),
                     logits.new_full((B, N), _LOG_EPS)], dim=1)
    em = logits.new_full((B, N), _LOG_EPS)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=1)

    for t in range(T):
        phi_orig = phi
        phi = update_phi(phi, em + _LOG_EPS * repeat)
        e_t, b_t = emit[:, t], lp_phi[:, t:t + 1]
        next_em = torch.logaddexp(phi[:, :-1] + e_t, em + e_t)
        next_phi = update_phi(phi + b_t, em + b_t + _LOG_EPS * (1.0 - repeat))
        pad = logit_pad[:, t:t + 1]
        em = pad * em + (1.0 - pad) * next_em
        phi = pad * phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, em)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


@op_emitter('warpctc')
def _warpctc_emit(ctx, op):
    logits = ctx.get(op.single_input('Logits'))   # [B, T, K] padded
    labels = ctx.get(op.single_input('Label'))    # [B, L] padded int
    if labels.ndim == 3:
        labels = labels[:, :, 0]
    B, T, _ = logits.shape
    L = labels.shape[1]
    lens = _lens(ctx, op, T, B, logits.device)
    if op.input('LabelLens'):
        label_lens = ctx.get(op.single_input('LabelLens')).reshape(-1)
    else:
        label_lens = torch.full((B,), L, dtype=torch.int32,
                                device=logits.device)
    logit_pad = 1.0 - _time_mask(lens, T).float()
    label_pad = 1.0 - _time_mask(label_lens, L).float()
    loss = ctc_loss(logits.float(), logit_pad, labels, label_pad,
                    op.attr('blank', 0))
    if op.attr('norm_by_times', False):
        loss = loss / lens.clamp(min=1).to(loss.dtype)
    ctx.set(op.single_output('Loss'), loss[:, None].to(logits.dtype))


def _warpctc_infer(op, block):
    x = block.var_recursive(op.single_input('Logits'))
    out = block.var_recursive(op.single_output('Loss'))
    out.shape = (x.shape[0], 1)
    out.dtype = x.dtype


register_op('warpctc', infer_shape=_warpctc_infer)
register_vjp_grad('warpctc', in_slots=('Logits',), out_slots=('Loss',),
                  nondiff_slots=('Label', 'SeqLens', 'LabelLens'))


# -- ctc_align: greedy CTC decoding's merge-repeats and drop-blanks -----------

@op_emitter('ctc_align')
def _ctc_align_emit(ctx, op):
    x = ctx.get(op.single_input('Input'))         # [B, T] token ids
    if x.ndim == 3:
        x = x[:, :, 0]
    B, T = x.shape
    lens = _lens(ctx, op, T, B, x.device)
    blank = op.attr('blank', 0)
    valid = _time_mask(lens, T)
    prev = torch.cat([torch.full((B, 1), -1, dtype=x.dtype, device=x.device),
                      x[:, :-1]], dim=1)
    keep = (x != blank) & (x != prev) & valid
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    # the dropped cells land in a scratch column past the output
    out = torch.full((B, T + 1), op.attr('padding_value', 0), dtype=x.dtype,
                     device=x.device)
    out = out.scatter(1, torch.where(keep, pos, T),
                      torch.where(keep, x, torch.zeros_like(x)))[:, :T]
    ctx.set(op.single_output('Output'), out)
    if op.output('OutLens'):
        ctx.set(op.single_output('OutLens'),
                keep.to(torch.int32).sum(1, dtype=torch.int32))


def _ctc_align_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    out = block.var_recursive(op.single_output('Output'))
    out.shape = x.shape[:2]
    out.dtype = x.dtype
    out.lod_level = 1
    if op.output('OutLens'):
        ol = block.var_recursive(op.single_output('OutLens'))
        ol.shape = (x.shape[0],)
        ol.dtype = 'int32'


register_op('ctc_align', infer_shape=_ctc_align_infer, no_grad=True)


# -- lstm_unit / gru_unit: one recurrence step as a plain op -------------------

@op_emitter('lstm_unit')
def _lstm_unit_emit(ctx, op):
    """X [B, 4D]: the pre-activation gates in (i, g, f, o) order;
    C_prev [B, D]."""
    x = ctx.get(op.single_input('X'))
    c_prev = ctx.get(op.single_input('C_prev'))
    i, g, f, o = torch.chunk(x, 4, dim=-1)
    c = c_prev * torch.sigmoid(f + op.attr('forget_bias', 0.0)) + \
        torch.sigmoid(i) * torch.tanh(g)
    ctx.set(op.single_output('C'), c)
    ctx.set(op.single_output('H'), torch.tanh(c) * torch.sigmoid(o))


def _lstm_unit_infer(op, block):
    c_prev = block.var_recursive(op.single_input('C_prev'))
    for slot in ('C', 'H'):
        v = block.var_recursive(op.single_output(slot))
        v.shape = c_prev.shape
        v.dtype = c_prev.dtype


register_op('lstm_unit', infer_shape=_lstm_unit_infer)
register_vjp_grad('lstm_unit', in_slots=('X', 'C_prev'),
                  out_slots=('C', 'H'))


@op_emitter('gru_unit')
def _gru_unit_emit(ctx, op):
    """Input [B, 3D]: the projected x in (update | reset | candidate)
    order; HiddenPrev [B, D]; Weight [D, 3D] = [W_u | W_r | W_c].
    u = σ(x_u + h·W_u), r = σ(x_r + h·W_r), c = act(x_c + (r·h)·W_c),
    h' = u·(c - h) + h."""
    x = ctx.get(op.single_input('Input'))
    h_prev = ctx.get(op.single_input('HiddenPrev'))
    w = ctx.get(op.single_input('Weight'))
    D = h_prev.shape[-1]
    gates_x = x
    if op.input('Bias'):
        gates_x = gates_x + ctx.get(op.single_input('Bias'))
    act = _ACT[op.attr('activation', 'tanh')]
    gate_act = _ACT[op.attr('gate_activation', 'sigmoid')]
    ur = gate_act(gates_x[:, :2 * D] + _matmul_to(h_prev, w[:, :2 * D],
                                                  x.dtype))
    u, r = ur[:, :D], ur[:, D:]
    r_h_prev = r * h_prev
    c = act(gates_x[:, 2 * D:] + _matmul_to(r_h_prev, w[:, 2 * D:], x.dtype))
    ctx.set(op.single_output('Hidden'), u * (c - h_prev) + h_prev)
    if op.output('Gate'):
        ctx.set(op.single_output('Gate'), torch.cat([u, r, c], dim=-1))
    if op.output('ResetHiddenPrev'):
        ctx.set(op.single_output('ResetHiddenPrev'), r_h_prev)


def _gru_unit_infer(op, block):
    h_prev = block.var_recursive(op.single_input('HiddenPrev'))
    out = block.var_recursive(op.single_output('Hidden'))
    out.shape = h_prev.shape
    out.dtype = h_prev.dtype
    if op.output('Gate'):
        g = block.var_recursive(op.single_output('Gate'))
        g.shape = (h_prev.shape[0], 3 * h_prev.shape[1])
        g.dtype = h_prev.dtype
    if op.output('ResetHiddenPrev'):
        r = block.var_recursive(op.single_output('ResetHiddenPrev'))
        r.shape = h_prev.shape
        r.dtype = h_prev.dtype


register_op('gru_unit', infer_shape=_gru_unit_infer)
register_vjp_grad('gru_unit', in_slots=('Input', 'HiddenPrev', 'Weight',
                                        'Bias'), out_slots=('Hidden',))


# -- lstmp: LSTM with a recurrent projection ----------------------------------

@op_emitter('lstmp')
def _lstmp_emit(ctx, op):
    """Input [B, T, 4H] (candidate, input, forget, output), Weight [P, 4H]
    over the carried projection, ProjWeight [H, P], Bias [1, 4H] or with
    peepholes [1, 7H]."""
    x = ctx.get(op.single_input('Input'))
    B, T, H4 = x.shape
    H = H4 // 4
    mask = _time_mask(_lens(ctx, op, T, B, x.device), T)
    peep = op.attr('use_peepholes', False)
    act_g = _ACT[op.attr('gate_activation', 'sigmoid')]
    act_c = _ACT[op.attr('cell_activation', 'tanh')]
    act_h = _ACT[op.attr('candidate_activation', 'tanh')]
    act_p = _ACT[op.attr('proj_activation', 'identity')]
    # AMP: the fp32 parameters are cast down to the activation dtype
    w = ctx.get(op.single_input('Weight')).to(x.dtype)
    proj = ctx.get(op.single_input('ProjWeight')).to(x.dtype)
    b = ctx.get(op.single_input('Bias')).to(x.dtype)
    gate_b = b[:, :4 * H]
    if peep:
        w_ic, w_fc, w_oc = b[:, 4 * H:5 * H], b[:, 5 * H:6 * H], \
            b[:, 6 * H:7 * H]
    r = x.new_zeros((B, proj.shape[1]))
    c = x.new_zeros((B, H))
    if op.input('H0'):
        # the initial hidden enters through the projection
        r = torch.matmul(ctx.get(op.single_input('H0')).to(x.dtype), proj)
    if op.input('C0'):
        c = ctx.get(op.single_input('C0')).to(x.dtype)
    is_reverse = op.attr('is_reverse', False)
    rs, cs = [], []
    for t in _time_order(T, is_reverse):
        gates = x[:, t] + torch.matmul(r, w) + gate_b
        gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
        if peep:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c_new = act_g(gf) * c + act_g(gi) * act_c(gc)
        if peep:
            go = go + c_new * w_oc
        r_new = act_p(torch.matmul(act_g(go) * act_h(c_new), proj))
        active = mask[:, t:t + 1]
        r = torch.where(active, r_new, r)
        c = torch.where(active, c_new, c)
        rs.append(r)
        cs.append(c)
    m3 = mask[:, :, None]
    ctx.set(op.single_output('Projection'),
            _zero_past(_stack_steps(rs, is_reverse), m3))
    ctx.set(op.single_output('Cell'),
            _zero_past(_stack_steps(cs, is_reverse), m3))


def _lstmp_infer(op, block):
    x = block.var_recursive(op.single_input('Input'))
    proj = block.var_recursive(op.single_input('ProjWeight'))
    H = x.shape[-1] // 4
    out = block.var_recursive(op.single_output('Projection'))
    out.shape = tuple(x.shape[:-1]) + (proj.shape[1],)
    out.dtype = x.dtype
    out.lod_level = max(1, x.lod_level)
    cell = block.var_recursive(op.single_output('Cell'))
    cell.shape = tuple(x.shape[:-1]) + (H,)
    cell.dtype = x.dtype
    cell.lod_level = max(1, x.lod_level)


register_op('lstmp', infer_shape=_lstmp_infer)
register_vjp_grad('lstmp', in_slots=('Input', 'Weight', 'ProjWeight', 'Bias',
                                     'H0', 'C0'),
                  out_slots=('Projection', 'Cell'), nondiff_slots=('SeqLens',))
