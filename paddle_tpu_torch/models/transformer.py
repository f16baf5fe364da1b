"""Decoder-only transformer LM, its training entry points and its cached
prefill/decode programs (counterpart of paddle_tpu/models/transformer.py:
26-188, 216-520).

Only the single-device dense path is here: no tensor, sequence, expert
or pipeline parallelism, no ring attention and no rematerialization.
Programs built with the same config and names are the same Program text
as the JAX package's, so weights carry across by name.

Cached-attention mode: a loaded LM program is read by
transpiler/decode_transpiler.py into a DecodeSpec (dims plus the exact
parameter names), and the builders below emit a prefill and a decode
program that bind those names, so both run on the Predictor's weight
Scope without a copy:

  prefill: [pb, T, 1] prompt tokens (+ last real position and target
           slot per prompt) -> causal attention, K/V written into the
           [slots, T, H, dh] ring caches, last-position logits
  decode:  [slots, 1, 1] one token per slot + per-slot position -> ring
           append at position % T, attention over the cache, next-token
           logits.

Every shape is fixed when the programs are built; slot liveness is a
mask (decode_mask), never a shape. The JAX builders also emit
sharding_constraint ops for mesh serving; on one device those are the
identity and are left out here.
"""
from __future__ import annotations

import numpy as np

from .. import layers as L
from .. import unique_name
from ..framework import Program, default_main_program, program_guard
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


class TransformerConfig(object):
    def __init__(self, vocab=1000, dim=64, heads=4, layers=2, ffn=128,
                 max_len=64, use_tp=False, use_sp=False,
                 flash_attention=False):
        if use_tp or use_sp:
            raise NotImplementedError(
                'tensor / sequence parallelism is not ported yet; build '
                'with use_tp=False, use_sp=False')
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.ffn, self.max_len = layers, ffn, max_len
        self.use_tp, self.use_sp = use_tp, use_sp
        # blockwise attention (kernels/flash_attention.py): no [T, T]
        # score tensor
        self.flash_attention = flash_attention


def _attention(x, cfg, prefix):
    D, H = cfg.dim, cfg.heads
    dh = D // H
    T = cfg.max_len
    qkv = L.fc(input=x, size=3 * D, num_flatten_dims=2, name=prefix + '_qkv')

    def heads(sl_start, sl_end):
        part = L.slice(qkv, axes=[2], starts=[sl_start], ends=[sl_end])
        part = L.reshape(part, shape=[-1, T, H, dh])
        return L.transpose(part, perm=[0, 2, 1, 3])        # [B, H, T, dh]

    q, k, v = heads(0, D), heads(D, 2 * D), heads(2 * D, 3 * D)
    if cfg.flash_attention:
        ctx = L.flash_attention(q, k, v, causal=True)      # [B, H, T, dh]
    else:
        scores = L.matmul(q, k, transpose_y=True, alpha=1.0 / np.sqrt(dh))
        probs = L.softmax(L.causal_mask_bias(scores))      # [B, H, T, T]
        ctx = L.matmul(probs, v)                           # [B, H, T, dh]
    ctx = L.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = L.reshape(ctx, shape=[-1, T, D])
    return L.fc(input=ctx, size=D, num_flatten_dims=2, name=prefix + '_proj')


def _ffn(x, cfg, prefix):
    h = L.fc(input=x, size=cfg.ffn, act='gelu', num_flatten_dims=2,
             name=prefix + '_up')
    return L.fc(input=h, size=cfg.dim, num_flatten_dims=2,
                name=prefix + '_down')


def _block(x, cfg, i):
    prefix = 'layer%d' % i
    x = L.elementwise_add(x, _attention(L.layer_norm(x, begin_norm_axis=2),
                                        cfg, prefix))
    return L.elementwise_add(x, _ffn(L.layer_norm(x, begin_norm_axis=2),
                                     cfg, prefix))


def _trunk(tokens, cfg):
    """Embedding + positions + blocks + final norm."""
    emb = L.embedding(tokens, size=[cfg.vocab, cfg.dim])
    x = L.elementwise_add(emb, L.position_embedding(emb, cfg.max_len))
    for i in range(cfg.layers):
        x = _block(x, cfg, i)
    return L.layer_norm(x, begin_norm_axis=2)


def language_model_trunk(tokens, cfg):
    """Embedding + positions + blocks + final norm, without a head: pair
    with layers.fused_softmax_cross_entropy for the logits-free LM loss
    (the training step bench.py measures)."""
    return _trunk(tokens, cfg)


def language_model(tokens, cfg):
    """tokens: [B, T, 1] int64 ids. Returns softmax probabilities
    [B, T, vocab]."""
    return L.fc(input=_trunk(tokens, cfg), size=cfg.vocab,
                num_flatten_dims=2, act='softmax')


def language_model_logits(tokens, cfg):
    """tokens: [B, T, 1] int64 ids. Returns raw logits [B, T, vocab]."""
    return L.fc(input=_trunk(tokens, cfg), size=cfg.vocab,
                num_flatten_dims=2, name='lm_head')


def train_network(tokens, labels, cfg):
    """Full LM training graph: next-token cross entropy over softmax
    probabilities. Returns (probs, avg_cost)."""
    probs = language_model(tokens, cfg)
    avg_cost = L.mean(L.cross_entropy(input=probs, label=labels))
    return probs, avg_cost


# ---------------------------------------------------------------------------
# Cached-attention mode: prefill + decode builders
# ---------------------------------------------------------------------------

class DecodeSpec(object):
    """Dims + parameter names recovered from a loaded LM program.

    blocks[i] maps ln1/ln2 -> (scale_name, bias_name) and
    qkv/proj/up/down -> (w_name, b_name); final_ln is (scale, bias);
    head is (w_name, b_name_or_None). pos_len is the positional TABLE
    length (>= max_len, the sequence length the programs are built for).
    """

    def __init__(self, vocab, dim, heads, layers, ffn, max_len, pos_len,
                 emb_w, pos_w, blocks, final_ln, head, use_flash=False):
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.ffn = layers, ffn
        self.max_len, self.pos_len = max_len, pos_len
        self.dh = dim // heads
        self.emb_w, self.pos_w = emb_w, pos_w
        self.blocks = blocks
        self.final_ln = final_ln
        self.head = head
        self.use_flash = use_flash

    def cache_names(self, layer=None):
        """Ring-cache var names, shared by the prefill/decode pair."""
        if layer is not None:
            return ('kv_cache.layer%d.k' % layer,
                    'kv_cache.layer%d.v' % layer)
        out = []
        for i in range(self.layers):
            out.extend(self.cache_names(i))
        return out

    def cache_shape(self, slots):
        return (slots, self.max_len, self.heads, self.dh)

    def param_names(self):
        names = [self.emb_w, self.pos_w,
                 self.final_ln[0], self.final_ln[1], self.head[0]]
        if self.head[1]:
            names.append(self.head[1])
        for blk in self.blocks:
            for key in ('ln1', 'ln2', 'qkv', 'proj', 'up', 'down'):
                names.extend(n for n in blk[key] if n)
        return names


def _named_attr(name):
    return ParamAttr(name=name) if name else False


def _named_fc(x, size, pair, act=None, num_flatten_dims=2):
    return L.fc(input=x, size=size, num_flatten_dims=num_flatten_dims,
                param_attr=_named_attr(pair[0]),
                bias_attr=_named_attr(pair[1]), act=act)


def _named_ln(x, pair):
    return L.layer_norm(x, begin_norm_axis=2,
                        param_attr=_named_attr(pair[0]),
                        bias_attr=_named_attr(pair[1]))


def _block_op(op_type, inputs, outputs):
    default_main_program().current_block().append_op(
        type=op_type, inputs=inputs, outputs=outputs)


def _tmp_var(dtype='float32'):
    return default_main_program().current_block().create_var(
        name=unique_name.generate('kv_decode.tmp'), dtype=dtype)


def _create_cache_vars(spec, slots):
    """Per-layer K/V ring vars: persistable (the executor keeps them in
    the Scope across runs; the cache ops update them in place) and
    is_cache (io.py never saves or loads them)."""
    block = default_main_program().global_block()
    return [tuple(block.create_var(name=n, shape=spec.cache_shape(slots),
                                   dtype='float32', persistable=True,
                                   stop_gradient=True, is_cache=True)
                  for n in spec.cache_names(i))
            for i in range(spec.layers)]


def _qkv_parts(x, spec, blk, t):
    """qkv fc + per-part slice/reshape to [-1, t, H, dh], the caches'
    storage layout."""
    qkv = _named_fc(x, 3 * spec.dim, blk['qkv'])
    D = spec.dim

    def part(s, e):
        p = L.slice(qkv, axes=[2], starts=[s], ends=[e])
        return L.reshape(p, shape=[-1, t, spec.heads, spec.dh])

    return part(0, D), part(D, 2 * D), part(2 * D, 3 * D)


def _heads_first(x):
    return L.transpose(x, perm=[0, 2, 1, 3])


def _prefill_attention(x, spec, blk, cache, slot_idx):
    q4, k4, v4 = _qkv_parts(x, spec, blk, spec.max_len)
    for cache_var, new in ((cache[0], k4), (cache[1], v4)):
        _block_op('kv_cache_write',
                  inputs={'Cache': [cache_var], 'X': [new],
                          'Slots': [slot_idx]},
                  outputs={'Out': [cache_var]})
    q, k, v = _heads_first(q4), _heads_first(k4), _heads_first(v4)
    if spec.use_flash:
        ctx = L.flash_attention(q, k, v, causal=True)  # [pb, H, T, dh]
    else:
        scores = L.matmul(q, k, transpose_y=True,
                          alpha=1.0 / np.sqrt(spec.dh))
        ctx = L.matmul(L.softmax(L.causal_mask_bias(scores)), v)
    ctx = L.reshape(_heads_first(ctx), shape=[-1, spec.max_len, spec.dim])
    return _named_fc(ctx, spec.dim, blk['proj'])


def _decode_attention(x, spec, blk, cache, step_idx):
    q1, k1, v1 = _qkv_parts(x, spec, blk, 1)           # [S, 1, H, dh]
    for cache_var, new in ((cache[0], k1), (cache[1], v1)):
        _block_op('kv_cache_append',
                  inputs={'Cache': [cache_var], 'X': [new],
                          'StepIdx': [step_idx]},
                  outputs={'Out': [cache_var]})
    scores = L.matmul(_heads_first(q1), _heads_first(cache[0]),
                      transpose_y=True,
                      alpha=1.0 / np.sqrt(spec.dh))    # [S, H, 1, T]
    masked = _tmp_var()
    _block_op('decode_mask', inputs={'X': [scores], 'StepIdx': [step_idx]},
              outputs={'Out': [masked]})
    ctx = L.matmul(L.softmax(masked), _heads_first(cache[1]))
    ctx = L.reshape(_heads_first(ctx), shape=[-1, 1, spec.dim])
    return _named_fc(ctx, spec.dim, blk['proj'])


def _cached_block(x, spec, i, attention):
    blk = spec.blocks[i]
    x = L.elementwise_add(x, attention(_named_ln(x, blk['ln1']), blk))
    ffn = _named_fc(_named_ln(x, blk['ln2']), spec.ffn, blk['up'],
                    act='gelu')
    return L.elementwise_add(x, _named_fc(ffn, spec.dim, blk['down']))


def build_prefill_program(spec, slots, batch=1):
    """Prefill program over `batch` prompt rows (padded to max_len).

    Feeds:  prefill_tokens [batch, T, 1] int64, prefill_pos [batch]
            int32 (index of each prompt's LAST real token, len - 1),
            prefill_slots [batch] int32 (target cache slots).
    Writes every layer's K/V rows for the fed slots, then gathers each
    prompt's last real position before the lm_head.
    Returns (program, feed_names, fetch_vars[logits [batch, V],
    ids [batch]]).
    """
    prog, startup = Program(), Program()
    prog._is_test = True
    with program_guard(prog, startup):
        tokens = L.data('prefill_tokens', [batch, spec.max_len, 1],
                        append_batch_size=False, dtype='int64')
        pos_idx = L.data('prefill_pos', [batch],
                         append_batch_size=False, dtype='int32')
        slot_idx = L.data('prefill_slots', [batch],
                          append_batch_size=False, dtype='int32')
        caches = _create_cache_vars(spec, slots)
        emb = L.embedding(tokens, size=[spec.vocab, spec.dim],
                          param_attr=_named_attr(spec.emb_w))
        pos = L.position_embedding(emb, spec.pos_len,
                                   param_attr=_named_attr(spec.pos_w))
        x = L.elementwise_add(emb, pos)
        for i in range(spec.layers):
            x = _cached_block(
                x, spec, i,
                lambda ln, blk, _i=i: _prefill_attention(
                    ln, spec, blk, caches[_i], slot_idx))
        x = _named_ln(x, spec.final_ln)
        last = _tmp_var()
        _block_op('gather_time', inputs={'X': [x], 'Index': [pos_idx]},
                  outputs={'Out': [last]})               # [batch, D]
        logits = _named_fc(last, spec.vocab, spec.head, num_flatten_dims=1)
        ids = L.argmax(logits, axis=-1)
    return prog, ['prefill_tokens', 'prefill_pos', 'prefill_slots'], \
        [logits, ids]


def build_decode_program(spec, slots):
    """One-token decode step over the whole slot pool.

    Feeds:  decode_tokens [slots, 1, 1] int64 (each slot's last token),
            decode_step_idx [slots] int32 (its absolute position; the
            ring write lands at step_idx % T).
    Idle slots compute values the caller ignores; their cache rows are
    rewritten whole at admission.
    Returns (program, feed_names, fetch_vars[logits [slots, V],
    ids [slots]]).
    """
    prog, startup = Program(), Program()
    prog._is_test = True
    with program_guard(prog, startup):
        tokens = L.data('decode_tokens', [slots, 1, 1],
                        append_batch_size=False, dtype='int64')
        step_idx = L.data('decode_step_idx', [slots],
                          append_batch_size=False, dtype='int32')
        caches = _create_cache_vars(spec, slots)
        emb = L.embedding(tokens, size=[spec.vocab, spec.dim],
                          param_attr=_named_attr(spec.emb_w))      # [S,1,D]
        # per-slot row of the positional TABLE: every slot sits at its
        # own position
        helper = LayerHelper('position_embedding',
                             param_attr=_named_attr(spec.pos_w))
        pos_var = helper.create_parameter(
            attr=helper.param_attr, shape=[spec.pos_len, spec.dim],
            dtype='float32')
        pos = _tmp_var()
        _block_op('position_embedding_at',
                  inputs={'Pos': [pos_var], 'Index': [step_idx]},
                  outputs={'Out': [pos]})                # [S, 1, D]
        x = L.elementwise_add(emb, pos)
        for i in range(spec.layers):
            x = _cached_block(
                x, spec, i,
                lambda ln, blk, _i=i: _decode_attention(
                    ln, spec, blk, caches[_i], step_idx))
        x = _named_ln(x, spec.final_ln)
        logits = L.reshape(_named_fc(x, spec.vocab, spec.head),
                           shape=[-1, spec.vocab])
        ids = L.argmax(logits, axis=-1)
    return prog, ['decode_tokens', 'decode_step_idx'], [logits, ids]
