"""DecodeTranspiler: loaded LM program -> prefill + decode pair
(counterpart of paddle_tpu/transpiler/decode_transpiler.py, dense pair
only).

It READS the loaded language-model program, walking the op sequence
models/transformer.py emits, to recover the architecture (dims, heads,
layers, flash or naive attention) and the exact parameter names, then
asks the cached-attention builders for two programs that bind those
names. Both run on the Predictor's weight Scope: transpiling moves no
weights.

Recognized source: the decoder-only LM of `language_model_logits` —
lookup_table, position_embedding, per block [layer_norm, qkv mul, proj
mul, layer_norm, up mul, down mul] (+ flash_attention or the
matmul/causal_mask/softmax triple), final layer_norm, lm_head mul.
Anything else raises DecodeTranspileError naming what is missing.
"""
from __future__ import annotations

from ..models.transformer import (DecodeSpec, build_prefill_program,
                                  build_decode_program)

__all__ = ['DecodeTranspileError', 'DecodePair', 'DecodeTranspiler',
           'extract_decode_spec']


class DecodeTranspileError(ValueError):
    """The loaded program is not a transpilable decoder-only LM."""


class DecodePair(object):
    """The transpile result: spec + both programs and their feed/fetch
    ABIs. Fetch order is [logits, greedy_ids] for both; the cache var
    names are shared, so one Scope carries the ring state from prefill
    into decode."""

    def __init__(self, spec, slots, prefill_batch,
                 prefill_program, prefill_feeds, prefill_fetches,
                 decode_program, decode_feeds, decode_fetches):
        self.spec = spec
        self.slots = slots
        self.prefill_batch = prefill_batch
        self.prefill_program = prefill_program
        self.prefill_feeds = prefill_feeds
        self.prefill_fetches = prefill_fetches
        self.decode_program = decode_program
        self.decode_feeds = decode_feeds
        self.decode_fetches = decode_fetches

    @property
    def cache_names(self):
        return self.spec.cache_names()


def _fail(msg):
    raise DecodeTranspileError(
        'cannot transpile program for cached decoding: %s (expected a '
        'decoder-only LM from models.transformer.language_model_logits)'
        % msg)


def extract_decode_spec(program):
    """Scan the loaded program and return its DecodeSpec."""
    block = program.global_block()
    emb_w = pos_w = None
    lns = []          # (scale_name, bias_name) in op order
    muls = []         # (w_name, out_name) in op order
    bias_of = {}      # mul out name -> persistable bias name
    reshape4 = None
    use_flash = False

    for op in block.ops:
        t = op.type
        if t == 'lookup_table' and emb_w is None:
            emb_w = op.single_input('W')
        elif t == 'position_embedding' and pos_w is None:
            pos_w = op.single_input('Pos')
        elif t == 'layer_norm':
            lns.append((op.single_input('Scale') if op.input('Scale')
                        else None,
                        op.single_input('Bias') if op.input('Bias')
                        else None))
        elif t == 'mul':
            muls.append((op.single_input('Y'), op.single_output('Out')))
        elif t == 'flash_attention':
            use_flash = True
        elif t in ('moe_ffn', 'ring_attention'):
            _fail('op %s has no cached-decode equivalent in this port' % t)
        elif t == 'reshape2' and reshape4 is None:
            shp = op.attr('shape') or []
            if len(shp) == 4:
                reshape4 = list(shp)
        elif t == 'elementwise_add':
            try:
                yv = block.var_recursive(op.single_input('Y'))
            except KeyError:
                continue
            if yv.persistable:
                bias_of[op.single_input('X')] = yv.name

    if emb_w is None:
        _fail('no lookup_table op (token embedding)')
    if pos_w is None:
        _fail('no position_embedding op')
    if reshape4 is None:
        _fail('no 4-d attention head reshape')
    if len(muls) < 5 or (len(muls) - 1) % 4:
        _fail('%d mul ops do not form 4*layers+1 (qkv/proj/up/down per '
              'block + lm_head)' % len(muls))
    layers = (len(muls) - 1) // 4
    if len(lns) != 2 * layers + 1:
        _fail('%d layer_norms for %d layers (want 2*layers+1)'
              % (len(lns), layers))

    max_len, heads, dh = reshape4[1], reshape4[2], reshape4[3]
    emb_shape = block.var_recursive(emb_w).shape
    if emb_shape is None or len(emb_shape) != 2:
        _fail('embedding table %r has no [vocab, dim] shape' % emb_w)
    vocab, dim = int(emb_shape[0]), int(emb_shape[1])
    if heads * dh != dim:
        _fail('head reshape %r inconsistent with dim %d' % (reshape4, dim))
    pos_len = int(block.var_recursive(pos_w).shape[0])
    ffn = int(block.var_recursive(muls[2][0]).shape[1])

    def pair(i):
        w, out = muls[i]
        return (w, bias_of.get(out))

    blocks = []
    for i in range(layers):
        base = 4 * i
        blk = {'ln1': lns[2 * i], 'ln2': lns[2 * i + 1],
               'qkv': pair(base), 'proj': pair(base + 1),
               'up': pair(base + 2), 'down': pair(base + 3)}
        qkv_shape = block.var_recursive(blk['qkv'][0]).shape
        if tuple(qkv_shape) != (dim, 3 * dim):
            _fail('layer %d qkv weight %r is %r, want (%d, %d)'
                  % (i, blk['qkv'][0], tuple(qkv_shape), dim, 3 * dim))
        blocks.append(blk)

    return DecodeSpec(vocab=vocab, dim=dim, heads=heads, layers=layers,
                      ffn=ffn, max_len=max_len, pos_len=pos_len,
                      emb_w=emb_w, pos_w=pos_w, blocks=blocks,
                      final_ln=lns[-1], head=pair(len(muls) - 1),
                      use_flash=use_flash)


class DecodeTranspiler(object):
    def transpile(self, program, slots=8, prefill_batch=1):
        """program: a loaded inference Program (AnalysisPredictor's).
        Returns a DecodePair over a `slots`-slot ring cache whose prefill
        takes `prefill_batch` prompts per call."""
        if slots < 1:
            raise ValueError('slots must be >= 1, got %r' % (slots,))
        if not 1 <= prefill_batch <= slots:
            raise ValueError('prefill_batch must be in [1, slots]')
        spec = extract_decode_spec(program)
        pp, pf, pv = build_prefill_program(spec, slots, batch=prefill_batch)
        dp, df, dv = build_decode_program(spec, slots)
        return DecodePair(spec, slots, prefill_batch,
                          pp, pf, pv, dp, df, dv)
