"""Decoder-only transformer LM, its training entry points and its cached
prefill/decode programs (counterpart of paddle_tpu/models/transformer.py:
26-188, 216-520).

The tensor- and sequence-parallel annotations of the default config
(use_tp, use_sp) are built always: inert on one card, the layouts of a
ParallelExecutor over ranks on a mesh; with moe_experts each block's FFN
is parallel.layers.moe_layer (its experts over 'ep' on a mesh); with
ring_attention the attention is the sp ring; with pp_stages the blocks
are split into pipeline stages (pipeline_stage_guard), which
ParallelExecutor runs through the GPipe engine on a pp mesh.
TransformerConfig(remat=) runs each block in a rematerialization scope
(layers.recompute), as in the JAX package. Programs built with the same config and names are the same
Program text as the JAX package's, so weights carry across by name.

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

Paged mode (serving/paged.py) replaces the rings by one
[num_pages, page_tokens, H, dh] pool per layer and K/V and a per-slot
page table fed each run (build_paged_prefill_program,
build_paged_decode_program, build_verify_program). Allocation, copy-on-
write and prefix sharing are host decisions that change feed values
only, so each program is captured once. Paged attention is the plain
ops (kv_page_gather, matmul, a mask op, softmax, matmul), as in the JAX
package, which reaches no Pallas kernel on this path either.

Every shape is fixed when the programs are built; slot liveness is a
mask (decode_mask), never a shape. Each program carries the JAX
package's sharding_constraint ops and is its program op for op: on one
device a constraint is the identity; on a serving mesh
(serving/mesh.py) it pins q/k/v and the K/V state heads-sharded
(DecodeSpec.cache_spec) and gathers every sharded contraction input
whole before its fc, so each output element reduces in one-device
order.
"""
from __future__ import annotations

import numpy as np

from .. import layers as L
from .. import unique_name
from ..framework import Program, default_main_program, program_guard
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from ..parallel.api import sharding_constraint, pipeline_stage_guard
from ..parallel.layers import (column_parallel_fc, row_parallel_fc,
                               vocab_parallel_embedding, moe_layer,
                               sequence_parallel_scope)


class TransformerConfig(object):
    """The JAX package's config with its defaults (use_tp=True,
    use_sp=True): on one card the tensor- and sequence-parallel
    annotations are inert (parallel/layers.py), so the default config
    builds and trains the same Program as the JAX package.
    moe_experts=E makes each block's FFN a top-1 mixture of E experts
    (moe_layer's defaults). ring_attention=True runs attention through
    the sp ring (parallel.layers.ring_attention; ordinary attention off
    a mesh). pp_stages=S groups the blocks into S uniform pipeline
    stages (the layers must divide; checked when the program is built,
    as in the JAX package).
    remat: None (keep every activation), 'nothing' (each block keeps
    only its output; the backward runs the block again) or 'dots' (it
    also keeps the matrix products' outputs); any other truthy value
    means 'nothing', as in the JAX package."""

    def __init__(self, vocab=1000, dim=64, heads=4, layers=2, ffn=128,
                 max_len=64, moe_experts=0, use_tp=True, use_sp=True,
                 pp_stages=0, ring_attention=False,
                 flash_attention=False, remat=None):
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.ffn, self.max_len = layers, ffn, max_len
        self.moe_experts, self.pp_stages = moe_experts, pp_stages
        self.use_tp, self.use_sp = use_tp, use_sp
        self.ring_attention = ring_attention
        # blockwise attention (kernels/flash_attention.py): no [T, T]
        # score tensor
        self.flash_attention = flash_attention
        self.remat = remat


def _attention(x, cfg, prefix):
    """Multi-head self-attention; under use_tp qkv is column-parallel and
    the output projection row-parallel, with the JAX package's
    constraints."""
    D, H = cfg.dim, cfg.heads
    dh = D // H
    T = cfg.max_len
    if cfg.use_tp:
        qkv = column_parallel_fc(x, 3 * D, name=prefix + '_qkv')
    else:
        qkv = L.fc(input=x, size=3 * D, num_flatten_dims=2,
                   name=prefix + '_qkv')

    def heads(sl_start, sl_end):
        part = L.slice(qkv, axes=[2], starts=[sl_start], ends=[sl_end])
        part = L.reshape(part, shape=[-1, T, H, dh])
        part = L.transpose(part, perm=[0, 2, 1, 3])        # [B, H, T, dh]
        if cfg.use_tp:
            # under ring attention T stays sharded over sp
            t_ax = 'sp' if (cfg.ring_attention and cfg.use_sp) else None
            part = sharding_constraint(part, ('dp', 'tp', t_ax, None))
        return part

    q, k, v = heads(0, D), heads(D, 2 * D), heads(2 * D, 3 * D)
    if cfg.ring_attention:
        from ..parallel.layers import ring_attention
        ctx = ring_attention(q, k, v, causal=True)         # [B, H, T, dh]
    elif cfg.flash_attention:
        ctx = L.flash_attention(q, k, v, causal=True)      # [B, H, T, dh]
    else:
        scores = L.matmul(q, k, transpose_y=True, alpha=1.0 / np.sqrt(dh))
        probs = L.softmax(L.causal_mask_bias(scores))      # [B, H, T, T]
        ctx = L.matmul(probs, v)                           # [B, H, T, dh]
    ctx = L.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = L.reshape(ctx, shape=[-1, T, D])
    if cfg.use_tp:
        ctx = sharding_constraint(ctx, ('dp', None, 'tp'))
        return row_parallel_fc(ctx, D, name=prefix + '_proj')
    return L.fc(input=ctx, size=D, num_flatten_dims=2, name=prefix + '_proj')


def _ffn(x, cfg, prefix):
    if cfg.moe_experts:
        return moe_layer(x, cfg.moe_experts, cfg.ffn)
    if cfg.use_tp:
        h = column_parallel_fc(x, cfg.ffn, act='gelu', name=prefix + '_up')
        return row_parallel_fc(h, cfg.dim, name=prefix + '_down')
    h = L.fc(input=x, size=cfg.ffn, act='gelu', num_flatten_dims=2,
             name=prefix + '_up')
    return L.fc(input=h, size=cfg.dim, num_flatten_dims=2,
                name=prefix + '_down')


def _block(x, cfg, i):
    prefix = 'layer%d' % i
    ln1 = L.layer_norm(x, begin_norm_axis=2)
    if cfg.use_sp:
        ln1 = sequence_parallel_scope(ln1)
    x = L.elementwise_add(x, _attention(ln1, cfg, prefix))
    ln2 = L.layer_norm(x, begin_norm_axis=2)
    if cfg.use_sp:
        ln2 = sequence_parallel_scope(ln2)
    return L.elementwise_add(x, _ffn(ln2, cfg, prefix))


def _trunk(tokens, cfg):
    """Embedding + positions + blocks + final norm."""
    if cfg.use_tp:
        emb = vocab_parallel_embedding(tokens, [cfg.vocab, cfg.dim])
    else:
        emb = L.embedding(tokens, size=[cfg.vocab, cfg.dim])
    x = L.elementwise_add(emb, L.position_embedding(emb, cfg.max_len))
    return L.layer_norm(_blocks(x, cfg), begin_norm_axis=2)


def _blocks(x, cfg):
    """Every block; with cfg.pp_stages, grouped into uniform pipeline
    stages by pipeline_stage_guard (remat is not applied there, as in
    the JAX package)."""
    if cfg.pp_stages:
        if cfg.layers % cfg.pp_stages:
            raise ValueError('layers %d not divisible by pp_stages %d'
                             % (cfg.layers, cfg.pp_stages))
        for i in range(cfg.layers):
            with pipeline_stage_guard(i * cfg.pp_stages // cfg.layers):
                x = _block(x, cfg, i)
        return x
    for i in range(cfg.layers):
        if cfg.remat:
            policy = 'dots' if cfg.remat == 'dots' else 'nothing'
            x = L.recompute(lambda h, i=i: _block(h, cfg, i), x,
                            policy=policy)
        else:
            x = _block(x, cfg, i)
    return x


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

    param_specs maps weight name -> its recovered training sharding
    spec in tuple form (None = replicated); the transpiler fills it from
    dist_attr and the surviving sharding_constraint ops, so mesh serving
    can shard the same scope. mesh is the serving mesh spec string
    ('tp=2'; '' = one device), stamped by the predictor.
    """

    def __init__(self, vocab, dim, heads, layers, ffn, max_len, pos_len,
                 emb_w, pos_w, blocks, final_ln, head, use_flash=False,
                 param_specs=None, mesh=''):
        self.vocab, self.dim, self.heads = vocab, dim, heads
        self.layers, self.ffn = layers, ffn
        self.max_len, self.pos_len = max_len, pos_len
        self.dh = dim // heads
        self.emb_w, self.pos_w = emb_w, pos_w
        self.blocks = blocks
        self.final_ln = final_ln
        self.head = head
        self.use_flash = use_flash
        self.param_specs = dict(param_specs or {})
        self.mesh = mesh

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

    def pool_names(self, layer=None):
        """Paged K/V pool var names, shared by the paged programs."""
        if layer is not None:
            return ('kv_pool.layer%d.k' % layer,
                    'kv_pool.layer%d.v' % layer)
        out = []
        for i in range(self.layers):
            out.extend(self.pool_names(i))
        return out

    def pool_shape(self, num_pages, page_tokens):
        return (num_pages, page_tokens, self.heads, self.dh)

    def cache_spec(self):
        """The sharding spec (tuple form) of the K/V state: the heads
        axis over tp. Dim 2 is H in both layouts (rings [slots, T, H, dh]
        and pools [pages, pt, H, dh]), so one spec covers dense and paged
        serving. A flash spec serves replicated (_tp_ax)."""
        return (None, None, _tp_ax(self), None)

    def serve_param_specs(self):
        """param_specs cut to the layouts that keep greedy decode in
        one-device order: column-style only (last dim sharded, the
        contraction dim whole), so every output element is reduced on one
        rank in the one-device order and the gathers are pure data
        movement. A row-parallel weight (dim 0 sharded) would split the
        contraction into a sum in another order, so it is served
        replicated."""
        out = {}
        for name, spec in self.param_specs.items():
            if not spec or len(spec) < 2:
                continue
            if spec[-1] is not None and \
                    all(s is None for s in spec[:-1]):
                out[name] = tuple(spec)
        return out

    def param_names(self):
        names = [self.emb_w, self.pos_w,
                 self.final_ln[0], self.final_ln[1], self.head[0]]
        if self.head[1]:
            names.append(self.head[1])
        for blk in self.blocks:
            for key in ('ln1', 'ln2', 'qkv', 'proj', 'up', 'down'):
                names.extend(n for n in blk[key] if n)
        return names


def _tp_ax(spec):
    """The model axis the cached programs shard on: None (replicated)
    for a flash spec, whose kernel runs every head of its input, as the
    JAX package's Pallas kernel is opaque to GSPMD."""
    return None if spec.use_flash else 'tp'


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
    storage layout, each part pinned to the K/V state's layout (heads
    over tp on a mesh; the identity on one device). The qkv contraction
    dim stays whole either way."""
    qkv = _named_fc(x, 3 * spec.dim, blk['qkv'])
    D = spec.dim

    def part(s, e):
        p = L.slice(qkv, axes=[2], starts=[s], ends=[e])
        p = L.reshape(p, shape=[-1, t, spec.heads, spec.dh])
        return sharding_constraint(p, (None, None, _tp_ax(spec), None))

    return part(0, D), part(D, 2 * D), part(2 * D, 3 * D)


def _heads_first(x, spec):
    """[B, t, H, dh] -> [B, H, t, dh], pinned heads-sharded on a mesh."""
    return sharding_constraint(L.transpose(x, perm=[0, 2, 1, 3]),
                               (None, _tp_ax(spec), None, None))


def _gathered_ctx(ctx, spec, rows):
    """[B, H, rows, dh] -> [B, rows, D], replicated before the proj
    contraction: the gather of the per-head context is data movement,
    and the full-D dot then reduces in one-device order."""
    ctx = L.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = L.reshape(ctx, shape=[-1, rows, spec.dim])
    return sharding_constraint(ctx, (None, None, None))


def _prefill_attention(x, spec, blk, cache, slot_idx):
    q4, k4, v4 = _qkv_parts(x, spec, blk, spec.max_len)
    for cache_var, new in ((cache[0], k4), (cache[1], v4)):
        _block_op('kv_cache_write',
                  inputs={'Cache': [cache_var], 'X': [new],
                          'Slots': [slot_idx]},
                  outputs={'Out': [cache_var]})
    q, k, v = (_heads_first(q4, spec), _heads_first(k4, spec),
               _heads_first(v4, spec))
    if spec.use_flash:
        ctx = L.flash_attention(q, k, v, causal=True)  # [pb, H, T, dh]
    else:
        scores = L.matmul(q, k, transpose_y=True,
                          alpha=1.0 / np.sqrt(spec.dh))
        ctx = L.matmul(L.softmax(L.causal_mask_bias(scores)), v)
    return _named_fc(_gathered_ctx(ctx, spec, spec.max_len), spec.dim,
                     blk['proj'])


def _decode_attention(x, spec, blk, cache, step_idx):
    q1, k1, v1 = _qkv_parts(x, spec, blk, 1)           # [S, 1, H, dh]
    for cache_var, new in ((cache[0], k1), (cache[1], v1)):
        _block_op('kv_cache_append',
                  inputs={'Cache': [cache_var], 'X': [new],
                          'StepIdx': [step_idx]},
                  outputs={'Out': [cache_var]})
    q = _heads_first(q1, spec)                         # [S, H, 1, dh]
    kt = _heads_first(cache[0], spec)                  # [S, H, T, dh]
    vt = _heads_first(cache[1], spec)
    scores = L.matmul(q, kt, transpose_y=True,
                      alpha=1.0 / np.sqrt(spec.dh))    # [S, H, 1, T]
    masked = _tmp_var()
    _block_op('decode_mask', inputs={'X': [scores], 'StepIdx': [step_idx]},
              outputs={'Out': [masked]})
    ctx = L.matmul(L.softmax(masked), vt)              # [S, H, 1, dh]
    return _named_fc(_gathered_ctx(ctx, spec, 1), spec.dim, blk['proj'])


def _cached_block(x, spec, i, attention):
    blk = spec.blocks[i]
    x = L.elementwise_add(x, attention(_named_ln(x, blk['ln1']), blk))
    ffn = _named_fc(_named_ln(x, blk['ln2']), spec.ffn, blk['up'],
                    act='gelu')
    # a column-sharded up weight leaves the gelu output ffn-sharded: it
    # is gathered whole before the down contraction, which then reduces
    # in one-device order
    ffn = sharding_constraint(ffn, (None, None, None))
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


# ---------------------------------------------------------------------------
# Paged-cache mode (serving/paged.py): page-table builders
# (paddle_tpu/models/transformer.py:561-866)
# ---------------------------------------------------------------------------

def _create_pool_vars(spec, num_pages, page_tokens):
    """Per-layer K/V page-pool vars: persistable (kept in the Scope and
    written in place by the page ops) and is_cache (never saved)."""
    block = default_main_program().global_block()
    return [tuple(block.create_var(
        name=n, shape=spec.pool_shape(num_pages, page_tokens),
        dtype='float32', persistable=True, stop_gradient=True,
        is_cache=True) for n in spec.pool_names(i))
        for i in range(spec.layers)]


def _paged_gather(pool_var, table, spec):
    g = _tmp_var()
    _block_op('kv_page_gather', inputs={'Pool': [pool_var],
                                        'Table': [table]},
              outputs={'Out': [g]})                    # [B, J, H, dh]
    return _heads_first(g, spec)                       # [B, H, J, dh]


def _paged_attention(x, spec, blk, pool, table, positions, cow_src,
                     cow_dst, rows, write, mask):
    """COW the forked pages, write this run's K/V rows through the table
    (`write`: 'kv_page_write' with its extra inputs, or
    'kv_page_append'), then attend every query row over the gathered
    history with the `mask` op."""
    q4, k4, v4 = _qkv_parts(x, spec, blk, rows)        # [B, rows, H, dh]
    op_type, extra = write
    for pool_var, new in ((pool[0], k4), (pool[1], v4)):
        _block_op('kv_page_cow',
                  inputs={'Pool': [pool_var], 'Src': [cow_src],
                          'Dst': [cow_dst]},
                  outputs={'Out': [pool_var]})
        inputs = {'Pool': [pool_var], 'X': [new], 'Table': [table],
                  'Positions': [positions]}
        inputs.update(extra)
        _block_op(op_type, inputs=inputs, outputs={'Out': [pool_var]})
    q = _heads_first(q4, spec)
    kt = _paged_gather(pool[0], table, spec)           # [B, H, J, dh]
    vt = _paged_gather(pool[1], table, spec)
    scores = L.matmul(q, kt, transpose_y=True,
                      alpha=1.0 / np.sqrt(spec.dh))    # [B, H, rows, J]
    masked = _tmp_var()
    _block_op(mask, inputs={'X': [scores], 'Positions': [positions]},
              outputs={'Out': [masked]})
    ctx = L.matmul(L.softmax(masked), vt)              # [B, H, rows, dh]
    return _named_fc(_gathered_ctx(ctx, spec, rows), spec.dim,
                     blk['proj'])


def _paged_pos_embedding(spec, index):
    """Positional rows by absolute index (paged positions never wrap):
    Index [rows] -> [rows, 1, D]; Index [S, R] -> [S, R, D]."""
    helper = LayerHelper('position_embedding',
                         param_attr=_named_attr(spec.pos_w))
    pos_var = helper.create_parameter(
        attr=helper.param_attr, shape=[spec.pos_len, spec.dim],
        dtype='float32')
    pos = _tmp_var()
    _block_op('position_embedding_at',
              inputs={'Pos': [pos_var], 'Index': [index]},
              outputs={'Out': [pos]})
    return pos


def _paged_trunk(spec, tokens, pos_fn, attention):
    """The token embedding, then the positional rows (`pos_fn()`), in
    the JAX package's op order, the blocks and the final norm."""
    emb = L.embedding(tokens, size=[spec.vocab, spec.dim],
                      param_attr=_named_attr(spec.emb_w))
    x = L.elementwise_add(emb, pos_fn())
    for i in range(spec.layers):
        x = _cached_block(x, spec, i,
                          lambda ln, blk, _i=i: attention(ln, blk, _i))
    return _named_ln(x, spec.final_ln)


def _int_data(name, shape, dtype='int32'):
    return L.data(name, shape, append_batch_size=False, dtype=dtype)


def build_paged_prefill_program(spec, chunk, num_pages, page_tokens,
                                pages_per_slot):
    """One prefill CHUNK through one stream's page table.

    Feeds:  prefill_tokens [1, C, 1] int64 (chunk tokens, zero-padded),
            prefill_positions [C] int32 (absolute position a row: chunk
            start + arange; rows >= Len are padding),
            prefill_len [1] int32 (live rows this chunk),
            prefill_last [1] int32 (Len - 1, the row whose logits are
            taken),
            prefill_page_table [1, P] int32 (the stream's table; entries
            past the written extent are 0, the null page),
            prefill_cow_src / prefill_cow_dst [1] int32 (the page copy
            to apply before the write; (0, 0) when none).
    A prefix hit arrives with its shared pages in the table and its
    chunk starting at the first unshared position. Only the final
    chunk's logits mean anything.
    Returns (program, feed_names, fetch_vars[logits [1, V], ids [1]]).
    """
    prog, startup = Program(), Program()
    prog._is_test = True
    with program_guard(prog, startup):
        tokens = _int_data('prefill_tokens', [1, chunk, 1], 'int64')
        positions = _int_data('prefill_positions', [chunk])
        length = _int_data('prefill_len', [1])
        last = _int_data('prefill_last', [1])
        table = _int_data('prefill_page_table', [1, pages_per_slot])
        cow_src = _int_data('prefill_cow_src', [1])
        cow_dst = _int_data('prefill_cow_dst', [1])
        pools = _create_pool_vars(spec, num_pages, page_tokens)
        write = ('kv_page_write', {'Len': [length]})
        x = _paged_trunk(spec, tokens, lambda: L.reshape(
            _paged_pos_embedding(spec, positions),
            shape=[-1, chunk, spec.dim]), lambda ln, blk, i:
                         _paged_attention(ln, spec, blk, pools[i], table,
                                          positions, cow_src, cow_dst,
                                          chunk, write,
                                          'paged_prefill_mask'))
        gathered = _tmp_var()
        _block_op('gather_time', inputs={'X': [x], 'Index': [last]},
                  outputs={'Out': [gathered]})               # [1, D]
        logits = _named_fc(gathered, spec.vocab, spec.head,
                           num_flatten_dims=1)
        ids = L.argmax(logits, axis=-1)
    return prog, ['prefill_tokens', 'prefill_positions', 'prefill_len',
                  'prefill_last', 'prefill_page_table', 'prefill_cow_src',
                  'prefill_cow_dst'], [logits, ids]


def build_paged_decode_program(spec, slots, num_pages, page_tokens,
                               pages_per_slot):
    """One-token decode step over the whole slot pool, page-indexed.

    Feeds:  decode_tokens [slots, 1, 1] int64,
            decode_step_idx [slots] int32 (absolute position of the
            incoming token; the write lands at
            pool[table[pos // pt], pos % pt], never wrapped),
            decode_page_table [slots, P] int32 (all-zero rows for idle
            or mid-prefill slots: their appends hit the null page),
            decode_cow_src / decode_cow_dst [slots] int32.
    Returns (program, feed_names, fetch_vars[logits [slots, V],
    ids [slots]]).
    """
    prog, startup = Program(), Program()
    prog._is_test = True
    with program_guard(prog, startup):
        tokens = _int_data('decode_tokens', [slots, 1, 1], 'int64')
        step_idx = _int_data('decode_step_idx', [slots])
        table = _int_data('decode_page_table', [slots, pages_per_slot])
        cow_src = _int_data('decode_cow_src', [slots])
        cow_dst = _int_data('decode_cow_dst', [slots])
        pools = _create_pool_vars(spec, num_pages, page_tokens)
        write = ('kv_page_append', {})
        x = _paged_trunk(spec, tokens, lambda: _paged_pos_embedding(
            spec, step_idx), lambda ln, blk, i:
                         _paged_attention(ln, spec, blk, pools[i], table,
                                          step_idx, cow_src, cow_dst, 1,
                                          write, 'paged_decode_mask'))
        logits = L.reshape(_named_fc(x, spec.vocab, spec.head),
                           shape=[-1, spec.vocab])
        ids = L.argmax(logits, axis=-1)
    return prog, ['decode_tokens', 'decode_step_idx', 'decode_page_table',
                  'decode_cow_src', 'decode_cow_dst'], [logits, ids]


def build_verify_program(spec, slots, k1, num_pages, page_tokens,
                         pages_per_slot):
    """Speculative verify: the target model over K1 = k+1 proposed
    positions for every slot in one run.

    Feeds:  verify_tokens [slots, K1, 1] int64 (row 0 the stream's last
            committed token, rows 1..k the draft proposals),
            verify_positions [slots, K1] int32 (base..base+k for live
            slots; a padding row carries P * pt, which the append sends
            to the null page),
            verify_page_table [slots, P] int32,
            verify_cow_src / verify_cow_dst [slots] int32 (at most one
            fork a slot: only the shared frontier page can fork).
    Returns (program, feed_names, fetch_vars[logits [slots*K1, V],
    ids [slots, K1]]): ids[s, r] is the target's next token after verify
    row r.
    """
    prog, startup = Program(), Program()
    prog._is_test = True
    with program_guard(prog, startup):
        tokens = _int_data('verify_tokens', [slots, k1, 1], 'int64')
        positions = _int_data('verify_positions', [slots, k1])
        table = _int_data('verify_page_table', [slots, pages_per_slot])
        cow_src = _int_data('verify_cow_src', [slots])
        cow_dst = _int_data('verify_cow_dst', [slots])
        pools = _create_pool_vars(spec, num_pages, page_tokens)
        write = ('kv_page_append', {})
        x = _paged_trunk(spec, tokens, lambda: _paged_pos_embedding(
            spec, positions), lambda ln, blk, i:
                         _paged_attention(ln, spec, blk, pools[i], table,
                                          positions, cow_src, cow_dst, k1,
                                          write, 'spec_verify_mask'))
        logits3 = _named_fc(x, spec.vocab, spec.head)        # [S, K1, V]
        ids = L.argmax(logits3, axis=-1)                     # [S, K1]
        logits = L.reshape(logits3, shape=[-1, spec.vocab])
    return prog, ['verify_tokens', 'verify_positions', 'verify_page_table',
                  'verify_cow_src', 'verify_cow_dst'], [logits, ids]
