"""DecodeTranspiler: loaded LM program -> prefill + decode pair, its
paged form, and the speculative target / draft / verify set
(counterpart of paddle_tpu/transpiler/decode_transpiler.py).

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

For mesh serving it also recovers each weight's training sharding spec
(DecodeSpec.param_specs): from var.dist_attr while the trained program
is in memory, else from the sharding_constraint ops parallel/layers.py
appends after each parallel fc, which survive save_inference_model.
"""
from __future__ import annotations

from ..flags import get_flag
from ..models.transformer import (DecodeSpec, build_prefill_program,
                                  build_decode_program,
                                  build_paged_prefill_program,
                                  build_paged_decode_program,
                                  build_verify_program)

__all__ = ['DecodeTranspileError', 'DecodePair', 'PagedDecodePair',
           'SpecDecodePair', 'DecodeTranspiler', 'extract_decode_spec']


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

    paged = False


class PagedDecodePair(DecodePair):
    """Paged transpile result: the cache state is per-layer page POOLS
    ([num_pages, page_tokens, H, dh]) instead of per-slot rings, the
    prefill program runs one `prefill_chunk`-token chunk through one
    stream's page table, and both programs take the page index as a
    feed (serving/paged.py computes it)."""

    paged = True

    def __init__(self, spec, slots, page_tokens, pages_per_slot,
                 num_pages, prefill_chunk,
                 prefill_program, prefill_feeds, prefill_fetches,
                 decode_program, decode_feeds, decode_fetches):
        DecodePair.__init__(self, spec, slots, 1,
                            prefill_program, prefill_feeds,
                            prefill_fetches, decode_program,
                            decode_feeds, decode_fetches)
        self.page_tokens = page_tokens
        self.pages_per_slot = pages_per_slot
        self.num_pages = num_pages
        self.prefill_chunk = prefill_chunk

    @property
    def cache_names(self):
        return self.spec.pool_names()

    @property
    def pool_shape(self):
        return self.spec.pool_shape(self.num_pages, self.page_tokens)


class SpecDecodePair(object):
    """Speculative transpile result: the TARGET PagedDecodePair, a
    verify program over K1 = spec_k + 1 rows a slot, and a DRAFT
    PagedDecodePair: transpiled from an explicit draft program (its own
    weights) or a self-draft, the target spec cut to its first
    `draft_layers` blocks, whose parameter names are a subset of the
    target's, so one weight scope serves both. The verify program binds
    the target's pool names (target prefill / decode / verify share one
    cache scope); the draft's pools live in the draft predictor's own
    scope."""

    def __init__(self, target, draft, spec_k, verify_program,
                 verify_feeds, verify_fetches, self_draft):
        self.target = target
        self.draft = draft
        self.spec_k = int(spec_k)
        self.verify_program = verify_program
        self.verify_feeds = verify_feeds
        self.verify_fetches = verify_fetches
        self.self_draft = bool(self_draft)

    @property
    def spec(self):
        return self.target.spec


def _truncate_spec(spec, draft_layers):
    """Self-draft spec: the target's first `draft_layers` blocks with
    the same embedding, final-norm and head names."""
    draft_layers = int(draft_layers)
    if not 1 <= draft_layers <= spec.layers:
        raise DecodeTranspileError(
            'spec_draft_layers %d outside [1, %d] (target layers)'
            % (draft_layers, spec.layers))
    truncated = DecodeSpec(vocab=spec.vocab, dim=spec.dim,
                           heads=spec.heads, layers=draft_layers,
                           ffn=spec.ffn, max_len=spec.max_len,
                           pos_len=spec.pos_len, emb_w=spec.emb_w,
                           pos_w=spec.pos_w,
                           blocks=spec.blocks[:draft_layers],
                           final_ln=spec.final_ln, head=spec.head,
                           use_flash=spec.use_flash)
    # the draft's params are a subset of the target's: they carry their
    # recovered specs, so the self-draft shards the same way
    names = set(truncated.param_names())
    truncated.param_specs = {n: s for n, s in spec.param_specs.items()
                             if n in names}
    return truncated


def _fail(msg):
    raise DecodeTranspileError(
        'cannot transpile program for cached decoding: %s (expected a '
        'decoder-only LM from models.transformer.language_model'
        '[_logits])' % msg)


# the mesh axes a recovered spec may name (parallel/mesh.py AXIS_ORDER)
_SERVABLE_AXES = ('dp', 'tp', 'sp', 'ep', 'pp')


def _recover_param_specs(block, spec, muls, add_out_of, act_out_of,
                         constraints):
    """Each weight's sharding spec (tuple form) for mesh serving, from,
    in order of preference:

    1. var.dist_attr: present while the trained program is in memory
       (shard_tensor wrote it), lost on save/load;
    2. the sharding_constraint ops parallel/layers.py appends right after
       each parallel fc's bias add, which survive save_inference_model: a
       constraint (.., ax) after a mul's add means column parallel (w
       sharded (None, ax)); (.., None) means row parallel (w sharded
       ('tp', None)).

    Unannotated weights map to None (replicated). An axis outside the
    mesh axes is a layout nothing can serve: DecodeTranspileError naming
    the weight and the axis."""
    specs = {}

    def record(name, wspec):
        if wspec is None:
            specs[name] = None
            return
        wspec = tuple(wspec)
        for ax in wspec:
            for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
                if a is not None and a not in _SERVABLE_AXES:
                    _fail('weight %r is sharded on unknown mesh axis '
                          '%r (valid: %s)' % (name, a, _SERVABLE_AXES))
        specs[name] = wspec

    def infer(name, out_name):
        try:
            var = block.var_recursive(name)
        except KeyError:
            var = None
        dist = getattr(var, 'dist_attr', None)
        if dist is not None:
            record(name, dist)
            return
        out = add_out_of.get(out_name, out_name)
        out = act_out_of.get(out, out)
        cspec = constraints.get(out)
        if cspec is None or len(cspec) < 2:
            specs[name] = None
            return
        ax = cspec[-1]
        if isinstance(ax, (tuple, list)):
            ax = ax[0] if ax else None
        if ax is not None:
            record(name, (None, ax))        # column parallel
        else:
            # a trailing-None constraint right after a mul is the
            # row-parallel signature; its contraction dim was sharded
            # over the model axis the net uses (tp)
            record(name, ('tp', None))

    for mul_w, mul_out in muls:
        infer(mul_w, mul_out)
    # the embedding: dist_attr only (vocab_parallel_embedding emits no
    # constraint); after save/load it serves replicated
    try:
        emb_var = block.var_recursive(spec.emb_w)
    except KeyError:
        emb_var = None
    dist = getattr(emb_var, 'dist_attr', None)
    record(spec.emb_w, tuple(dist) if dist is not None else None)
    spec.param_specs = {n: specs.get(n) for n in spec.param_names()}


def extract_decode_spec(program):
    """Scan the loaded program and return its DecodeSpec."""
    block = program.global_block()
    emb_w = pos_w = None
    lns = []          # (scale_name, bias_name) in op order
    muls = []         # (w_name, out_name) in op order
    bias_of = {}      # mul out name -> persistable bias name
    add_out_of = {}   # mul out name -> its bias add's out name
    act_out_of = {}   # fc activation's in name -> its out name
    constraints = {}  # constrained var name -> sharding spec tuple
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
        elif t == 'moe_ffn':
            _fail('op moe_ffn: expert-sharded (ep) MoE FFN has no '
                  'cached-decode equivalent')
        elif t == 'ring_attention':
            _fail('op ring_attention: sp-ring attention has no '
                  'cached-decode equivalent (serve with the paged '
                  'cache instead)')
        elif t == 'sharding_constraint':
            spec = op.attr('spec')
            if spec is not None:
                constraints[op.single_input('X')] = tuple(spec)
        elif t in ('gelu', 'relu', 'tanh', 'sigmoid'):
            # fc applies its act after the bias add, so a parallel fc's
            # constraint sits one hop past the add's output
            act_out_of[op.single_input('X')] = op.single_output('Out')
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
                x = op.single_input('X')
                bias_of[x] = yv.name
                add_out_of[x] = op.single_output('Out')

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

    spec = DecodeSpec(vocab=vocab, dim=dim, heads=heads, layers=layers,
                      ffn=ffn, max_len=max_len, pos_len=pos_len,
                      emb_w=emb_w, pos_w=pos_w, blocks=blocks,
                      final_ln=lns[-1], head=pair(len(muls) - 1),
                      use_flash=use_flash)
    _recover_param_specs(block, spec, muls, add_out_of, act_out_of,
                         constraints)
    return spec


class DecodeTranspiler(object):
    def transpile(self, program, slots=8, prefill_batch=1, paged=False,
                  page_tokens=None, kv_pages=None, prefill_chunk=None):
        """program: a loaded inference Program (AnalysisPredictor's).
        Returns a DecodePair over a `slots`-slot ring cache whose prefill
        takes `prefill_batch` prompts per call, or with paged=True a
        PagedDecodePair whose cache is a page pool sized by page_tokens
        / kv_pages and whose prefill runs prefill_chunk-token chunks
        (each None defaults from FLAGS_serving_*; kv_pages 0 auto-sizes
        to slots * pages_per_slot + 1)."""
        if slots < 1:
            raise ValueError('slots must be >= 1, got %r' % (slots,))
        if not 1 <= prefill_batch <= slots:
            raise ValueError('prefill_batch must be in [1, slots]')
        spec = extract_decode_spec(program)
        if paged:
            return self._transpile_paged(spec, slots, page_tokens,
                                         kv_pages, prefill_chunk)
        pp, pf, pv = build_prefill_program(spec, slots, batch=prefill_batch)
        dp, df, dv = build_decode_program(spec, slots)
        return DecodePair(spec, slots, prefill_batch,
                          pp, pf, pv, dp, df, dv)

    def transpile_spec(self, program, draft_program=None, slots=8,
                       spec_k=None, draft_layers=None, page_tokens=None,
                       kv_pages=None, prefill_chunk=None):
        """Speculative-decoding transpile: target program (+ optional
        draft program) -> SpecDecodePair. With no draft_program the
        draft is the target cut to its first `draft_layers` (default
        FLAGS_spec_draft_layers) blocks, sharing the target's weight
        scope. spec_k defaults from FLAGS_spec_k. The draft pair takes
        the target's page geometry."""
        spec_k = int(spec_k if spec_k is not None else get_flag('spec_k'))
        if spec_k < 1:
            raise ValueError('spec_k must be >= 1, got %r' % spec_k)
        target = self.transpile(program, slots=slots, paged=True,
                                page_tokens=page_tokens,
                                kv_pages=kv_pages,
                                prefill_chunk=prefill_chunk)
        spec = target.spec
        if draft_program is not None:
            draft_spec = extract_decode_spec(draft_program)
            if draft_spec.vocab != spec.vocab:
                raise DecodeTranspileError(
                    'draft vocab %d != target vocab %d: proposals would '
                    'not index the target logits'
                    % (draft_spec.vocab, spec.vocab))
            if draft_spec.max_len < spec.max_len:
                raise DecodeTranspileError(
                    'draft max_len %d < target max_len %d: the draft '
                    'cannot cover the target window'
                    % (draft_spec.max_len, spec.max_len))
        else:
            draft_spec = _truncate_spec(
                spec, draft_layers if draft_layers is not None
                else get_flag('spec_draft_layers'))
        draft = self._transpile_paged(draft_spec, target.slots,
                                      target.page_tokens, kv_pages,
                                      prefill_chunk)
        vp, vf, vv = build_verify_program(
            spec, target.slots, spec_k + 1, target.num_pages,
            target.page_tokens, target.pages_per_slot)
        return SpecDecodePair(target, draft, spec_k, vp, vf, vv,
                              self_draft=draft_program is None)

    def _transpile_paged(self, spec, slots, page_tokens, kv_pages,
                         prefill_chunk):
        pt = int(page_tokens or get_flag('serving_page_tokens'))
        if pt < 1:
            raise ValueError('page_tokens must be >= 1, got %r' % pt)
        pages_per_slot = -(-spec.max_len // pt)         # ceil
        num_pages = int(kv_pages if kv_pages is not None
                        else get_flag('serving_kv_pages'))
        if num_pages == 0:
            # every slot can hold a full window, plus the null page
            num_pages = slots * pages_per_slot + 1
        if num_pages < 2:
            raise ValueError('kv_pages must be >= 2 (page 0 is the '
                             'reserved null page), got %d' % num_pages)
        chunk = int(prefill_chunk or get_flag('serving_prefill_chunk'))
        chunk = max(1, min(chunk, spec.max_len))
        pp, pf, pv = build_paged_prefill_program(
            spec, chunk, num_pages, pt, pages_per_slot)
        dp, df, dv = build_paged_decode_program(
            spec, slots, num_pages, pt, pages_per_slot)
        return PagedDecodePair(spec, slots, pt, pages_per_slot,
                               num_pages, chunk,
                               pp, pf, pv, dp, df, dv)
