"""Speculative decoding over the paged KV cache: draft k, verify once
(counterpart of paddle_tpu/serving/speculative.py).

A small DRAFT model proposes `k` tokens per stream with k cheap
sequential decode steps, then the TARGET model scores all k+1 proposed
positions for every slot in ONE batched verify pass
(models/transformer.py build_verify_program — the paged prefill program
generalized to a fixed K1-row batch over the slot pool). Greedy
acceptance per slot: the longest prefix of the draft chain that matches
the target's own greedy choices is committed, plus the target's next
token after the match (the free bonus token), so every iteration emits
between 1 and k+1 tokens per stream and the emitted stream is the one
plain greedy decode emits, token for token, wherever the verify row's
logits pick the token the decode step's would. The verify pass runs
K1 rows a slot where the decode step runs one, so on the card its
matmuls may sum in another order: a speculative stream equals the plain
one, or first differs where the target's two best logits are a near
tie (tests/test_torch_speculative.py, chip_smoke.py v4).

Why no device-side rollback: K/V validity is positional masking
(j <= position), and every program appends before it gathers within a
layer. A rejected proposal's K/V rows are garbage parked at positions
ahead of the committed length; the next iteration REWRITES those
positions before any mask ever validates them. So acceptance is pure
host bookkeeping (table.length), and the only transactional state is
the page machinery: at most ONE copy-on-write per slot per verify
(only the shared frontier page can fork — pages grown for proposals
are born private), rolled back with the same deferred-unref discipline
when the pool runs dry mid-verify, after which the iteration retries
as one plain decode step (spec.fallback_steps).

The draft is either an explicit smaller LM (its own ProgramDesc and
weight scope) or the default SELF-draft: the target truncated to its
first FLAGS_spec_draft_layers transformer blocks — the truncated
spec's parameter names are a subset of the target's, so the same
pinned weights serve both models with zero extra weight HBM. Either
way the draft runs the full paged-cache machinery (its own PagePool /
PrefixCache / page tables) in its own child Scope.

k adapts per predictor between 1 and FLAGS_spec_k from the rolling
accept rate (a deterministic rule — adaptation shifts the draft/verify
work split, never the emitted tokens).

Telemetry: spec.accept_rate histogram, spec.draft_tokens /
spec.accepted_tokens / spec.rejected_tokens / spec.fallback_steps
counters, serving.effective_tokens_per_step gauge.
"""
from __future__ import annotations

import numpy as np

from ..flags import get_flag
from ..obs import telemetry
from .paged import PagedDecodePredictor
from .paging import CacheExhaustedError

__all__ = ['DraftModel', 'SpeculativeDecodePredictor']

_accept_rate = telemetry.histogram('spec.accept_rate')
_draft_tokens = telemetry.counter('spec.draft_tokens')
_accepted_tokens = telemetry.counter('spec.accepted_tokens')
_rejected_tokens = telemetry.counter('spec.rejected_tokens')
_fallback_steps = telemetry.counter('spec.fallback_steps')
_effective_tps = telemetry.gauge('serving.effective_tokens_per_step')

# adaptive k: evaluate the rolling accept rate every WINDOW proposed
# tokens; widen k above RAISE, narrow below LOWER (floor 1 — plain
# decode is spec_k=0, a different predictor, not an adaptation state)
_ADAPT_WINDOW = 32
_ADAPT_RAISE = 0.8
_ADAPT_LOWER = 0.4


class DraftModel(PagedDecodePredictor):
    """The proposer: a PagedDecodePredictor over the draft pair from
    transpile_spec — its own PagePool / PrefixCache / page tables in
    its own child Scope, its own captured prefill + decode programs.
    For a self-draft the parent weight scope is the TARGET's, and the
    draft's parameter names resolve to the target's own pinned
    weights."""

    def __init__(self, predictor, pair=None, _clone_of=None, mesh=None):
        PagedDecodePredictor.__init__(self, predictor, pair=pair,
                                      _clone_of=_clone_of, mesh=mesh)

    def clone(self):
        return DraftModel(self._base, _clone_of=self)


class SpeculativeDecodePredictor(PagedDecodePredictor):
    """PagedDecodePredictor wrapped with draft/verify speculation.

    The target-side surface (open_stream / prefill_step / decode_step /
    release / reset / clone) is inherited; speculation adds

        spec_step(tokens, positions) -> {slot: [emitted tokens]}

    one draft->verify iteration over every live stream, emitting 1 to
    k+1 tokens per slot with per-slot mixed accept lengths in the same
    iteration. decode_step stays the plain single-token path (the
    mid-verify exhaustion fallback runs through it); generate() drives
    spec_step so the solo parity path exercises speculation end to
    end."""

    speculative = True

    def __init__(self, predictor, slots=None, spec_k=None,
                 draft_layers=None, draft_predictor=None,
                 page_tokens=None, kv_pages=None, prefill_chunk=None,
                 _clone_of=None, mesh=None):
        """mesh: as DecodePredictor's; the draft and the target serve on
        the one mesh (the target's ranks hold the draft's station too)."""
        if _clone_of is not None:
            self._spair = _clone_of._spair
            self._draft = _clone_of._draft.clone()
            PagedDecodePredictor.__init__(self, predictor,
                                          _clone_of=_clone_of)
            return
        from ..transpiler.decode_transpiler import DecodeTranspiler
        spair = DecodeTranspiler().transpile_spec(
            predictor._program,
            draft_program=(draft_predictor._program
                           if draft_predictor is not None else None),
            slots=int(slots or get_flag('serving_slots')),
            spec_k=spec_k, draft_layers=draft_layers,
            page_tokens=page_tokens, kv_pages=kv_pages,
            prefill_chunk=prefill_chunk)
        from .mesh import serving_mesh
        mesh, _ = serving_mesh(mesh)
        self._spair = spair
        self._draft = DraftModel(draft_predictor or predictor,
                                 pair=spair.draft, mesh=mesh or '')
        PagedDecodePredictor.__init__(self, predictor, pair=spair.target,
                                      mesh=mesh or '')

    # -- introspection -----------------------------------------------------
    @property
    def spec_k(self):
        return self._spair.spec_k

    @property
    def k_live(self):
        """The adaptive k currently in force (1..spec_k)."""
        return self._k_live

    @property
    def draft(self):
        return self._draft

    def spec_stats(self):
        """Cumulative speculation accounting since reset() — the
        LMServer.stats() / SRV_HEALTH surface the fleet router's
        effective-throughput weighting reads."""
        drafted = self._stat_drafted
        steps = self._stat_steps
        return {'spec_k': self.spec_k,
                'k_live': self._k_live,
                'steps': steps,
                'draft_tokens': drafted,
                'accepted_tokens': self._stat_accepted,
                'rejected_tokens': drafted - self._stat_accepted,
                'fallback_steps': self._stat_fallbacks,
                'accept_rate': (self._stat_accepted / drafted
                                if drafted else 0.0),
                # per slot-step so 1.0 == plain decode regardless of
                # how many lanes were live each iteration
                'effective_tokens_per_step':
                    (self._stat_emitted / self._stat_slot_steps
                     if self._stat_slot_steps else 0.0)}

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        PagedDecodePredictor.reset(self)
        draft = getattr(self, '_draft', None)
        if draft is not None:
            draft.reset()
        self._draft_dead = set()
        self._k_live = self._spair.spec_k
        self._win_proposed = 0
        self._win_accepted = 0
        self._stat_steps = 0
        self._stat_slot_steps = 0
        self._stat_drafted = 0
        self._stat_accepted = 0
        self._stat_emitted = 0
        self._stat_fallbacks = 0

    def clone(self):
        return SpeculativeDecodePredictor(self._base, _clone_of=self)

    def close(self):
        PagedDecodePredictor.close(self)
        self._draft.close()

    # -- streams -----------------------------------------------------------
    def open_stream(self, slot, prompt):
        info = PagedDecodePredictor.open_stream(self, slot, prompt)
        try:
            self._draft.open_stream(slot, prompt)
            self._draft_dead.discard(slot)
        except (CacheExhaustedError, RuntimeError):
            # target stream stands; the slot just decodes unassisted
            self._draft_dead.add(slot)
        return info

    def release(self, slot):
        PagedDecodePredictor.release(self, slot)
        self._draft.release(slot)
        self._draft_dead.discard(int(slot))

    def restore_stream(self, slot, snapshot, prompt=None):
        """Resume a preempted stream (serving/preempt.py): the TARGET
        pages restore from the snapshot with the same bits; the draft cache was
        dropped at preemption, so it re-prefills from the committed
        sequence (prompt + tokens so far) — its last position is later
        re-fed by the chain as an identical K/V rewrite, the same
        safe idiom as a frozen chain slot. A draft that cannot fit
        leaves the slot decoding unassisted (plain decode, exactly the
        mid-verify exhaustion escape), which never changes the emitted
        tokens — verify trusts only the target."""
        slot = int(slot)
        PagedDecodePredictor.restore_stream(self, slot, snapshot,
                                            prompt=prompt)
        self._draft_dead.add(slot)
        if prompt is None:
            return
        try:
            self._draft.open_stream(slot, prompt)
            while self._draft.prefill_step(slot) is None:
                pass
        except (CacheExhaustedError, RuntimeError):
            self._draft.release(slot)
            return
        self._draft_dead.discard(slot)

    def prefill_step(self, slot, return_logits=False):
        out = PagedDecodePredictor.prefill_step(self, slot,
                                                return_logits)
        if out is None:
            return None
        # target prompt complete: bring the draft cache up in full (its
        # chunks are a draft_layers-deep fraction of the target's work)
        slot = int(slot)
        if slot not in self._draft_dead:
            try:
                while self._draft.prefill_step(slot) is None:
                    pass
            except CacheExhaustedError:
                self._draft.release(slot)
                self._draft_dead.add(slot)
        return out

    # -- speculation -------------------------------------------------------
    def _draft_chain(self, live, tokens, positions, budget):
        """Run up to k draft decode steps and return {slot: proposals}.
        Every open draft stream is fed a committed (token, position)
        pair each step — a slot past its budget freezes on its last
        pair, an identical K/V rewrite, so no draft write is ever
        uncommitted garbage at a position another row still reads."""
        props = {s: [] for s in live}
        chain = [s for s in live
                 if s not in self._draft_dead and budget[s] > 0]
        if not chain:
            return props
        S = self.slots
        cur_tok = {s: int(tokens[s]) for s in chain}
        cur_pos = {s: int(positions[s]) for s in chain}
        dt = np.zeros((S,), np.int64)
        dp = np.zeros((S,), np.int32)
        for _ in range(max(budget[s] for s in chain)):
            for s in chain:
                dt[s] = cur_tok[s]
                dp[s] = cur_pos[s]
            try:
                ids = self._draft.decode_step(dt, dp)
            except CacheExhaustedError:
                break                    # verify what we already have
            for s in chain:
                if len(props[s]) < budget[s]:
                    nxt = int(ids[s])
                    props[s].append(nxt)
                    cur_tok[s] = nxt
                    cur_pos[s] += 1
        return props

    def _draft_sync(self, gaps, live, tokens, positions):
        """Feed the draft the one token per fully-accepting slot it
        never saw (the chain proposes q_k without consuming it). Other
        draft streams freeze on their base pair — identical rewrites.
        A failure here only costs future accept rate: verify never
        trusts the draft."""
        S = self.slots
        dt = np.zeros((S,), np.int64)
        dp = np.zeros((S,), np.int32)
        for s in live:
            dt[s] = int(tokens[s])
            dp[s] = int(positions[s])
        for s, tok, pos in gaps:
            dt[s] = tok
            dp[s] = pos
        try:
            self._draft.decode_step(dt, dp)
        except CacheExhaustedError:
            pass

    def _adapt(self, proposed, accepted):
        self._win_proposed += proposed
        self._win_accepted += accepted
        if self._win_proposed < _ADAPT_WINDOW:
            return
        rate = self._win_accepted / self._win_proposed
        if rate >= _ADAPT_RAISE:
            self._k_live = min(self.spec_k, self._k_live + 1)
        elif rate < _ADAPT_LOWER:
            self._k_live = max(1, self._k_live - 1)
        self._win_proposed = self._win_accepted = 0

    def spec_step(self, tokens, positions):
        """One draft->verify iteration over every live stream.

        tokens [slots] (each stream's last emitted token), positions
        [slots] (its absolute position) — the decode_step ABI. Returns
        {slot: [emitted tokens]} with 1..k+1 tokens per live slot, the
        exact prefix the plain greedy path would have produced. On
        mid-verify CacheExhaustedError the whole speculation is rolled
        back (the deferred-unref discipline: COW sources were not
        dropped yet) and the iteration retries as ONE plain decode
        step; if even that cannot grow, decode_step's own typed error
        propagates with the victim slots named."""
        S, P, pt = self.slots, self.pages_per_slot, self.page_tokens
        tokens = np.asarray(tokens, np.int64).reshape(S)
        positions = np.asarray(positions, np.int32).reshape(S)
        live = [s for s in sorted(self._tables)
                if s not in self._pending]
        if not live:
            return {}
        # per-slot proposal budget: the adaptive k, clamped so the
        # bonus position stays inside the window (a stream at its last
        # position verifies just its base row — a plain decode step in
        # verify clothing)
        budget = {s: (0 if s in self._draft_dead else
                      max(0, min(self._k_live,
                                 self.max_len - 1 - int(positions[s]))))
                  for s in live}
        props = self._draft_chain(live, tokens, positions, budget)

        K1 = self.spec_k + 1
        sentinel = P * pt                  # out of range -> null page
        vtok = np.zeros((S, K1, 1), np.int64)
        vpos = np.full((S, K1), sentinel, np.int32)
        table_feed = np.zeros((S, P), np.int32)
        cow_src = np.zeros((S,), np.int32)
        cow_dst = np.zeros((S,), np.int32)
        cows, grows, failed = [], [], []
        n_of = {}
        for s in live:
            table = self._tables[s]
            pos = int(positions[s])
            n = min(len(props[s]), budget[s])
            n_of[s] = n
            before = len(table.pages)
            try:
                pair = table.cow_for_append(pos)
                if pair is not None:
                    cows.append((table, pos // pt, pair))
                table.ensure(pos + n + 1)
            except CacheExhaustedError:
                failed.append(s)
                continue
            if len(table.pages) > before:
                grows.append((table, before))
            table.row(table_feed[s])
            vtok[s, 0, 0] = int(tokens[s])
            for r in range(n):
                vtok[s, r + 1, 0] = props[s][r]
            vpos[s, :n + 1] = pos + np.arange(n + 1, dtype=np.int32)
            if pair is not None:
                cow_src[s], cow_dst[s] = pair
        if failed:
            # mid-verify exhaustion: undo this call's COWs and grows
            # (device untouched — the program never ran) and retry as a
            # plain decode step. decode_step re-forks the same frontier
            # pages deterministically, so the retry gives the same bits.
            self._rollback(cows, grows)
            self._update_gauges()
            _fallback_steps.inc()
            self._stat_fallbacks += 1
            ids = PagedDecodePredictor.decode_step(self, tokens,
                                                   positions)
            out = {s: [int(ids[s])] for s in live}
            self._account(out, {s: 0 for s in live},
                          {s: 0 for s in live})
            return out

        _logits, ids = self._exe.run(
            self._spair.verify_program,
            feed={'verify_tokens': vtok,
                  'verify_positions': vpos,
                  'verify_page_table': table_feed,
                  'verify_cow_src': cow_src,
                  'verify_cow_dst': cow_dst},
            fetch_list=self._spair.verify_fetches,
            scope=self._scope, return_numpy=False)
        ids = ids.cpu().numpy()            # [S, K1] target greedy
        for table, _idx, (src, _dst) in cows:
            table.pool.unref(src)

        out, accepts, gaps = {}, {}, []
        for s in live:
            n, pos = n_of[s], int(positions[s])
            a = 0
            while a < n and props[s][a] == int(ids[s, a]):
                a += 1
            out[s] = props[s][:a] + [int(ids[s, a])]
            accepts[s] = a
            table = self._tables[s]
            table.length = max(table.length, pos + a + 1)
            if n and a == n:
                # full accept: the chain never fed its own last
                # proposal — close the draft cache gap at pos + n
                gaps.append((s, props[s][n - 1], pos + n))
        if gaps:
            self._draft_sync(gaps, live, tokens, positions)
        self._update_gauges()
        self._account(out, n_of, accepts)
        return out

    def _account(self, out, proposed, accepted):
        emitted = sum(len(v) for v in out.values())
        n_prop = sum(proposed.values())
        n_acc = sum(accepted.values())
        self._stat_steps += 1
        self._stat_emitted += emitted
        self._stat_slot_steps += len(out)
        self._stat_drafted += n_prop
        self._stat_accepted += n_acc
        if n_prop:
            _draft_tokens.inc(n_prop)
            _accepted_tokens.inc(n_acc)
            _rejected_tokens.inc(n_prop - n_acc)
            _accept_rate.observe(n_acc / n_prop)
            self._adapt(n_prop, n_acc)
        if out:
            _effective_tps.set(emitted / len(out))

    # -- solo path ---------------------------------------------------------
    def generate(self, prompt, max_new_tokens, eos_id=None, slot=0):
        """Solo greedy generation through the speculative path — same
        contract (and, by the acceptance rule, same output) as the
        plain predictors' generate()."""
        slot = int(slot)
        if slot in self._tables:
            self.release(slot)
        self.open_stream(slot, prompt)
        tok = None
        while tok is None:
            tok = self.prefill_step(slot)
        tok = int(tok)
        out = [tok]
        pos = len(np.asarray(prompt).reshape(-1))
        toks = np.zeros((self.slots,), np.int64)
        poss = np.zeros((self.slots,), np.int32)
        while len(out) < max_new_tokens and tok != eos_id:
            toks[slot] = tok
            poss[slot] = pos
            for t in self.spec_step(toks, poss)[slot]:
                tok = int(t)
                out.append(tok)
                pos += 1
                if len(out) >= max_new_tokens or tok == eos_id:
                    break
        return out
