"""PagedDecodePredictor: page-table cached decoding over a shared pool
(counterpart of paddle_tpu/serving/paged.py).

The DecodePredictor contract (prefill / decode_step / generate /
clone, weights pinned once in the parent Scope) re-based onto the
paged cache: per-layer [num_pages, page_tokens, H, dk] pools live in
this predictor's child Scope, a host-side PagePool/PrefixCache
(serving/paging.py) decides which physical page every logical position
maps to, and both programs take the page index as a FEED: admission,
copy-on-write and prefix sharing never capture a program again. The
pools are written in place (the page ops, reset, restore_stream,
install_prefix), never rebound.

Streams replace the dense path's whole-row prefill:

    open_stream(slot, prompt)   match the prefix cache, adopt shared
                                pages read-only (zero recompute),
                                allocate nothing yet
    prefill_step(slot)          run ONE prefill_chunk-token chunk;
                                returns the first greedy token once the
                                prompt is complete (None before that)
    decode_step(tokens, pos)    one captured step over ALL slots; pages
                                are allocated on demand per live stream
    release(slot)               drop the stream's page refs
    save_stream(slot)           copy the stream's pages to host RAM
                                (preempt-first capacity); paired with
    restore_stream(slot, snap)  write them back onto fresh pages and
                                resume with the same bits

Exhaustion is typed: when the pool runs dry (after prefix-cache LRU
eviction) prefill_step/decode_step raise CacheExhaustedError — the
dense ring's silent slide past max_len (COVERAGE divergence 8) cannot
happen here. decode_step is transactional: on exhaustion every page
allocated for THAT call is rolled back, so retrying the same feed
after a release is deterministic and gives the same bits.

Telemetry: serving.kv_pages_in_use / serving.kv_pages_free gauges,
serving.prefix_hits / serving.prefix_tokens_reused counters,
serving.prefill_chunks histogram (chunks per admitted prompt).
"""
from __future__ import annotations

import numpy as np

from ..flags import get_flag
from ..obs import telemetry
from .decode import DecodePredictor
from .paging import (CacheExhaustedError, PagePool, PageTable, PrefixCache,
                     chain_keys)

__all__ = ['PagedDecodePredictor']

_pages_in_use = telemetry.gauge('serving.kv_pages_in_use')
_pages_free = telemetry.gauge('serving.kv_pages_free')
_prefix_hits = telemetry.counter('serving.prefix_hits')
_prefix_tokens = telemetry.counter('serving.prefix_tokens_reused')
_prefill_chunks = telemetry.histogram('serving.prefill_chunks')


class _PendingPrefill(object):
    __slots__ = ('prompt', 'chunks')

    def __init__(self, prompt):
        self.prompt = prompt
        self.chunks = 0


class PagedDecodePredictor(DecodePredictor):
    """Drop-in replacement for DecodePredictor with a paged cache.
    prefer AnalysisPredictor.prepare_decoding(paged=True) over calling
    this directly."""

    paged = True

    def __init__(self, predictor, slots=None, page_tokens=None,
                 kv_pages=None, prefill_chunk=None, _clone_of=None,
                 pair=None, mesh=None):
        """With `pair` (an already-transpiled PagedDecodePair) the
        transpile is skipped: the speculative path builds its target
        and draft pairs in one transpile_spec and hands them here.
        mesh: as DecodePredictor's; on a serving mesh each rank holds
        its heads of every page of the pools."""
        if _clone_of is not None:
            pair = _clone_of._pair
        elif pair is None:
            from ..transpiler.decode_transpiler import DecodeTranspiler
            pair = DecodeTranspiler().transpile(
                predictor._program,
                slots=int(slots or get_flag('serving_slots')), paged=True,
                page_tokens=page_tokens, kv_pages=kv_pages,
                prefill_chunk=prefill_chunk)
        self._setup(predictor, pair, check=_clone_of is None, mesh=mesh,
                    clone_of=_clone_of)

    def _state_shape(self):
        return self._pair.pool_shape

    # -- introspection -----------------------------------------------------
    @property
    def page_tokens(self):
        return self._pair.page_tokens

    @property
    def num_pages(self):
        return self._pair.num_pages

    @property
    def pages_per_slot(self):
        return self._pair.pages_per_slot

    @property
    def prefill_chunk(self):
        return self._pair.prefill_chunk

    @property
    def window(self):
        """Max tokens (prompt + generated) one stream can hold."""
        return self.pages_per_slot * self.page_tokens

    def slot_tokens(self):
        """{slot: tokens held} for every open stream: the per-slot
        cache pressure LMServer.stats() exposes."""
        return {slot: t.length for slot, t in self._tables.items()}

    def pool_stats(self):
        return {'page_tokens': self.page_tokens,
                'num_pages': self.num_pages,
                'pages_in_use': self._pool.pages_in_use,
                'pages_free': self._pool.pages_free,
                'prefix_entries': len(self._prefix),
                'prefix_hits': self._prefix.hits,
                'prefix_misses': self._prefix.misses,
                'prefix_pages': self._prefix.resident_pages,
                'prefix_tokens_reused': self._prefix.tokens_reused}

    def _update_gauges(self):
        _pages_in_use.set(self._pool.pages_in_use)
        _pages_free.set(self._pool.pages_free)

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Zero the page pools in place and forget every stream and
        cached prefix (fresh allocator state)."""
        self._zero_state(self._pair.pool_shape)
        self._pool = PagePool(self.num_pages, self.page_tokens)
        self._prefix = PrefixCache(self._pool)
        self._pool.set_evict(self._prefix.evict_one)
        self._tables = {}             # slot -> PageTable
        self._pending = {}            # slot -> _PendingPrefill
        self._update_gauges()

    def clone(self):
        return PagedDecodePredictor(self._base, _clone_of=self)

    def _pools(self):
        return [self._scope.find_var(name)
                for name in self._pair.cache_names]

    def _save_pages(self, pages):
        """The rows `pages` of every pool as whole host float32 arrays (on
        a mesh gathered from every rank's heads)."""
        if not self._remote:
            return self._pool.save_pages(self._pools(), pages)
        return self._exe.read_rows(self._pool._check_live(pages))

    def _restore_pages(self, data):
        """Allocate fresh pages for host rows `data` (all or nothing) and
        write them in place (on a mesh each rank its heads). Returns the
        page ids."""
        if not self._remote:
            return self._pool.restore_pages(self._pools(), data)[0]
        ids = self._pool.alloc_many(len(data[0]) if data else 0)
        try:
            self._exe.write_rows(ids, data)
        except BaseException:
            for p in ids:
                self._pool.unref(p)
            raise
        return ids

    # -- streams -----------------------------------------------------------
    def open_stream(self, slot, prompt):
        """Begin a stream on `slot`: match the prefix cache and adopt
        any shared pages (read-only, zero recompute). Allocates no new
        pages, so admission itself can never exhaust the pool. Returns
        {'shared_tokens', 'chunks'} — the suffix prefill plan."""
        slot = int(slot)
        if not 0 <= slot < self.slots:
            raise ValueError('slot %r outside [0, %d)' % (slot, self.slots))
        if slot in self._tables:
            raise RuntimeError('slot %d already holds a stream — '
                               'release() it first' % slot)
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not 1 <= len(prompt) <= self.max_len:
            raise ValueError('prompt length %d outside [1, %d] (max_len)'
                             % (len(prompt), self.max_len))
        table = PageTable(self._pool, self.pages_per_slot)
        pages, shared = self._prefix.match(prompt, limit=len(prompt) - 1)
        if shared:
            table.adopt_shared(pages, shared)
            _prefix_hits.inc()
            _prefix_tokens.inc(shared)
        self._tables[slot] = table
        self._pending[slot] = _PendingPrefill(prompt)
        self._update_gauges()
        chunk = self.prefill_chunk
        return {'slot': slot, 'prompt_tokens': len(prompt),
                'shared_tokens': shared,
                'chunks': -(-(len(prompt) - shared) // chunk)}

    def release(self, slot):
        """Drop a stream's page refs (cache-registered prefix pages
        stay resident for future hits)."""
        slot = int(slot)
        table = self._tables.pop(slot, None)
        self._pending.pop(slot, None)
        if table is not None:
            table.release()
            self._update_gauges()

    # -- preempt / resume (serving/preempt.py) -----------------------------
    def save_stream(self, slot):
        """Snapshot one open, fully prefilled stream's page contents
        device -> host (preempt-first capacity, serving/preempt.py).
        Returns {'length', 'pages', 'data', 'nbytes'}; the stream
        itself is untouched — the caller release()s the slot only after
        the copy succeeded, so a failed gather never loses pages."""
        slot = int(slot)
        if slot in self._pending:
            raise RuntimeError('slot %d is still prefilling — requeue '
                               'it, there is nothing worth swapping'
                               % slot)
        table = self._tables[slot]
        data = self._save_pages(table.pages)
        return {'length': table.length, 'pages': len(table.pages),
                'data': data,
                'nbytes': int(sum(d.nbytes for d in data))}

    def restore_stream(self, slot, snapshot, prompt=None):
        """Re-seat a save_stream() snapshot on `slot`: allocate fresh
        pages (all-or-nothing — CacheExhaustedError with nothing taken
        when the pool is still too tight, so the resuming stream just
        stays queued), write the host copies back, and rebuild the page
        table at the saved length. Every restored page is private (the
        stream owns the fresh copies), so later appends never fork.
        `prompt` (the committed token sequence) is unused here; the
        speculative override re-prefills its draft from it."""
        slot = int(slot)
        if slot in self._tables:
            raise RuntimeError('slot %d already holds a stream — '
                               'release() it first' % slot)
        ids = self._restore_pages(snapshot['data'])
        table = PageTable(self._pool, self.pages_per_slot)
        table.pages = list(ids)
        table.length = int(snapshot['length'])
        self._tables[slot] = table
        self._update_gauges()

    # -- prefix export / install (serving/disagg.py ships pages between
    #    replicas with these) ---------------------------------------------
    def export_prefix(self, prompt):
        """Gather the full-page hash chain this cache holds for
        `prompt` (capped at prompt[:-1], the sharing limit) into host
        float32 copies — the prefill tier's half of a page ship.
        Returns None when nothing is resident, else {'keys' (hex, in
        chain order), 'tokens', 'data' (one [n, page_tokens, ...] array
        per layer pool), 'nbytes'}. A pure read: refcounts, tables and
        LRU stamps are untouched."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        digests, pages = self._prefix.chain(prompt,
                                            limit=len(prompt) - 1)
        if not digests:
            return None
        data = self._save_pages(pages)
        return {'keys': [d.hex() for d in digests],
                'tokens': len(digests) * self.page_tokens,
                'data': data,
                'nbytes': int(sum(d.nbytes for d in data))}

    def resident_keys(self, prompt):
        """Hex keys of the leading full-page chain run this cache holds
        for `prompt` — the 'have' list a page fetch sends so the sender
        skips pages already here. Advisory (no quiesce, no LRU touch):
        install_prefix re-checks residency under the swap gate, so a
        racing eviction only costs wire bytes, never correctness."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        digests, _ = self._prefix.chain(prompt, limit=len(prompt) - 1)
        return [d.hex() for d in digests]

    def install_prefix(self, prompt, keys, data, skip=0):
        """Install a shipped page run into the local pool + prefix
        cache (the decode tier's half). `keys` is the FULL leading run
        of the prompt's hash chain the sender holds; `data` carries
        rows for keys[skip:] only (the sender omitted pages the
        receiver reported having). The chain is recomputed here, so a
        shipment with foreign pages, corrupt keys, or a different
        page_tokens is refused with ValueError and the caller
        re-prefills locally — as is a shipment whose skipped prefix is
        no longer resident (evicted between report and install: the
        graft would dangle). Rows already resident (a racing install)
        are deduped without allocation. Returns (installed, deduped)
        page counts; raises the retryable CacheExhaustedError with
        nothing taken when the pool cannot fit the fresh rows."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        keys = list(keys)
        skip = int(skip)
        n = len(keys)
        if n == 0:
            return 0, 0
        expected = chain_keys(prompt, self.page_tokens,
                              limit=len(prompt) - 1)
        if keys != expected[:n]:
            raise ValueError(
                'shipped keys are not a leading run of the prompt '
                'hash chain (%d keys, page_tokens=%d)'
                % (n, self.page_tokens))
        resident, _ = self._prefix.chain(prompt, limit=len(prompt) - 1)
        have = min(len(resident), n)
        if have >= n:
            return 0, n
        if have < skip:
            raise ValueError(
                'shipment skipped %d pages but only %d are still '
                'resident — the graft parent was evicted' % (skip, have))
        ids = self._restore_pages(
            [rows[have - skip:n - skip] for rows in data])
        parent = resident[have - 1] if have else b''
        self._prefix.extend_chain(
            parent, [bytes.fromhex(k) for k in keys[have:n]], ids)
        self._update_gauges()
        return n - have, have

    def prefix_report(self):
        """Drain the prefix cache's registered/evicted delta since the
        last call."""
        return self._prefix.drain_events()

    @staticmethod
    def _rollback(cows, grows):
        """Undo page mutations from a failed (never-run) step: COW
        sources were NOT unref'd yet, so restoring them is pure
        bookkeeping and the device state is untouched."""
        for table, before in reversed(grows):
            while len(table.pages) > before:
                table.pool.unref(table.pages.pop())
        for table, idx, (src, dst) in reversed(cows):
            table.pages[idx] = src
            table.shared.add(idx)
            table.pool.unref(dst)

    # -- execution ---------------------------------------------------------
    def prefill_step(self, slot, return_logits=False):
        """Advance one stream's prefill by ONE chunk. Returns None
        while more chunks remain; on the final chunk, registers the
        prompt with the prefix cache and returns the first greedy
        token (with return_logits: (token, logits [vocab])). Raises
        CacheExhaustedError — with this call's allocations rolled
        back — when the pool cannot cover the chunk."""
        slot = int(slot)
        st = self._pending[slot]
        table = self._tables[slot]
        prompt, start = st.prompt, table.length
        C, P, pt = self.prefill_chunk, self.pages_per_slot, self.page_tokens
        n = min(C, len(prompt) - start)
        cows, grows = [], []
        before = len(table.pages)
        try:
            pair = table.cow_for_append(start)
            if pair is not None:
                cows.append((table, start // pt, pair))
            table.ensure(start + n)
        except CacheExhaustedError as e:
            self._rollback(cows, grows)
            raise CacheExhaustedError(str(e), slots=[slot])
        if len(table.pages) > before:
            grows.append((table, before))
        tokens = np.zeros((1, C, 1), np.int64)
        tokens[0, :n, 0] = prompt[start:start + n]
        positions = (start + np.arange(C, dtype=np.int32))
        table_feed = np.zeros((1, P), np.int32)
        table.row(table_feed[0])
        cow_src = np.zeros((1,), np.int32)
        cow_dst = np.zeros((1,), np.int32)
        if cows:
            cow_src[0], cow_dst[0] = cows[0][2]
        logits, ids = self._exe.run(
            self._pair.prefill_program,
            feed={'prefill_tokens': tokens,
                  'prefill_positions': positions,
                  'prefill_len': np.array([n], np.int32),
                  'prefill_last': np.array([n - 1], np.int32),
                  'prefill_page_table': table_feed,
                  'prefill_cow_src': cow_src,
                  'prefill_cow_dst': cow_dst},
            fetch_list=self._pair.prefill_fetches,
            scope=self._scope, return_numpy=False)
        for table_, _idx, (src, _dst) in cows:
            table_.pool.unref(src)
        table.length = start + n
        st.chunks += 1
        self._update_gauges()
        if table.length < len(prompt):
            return None
        self._prefix.register(prompt, table)
        del self._pending[slot]
        _prefill_chunks.observe(st.chunks)
        tok = int(ids.cpu()[0])
        if return_logits:
            return tok, logits.cpu().numpy()[0]
        return tok

    def decode_step(self, tokens, positions, return_logits=False):
        """One step for the WHOLE pool — same ABI as the dense path:
        tokens [slots], positions [slots] (each stream's next append
        position, which must be its current length). Only open,
        fully-prefilled streams take part; every other lane is fed the
        null-page table row, so its mandatory write is dead weight
        exactly like the dense ring's idle-slot append. New pages are
        allocated on demand; if ANY stream cannot grow, the step runs
        nothing, this call's allocations are rolled back, and
        CacheExhaustedError(slots=[...]) names the victims — the
        caller releases or evicts them and retries the same feed."""
        S, P, pt = self.slots, self.pages_per_slot, self.page_tokens
        tokens = np.asarray(tokens, np.int64).reshape(S, 1, 1)
        positions = np.asarray(positions, np.int32).reshape(S)
        table_feed = np.zeros((S, P), np.int32)
        pos_feed = np.zeros((S,), np.int32)
        cow_src = np.zeros((S,), np.int32)
        cow_dst = np.zeros((S,), np.int32)
        cows, grows, failed, live = [], [], [], []
        for slot in sorted(self._tables):
            if slot in self._pending:
                continue              # mid-prefill: stays on null pages
            table = self._tables[slot]
            pos = int(positions[slot])
            before = len(table.pages)
            try:
                pair = table.cow_for_append(pos)
                if pair is not None:
                    cows.append((table, pos // pt, pair))
                table.ensure(pos + 1)
            except CacheExhaustedError:
                failed.append(slot)
                continue
            if len(table.pages) > before:
                grows.append((table, before))
            table.row(table_feed[slot])
            pos_feed[slot] = pos
            if pair is not None:
                cow_src[slot], cow_dst[slot] = pair
            live.append(slot)
        if failed:
            self._rollback(cows, grows)
            self._update_gauges()
            raise CacheExhaustedError(
                'KV page pool exhausted for slot(s) %s'
                % ','.join(map(str, failed)), slots=failed)
        logits, ids = self._exe.run(
            self._pair.decode_program,
            feed={'decode_tokens': tokens,
                  'decode_step_idx': pos_feed,
                  'decode_page_table': table_feed,
                  'decode_cow_src': cow_src,
                  'decode_cow_dst': cow_dst},
            fetch_list=self._pair.decode_fetches,
            scope=self._scope, return_numpy=False)
        for table, _idx, (src, _dst) in cows:
            table.pool.unref(src)
        for slot in live:
            table = self._tables[slot]
            table.length = max(table.length, int(positions[slot]) + 1)
        self._update_gauges()
        if return_logits:
            return ids.cpu().numpy(), logits.cpu().numpy()
        # ids only: the [slots, vocab] logits stay on the device
        return ids.cpu().numpy()

    def prefill(self, prompts, slot_ids, return_logits=False):
        """Dense-ABI prefill (the parity / generate() path): each
        prompt is streamed chunk by chunk to completion; a slot that
        already holds a stream is released first (the dense path's
        overwrite-on-admission semantics). Returns first greedy ids
        [len(prompts)] (+ last-position logits with return_logits)."""
        if not prompts or len(prompts) != len(slot_ids):
            raise ValueError('%d prompts for %d slots'
                             % (len(prompts), len(slot_ids)))
        out_ids = np.zeros((len(prompts),), np.int64)
        out_logits = []
        for i, (prompt, slot) in enumerate(zip(prompts, slot_ids)):
            slot = int(slot)
            if slot in self._tables:
                self.release(slot)
            self.open_stream(slot, prompt)
            result = None
            while result is None:
                result = self.prefill_step(slot,
                                           return_logits=return_logits)
            if return_logits:
                out_ids[i], logits = result
                out_logits.append(logits)
            else:
                out_ids[i] = result
        if return_logits:
            return out_ids, np.stack(out_logits)
        return out_ids
