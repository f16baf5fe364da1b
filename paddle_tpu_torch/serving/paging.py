"""Host-side paged KV-cache bookkeeping: PagePool / PageTable /
PrefixCache (counterpart of paddle_tpu/serving/paging.py, copied: it is
host-side numpy, except save_pages / restore_pages, which read and
write the device pools with PyTorch).

The device side (ops/attention_ops.py kv_page_* ops, the paged program
pair from models/transformer.py) is pure address arithmetic over feed
values; everything stateful lives HERE, on the host, in plain Python:

  PagePool     free list + per-page refcounts over the physical pool.
               Physical page 0 is the reserved null page (never
               allocated, the redirect target for dead writes). An
               empty free list first asks the eviction callback (the
               PrefixCache LRU) to give a page back, then raises the
               typed, retryable CacheExhaustedError — the paged answer
               to COVERAGE divergence 8's silent ring slide.
               save_pages/restore_pages move page contents device<->
               host for the preempt-first capacity engine
               (serving/preempt.py): float32 copies out, and back in
               place onto freshly allocated pages of the same pool
               storage, so a swapped-out stream resumes with the same
               bits.
  PageTable    one stream's logical -> physical mapping. Pages adopted
               from the prefix cache are marked SHARED; the first
               append into a shared page forks it (copy-on-write): a
               fresh page is allocated, a (src, dst) copy instruction
               is returned for the device program, and the shared ref
               is dropped. Because the device copy reads all sources
               before writing any destination, a page freed and
               reallocated within the same step still copies its
               pre-step contents.
  PrefixCache  content-hash chain over FULL pages (h_k = sha1(h_{k-1}
               || tokens of page k) -> physical page) plus
               partial-tail entries keyed by (chain hash, tail tokens)
               — RadixAttention-style sharing restricted to page
               granularity. The cache holds its own +1 ref on every
               registered page so shared prefixes survive stream
               churn; entries are evicted leaf-first by LRU when the
               pool runs dry.

Sharing is capped at prompt[:-1]: the last prompt token is always
recomputed, because its logits produce the stream's first output
token. Everything here is deterministic — no clocks, no randomness —
so a prefix hit whose suffix chunk starts where a cold prefill's chunk
does runs the same ops on the same page contents and gives the same
bits.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

__all__ = ['CacheExhaustedError', 'PagePool', 'PageTable', 'PrefixCache',
           'chain_keys']

NULL_PAGE = 0


class CacheExhaustedError(RuntimeError):
    """The page pool is empty (after prefix-cache eviction): the stream
    cannot grow. Retryable — a shed, not a model error: the serving
    engine preempts or requeues the victim (serving/engine.py)."""

    retryable = True

    def __init__(self, msg, slots=()):
        super(CacheExhaustedError, self).__init__(msg)
        self.slots = tuple(slots)


class PagePool(object):
    """Refcounted free-list allocator over `num_pages` physical pages.

    Page 0 is pinned as the null page and never handed out. `evict` is
    an optional zero-arg callable returning True if it released at
    least one page (the PrefixCache's LRU drop) — alloc() keeps asking
    it until a page frees or it gives up."""

    def __init__(self, num_pages, page_tokens, evict=None):
        num_pages = int(num_pages)
        if num_pages < 2:
            raise ValueError('page pool needs >= 2 pages (one is the '
                             'reserved null page), got %d' % num_pages)
        self.num_pages = num_pages
        self.page_tokens = int(page_tokens)
        self._free = collections.deque(range(1, num_pages))
        self._ref = [0] * num_pages
        self._ref[NULL_PAGE] = 1            # pinned forever
        self._evict = evict

    def set_evict(self, evict):
        self._evict = evict

    # -- accounting --------------------------------------------------------
    @property
    def pages_free(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.num_pages - 1 - len(self._free)

    def refcount(self, page):
        return self._ref[page]

    def check(self):
        """Invariant sweep (the property test's oracle): the free list
        and the ref>0 set partition pages 1..N-1 exactly."""
        free = set(self._free)
        assert len(free) == len(self._free), 'free list holds duplicates'
        assert NULL_PAGE not in free, 'null page leaked into free list'
        assert self._ref[NULL_PAGE] >= 1, 'null page pin lost'
        for p in range(1, self.num_pages):
            assert self._ref[p] >= 0, 'negative refcount on page %d' % p
            assert (self._ref[p] == 0) == (p in free), \
                'page %d: ref %d but free=%s' % (p, self._ref[p], p in free)

    # -- alloc / ref -------------------------------------------------------
    def alloc(self):
        while not self._free:
            if self._evict is None or not self._evict():
                raise CacheExhaustedError(
                    'KV page pool exhausted: %d pages all referenced '
                    '(and no prefix-cache entry left to evict)'
                    % (self.num_pages - 1))
        page = self._free.popleft()
        self._ref[page] = 1
        return page

    def alloc_many(self, n):
        """All-or-nothing batch alloc: returns n pages or raises with
        none taken (so a failed admission never strands pages)."""
        out = []
        try:
            for _ in range(int(n)):
                out.append(self.alloc())
        except CacheExhaustedError:
            for p in out:
                self.unref(p)
            raise
        return out

    def share(self, page):
        if page == NULL_PAGE or self._ref[page] <= 0:
            raise ValueError('cannot share dead page %d' % page)
        self._ref[page] += 1
        return page

    def unref(self, page):
        if page == NULL_PAGE:
            raise ValueError('cannot unref the null page')
        if self._ref[page] <= 0:
            raise ValueError('double free of page %d' % page)
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    # -- host swap (preempt-first capacity, serving/preempt.py) ------------
    def _check_live(self, page_ids):
        idx = [int(p) for p in page_ids]
        for p in idx:
            if p == NULL_PAGE or not 0 < p < self.num_pages \
                    or self._ref[p] <= 0:
                raise ValueError('cannot save dead/null page %d' % p)
        return idx

    def save_pages(self, pools, page_ids):
        """Device -> host: gather the `page_ids` rows of every pool
        (a torch.Tensor on any device, or a numpy array) into float32
        host copies (one np.ndarray per pool, shape
        [len(page_ids), page_tokens, ...]). A pure read: refcounts and
        the free list are untouched; the caller releases the stream's
        refs AFTER the copy so a failed gather never strands a page.
        Float32 bytes copy exactly, so a later restore_pages gives the
        same bits."""
        idx = self._check_live(page_ids)
        out = []
        for pool in pools:
            if isinstance(pool, torch.Tensor):
                sel = torch.as_tensor(idx, dtype=torch.long,
                                      device=pool.device)
                out.append(pool.index_select(0, sel).cpu().numpy())
            else:
                out.append(np.asarray(pool)[np.asarray(idx, np.int64)])
        return out

    def restore_pages(self, pools, saved):
        """Host -> device: allocate len(saved[0]) FRESH pages
        (all-or-nothing: raises the retryable CacheExhaustedError
        with nothing taken when the pool cannot fit, so a resuming
        stream just stays queued) and write each saved row back at the
        new physical ids, in place: a device pool keeps its storage
        (a captured graph reads that address), a numpy pool is written
        through. Returns (page_ids, pools), the same pool objects."""
        n = len(saved[0]) if saved else 0
        ids = self.alloc_many(n)
        for pool, host in zip(pools, saved):
            if isinstance(pool, torch.Tensor):
                sel = torch.as_tensor(ids, dtype=torch.long,
                                      device=pool.device)
                pool.index_copy_(0, sel, torch.from_numpy(
                    np.ascontiguousarray(host)).to(pool.device, pool.dtype))
            else:
                pool[np.asarray(ids, np.int64)] = host
        return ids, list(pools)


class PageTable(object):
    """One stream's page index: logical position j lives at
    pages[j // page_tokens] offset j % page_tokens. `shared` marks
    table indices whose page is referenced elsewhere (prefix cache or
    another stream) and therefore read-only for this stream."""

    def __init__(self, pool, width):
        self.pool = pool
        self.width = int(width)             # table entries (P)
        self.pages = []                     # physical page ids
        self.length = 0                     # tokens written so far
        self.shared = set()                 # read-only table indices

    @property
    def capacity(self):
        return self.width * self.pool.page_tokens

    def adopt_shared(self, pages, tokens):
        """Seed a fresh table with prefix-cache pages (the cache's own
        refs are untouched; this stream takes one more each)."""
        assert not self.pages and not self.length
        if tokens > len(pages) * self.pool.page_tokens:
            raise ValueError('shared prefix %d tokens > %d pages'
                             % (tokens, len(pages)))
        for p in pages:
            self.pool.share(p)
            self.shared.add(len(self.pages))
            self.pages.append(p)
        self.length = int(tokens)

    def mark_shared(self, index):
        self.shared.add(int(index))

    def ensure(self, tokens):
        """Grow the table so positions [0, tokens) are addressable.
        All-or-nothing; raises CacheExhaustedError past `width` pages
        or an empty pool. Idempotent for already-covered extents."""
        tokens = int(tokens)
        need = -(-tokens // self.pool.page_tokens)      # ceil
        if need > self.width:
            raise CacheExhaustedError(
                'stream needs %d pages, table width is %d (%d-token '
                'window)' % (need, self.width, self.capacity))
        if need > len(self.pages):
            self.pages.extend(self.pool.alloc_many(need - len(self.pages)))

    def cow_for_append(self, position):
        """Make the page holding `position` writable. Returns a
        (src, dst) physical copy pair for the device program when the
        page was shared and had to fork, else None. This stream's ref
        on src is deliberately NOT dropped here: the caller unrefs it
        only AFTER the device copy actually ran, so a step that fails
        after this fork can roll back (restore src, unref dst) without
        ever touching a freed page."""
        idx = int(position) // self.pool.page_tokens
        if idx >= len(self.pages) or idx not in self.shared:
            return None
        dst = self.pool.alloc()
        src = self.pages[idx]
        self.pages[idx] = dst
        self.shared.discard(idx)
        return (src, dst)

    def row(self, out):
        """Fill `out` (a length-width int32 view) with the physical
        page ids, null-padded."""
        out[:] = NULL_PAGE
        out[:len(self.pages)] = self.pages
        return out

    def release(self):
        for p in self.pages:
            self.pool.unref(p)
        self.pages = []
        self.shared = set()
        self.length = 0


def _digest(prev, tokens):
    h = hashlib.sha1(prev)
    h.update(b','.join(b'%d' % int(t) for t in tokens))
    return h.digest()


def chain_keys(tokens, page_tokens, limit=None):
    """Hex hash-chain keys over the FULL pages of tokens[:limit] — the
    content address every disagg page ship and fleet prefix-directory
    entry is keyed by. A pure function of the tokens and the page size,
    so a receiver can recompute the chain and refuse a shipment whose
    keys do not match its own hash of the prompt."""
    pt = int(page_tokens)
    toks = [int(t) for t in tokens]
    limit = len(toks) if limit is None else min(int(limit), len(toks))
    out, chain = [], b''
    for k in range(limit // pt):
        chain = _digest(chain, toks[k * pt:(k + 1) * pt])
        out.append(chain.hex())
    return out


class _Node(object):
    __slots__ = ('page', 'parent', 'children', 'tails', 'stamp')

    def __init__(self, page, parent):
        self.page = page
        self.parent = parent     # chain digest of the previous node
        self.children = 0
        self.tails = 0
        self.stamp = 0


class _Tail(object):
    __slots__ = ('page', 'tokens', 'chain', 'stamp')

    def __init__(self, page, tokens, chain):
        self.page = page
        self.tokens = tokens
        self.chain = chain
        self.stamp = 0


class PrefixCache(object):
    """Content-hash page index for shared prefixes.

    Full pages form a hash CHAIN (a radix tree collapsed to page
    granularity): node k is keyed by sha1 over all tokens of pages
    0..k and maps to the physical page holding page k's K/V. A prompt
    matches greedily along the chain; an optional partial TAIL entry
    (chain digest + the tail's exact tokens) shares the last,
    partially filled page — the matcher picks the longest registered
    tail that prefixes the prompt remainder. The cache owns one ref
    per registered page; evict_one() drops the least-recently-used
    LEAF (no children, no tails) so interior chain pages are never
    orphaned while still reachable."""

    def __init__(self, pool):
        self.pool = pool
        self._nodes = {}          # chain digest -> _Node
        self._tails = {}          # chain digest -> {tokens: _Tail}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        # delta logs for the fleet prefix directory (drained through
        # SRV_HEALTH): hex chain keys of full-page nodes registered /
        # evicted since the last drain_events(). Bounded by cache
        # churn between probes — tails are never logged (the directory
        # tracks full pages only).
        self._announced = []
        self._evicted = []

    def _touch(self, entry):
        self._clock += 1
        entry.stamp = self._clock

    # -- lookup ------------------------------------------------------------
    def match(self, prompt, limit=None):
        """Longest shared prefix of `prompt` (at most `limit` tokens;
        callers pass len(prompt) - 1 so the last token is always
        computed). Returns (pages, tokens): the physical pages to adopt
        (the last may be partial) and how many tokens they carry. The
        caller must adopt_shared() them promptly — match() itself takes
        no refs."""
        pt = self.pool.page_tokens
        limit = len(prompt) if limit is None else min(limit, len(prompt))
        full = limit // pt
        pages, chain, k = [], b'', 0
        while k < full:
            nxt = _digest(chain, prompt[k * pt:(k + 1) * pt])
            node = self._nodes.get(nxt)
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            chain = nxt
            k += 1
        tokens = k * pt
        if k == full:             # a tail only connects at chain end
            rest = tuple(int(t) for t in prompt[tokens:limit])
            best = None
            for tail_tokens, tail in self._tails.get(chain, {}).items():
                if rest[:len(tail_tokens)] == tail_tokens and \
                        (best is None or len(tail_tokens) > len(best.tokens)):
                    best = tail
            if best is not None:
                self._touch(best)
                pages.append(best.page)
                tokens += len(best.tokens)
        if tokens:
            self.hits += 1
            self.tokens_reused += tokens
        elif limit > 0:
            # a shareable prompt found nothing — the miss half of the
            # fleet_prefix_hit_rate metric (a 1-token prompt, limit 0,
            # can never share and counts as neither)
            self.misses += 1
        return pages, tokens

    def chain(self, prompt, limit=None):
        """Walk the FULL-page hash chain registered for prompt[:limit]
        (no hit/LRU accounting — a pure read for the disagg shipper
        and directory). Returns (digests, pages): the longest resident
        leading run. Because eviction is leaf-first, the resident part
        of a chain is always a prefix of it."""
        pt = self.pool.page_tokens
        toks = [int(t) for t in prompt]
        limit = len(toks) if limit is None else min(int(limit), len(toks))
        digests, pages, chain = [], [], b''
        for k in range(limit // pt):
            nxt = _digest(chain, toks[k * pt:(k + 1) * pt])
            node = self._nodes.get(nxt)
            if node is None:
                break
            digests.append(nxt)
            pages.append(node.page)
            chain = nxt
        return digests, pages

    def extend_chain(self, parent, digests, pages):
        """Graft externally prefilled full pages onto the chain at
        `parent` (b'' = the root): digests[i] hangs off digests[i-1].
        Each page arrives with the caller's fresh-alloc ref, which
        BECOMES the cache's ref (no extra share). A digest already
        present — a racing install — keeps the resident page and the
        duplicate ref is returned to the pool. The disagg install path
        (serving/disagg.py): shipped bytes were computed by the same
        deterministic prefill on the sender, so the content address
        guarantees byte-identical pages."""
        chain = parent
        for d, p in zip(digests, pages):
            node = self._nodes.get(d)
            if node is not None:
                self.pool.unref(p)
                self._touch(node)
                chain = d
                continue
            node = _Node(p, chain)
            self._nodes[d] = node
            par = self._nodes.get(chain)
            if par is not None:
                par.children += 1
            self._touch(node)
            self._announced.append(d.hex())
            chain = d

    # -- registration ------------------------------------------------------
    def register(self, prompt, table):
        """Index a freshly prefilled prompt's pages for future sharing.
        Takes one cache ref per newly registered page and returns the
        TABLE indices that are now shared (the caller marks them so the
        stream's own appends fork instead of scribbling on cached
        pages)."""
        pt = self.pool.page_tokens
        full = len(prompt) // pt
        chain = b''
        newly_shared = []
        for k in range(min(full, len(table.pages))):
            nxt = _digest(chain, prompt[k * pt:(k + 1) * pt])
            node = self._nodes.get(nxt)
            if node is None:
                node = _Node(self.pool.share(table.pages[k]), chain)
                self._nodes[nxt] = node
                parent = self._nodes.get(chain)
                if parent is not None:
                    parent.children += 1
                newly_shared.append(k)
                self._announced.append(nxt.hex())
            elif node.page == table.pages[k]:
                newly_shared.append(k)       # already cache-shared
            self._touch(node)
            chain = nxt
        rest = tuple(int(t) for t in prompt[full * pt:])
        if rest and full < len(table.pages):
            tails = self._tails.setdefault(chain, {})
            if rest not in tails:
                tail = _Tail(self.pool.share(table.pages[full]),
                             rest, chain)
                tails[rest] = tail
                node = self._nodes.get(chain)
                if node is not None:
                    node.tails += 1
                newly_shared.append(full)
            elif tails[rest].page == table.pages[full]:
                newly_shared.append(full)
            self._touch(tails[rest])
        for idx in newly_shared:
            table.mark_shared(idx)
        return newly_shared

    # -- eviction ----------------------------------------------------------
    def _leaves(self):
        for digest, node in self._nodes.items():
            if not node.children and not node.tails:
                yield node.stamp, ('node', digest, node)
        for chain, tails in self._tails.items():
            for tokens, tail in tails.items():
                yield tail.stamp, ('tail', (chain, tokens), tail)

    def evict_one(self):
        """Drop the LRU leaf entry and unref its page; True if a page
        ref was released (it only FREES the page if no live stream
        still shares it — alloc() loops until one actually frees)."""
        best = min(self._leaves(), default=None, key=lambda e: e[0])
        if best is None:
            return False
        _, (kind, key, entry) = best
        if kind == 'node':
            del self._nodes[key]
            parent = self._nodes.get(entry.parent)
            if parent is not None:
                parent.children -= 1
            self._evicted.append(key.hex())
        else:
            chain, tokens = key
            del self._tails[chain][tokens]
            if not self._tails[chain]:
                del self._tails[chain]
            node = self._nodes.get(chain)
            if node is not None:
                node.tails -= 1
        self.pool.unref(entry.page)
        return True

    def drain_events(self):
        """Take (and clear) the registered/evicted delta since the last
        drain — the replica's SRV_HEALTH reply carries these so the
        router's prefix directory follows replica truth instead of
        guessing from dispatch history."""
        new, gone = self._announced, self._evicted
        self._announced, self._evicted = [], []
        return {'new': new, 'evicted': gone}

    @property
    def resident_pages(self):
        """Pages the cache itself holds a ref on (nodes + tails)."""
        return len(self)

    def __len__(self):
        return len(self._nodes) + sum(len(t) for t in self._tails.values())
