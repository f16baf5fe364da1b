"""Disaggregated prefill/decode serving: KV pages as wire objects
(counterpart of paddle_tpu/serving/disagg.py; the same frames, byte for
byte).

The DistServe/Mooncake split re-based onto this repo's paged cache: a
PREFILL TIER of replicas runs the compute-bound prompt pass and a
DECODE TIER runs the HBM-bound token loop, so the two capacities scale
independently and a long prompt never steals step time from live
decode lanes. The unit of transfer is the page — fixed-size,
refcounted, and content-addressed by the sha1 hash chain
(serving/paging.py) — so a shipment is just "these chain keys, these
float32 rows" and a receiver can verify, dedup, and install it with
machinery that already exists (PagePool.restore_pages +
PrefixCache.extend_chain).

The flow is DECODE-PULL. The router dispatches a stream to a decode
replica with meta['prefill_from'] naming a prefill peer; the decode
replica acks immediately and a ship thread:

    1. computes its 'have' list (resident chain keys for the prompt) —
       a full local hit skips the wire entirely;
    2. sends SRV_PAGE_FETCH (prompt + have) to the prefill peer, which
       prefills on a cache miss (once per unique prefix fleet-wide —
       later fetches hit its PrefixCache) and replies with one
       SRV_PAGES frame carrying only the pages the requester lacked;
    3. installs the shipment at a step boundary and submits the stream
       locally with the REMAINING deadline budget — TTFT is ship time,
       not prefill time.

Every failure mode — peer dead, graying mid-ship (the socket timeout
is FLAGS_disagg_ship_timeout), corrupt frame, key mismatch, pool
exhaustion — degrades to LOCAL RE-PREFILL on the decode replica,
bit-exact with the shipped path by greedy determinism. Nothing on this
path is load-bearing for correctness; it only moves where the prefill
FLOPs are spent.

The torch boundary: page rows leave the card once, as the host float32
copies export_prefix gathers, travel as one float32 array, arrive as a
CPU tensor over the received bytes, and reach the card once, through
install_prefix. Token ids cross as int64.

Telemetry: disagg.pages_shipped / disagg.ship_bytes /
disagg.pages_installed / disagg.pages_deduped counters,
disagg.local_reprefills (fallbacks taken), disagg.ship_latency
histogram (fetch + install seconds).
"""
from __future__ import annotations

import socket
import time

import numpy as np
import torch

from ..distributed import wire
from ..flags import get_flag
from ..obs import telemetry

__all__ = ['ShipError', 'pack_pages', 'unpack_rows', 'install_shipment',
           'serve_page_fetch', 'fetch_and_install']

_pages_shipped = telemetry.counter('disagg.pages_shipped')
_ship_bytes = telemetry.counter('disagg.ship_bytes')
_pages_installed = telemetry.counter('disagg.pages_installed')
_pages_deduped = telemetry.counter('disagg.pages_deduped')
_local_reprefills = telemetry.counter('disagg.local_reprefills')
_ship_latency = telemetry.histogram('disagg.ship_latency')


class ShipError(RuntimeError):
    """A page ship failed (peer dead/slow, frame corrupt, keys refused,
    budget spent). Always recoverable: the caller re-prefills locally
    and the stream proceeds bit-exact."""


def pack_pages(prompt, export, have=()):
    """Build the SRV_PAGES (meta, value) pair from an
    LMServer.export_prefix() result, omitting the leading pages the
    receiver's `have` key list already holds. meta['keys'] is the FULL
    chain run (receiver re-verifies it against its own hash of the
    prompt); meta['skip'] counts the omitted leading rows; the value is
    one float32 [pools, shipped_pages, page_tokens, ...] array (None
    when everything deduped)."""
    keys = list(export['keys'])
    skip = 0
    for mine, theirs in zip(keys, have):
        if mine != theirs:
            break
        skip += 1
    meta = {'keys': keys, 'skip': skip,
            'prompt': [int(t) for t in prompt],
            'page_tokens': int(export['tokens'] // max(1, len(keys)))}
    if skip >= len(keys):
        return meta, None
    value = np.stack([np.asarray(rows[skip:], np.float32)
                      for rows in export['data']])
    return meta, value


def unpack_rows(meta, value):
    """The shipped per-pool row arrays from an SRV_PAGES frame — [] when
    the frame was a pure dedup ack."""
    if value is None:
        return []
    if isinstance(value, torch.Tensor):
        arr = value.to(torch.float32).numpy()
    else:
        arr = np.asarray(value, np.float32)
    return [arr[i] for i in range(arr.shape[0])]


def install_shipment(srv, meta, value):
    """Install one SRV_PAGES frame into `srv` (an LMServer). Returns
    (installed, deduped) page counts. ValueError (keys refused) and
    CacheExhaustedError propagate — the replica's dispatch crosses them
    to the pusher as REPLY_ERR with the usual retryable split."""
    prompt = [int(t) for t in meta['prompt']]
    keys = list(meta.get('keys') or ())
    installed, deduped = srv.install_prefix(
        prompt, keys, unpack_rows(meta, value),
        skip=int(meta.get('skip', 0)))
    _pages_installed.inc(installed)
    _pages_deduped.inc(deduped)
    return installed, deduped


def serve_page_fetch(srv, meta, value):
    """The prefill tier's half: answer one SRV_PAGE_FETCH with the
    (meta, value) of the SRV_PAGES reply. Prefills the prompt locally
    when its pages are not already cached — srv.submit with
    max_new_tokens=1 registers every full prompt page with the
    PrefixCache, so the SECOND fetch of the same prefix ships straight
    from cache (prefill once per unique prefix fleet-wide). A
    deadline_ms in the fetch meta bounds the prefill wait; on expiry
    the typed DeadlineExceededError crosses back as non-retryable and
    the requester eats the remaining budget locally."""
    prompt = token_ids(value)
    have = [str(k) for k in meta.get('have') or ()]
    export = srv.export_prefix(prompt)
    full = (len(prompt) - 1) // max(1, _page_tokens(srv))
    if full > 0 and (export is None or len(export['keys']) < full):
        # cache miss (or a partially evicted chain): run the prefill —
        # one generated token is the cheapest complete prefill, and
        # registration happens on the final prefill chunk
        ddl = meta.get('deadline_ms')
        handle = srv.submit(prompt, max_new_tokens=1,
                            deadline_ms=None if ddl is None
                            else float(ddl))
        srv.result(handle)
        export = srv.export_prefix(prompt)
    if export is None:
        # sub-page prompt (or the pool evicted everything under
        # pressure): nothing shippable, the requester prefills locally
        return ({'keys': [], 'skip': 0, 'prompt': prompt,
                 'page_tokens': _page_tokens(srv)}, None)
    rmeta, rvalue = pack_pages(prompt, export, have=have)
    shipped = len(rmeta['keys']) - rmeta['skip']
    _pages_shipped.inc(shipped)
    _pages_deduped.inc(rmeta['skip'])
    if rvalue is not None:
        _ship_bytes.inc(int(rvalue.nbytes))
    return rmeta, rvalue


def token_ids(value):
    """Token ids as a list of ints, from a wire value (a CPU int64
    tensor), a numpy array or a list."""
    if isinstance(value, torch.Tensor):
        return [int(t) for t in value.reshape(-1).tolist()]
    return [int(t) for t in np.asarray(value).reshape(-1)]


def _page_tokens(srv):
    stats = srv.stats().get('kv') or {}
    return int(stats.get('page_tokens') or 0)


def fetch_and_install(srv, endpoint, prompt, deadline_at=None,
                      timeout=None):
    """The decode tier's half: pull `prompt`'s pages from the prefill
    replica at `endpoint` and install them into `srv`. Returns
    {'installed', 'deduped', 'fetched', 'bytes'}; raises ShipError on
    ANY failure (the caller falls back to local prefill). `deadline_at`
    (absolute perf_counter, from the stream's submit meta) is deducted
    at every stage — the fetch forwards only the REMAINING milliseconds
    and the socket never waits past min(remaining,
    FLAGS_disagg_ship_timeout)."""
    t0 = time.perf_counter()
    budget = float(timeout if timeout is not None
                   else get_flag('disagg_ship_timeout'))
    prompt = token_ids(prompt)
    have = srv.resident_keys(prompt)
    full = (len(prompt) - 1) // max(1, _page_tokens(srv))
    if len(have) >= full:
        # the whole shippable chain is already local — zero wire bytes
        return {'installed': 0, 'deduped': full, 'fetched': False,
                'bytes': 0}
    fmeta = {'have': have}
    if deadline_at is not None:
        remaining = deadline_at - time.perf_counter()
        if remaining <= 0:
            raise ShipError('deadline spent before the page fetch')
        fmeta['deadline_ms'] = max(1.0, remaining * 1000.0)
        budget = min(budget, remaining)
    host, port = endpoint.rsplit(':', 1)
    sock = None
    try:
        sock = socket.create_connection(
            (host, int(port)),
            timeout=min(budget, float(get_flag('fleet_connect_timeout'))))
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(budget)
        wire.write_msg(sock, wire.SRV_PAGE_FETCH, fmeta,
                       np.asarray(prompt, np.int64))
        rt, rmeta, rvalue = wire.read_msg(sock)
    except (ConnectionError, OSError) as e:
        raise ShipError('page fetch from %s failed: %s' % (endpoint, e))
    finally:
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
    if rt == wire.REPLY_ERR:
        raise ShipError('prefill peer %s refused the fetch: %s'
                        % (endpoint, rmeta.get('error')))
    if rt != wire.SRV_PAGES:
        raise ShipError('prefill peer %s answered msg type %d, expected '
                        'SRV_PAGES' % (endpoint, rt))
    if deadline_at is not None and time.perf_counter() >= deadline_at:
        raise ShipError('deadline spent during the page fetch')
    try:
        installed, deduped = install_shipment(srv, rmeta, rvalue)
    except (ValueError, RuntimeError) as e:
        raise ShipError('shipment from %s refused: %s' % (endpoint, e))
    _ship_latency.observe(time.perf_counter() - t0)
    nbytes = 0 if rvalue is None else \
        int(rvalue.numel() * rvalue.element_size())
    return {'installed': installed, 'deduped': deduped, 'fetched': True,
            'bytes': nbytes}


def count_local_reprefill():
    """Bump disagg.local_reprefills — the ship path's fallback taken
    (replica.py calls this when a ship fails and the stream prefills
    locally instead)."""
    _local_reprefills.inc()
