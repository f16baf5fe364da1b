"""ReplicaServer: one LMServer behind the wire, fleet-addressable
(counterpart of paddle_tpu/serving/replica.py; the same SRV_* frames,
so a router of either package drives a replica of the other).

The serving half of the fleet topology (serving/fleet.py): a thin
threaded TCP server — same framing, accept loop and reply conventions
as distributed/rpc.PSServer — dispatching the SRV_* message types into
a local LMServer. A FleetRouter talks to N of these:

  SRV_SUBMIT   open a stream (rid, prompt ids, budget, eos)
  SRV_POLL     batched progress of many rids -> {state, tokens}
  SRV_CANCEL   cancel one stream
  SRV_HEALTH   liveness + load probe (queue depth, active, capacity,
               param version, draining; optional param digests)
  SRV_DRAIN    admission fence on/off (rolling-deploy drain step)
  SRV_REFRESH  orchestrator-driven ParamSubscriber.refresh_once()
  SRV_PAGES    install a pushed KV-page shipment (serving/disagg.py);
               ack carries {installed, deduped}
  SRV_PAGE_FETCH  prefill the meta-described prompt (cache hit = free)
               and reply with an SRV_PAGES frame — the prefill tier's
               serving surface
  COMPLETE     clean shutdown (the tools/serve_replica.py exit path)

Values cross as the wire decodes them: a prompt arrives as a CPU int64
tensor and is read as a list of ints; a page shipment's rows go to the
card once, in install_prefix.

A SUBMIT whose meta names a prefill peer ('prefill_from') is acked
immediately and a ship thread pulls the prompt's pages from that peer
before the local submit (disagg.fetch_and_install) — the stream polls
as QUEUED while shipping, and ANY ship failure falls back to local
re-prefill with the remaining deadline budget (bit-exact by greedy
determinism).

Error classification crosses the wire like the pserver's: a reply
REPLY_ERR with retryable=True (queue full, draining, a failed-but-
retryable refresh) invites the router to try elsewhere/later; anything
else is stream-fatal. Every reply echoes the request's seq.

Stream state is process-local: a kill-9'd replica loses its rids, and
its restarted incarnation answers SRV_POLL for them with UNKNOWN — the
router's failover treats both the dead connection and the UNKNOWN
answer as the same signal and re-prefills the stream elsewhere.
"""
from __future__ import annotations

import socket
import threading
import time

from ..distributed import wire
from . import disagg

__all__ = ['ReplicaServer']

UNKNOWN = 'UNKNOWN'


class _ShippingStream(object):
    """Placeholder handle for a stream whose pages are still in flight
    from the prefill tier: polls as QUEUED, flips to the real LMServer
    handle (or a dead-letter FAILED) when the ship thread finishes.
    Cancellation is a flag the ship thread honors before the local
    submit."""

    __slots__ = ('cancelled', 'error')

    def __init__(self):
        self.cancelled = False
        self.error = None

    def poll(self):
        if self.error is not None:
            return {'state': 'FAILED', 'tokens': [],
                    'error': self.error}
        if self.cancelled:
            return {'state': 'CANCELLED', 'tokens': []}
        return {'state': 'QUEUED', 'tokens': []}


class ReplicaServer(object):
    def __init__(self, server, endpoint='127.0.0.1:0',
                 bind_retry_secs=30.0):
        """server: the LMServer to expose. Binds immediately (with the
        PSServer restart-race retry) so `.port` is known before
        serve_forever()."""
        self._srv = server
        host, port = endpoint.rsplit(':', 1)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        deadline = time.monotonic() + bind_retry_secs
        while True:
            try:
                self._lsock.bind((host, int(port)))
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        self._lsock.listen(64)
        self.port = self._lsock.getsockname()[1]
        self._done = threading.Event()
        self._threads = []
        self._lock = threading.Lock()
        self._streams = {}            # rid -> LMServer handle
        self._draining = False
        # disaggregated-serving counters (SRV_HEALTH feeds these to the
        # router's fleet.* aggregates)
        self._pages_shipped_n = 0     # prefill side: rows sent
        self._ship_bytes_n = 0
        self._pages_installed_n = 0   # decode side: rows grafted
        self._pages_deduped_n = 0
        self._local_reprefills_n = 0  # ship failures eaten locally

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self):
        accept_t = threading.Thread(target=self._accept_loop,
                                    daemon=True)
        accept_t.start()
        self._done.wait()
        try:
            self._lsock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def shutdown(self):
        self._done.set()

    def _accept_loop(self):
        while not self._done.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # -- dispatch ----------------------------------------------------------
    def _serve_conn(self, conn):
        try:
            while True:
                msg_type, meta, value = wire.read_msg(conn)
                ack = {'seq': meta['seq']} if 'seq' in meta else {}
                try:
                    self._dispatch(conn, msg_type, meta, value, ack)
                except (ConnectionError, OSError):
                    return
                except Exception as e:   # noqa: BLE001 — cross the wire
                    err = dict(ack)
                    err.update({'error': str(e),
                                'retryable': _retryable(e)})
                    wire.write_msg(conn, wire.REPLY_ERR, err)
        except (ConnectionError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn, msg_type, meta, value, ack):
        if msg_type == wire.SRV_SUBMIT:
            self._on_submit(conn, meta, value, ack)
        elif msg_type == wire.SRV_POLL:
            self._on_poll(conn, meta, ack)
        elif msg_type == wire.SRV_CANCEL:
            with self._lock:
                handle = self._streams.get(meta['rid'])
            if isinstance(handle, _ShippingStream):
                handle.cancelled = True
            elif handle is not None:
                self._srv.cancel(handle)
            wire.write_msg(conn, wire.REPLY_OK, ack)
        elif msg_type == wire.SRV_PAGES:
            installed, deduped = disagg.install_shipment(self._srv,
                                                         meta, value)
            with self._lock:
                self._pages_installed_n += installed
                self._pages_deduped_n += deduped
            reply = dict(ack)
            reply.update({'installed': installed, 'deduped': deduped})
            wire.write_msg(conn, wire.REPLY_OK, reply)
        elif msg_type == wire.SRV_PAGE_FETCH:
            rmeta, rvalue = disagg.serve_page_fetch(self._srv, meta,
                                                    value)
            with self._lock:
                self._pages_shipped_n += (len(rmeta['keys'])
                                          - rmeta['skip'])
                if rvalue is not None:
                    self._ship_bytes_n += int(rvalue.nbytes)
            reply = dict(ack)
            reply.update(rmeta)
            wire.write_msg(conn, wire.SRV_PAGES, reply, rvalue)
        elif msg_type == wire.SRV_HEALTH:
            reply = dict(ack)
            reply.update(self._health(bool(meta.get('digests'))))
            wire.write_msg(conn, wire.REPLY_OK, reply)
        elif msg_type == wire.SRV_DRAIN:
            self._draining = bool(meta.get('on', True))
            reply = dict(ack)
            reply['draining'] = self._draining
            wire.write_msg(conn, wire.REPLY_OK, reply)
        elif msg_type == wire.SRV_REFRESH:
            if self._srv.subscriber is None:
                err = dict(ack)
                err.update({'error': 'no refresh attached — replica '
                                     'launched without pserver '
                                     'endpoints', 'retryable': False})
                wire.write_msg(conn, wire.REPLY_ERR, err)
                return
            version = self._srv.refresh_once()
            reply = dict(ack)
            reply['param_version'] = int(version)
            wire.write_msg(conn, wire.REPLY_OK, reply)
        elif msg_type == wire.COMPLETE:
            wire.write_msg(conn, wire.REPLY_OK, ack)
            self.shutdown()
        else:
            err = dict(ack)
            err.update({'error': 'replica cannot serve msg type %d'
                                 % msg_type, 'retryable': False})
            wire.write_msg(conn, wire.REPLY_ERR, err)

    def _on_submit(self, conn, meta, value, ack):
        rid = meta['rid']
        if self._draining:
            err = dict(ack)
            err.update({'error': 'replica draining', 'retryable': True})
            wire.write_msg(conn, wire.REPLY_ERR, err)
            return
        prompt = disagg.token_ids(value)
        # deadline_ms rides the meta only when the peer set one — an
        # old router's meta simply lacks the key and decodes to None
        ddl = meta.get('deadline_ms')
        peer = meta.get('prefill_from')
        if peer and getattr(self._srv, 'paged', False):
            # disaggregated dispatch: ack now, ship pages off-thread,
            # submit locally when they land (or when the ship fails —
            # local re-prefill, bit-exact by greedy determinism). The
            # deadline clock starts HERE so every downstream stage
            # deducts elapsed time from one absolute budget.
            deadline_at = (None if ddl is None
                           else time.perf_counter() + float(ddl) / 1000.0)
            sentinel = _ShippingStream()
            with self._lock:
                self._streams[rid] = sentinel
            t = threading.Thread(
                target=self._ship_and_submit,
                args=(rid, sentinel, str(peer), prompt, meta,
                      deadline_at),
                daemon=True)
            t.start()
            wire.write_msg(conn, wire.REPLY_OK, ack)
            return
        handle = self._srv.submit(prompt,
                                  max_new_tokens=int(meta['mnt']),
                                  eos_id=meta.get('eos'),
                                  priority=int(meta.get('prio', 0)),
                                  deadline_ms=None if ddl is None
                                  else float(ddl))
        with self._lock:
            self._streams[rid] = handle
        wire.write_msg(conn, wire.REPLY_OK, ack)

    def _ship_and_submit(self, rid, sentinel, peer, prompt, meta,
                         deadline_at):
        """Ship-thread body: fetch + install the prompt's pages from
        the prefill peer, then run the normal local submit with the
        REMAINING deadline. A dead/gray/slow peer, a refused shipment,
        or a spent budget all converge on the same fallback — submit
        locally anyway; only a failure of the LOCAL submit dead-letters
        the stream (the router sees FAILED with the error string)."""
        try:
            disagg.fetch_and_install(self._srv, peer, prompt,
                                     deadline_at=deadline_at)
        except Exception:  # noqa: BLE001 — every ship failure falls back
            disagg.count_local_reprefill()
            with self._lock:
                self._local_reprefills_n += 1
        if sentinel.cancelled:
            return
        remaining = (None if deadline_at is None
                     else max(1.0, (deadline_at - time.perf_counter())
                              * 1000.0))
        try:
            handle = self._srv.submit(prompt,
                                      max_new_tokens=int(meta['mnt']),
                                      eos_id=meta.get('eos'),
                                      priority=int(meta.get('prio', 0)),
                                      deadline_ms=remaining)
        except Exception as e:  # noqa: BLE001 — dead-letter for the poll
            sentinel.error = str(e)
            return
        with self._lock:
            if sentinel.cancelled:
                self._srv.cancel(handle)
                return
            self._streams[rid] = handle

    def _on_poll(self, conn, meta, ack):
        out = {}
        for rid in meta.get('rids', ()):
            with self._lock:
                handle = self._streams.get(rid)
            if handle is None:
                out[rid] = {'state': UNKNOWN, 'tokens': []}
            elif isinstance(handle, _ShippingStream):
                out[rid] = handle.poll()
            else:
                out[rid] = self._srv.poll(handle)
        reply = dict(ack)
        reply['streams'] = out
        wire.write_msg(conn, wire.REPLY_OK, reply)

    def _health(self, with_digests):
        stats = self._srv.stats()
        out = {'queue_depth': stats['queue_depth'],
               'active': stats['active'],
               'workers': stats['workers'],
               'capacity': stats['workers'] * stats['slots_per_worker'],
               'max_len': self._srv.max_len,
               'param_version': stats.get('param_version'),
               'staleness_rounds': stats.get('staleness_rounds'),
               # paged-cache pressure: tokens held across live slots vs
               # total cache capacity — the router weighs this beyond
               # lane counts (a worker full of 4k streams is hotter
               # than one full of 16-token streams)
               'cache_tokens': stats.get('cache_tokens', 0),
               'cache_capacity': stats.get('cache_capacity'),
               # speculative replicas emit >1 token per step on
               # average: the router divides its load score by this so
               # a high-accept-rate replica looks proportionally roomier
               'effective_tokens_per_step':
                   stats.get('effective_tokens_per_step'),
               'spec_accept_rate':
                   stats.get('spec', {}).get('accept_rate'),
               # preempt-first capacity (serving/preempt.py): lifetime
               # preemptions plus streams currently swapped out and
               # waiting to resume — the router's dispatch score
               # treats waiting preempted streams as cache pressure
               'preemptions': stats.get('preemptions', 0),
               'preempted_streams': stats.get('preempted_streams', 0),
               # mesh-sharded serving: the axis spec and chip count;
               # '' and 1 here, where a replica serves from one card
               'mesh_shape': stats.get('mesh_shape', ''),
               'mesh_devices': stats.get('mesh_devices', 1),
               'draining': self._draining}
        with self._lock:
            out['pages_shipped'] = self._pages_shipped_n
            out['ship_bytes'] = self._ship_bytes_n
            out['pages_installed'] = self._pages_installed_n
            out['pages_deduped'] = self._pages_deduped_n
            out['local_reprefills'] = self._local_reprefills_n
        kv = stats.get('kv')
        if kv:
            # prefix-cache truth for the router's fleet directory: the
            # counters seed fleet.prefix_hit_rate, the drained new/
            # evicted key deltas reconcile the directory against what
            # is ACTUALLY resident here (not router dispatch guesses)
            out['page_tokens'] = kv.get('page_tokens')
            out['prefix_entries'] = kv.get('prefix_entries', 0)
            out['prefix_hits'] = kv.get('prefix_hits', 0)
            out['prefix_misses'] = kv.get('prefix_misses', 0)
            out['prefix_pages'] = kv.get('prefix_pages', 0)
            report = self._srv.prefix_report()
            out['prefix_new'] = report['new']
            out['prefix_evicted'] = report['evicted']
        if with_digests:
            out['digests'] = self._srv.param_digests()
        return out


def _retryable(e):
    """queue-full / draining / a retryable refresh invite the router to
    come back; a bad prompt, a missing subscriber, or a spent deadline
    is stream-fatal — retrying a DeadlineExceededError elsewhere can
    only burn more of a budget that is already gone."""
    from ..online.subscriber import RefreshError
    from .engine import DeadlineExceededError
    if isinstance(e, RefreshError):
        return True
    if isinstance(e, DeadlineExceededError):
        return False
    return isinstance(e, RuntimeError) and not isinstance(e, ValueError)
