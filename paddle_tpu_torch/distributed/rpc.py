"""TCP RPC client/server for parameter-server mode (counterpart of
paddle_tpu/distributed/rpc.py: the same requests, replies and recovery,
over the same frames, so a client of either package talks to a server
of the other).

The capability analog of the reference's GRPCClient (operators/distributed/
grpc_client.h:175: AsyncSendVar/AsyncGetVar/AsyncPrefetchVar/
AsyncSendBatchBarrier/AsyncSendFetchBarrier/AsyncSendComplete) and
AsyncGRPCServer (grpc_server.h:46), re-based on plain sockets + the binary
wire format in wire.py. Each trainer holds one persistent connection per
pserver; the server runs one thread per connection and dispatches into a
service object (param_service.ParameterService) — the threading shape of
the reference's RunSyncLoop server.

Resilience (see distributed/resilience.py): a PSClient survives a dropped
connection mid-training. Every request carries a `seq` number plus a
per-client incarnation nonce; on any transport failure the client closes
the poisoned socket, reconnects under the shared RetryPolicy
(exponential backoff + jitter), and REPLAYS the request with the SAME
seq. The ParameterService keeps a per-trainer dedup window, so a replay
of an already-applied mutation (SEND_VAR / BATCH_BARRIER / CHECKPOINT)
is acknowledged without being applied twice — a retried gradient never
double-counts in a sync round. REPLY_ERR metas carry `retryable`:
transient server rejections re-enter the retry loop, fatal ones raise
FatalRPCError (the reference GRPCClient's channel-retry/backoff model
plus at-most-once semantics that gRPC got from request ids).

Pipelining (the reference's AsyncSendVar/AsyncGetVar completion-queue
model): `send_var_async`/`get_var_async`/`prefetch_async` and the
barrier/checkpoint `_async` variants return concurrent.futures.Futures.
The caller's thread streams request frames onto the connection while a
per-client reader thread matches replies back by the `seq` the server
echoes in every reply meta (an additive optional field, like `trace`) —
up to FLAGS_rpc_inflight_window requests ride one connection, so N
small pushes cost ~1 RTT instead of N. On ANY transport failure the
reader rebuilds the connection and replays every unacked request in seq
order; the server's (cli, seq) dedup window makes that at-most-once
exactly as it does for sync retries. Small dense gradients bound for
the same endpoint coalesce into one SEND_VARS frame (FLAGS_rpc_batch_*)
whose per-var entries each keep their own dedup token. The engine
starts lazily on the first *_async call; until then (and for clients
used purely synchronously) the original blocking path runs unchanged.
Submissions are expected from one thread at a time per client (the
host-op emitter thread) — the engine serializes writes internally, but
interleaving sync calls from OTHER threads while async requests are in
flight is not supported.
"""
from __future__ import annotations

import binascii
import os
import socket
import threading
import time
from concurrent import futures as _futures

import numpy as np
import torch

from . import wire
from .resilience import FatalRPCError, RetryableRPCError, RetryPolicy
from ..obs import telemetry as _tm
from ..obs import trace as _trace

__all__ = ['PSClient', 'PSServer', 'get_client', 'close_all_clients',
           'get_serving_client', 'SERVING_TID_BASE',
           'RetryableRPCError', 'FatalRPCError']

# client-side RPC health: every logical call, every replay of one
# (retries), every fresh connection made to replace a dropped socket
# (reconnects), and read-deadline expiries specifically — the silent
# peer case (FLAGS_rpc_read_deadline)
_CALLS = _tm.counter('rpc.client.calls')
_RETRIES = _tm.counter('rpc.client.retries')
_RECONNECTS = _tm.counter('rpc.client.reconnects')
_DEADLINE_TIMEOUTS = _tm.counter('rpc.client.read_deadline_timeouts')
_CALL_LATENCY = _tm.histogram('rpc.client.call_latency')
# pipelined-engine health: how many requests are riding the connection
# unacked right now, and how many vars each SEND_VARS frame coalesced
_INFLIGHT = _tm.gauge('rpc.client.inflight')
_BATCH_VARS = _tm.histogram('rpc.client.batch_vars')

_MSG_NAMES = {
    wire.SEND_VAR: 'SEND_VAR', wire.GET_VAR: 'GET_VAR',
    wire.SEND_VARS: 'SEND_VARS', wire.GET_VARS: 'GET_VARS',
    wire.GET_VERSION: 'GET_VERSION',
    wire.PREFETCH: 'PREFETCH', wire.BATCH_BARRIER: 'BATCH_BARRIER',
    wire.FETCH_BARRIER: 'FETCH_BARRIER', wire.COMPLETE: 'COMPLETE',
    wire.CHECKPOINT: 'CHECKPOINT', wire.REGISTER: 'REGISTER',
}

# serving-side trainer-id range: a ParamSubscriber co-located with a
# trainer process must never share the server's per-tid (cli, seq)
# dedup/replay windows, liveness clocks, or round state with the real
# trainer 0..num_trainers-1 — tids at or above this base are READ-ONLY
# peers the ParameterService treats as inert (no liveness retirement,
# no round waits, COMPLETE ignored).
SERVING_TID_BASE = 1 << 16


def _msg_name(msg_type):
    return _MSG_NAMES.get(msg_type, 'MSG%d' % msg_type)


def _nbytes(value):
    """Payload bytes of a dense value (torch tensor or array)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(np.asarray(value).nbytes)


def _int32_ids(ids):
    """Row ids as the int32 the PREFETCH request carries."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().to('cpu', torch.int32)
    return np.asarray(ids, dtype='int32')


class _Pending(object):
    """One in-flight pipelined request: the wire meta frozen at submit
    time (a replay reuses the SAME seq/round — the server's dedup
    contract), the future its caller waits on, and the connection
    generation it was last written on (-1: on no socket yet; recovery
    or a rewrite puts it back on the wire)."""
    __slots__ = ('seq', 'msg_type', 'meta', 'value', 'items', 'future',
                 'gen', 'attempts', 'sid', 't0', 'tm0')

    def __init__(self, seq, msg_type, meta, value, items, sid):
        self.seq = seq
        self.msg_type = msg_type
        self.meta = meta
        self.value = value
        self.items = items       # SEND_VARS: [(entry_meta, value), ...]
        self.future = _futures.Future()
        self.gen = -1
        self.attempts = 0        # REPLY_ERR-retryable resubmissions
        self.sid = sid           # trace span id (None: untraced)
        self.t0 = time.time()    # span clock
        self.tm0 = time.monotonic()   # latency clock


def _chain(fut, fn):
    """A future resolving to fn(parent.result()) — runs on the reader
    thread the moment the reply lands."""
    out = _futures.Future()

    def _done(f):
        try:
            out.set_result(fn(f.result()))
        except BaseException as e:
            out.set_exception(e)
    fut.add_done_callback(_done)
    return out


class PSClient(object):
    """One trainer's (self-healing) connection to one pserver endpoint."""

    def __init__(self, endpoint, trainer_id=0, timeout=None,
                 connect_retry_secs=60.0, retry_policy=None,
                 incarnation=None):
        self.endpoint = endpoint
        self.trainer_id = trainer_id
        if timeout is None:
            # read deadline (FLAGS_rpc_read_deadline): create_connection
            # leaves its timeout set on the socket, so every recv also
            # times out — a peer that accepts but never replies (a wedged
            # pserver) surfaces as socket.timeout, which _call_locked
            # already treats as a retryable connection failure, instead
            # of hanging the trainer forever
            from ..flags import get_flag
            timeout = float(get_flag('rpc_read_deadline', 120.0))
        self.timeout = timeout
        host, port = endpoint.rsplit(':', 1)
        self._addr = (host, int(port))
        self._retry = retry_policy or RetryPolicy.from_flags()
        # incarnation nonce: a RESTARTED trainer process re-using this
        # trainer_id must not collide with seqs the server already saw
        self._incarnation = binascii.hexlify(os.urandom(6)).decode()
        # LOGICAL incarnation: the supervisor bumps
        # FLAGS_trainer_incarnation on every restart; the pserver fences
        # lower values (zombie) and rejoins higher ones (see
        # param_service._fence_locked)
        if incarnation is None:
            from ..flags import get_flag
            incarnation = int(get_flag('trainer_incarnation', 0))
        self.incarnation = int(incarnation)
        # this trainer's step index, tagged onto SEND_VAR/BATCH_BARRIER
        # so a pserver that already closed the round ack-ignores a
        # resumed trainer's replay of it
        self._round = 0
        self._seq = 0
        self._sock = None
        self._lock = threading.Lock()
        # pipelined engine (started lazily by the first *_async call).
        # Lock order where both are held: _wlock (write serialization)
        # OUTSIDE _mu (seq/inflight/socket state). The reader thread is
        # the only place sockets are closed while the engine runs;
        # writers that hit a dead socket shutdown() it (waking the
        # reader blocked in recv) and leave recovery to the reader.
        self._mu = threading.Condition(threading.Lock())
        self._wlock = threading.Lock()
        self._inflight = {}      # seq -> _Pending
        self._gen = 0            # connection generation
        self._reader = None
        self._closed = False
        self._reconnect_tries = 0
        self._window_sem = None
        # trainers routinely start before their pservers finish binding
        # (reference GRPC clients block on channel readiness) — retry
        self._connect(connect_retry_secs)

    # -- connection lifecycle ---------------------------------------------
    def _connect(self, retry_secs):
        deadline = time.monotonic() + retry_secs
        while True:
            try:
                sock = socket.create_connection(self._addr,
                                                timeout=self.timeout)
                break
            except (ConnectionRefusedError, OSError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock

    def _drop_socket(self):
        """Close a (possibly half-framed) socket; the next attempt
        reconnects fresh. Never reuse a connection whose framing state
        is unknown."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _invalidate(self):
        """Connection is beyond saving: close it AND evict this client
        from the module pool so no later get_client() hands out a
        poisoned instance."""
        self._drop_socket()
        _evict_client(self)

    # -- request path ------------------------------------------------------
    def _call(self, msg_type, meta=None, value=None):
        if self._reader is not None:
            # the pipelined engine owns the socket once started: the
            # reader thread is the sole reply consumer, so sync calls
            # become submit-and-wait (same blocking semantics, same
            # exceptions — fut.result() re-raises)
            return self._submit(msg_type, dict(meta or {}), value).result()
        meta = dict(meta or {})
        meta['trainer_id'] = self.trainer_id
        with self._lock:
            self._seq += 1
            meta['seq'] = self._seq
            meta['cli'] = self._incarnation
            meta['inc'] = self.incarnation
            # one client span per LOGICAL call (the span covers every
            # retry); its id rides the optional meta 'trace' field so
            # the server's handler span shares it — absent field means
            # untraced, no wire-version bump
            _CALLS.inc()
            t0 = time.monotonic()
            with _trace.span('rpc.%s' % _msg_name(msg_type),
                             kind='client', endpoint=self.endpoint,
                             seq=self._seq) as sp:
                tr = _trace.wire_trace(sp)
                if tr is not None:
                    meta['trace'] = tr
                out = self._call_locked(msg_type, meta, value)
            _CALL_LATENCY.observe(time.monotonic() - t0)
            return out

    def _call_locked(self, msg_type, meta, value):
        last_err = None
        first = True
        for delay in self._retry.schedule():
            if not first:
                _RETRIES.inc()
            first = False
            if delay:
                time.sleep(delay)
            try:
                if self._sock is None:
                    _RECONNECTS.inc()
                    self._connect(self._retry.reconnect_secs)
                wire.write_msg(self._sock, msg_type, meta, value)
                rtype, rmeta, rvalue = wire.read_msg(self._sock)
                rseq = rmeta.get('seq')
                if rseq is not None and rseq != meta['seq']:
                    # stream-desync detector: the reply belongs to a
                    # DIFFERENT request, so framing alignment on this
                    # connection cannot be trusted. FrameCorruptError
                    # is a ConnectionError — caught below, socket
                    # dropped, request replayed on a fresh connection.
                    raise wire.FrameCorruptError(
                        'pserver %s echoed seq %s for request seq %s — '
                        'desynced reply stream'
                        % (self.endpoint, rseq, meta['seq']))
            except FatalRPCError:
                self._invalidate()
                raise
            except (ConnectionError, OSError) as e:
                # transport failure mid-frame (socket.timeout included):
                # the socket may hold misframed garbage — drop it and
                # replay this request (same seq) on a fresh connection
                if isinstance(e, socket.timeout):
                    _DEADLINE_TIMEOUTS.inc()
                last_err = e
                self._drop_socket()
                continue
            if rtype == wire.REPLY_ERR:
                err = 'pserver %s: %s' % (self.endpoint,
                                          rmeta.get('error'))
                if rmeta.get('retryable'):
                    last_err = RetryableRPCError(err)
                    continue
                raise FatalRPCError(err)
            return rmeta, rvalue
        self._invalidate()
        raise RetryableRPCError(
            'pserver %s unreachable after %d attempts (%s: %s)'
            % (self.endpoint, self._retry.max_attempts,
               type(last_err).__name__, last_err)) from last_err

    # -- pipelined engine --------------------------------------------------
    def _ensure_engine(self):
        """Start the reader thread + in-flight window on the first
        async call (idempotent; serialized against in-progress sync
        calls by self._lock, so the engine never steals a reply a sync
        caller is blocked on)."""
        if self._reader is not None:
            return
        with self._lock:
            if self._reader is not None:
                return
            from ..flags import get_flag
            window = max(1, int(get_flag('rpc_inflight_window', 32)))
            self._window_sem = threading.BoundedSemaphore(window)
            t = threading.Thread(
                target=self._read_loop, daemon=True,
                name='psclient-reader-%s' % self.endpoint)
            self._reader = t
            t.start()

    def _submit(self, msg_type, meta, value=None, pairs=None):
        """Register a request in the in-flight window and stream its
        frame onto the connection; returns the future the reader thread
        resolves when the matching (seq-echoed) reply arrives. Blocks
        only when the window is full. A write failure here does NOT
        fail the request: the pending stays registered and the reader's
        recovery replays it on a fresh connection."""
        self._ensure_engine()
        self._window_sem.acquire()
        p = None
        try:
            with self._wlock:
                with self._mu:
                    items = None
                    if pairs is not None:
                        # one seq per CONTAINED var (its dedup token)
                        # plus one frame seq below (reply matching)
                        items = []
                        for name, v in pairs:
                            self._seq += 1
                            items.append(({'name': name,
                                           'seq': self._seq,
                                           'round': self._round}, v))
                    self._seq += 1
                    seq = self._seq
                    meta = dict(meta)
                    meta['trainer_id'] = self.trainer_id
                    meta['seq'] = seq
                    meta['cli'] = self._incarnation
                    meta['inc'] = self.incarnation
                    sid = _trace.new_id() if _trace.enabled() else None
                    if sid is not None:
                        meta['trace'] = {'sid': sid}
                    p = _Pending(seq, msg_type, meta, value, items, sid)
                    self._inflight[seq] = p
                    _CALLS.inc()
                    _INFLIGHT.set(len(self._inflight))
                    if items is not None:
                        _BATCH_VARS.observe(len(items))
                    sock = self._sock
                    gen = self._gen
                    self._mu.notify_all()   # wake the reader
                if sock is not None:
                    try:
                        self._write_pending(sock, p)
                        p.gen = gen
                    except FatalRPCError as e:
                        # injected fatal on THIS request, raised before
                        # any bytes hit the wire: fail it alone, the
                        # connection is unharmed
                        self._finish(p, err=e)
                    except (ConnectionError, OSError):
                        # poisoned socket: wake the reader (shutdown,
                        # NOT close — it may be blocked in recv on this
                        # fd) and leave the pending for its recovery
                        self._shutdown_sock(sock)
                # sock is None: reader is mid-recovery and will replay
                # this pending (gen == -1) along with the others
        except BaseException:
            if p is not None:
                self._finish(p, err=RetryableRPCError('submit failed'))
            else:
                self._window_sem.release()
            raise
        return p.future

    def _write_pending(self, sock, p):
        if p.items is not None:
            wire.write_vars_msg(sock, p.meta, p.items)
        else:
            wire.write_msg(sock, p.msg_type, p.meta, p.value)

    @staticmethod
    def _shutdown_sock(sock):
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _retire_locked(self, sock):
        """Close a dead engine socket; caller holds _wlock (so no
        writer is mid-sendall on the fd when it closes)."""
        with self._mu:
            if self._sock is sock:
                self._sock = None
                self._gen += 1
        try:
            sock.close()
        except OSError:
            pass

    def _read_loop(self):
        """Reader thread: the engine's sole reply consumer and sole
        recovery agent. Sleeps (no deadline churn) while nothing is in
        flight; recovers + replays whenever the connection dies."""
        while True:
            with self._mu:
                while not self._closed and not self._inflight:
                    self._mu.wait()
                if self._closed:
                    break
                sock = self._sock
            if sock is None:
                self._recover()
                continue
            try:
                rtype, rmeta, rvalue = wire.read_msg(sock)
            except (ConnectionError, OSError) as e:
                if isinstance(e, socket.timeout):
                    _DEADLINE_TIMEOUTS.inc()
                with self._wlock:
                    self._retire_locked(sock)
                continue
            self._on_reply(rtype, rmeta, rvalue)
        self._fail_all(RetryableRPCError(
            'client for %s closed with requests in flight'
            % self.endpoint))

    def _recover(self):
        """Rebuild the connection and replay EVERY unacked in-flight
        request in seq order — the server's per-var (cli, seq) dedup
        window turns the replay into at-most-once delivery. Gives up
        (failing all pendings) after the retry policy's attempt budget
        of consecutive recoveries with no successful reply."""
        with self._mu:
            if not self._inflight:
                return
            self._reconnect_tries += 1
            tries = self._reconnect_tries
        if tries > self._retry.max_attempts:
            self._fail_all(RetryableRPCError(
                'pserver %s unreachable after %d attempts — failing '
                'all in-flight requests'
                % (self.endpoint, self._retry.max_attempts)))
            with self._mu:
                self._reconnect_tries = 0
            return
        if tries > 1:
            time.sleep(min(
                self._retry.backoff
                * (self._retry.multiplier ** (tries - 2)),
                self._retry.max_backoff))
        _RECONNECTS.inc()
        try:
            sock = socket.create_connection(self._addr,
                                            timeout=self.timeout)
        except OSError:
            return   # next loop iteration backs off longer and retries
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._wlock:
            with self._mu:
                self._sock = sock
                self._gen += 1
                gen = self._gen
                pend = sorted(self._inflight.values(),
                              key=lambda q: q.seq)
            for q in pend:
                _RETRIES.inc()
                try:
                    self._write_pending(sock, q)
                    q.gen = gen
                except FatalRPCError as e:
                    self._finish(q, err=e)
                except (ConnectionError, OSError):
                    # died again mid-replay: retire and try once more
                    # on the next loop iteration (unwritten pendings
                    # kept gen == -1)
                    self._retire_locked(sock)
                    break

    def _on_reply(self, rtype, rmeta, rvalue):
        seq = rmeta.get('seq')
        replay = []
        with self._mu:
            self._reconnect_tries = 0
            if seq is not None:
                p = self._inflight.get(seq)
            else:
                # legacy peer that doesn't echo seq: the server answers
                # in request order on one connection, so the oldest
                # WRITTEN pending owns this reply
                written = [q for q in self._inflight.values()
                           if q.gen >= 0]
                p = min(written, key=lambda q: q.seq) if written else None
            if p is None:
                return   # stale duplicate ack for a replayed request
            # dropped-request inference: the server replies in arrival
            # order per connection, so a reply for seq S proves every
            # lower seq written on the SAME generation was consumed
            # without a reply (an injected recv-drop ate it) — replay
            # those now instead of waiting for the read deadline.
            # (Spurious inferences are possible when a rewrite put an
            # old seq back on the wire after newer ones; the server's
            # dedup makes the extra replay harmless.)
            for q in self._inflight.values():
                if q is not p and q.seq < p.seq and q.gen == p.gen \
                        and q.gen >= 0:
                    q.gen = -1
                    replay.append(q)
            replay.sort(key=lambda q: q.seq)
        if rtype == wire.REPLY_ERR:
            err = 'pserver %s: %s' % (self.endpoint, rmeta.get('error'))
            if rmeta.get('retryable'):
                p.attempts += 1
                if p.attempts >= self._retry.max_attempts:
                    self._finish(p, err=RetryableRPCError(err))
                else:
                    with self._mu:
                        p.gen = -1
                    replay.append(p)
            else:
                self._finish(p, err=FatalRPCError(err))
        else:
            self._finish(p, result=(rmeta, rvalue))
        for q in replay:
            _RETRIES.inc()
            self._rewrite(q)

    def _rewrite(self, q):
        """Put a still-pending request back on the wire (recv-drop
        inference or a retryable server rejection). Reader thread
        only."""
        with self._wlock:
            with self._mu:
                if q.seq not in self._inflight:
                    return
                sock = self._sock
                gen = self._gen
            if sock is None:
                return   # recovery in progress replays it anyway
            try:
                self._write_pending(sock, q)
                q.gen = gen
            except FatalRPCError as e:
                self._finish(q, err=e)
            except (ConnectionError, OSError):
                self._retire_locked(sock)

    def _finish(self, p, err=None, result=None):
        """Resolve one pending exactly once: pop it (the pop is the
        claim — a pending already failed by _fail_all is skipped),
        release its window slot, record latency + the client span, then
        wake the caller."""
        with self._mu:
            if self._inflight.pop(p.seq, None) is None:
                return
            _INFLIGHT.set(len(self._inflight))
        self._window_sem.release()
        _CALL_LATENCY.observe(time.monotonic() - p.tm0)
        if p.sid is not None:
            _trace.record_span('rpc.%s' % _msg_name(p.msg_type),
                               'client', p.sid, p.t0, time.time(),
                               endpoint=self.endpoint, seq=p.seq)
        if err is not None:
            p.future.set_exception(err)
        else:
            p.future.set_result(result)

    def _fail_all(self, err):
        """Fail every in-flight request (recovery budget exhausted or
        close with work outstanding) and retire the connection + this
        client's pool slot, mirroring the sync path's _invalidate."""
        with self._wlock:
            with self._mu:
                pend = sorted(self._inflight.values(),
                              key=lambda q: q.seq)
                self._inflight.clear()
                _INFLIGHT.set(0)
                sock, self._sock = self._sock, None
                if sock is not None:
                    self._gen += 1
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        for p in pend:
            self._window_sem.release()
            _CALL_LATENCY.observe(time.monotonic() - p.tm0)
            if p.sid is not None:
                _trace.record_span('rpc.%s' % _msg_name(p.msg_type),
                                   'client', p.sid, p.t0, time.time(),
                                   endpoint=self.endpoint, seq=p.seq,
                                   error=True)
            p.future.set_exception(err)
        if pend:
            _evict_client(self)

    # -- async API (the reference's AsyncSendVar/AsyncGetVar shape) --------
    def send_var_async(self, name, value):
        """Pipelined send_var: returns a future resolving to the reply
        meta (or raising the same taxonomy the sync path raises). The
        non-finite pre-check fires HERE at submit time, exactly like
        send_var."""
        from ..flags import get_flag
        if (get_flag('ps_check_grad_finite', True)
                and not wire.value_is_finite(value)):
            raise RetryableRPCError(
                'refusing to send non-finite gradient %r to %s '
                '(FLAGS_ps_check_grad_finite)' % (name, self.endpoint))
        return self._submit(wire.SEND_VAR,
                            {'name': name, 'round': self._round}, value)

    def send_vars_async(self, pairs):
        """Push many gradients to this endpoint; dense values at most
        FLAGS_rpc_batch_bytes big coalesce into SEND_VARS frames (one
        CRC + one JSON header + one reply for dozens of BN scales and
        biases), flushed at FLAGS_rpc_batch_max_bytes /
        FLAGS_rpc_batch_max_vars. Sparse or large values go as
        individual SEND_VARs, in order. Returns one future per frame."""
        from ..flags import get_flag
        from ..selected_rows import SelectedRows
        check = get_flag('ps_check_grad_finite', True)
        thresh = int(get_flag('rpc_batch_bytes', 65536))
        max_bytes = max(1, int(get_flag('rpc_batch_max_bytes', 1 << 20)))
        max_vars = max(2, int(get_flag('rpc_batch_max_vars', 64)))
        futs = []
        batch = []          # [(name, value), ...] accumulating
        nbytes = 0

        def flush():
            nonlocal nbytes
            if not batch:
                return
            if len(batch) == 1:
                name, v = batch[0]
                futs.append(self._submit(
                    wire.SEND_VAR,
                    {'name': name, 'round': self._round}, v))
            else:
                futs.append(self._submit(wire.SEND_VARS, {},
                                         pairs=list(batch)))
            del batch[:]
            nbytes = 0

        for name, value in pairs:
            if check and not wire.value_is_finite(value):
                raise RetryableRPCError(
                    'refusing to send non-finite gradient %r to %s '
                    '(FLAGS_ps_check_grad_finite)'
                    % (name, self.endpoint))
            nb = 0
            small = False
            if thresh > 0 and not isinstance(value, SelectedRows):
                nb = _nbytes(value)
                small = nb <= thresh
            if not small:
                flush()
                futs.append(self._submit(
                    wire.SEND_VAR,
                    {'name': name, 'round': self._round}, value))
                continue
            if batch and (nbytes + nb > max_bytes
                          or len(batch) >= max_vars):
                flush()
            batch.append((name, value))
            nbytes += nb
        flush()
        return futs

    def get_var_async(self, name):
        """Pipelined get_var: future resolving to the parameter value."""
        return _chain(self._submit(wire.GET_VAR, {'name': name}),
                      lambda r: r[1])

    def get_vars_async(self, names):
        """Pipelined multi-param pull (online refresh): ONE GET_VARS
        frame for all of `names`, read atomically on the server. Future
        resolves to (version, entries, values) — entries carry the
        per-param digest stamped under the same lock hold as the read,
        values decode in entry order."""
        return _chain(self._submit(wire.GET_VARS,
                                   {'names': [str(n) for n in names]}),
                      lambda r: (int(r[0].get('version', 0)),
                                 r[0].get('vars', []), r[1]))

    def get_version_async(self, with_manifest=False):
        """Pipelined version poll: future resolving to {'version': int
        [, 'manifest': {name: crc32}]} for this shard."""
        def _strip(r):
            out = dict(r[0])
            out.pop('seq', None)
            return out
        meta = {'manifest': True} if with_manifest else {}
        return _chain(self._submit(wire.GET_VERSION, meta), _strip)

    def get_version(self, with_manifest=False):
        """This shard's current published param version (optionally
        with the per-param digest manifest)."""
        if self._reader is not None:
            return self.get_version_async(with_manifest).result()
        meta = {'manifest': True} if with_manifest else {}
        rmeta, _ = self._call(wire.GET_VERSION, meta)
        out = dict(rmeta)
        out.pop('seq', None)
        return out

    def get_vars(self, names):
        """Blocking multi-param pull — see get_vars_async."""
        if self._reader is not None:
            return self.get_vars_async(names).result()
        rmeta, values = self._call(
            wire.GET_VARS, {'names': [str(n) for n in names]})
        return (int(rmeta.get('version', 0)),
                rmeta.get('vars', []), values)

    def prefetch_async(self, table_name, ids):
        """Pipelined prefetch: future resolving to the embedding rows."""
        return _chain(self._submit(wire.PREFETCH, {'name': table_name},
                                   _int32_ids(ids)),
                      lambda r: r[1])

    def batch_barrier_async(self):
        fut = self._submit(wire.BATCH_BARRIER, {'round': self._round})
        # the round advances at SUBMIT time: the tagged index already
        # rode the meta, and a replay reuses that frozen meta
        self._round += 1
        return fut

    def fetch_barrier_async(self):
        return self._submit(wire.FETCH_BARRIER, {})

    def checkpoint_notify_async(self, dirname):
        return self._submit(wire.CHECKPOINT, {'dirname': dirname})

    def send_var(self, name, value):
        """Push a gradient (dense array or SelectedRows). A non-finite
        value fails fast HERE (retryable — the Trainer's step retry
        recomputes it) rather than spending a round trip on the
        pserver's rejection; the server-side guard still backstops
        corruption introduced downstream of this check."""
        from ..flags import get_flag
        if (get_flag('ps_check_grad_finite', True)
                and not wire.value_is_finite(value)):
            raise RetryableRPCError(
                'refusing to send non-finite gradient %r to %s '
                '(FLAGS_ps_check_grad_finite)' % (name, self.endpoint))
        self._call(wire.SEND_VAR, {'name': name, 'round': self._round},
                   value)

    def get_var(self, name):
        """Pull a parameter value."""
        _, value = self._call(wire.GET_VAR, {'name': name})
        return value

    def prefetch(self, table_name, ids):
        """Distributed lookup table: local row ids -> embedding rows."""
        _, rows = self._call(wire.PREFETCH, {'name': table_name},
                             _int32_ids(ids))
        return rows

    def batch_barrier(self):
        self._call(wire.BATCH_BARRIER, {'round': self._round})
        self._round += 1

    def register(self):
        """(Re)join handshake: announce this incarnation and learn the
        shard's round state. -> {'round', 'expected', 'rejoined'}; a
        restarted trainer resumes at min('expected') across shards and
        set_round()s each client there (elastic recovery)."""
        rmeta, _ = self._call(wire.REGISTER)
        rmeta = dict(rmeta)
        rmeta.pop('seq', None)   # transport echo, not handshake state
        return rmeta

    def set_round(self, round_idx):
        """Pin the step index tagged onto subsequent sends — the resume
        point a restarted trainer computed from register() replies."""
        self._round = int(round_idx)

    def fetch_barrier(self):
        self._call(wire.FETCH_BARRIER)

    def checkpoint_notify(self, dirname):
        """Ask the pserver to save its parameter shard (reference
        checkpoint_notify_op.cc -> RequestCheckpointHandler)."""
        self._call(wire.CHECKPOINT, {'dirname': dirname})

    def complete(self):
        self._call(wire.COMPLETE)

    def close(self):
        r = self._reader
        if r is not None:
            with self._mu:
                self._closed = True
                sock = self._sock
                self._mu.notify_all()
            if sock is not None:
                self._shutdown_sock(sock)   # wake a reader blocked in recv
            r.join(timeout=5.0)
            self._reader = None
        self._drop_socket()


# module-level client pool: one PSClient per (endpoint, trainer_id) for
# this process (the analog of GRPCClient's channel cache);
# Executor.close() drains it.
_clients = {}
_clients_lock = threading.Lock()


def get_client(endpoint, trainer_id=0):
    key = (endpoint, trainer_id)
    with _clients_lock:
        c = _clients.get(key)
        if c is None:
            c = _clients[key] = PSClient(endpoint, trainer_id)
        return c


def get_serving_client(endpoint, subscriber_id=0):
    """A pooled PSClient in the serving tid range (SERVING_TID_BASE +
    subscriber_id): its (cli, seq) tokens, liveness clock and dedup
    window on the server are disjoint from every co-located trainer's
    client pool — a subscriber pull can never be mistaken for (or
    replay-collide with) trainer traffic."""
    return get_client(endpoint, SERVING_TID_BASE + int(subscriber_id))


def _evict_client(client):
    """Drop a poisoned client from the pool (called by the client itself
    while holding its own lock — take only the pool lock here)."""
    with _clients_lock:
        for key, c in list(_clients.items()):
            if c is client:
                del _clients[key]


def close_all_clients(send_complete=True):
    """Notify every connected pserver this trainer is done and drop the
    connections (reference Executor::Close -> SendComplete)."""
    with _clients_lock:
        clients = list(_clients.values())
        _clients.clear()
    # complete() takes each client's own lock and may evict from the
    # pool — keep the pool lock released to avoid lock-order inversion
    for c in clients:
        if send_complete:
            try:
                c.complete()
            except (RuntimeError, OSError, ConnectionError):
                pass
        c.close()


class PSServer(object):
    """Threaded TCP server dispatching wire messages into a service.

    service interface (see param_service.ParameterService); `seq` is an
    opaque replay-dedup token threaded from the request meta, `inc` the
    trainer's logical incarnation (fencing), `round_idx` the trainer's
    step index (resume idempotency):
      on_send_var(name, trainer_id, value, seq=None, inc=None,
                  round_idx=None)
      on_get_var(name, trainer_id, inc=None) -> value
      on_prefetch(name, trainer_id, ids, inc=None) -> rows
      on_batch_barrier(trainer_id, seq=None, inc=None, round_idx=None)
      on_fetch_barrier(trainer_id, inc=None)
      on_checkpoint(dirname, trainer_id, seq=None, inc=None)
      on_register(trainer_id, inc=None, seq=None) -> reply meta dict
      on_complete(trainer_id, inc=None) -> True when ALL completed
      on_get_vars(names, trainer_id, inc=None) -> (version, items)
      on_get_version(trainer_id, inc=None, with_manifest=False) -> meta

    A restarted pserver re-binding its endpoint may race the dying
    process's listener (or its TIME_WAIT): bind retries for
    `bind_retry_secs` so supervisor restarts resume on the SAME
    endpoint the trainers' retry layer is already reconnecting to.
    """

    def __init__(self, endpoint, service, bind_retry_secs=30.0):
        host, port = endpoint.rsplit(':', 1)
        self.service = service
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

    def serve_forever(self):
        """Accept + dispatch until the service reports all trainers
        complete (the RunSyncLoop exit condition, listen_and_serv_op.cc:
        exit_flag on COMPLETE messages). A reaper thread sweeps trainer
        liveness (service.check_liveness) so a silently-dead trainer is
        retired after its rpc_deadline and the server still exits —
        the no-silent-deadlock guarantee."""
        accept_t = threading.Thread(target=self._accept_loop, daemon=True)
        accept_t.start()
        if hasattr(self.service, 'check_liveness'):
            reaper = threading.Thread(target=self._reap_loop, daemon=True)
            reaper.start()
        self._done.wait()
        try:
            self._lsock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=5.0)

    def _reap_loop(self):
        warned = False
        while not self._done.is_set():
            try:
                if self.service.check_liveness():
                    self.shutdown()
                    return
            except Exception as e:
                if not warned:   # a broken sweep must not fail silently
                    import sys
                    print('pserver liveness sweep failed: %r' % e,
                          file=sys.stderr)
                    warned = True
            self._done.wait(timeout=1.0)

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

    def _serve_conn(self, conn):
        svc = self.service
        try:
            while True:
                msg_type, meta, value = wire.read_msg(conn)
                tid = int(meta.get('trainer_id', 0))
                name = meta.get('name')
                # replay-dedup token: (incarnation, seq) — None for
                # legacy clients that don't number their requests
                seq = meta.get('seq')
                key = (meta.get('cli'), seq) if seq is not None else None
                inc = meta.get('inc')
                round_idx = meta.get('round')
                # every reply echoes the request's seq (additive
                # optional meta field, like 'trace'): the pipelined
                # client matches replies to in-flight requests by it,
                # and the sync client uses it as a desync detector
                ack = {'seq': seq} if seq is not None else {}
                try:
                    # handler span shares the CLIENT's span id (meta
                    # 'trace', when present and tracing is on here):
                    # the cross-process link obs/report.py draws flow
                    # events and clock-offset estimates from
                    with _trace.server_span(_msg_name(msg_type),
                                            meta.get('trace'),
                                            trainer_id=tid):
                        self._dispatch(conn, svc, msg_type, meta, value,
                                       tid, name, key, inc, round_idx,
                                       ack)
                except (ConnectionError, OSError):
                    return   # peer vanished mid-dispatch
                except Exception as e:   # surface server-side op errors
                    # classification crosses the wire: transient errors
                    # invite a replay, everything else is fatal
                    err = dict(ack)
                    err.update({'error': str(e),
                                'retryable': isinstance(
                                    e, RetryableRPCError)})
                    wire.write_msg(conn, wire.REPLY_ERR, err)
        except (ConnectionError, OSError):
            return   # read failed / reply write failed: connection dead
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn, svc, msg_type, meta, value, tid, name,
                  key, inc, round_idx, ack=None):
        ack = ack or {}
        if msg_type == wire.SEND_VAR:
            svc.on_send_var(name, tid, value, seq=key,
                            inc=inc, round_idx=round_idx)
            wire.write_msg(conn, wire.REPLY_OK, ack)
        elif msg_type == wire.SEND_VARS:
            # one reply acks the whole batch; each contained var
            # carries its OWN (cli, seq) dedup token + round tag and is
            # applied/journaled exactly like an individual SEND_VAR
            svc.on_send_vars(tid, meta['vars'], value,
                             cli=meta.get('cli'), inc=inc)
            wire.write_msg(conn, wire.REPLY_OK, ack)
        elif msg_type == wire.GET_VAR:
            out = svc.on_get_var(name, tid, inc=inc)
            wire.write_msg(conn, wire.REPLY_VAR, ack, value=out)
        elif msg_type == wire.PREFETCH:
            out = svc.on_prefetch(name, tid, value, inc=inc)
            wire.write_msg(conn, wire.REPLY_VAR, ack, value=out)
        elif msg_type == wire.BATCH_BARRIER:
            svc.on_batch_barrier(tid, seq=key, inc=inc,
                                 round_idx=round_idx)
            wire.write_msg(conn, wire.REPLY_OK, ack)
        elif msg_type == wire.FETCH_BARRIER:
            svc.on_fetch_barrier(tid, inc=inc)
            wire.write_msg(conn, wire.REPLY_OK, ack)
        elif msg_type == wire.CHECKPOINT:
            svc.on_checkpoint(meta.get('dirname'), tid,
                              seq=key, inc=inc)
            wire.write_msg(conn, wire.REPLY_OK, ack)
        elif msg_type == wire.REGISTER:
            out = svc.on_register(tid, inc=inc, seq=key)
            reply = dict(out or {})
            reply.update(ack)
            wire.write_msg(conn, wire.REPLY_OK, reply)
        elif msg_type == wire.GET_VARS:
            version, items = svc.on_get_vars(meta.get('names', ()),
                                             tid, inc=inc)
            entries, payload = wire.pack_vars_body(items)
            reply = dict(ack)
            reply['version'] = int(version)
            reply['vars'] = entries
            # one REPLY_VAR frame for the whole shard pull: the 'vars'
            # meta makes the client decode it as a value list, and a
            # chaos-plan 'corrupt' rule on REPLY_VAR hits exactly this
            # reply (the refresh-path fault surface)
            wire.write_msg(conn, wire.REPLY_VAR, reply, payload=payload)
        elif msg_type == wire.GET_VERSION:
            out = svc.on_get_version(
                tid, inc=inc, with_manifest=bool(meta.get('manifest')))
            reply = dict(out or {})
            reply.update(ack)
            wire.write_msg(conn, wire.REPLY_OK, reply)
        elif msg_type == wire.COMPLETE:
            all_done = svc.on_complete(tid, inc=inc)
            wire.write_msg(conn, wire.REPLY_OK, ack)
            if all_done:
                self.shutdown()
        else:
            err = dict(ack)
            err.update({'error': 'bad msg type %d' % msg_type,
                        'retryable': False})
            wire.write_msg(conn, wire.REPLY_ERR, err)
