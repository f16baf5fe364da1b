"""Fault-tolerant data-task master (counterpart of
paddle_tpu/distributed/master.py, copied: it is plain Python over the
wire): the analog of the reference's Go master service (go/master/service.go — SetDataset :280
builds a task queue over RecordIO chunks, GetTask :368 leases a task
with a timeout timer :341, TaskFinished :411, TaskFailed :455
re-enqueues until failureMax kills the task; etcd-backed snapshot
:207 / recover :166).

Redesign decisions:
- etcd is replaced by an atomic-rename JSON snapshot on local/shared
  disk (the same durability contract the Trainer checkpoints use:
  written-fully-or-not-at-all, recovered on restart);
- the RPC layer is the framework's own wire/TCP stack (distributed/
  wire.py) rather than Go net/rpc;
- tasks are opaque JSON payloads — recordio shard paths from
  recordio.convert_reader_to_recordio_files fit naturally, but any
  descriptor works;
- leases expire lazily (checked on every queue interaction) AND via a
  reaper thread, so a dead worker's tasks return to the queue even
  when no one else is calling.

`task_reader(client, make_samples)` adapts the lease/finish/fail cycle
into an ordinary sample generator, so the whole data stack
(batch/DataFeeder/py_reader) composes with elastic dispatch.
"""
from __future__ import annotations

import binascii
import json
import os
import socket
import threading
import time
from collections import deque

from . import wire
from .resilience import FatalRPCError, RetryableRPCError, RetryPolicy
from ..obs import telemetry as _tm
from ..obs import trace as _trace

__all__ = ['TaskMaster', 'MasterServer', 'MasterClient', 'task_reader']

# wire message types (continuing distributed/wire.py's space)
GET_TASK = 20
TASK_FINISHED = 21
TASK_FAILED = 22
SET_DATASET = 23
MASTER_STATUS = 24

_MSG_NAMES = {GET_TASK: 'GET_TASK', TASK_FINISHED: 'TASK_FINISHED',
              TASK_FAILED: 'TASK_FAILED', SET_DATASET: 'SET_DATASET',
              MASTER_STATUS: 'MASTER_STATUS'}

# MasterClient shares the rpc.client.* series with PSClient — a
# trainer's RPC health is one number regardless of which server it
# talked to; the trace span name distinguishes them
_CALLS = _tm.counter('rpc.client.calls')
_RETRIES = _tm.counter('rpc.client.retries')
_RECONNECTS = _tm.counter('rpc.client.reconnects')
_DEADLINE_TIMEOUTS = _tm.counter('rpc.client.read_deadline_timeouts')


class TaskMaster(object):
    """Task-queue state machine (thread-safe). States mirror the
    reference: todo -> pending(lease) -> done | failed(dropped)."""

    def __init__(self, timeout_secs=60.0, failure_max=3,
                 snapshot_path=None):
        self.timeout_secs = float(timeout_secs)
        self.failure_max = int(failure_max)
        self.snapshot_path = snapshot_path
        self._lock = threading.Lock()
        self._todo = []            # [task_id]
        self._pending = {}         # task_id -> (deadline, worker)
        self._done = []
        self._dead = []            # failed > failure_max
        self._payloads = {}        # task_id -> payload
        self._failures = {}        # task_id -> count
        self._lease_seq = 0        # nonce: stale finish/fail rejected
        self._next_id = 0
        self._pass_id = 0
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # -- queue operations --------------------------------------------------
    def set_dataset(self, payloads):
        """Start a pass over `payloads` (one task each). Appends to any
        unfinished work (reference SetDataset is idempotent per pass)."""
        with self._lock:
            for p in payloads:
                tid = self._next_id
                self._next_id += 1
                self._payloads[tid] = p
                self._failures[tid] = 0
                self._todo.append(tid)
            self._pass_id += 1
            self._snapshot()
            return self._pass_id

    def get_task(self, worker='?'):
        """Lease one task: (task_id, payload, lease_id) or
        (None, None, None) when nothing is leasable right now.
        Distinguish 'drained' (all done/dead) from 'wait' (leases
        outstanding) via all_done(). The lease_id must be echoed to
        task_finished/task_failed: a worker that stalled past its
        timeout holds a STALE lease and must not be able to complete or
        revoke the task after it was re-leased elsewhere.

        No snapshot here: recovery re-queues pending as todo anyway, so
        the persisted state is identical to the pre-lease snapshot (and
        per-lease writes would make snapshot I/O O(n^2) per pass)."""
        with self._lock:
            self._requeue_expired()
            if not self._todo:
                return None, None, None
            tid = self._todo.pop(0)
            self._lease_seq += 1
            self._pending[tid] = (time.monotonic() + self.timeout_secs,
                                  worker, self._lease_seq)
            return tid, self._payloads[tid], self._lease_seq

    def _owns(self, task_id, lease_id):
        lease = self._pending.get(task_id)
        return lease is not None and (lease_id is None
                                      or lease[2] == lease_id)

    def task_finished(self, task_id, lease_id=None):
        with self._lock:
            if self._owns(task_id, lease_id):
                del self._pending[task_id]
                self._done.append(task_id)
                self._snapshot()
                return True
            return False    # lease expired/re-leased; not the owner

    def task_failed(self, task_id, lease_id=None):
        """Re-enqueue, or drop after failure_max (reference :455)."""
        with self._lock:
            if not self._owns(task_id, lease_id):
                return False
            del self._pending[task_id]
            self._failures[task_id] += 1
            if self._failures[task_id] >= self.failure_max:
                self._dead.append(task_id)
            else:
                self._todo.append(task_id)
            self._snapshot()
            return True

    def all_done(self):
        with self._lock:
            self._requeue_expired()
            return not self._todo and not self._pending

    def status(self):
        with self._lock:
            self._requeue_expired()
            return {'todo': len(self._todo),
                    'pending': len(self._pending),
                    'done': len(self._done), 'dead': len(self._dead),
                    'pass': self._pass_id}

    def _requeue_expired(self):
        now = time.monotonic()
        expired = [t for t, (dl, _w, _l) in self._pending.items()
                   if dl < now]
        for t in expired:
            del self._pending[t]
            self._failures[t] += 1
            if self._failures[t] >= self.failure_max:
                self._dead.append(t)
            else:
                self._todo.append(t)
        if expired:
            self._snapshot()

    # -- durability --------------------------------------------------------
    def _snapshot(self):
        if not self.snapshot_path:
            return
        state = {'todo': self._todo,
                 # pending leases snapshot as todo: after a master
                 # restart their deadlines are meaningless and the
                 # reference recovers them as runnable
                 'pending_as_todo': list(self._pending),
                 'done': self._done, 'dead': self._dead,
                 'payloads': {str(k): v
                              for k, v in self._payloads.items()},
                 'failures': {str(k): v
                              for k, v in self._failures.items()},
                 'next_id': self._next_id, 'pass_id': self._pass_id}
        from .statefile import atomic_write_json
        atomic_write_json(self.snapshot_path, state)   # (service.go:346)

    def _recover(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        self._todo = list(state['todo']) + list(state['pending_as_todo'])
        self._done = list(state['done'])
        self._dead = list(state['dead'])
        self._payloads = {int(k): v for k, v in state['payloads'].items()}
        self._failures = {int(k): v for k, v in state['failures'].items()}
        self._next_id = state['next_id']
        self._pass_id = state['pass_id']


class MasterServer(object):
    """TCP front end over a TaskMaster (wire.py framing, JSON meta).

    Replay idempotency: every reply is cached under the request's
    (incarnation, seq) token. A MasterClient that lost a reply to a
    dropped connection replays the request on a fresh connection and
    receives the ORIGINAL reply — a replayed GET_TASK does not lease a
    second task, and a replayed TASK_FINISHED does not read as a stale
    lease (the at-most-once contract the Go master gets from net/rpc
    call sequencing)."""

    _REPLY_CACHE_MAX = 1024

    def __init__(self, endpoint, master=None, bind_retry_secs=10.0,
                 **master_kwargs):
        self.master = master or TaskMaster(**master_kwargs)
        self._replies = {}            # (cli, seq) -> reply meta
        self._reply_order = deque()
        self._reply_lock = threading.Lock()
        host, port = endpoint.rsplit(':', 1)
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # a RESTARTED master re-binds its old endpoint while the dead
        # instance's connections drain — retry instead of failing the
        # recovery it exists to provide
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
        self._stop = threading.Event()
        self._threads = []
        self._conns = []
        # reaper: expired leases return to the queue even while idle
        self._reaper = threading.Thread(target=self._reap_loop,
                                        daemon=True)

    def start(self):
        self._accept_t = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._accept_t.start()
        self._reaper.start()
        return self

    def _reap_loop(self):
        while not self._stop.wait(min(self.master.timeout_secs / 4, 5)):
            self.master.all_done()       # side effect: requeue expired

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _cached_reply(self, key):
        if key is None:
            return None
        with self._reply_lock:
            return self._replies.get(key)

    def _remember_reply(self, key, reply):
        if key is None:
            return
        with self._reply_lock:
            if key in self._replies:
                return
            self._replies[key] = reply
            self._reply_order.append(key)
            while len(self._reply_order) > self._REPLY_CACHE_MAX:
                self._replies.pop(self._reply_order.popleft(), None)

    def _serve_conn(self, conn):
        replay_hits = _tm.counter('master.reply_cache_hits')
        try:
            while not self._stop.is_set():
                msg_type, meta, _ = wire.read_msg(conn)
                seq = meta.get('seq')
                key = (meta.get('cli'), seq) if seq is not None else None
                reply = self._cached_reply(key)
                if reply is not None:   # replay: resend, don't re-apply
                    replay_hits.inc()
                    wire.write_msg(conn, wire.REPLY_OK, reply)
                    continue
                with _trace.server_span(
                        _MSG_NAMES.get(msg_type, 'MSG%d' % msg_type),
                        meta.get('trace')):
                    self._dispatch_one(conn, msg_type, meta, key)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            # prune: long-lived masters serve many short-lived workers
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            self._threads = [t for t in self._threads if t.is_alive()]

    def _dispatch_one(self, conn, msg_type, meta, key):
        if msg_type == GET_TASK:
            tid, payload, lease = self.master.get_task(
                meta.get('worker', '?'))
            reply = {'task_id': tid, 'payload': payload,
                     'lease_id': lease,
                     'drained': self.master.all_done()}
        elif msg_type == TASK_FINISHED:
            reply = {'ok': self.master.task_finished(
                meta['task_id'], meta.get('lease_id'))}
        elif msg_type == TASK_FAILED:
            reply = {'ok': self.master.task_failed(
                meta['task_id'], meta.get('lease_id'))}
        elif msg_type == SET_DATASET:
            reply = {'pass': self.master.set_dataset(
                meta['payloads'])}
        elif msg_type == MASTER_STATUS:
            reply = self.master.status()
        else:
            wire.write_msg(conn, wire.REPLY_ERR,
                           {'error': 'unknown msg %d' % msg_type,
                            'retryable': False})
            return
        self._remember_reply(key, reply)
        wire.write_msg(conn, wire.REPLY_OK, reply)

    def shutdown(self):
        self._stop.set()
        # a thread parked in accept() holds the kernel listen socket
        # open past close() — SHUT_RDWR unblocks it so the port is
        # actually released for a restarted master
        try:
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        if hasattr(self, '_accept_t'):
            self._accept_t.join(timeout=5.0)
        # close live connections too: their server-side sockets hold the
        # port and would block a restarted master's re-bind
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


class MasterClient(object):
    """Worker-side client with the same reconnect/replay discipline as
    PSClient: seq-numbered requests, transparent reconnect under the
    shared RetryPolicy, and replay against the master's reply cache (a
    restarted MASTER also re-serves: connect retries cover its re-bind
    window, and TaskMaster recovery re-queues leases)."""

    def __init__(self, endpoint, worker='worker', timeout=None,
                 connect_retry_secs=60.0, retry_policy=None):
        self.worker = worker
        if timeout is None:
            # same read deadline as PSClient: a mute master surfaces as
            # a retryable timeout, never a silent hang
            from ..flags import get_flag
            timeout = float(get_flag('rpc_read_deadline', 120.0))
        self.timeout = timeout
        host, port = endpoint.rsplit(':', 1)
        self._addr = (host, int(port))
        self._retry = retry_policy or RetryPolicy.from_flags()
        self._incarnation = binascii.hexlify(os.urandom(6)).decode()
        self._seq = 0
        self._sock = None
        self._lock = threading.Lock()
        self._connect(connect_retry_secs)

    def _connect(self, retry_secs):
        deadline = time.monotonic() + retry_secs
        while True:
            try:
                self._sock = socket.create_connection(
                    self._addr, timeout=self.timeout)
                return
            except (ConnectionRefusedError, OSError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)

    def _drop_socket(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, msg_type, meta):
        meta = dict(meta)
        meta['worker'] = self.worker
        with self._lock:
            self._seq += 1
            meta['seq'] = self._seq
            meta['cli'] = self._incarnation
            _CALLS.inc()
            with _trace.span(
                    'master.%s' % _MSG_NAMES.get(msg_type, msg_type),
                    kind='client', seq=self._seq) as sp:
                tr = _trace.wire_trace(sp)
                if tr is not None:
                    meta['trace'] = tr
                return self._call_locked(msg_type, meta)

    def _call_locked(self, msg_type, meta):
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
                wire.write_msg(self._sock, msg_type, meta)
                rtype, reply, _ = wire.read_msg(self._sock)
            except FatalRPCError:
                self._drop_socket()
                raise
            except (ConnectionError, OSError) as e:
                if isinstance(e, socket.timeout):
                    _DEADLINE_TIMEOUTS.inc()
                last_err = e
                self._drop_socket()
                continue
            if rtype == wire.REPLY_ERR:
                err = 'master: %s' % reply.get('error')
                if reply.get('retryable'):
                    last_err = RetryableRPCError(err)
                    continue
                raise FatalRPCError(err)
            return reply
        raise RetryableRPCError(
            'master unreachable after %d attempts (%s: %s)'
            % (self._retry.max_attempts, type(last_err).__name__,
               last_err)) from last_err

    def set_dataset(self, payloads):
        return self._call(SET_DATASET, {'payloads': list(payloads)})

    def get_task(self):
        """(task_id, payload, drained); remembers the lease id for
        the matching task_finished/task_failed call."""
        r = self._call(GET_TASK, {})
        tid = r.get('task_id')
        if tid is not None:
            self._leases = getattr(self, '_leases', {})
            self._leases[tid] = r.get('lease_id')
        return tid, r.get('payload'), r.get('drained')

    def task_finished(self, task_id):
        lease = getattr(self, '_leases', {}).pop(task_id, None)
        return self._call(TASK_FINISHED, {'task_id': task_id,
                                          'lease_id': lease})['ok']

    def task_failed(self, task_id):
        lease = getattr(self, '_leases', {}).pop(task_id, None)
        return self._call(TASK_FAILED, {'task_id': task_id,
                                        'lease_id': lease})['ok']

    def status(self):
        return self._call(MASTER_STATUS, {})

    def close(self):
        self._drop_socket()


def task_reader(client, make_samples, poll_secs=0.5):
    """Adapt the lease cycle into a sample generator (the Go client's
    live-reader integration, go/master/client.go): pulls tasks until the
    master reports the pass drained; a task whose sample stream raises
    is reported failed (-> retried elsewhere) instead of crashing the
    pass."""
    def reader():
        while True:
            tid, payload, drained = client.get_task()
            if tid is None:
                if drained:
                    return
                time.sleep(poll_secs)   # leases outstanding elsewhere
                continue
            try:
                for sample in make_samples(payload):
                    yield sample
            except Exception:           # noqa: BLE001 — retried via lease
                client.task_failed(tid)
                continue
            client.task_finished(tid)
    return reader
