"""Parameter service: the listen_and_serv sync/async loop state machine
(counterpart of paddle_tpu/distributed/param_service.py). The values it
holds and merges are CPU torch tensors (what the port's wire decodes)
or numpy arrays; the merge adds them in the JAX package's order, so its
sums are the same bits.

Semantics transplanted from the reference pserver
(operators/listen_and_serv_op.cc — RunSyncLoop :102, RunAsyncLoop :178):

sync mode, per round:
  1. every trainer pushes its gradients (SEND_VAR) then a BATCH_BARRIER;
  2. when all live trainers' barriers arrived, gradients are merged
     (sum / num_trainers — averaging half-batch mean-loss grads
     reproduces the full-batch gradient exactly) and the optimize blocks
     run against the pserver scope;
  3. parameter pulls (GET_VAR / PREFETCH) issued after a trainer's
     barrier block until that round's update is applied, then serve the
     fresh values; FETCH_BARRIER ends the trainer's round.

async mode: each SEND_VAR immediately runs that gradient's optimize
block (no barriers, no merge — the reference's async SGD).

A COMPLETE message retires a trainer; barriers re-evaluate against the
live set so stragglers don't deadlock (reference rpc_server.cc
DecreaseClientNum), and the server shuts down once every trainer
completed.

Liveness: a trainer that dies WITHOUT sending COMPLETE would stall
every barrier forever. Every message refreshes the
trainer's last-seen time, and barrier evaluation retires any trainer
silent for longer than `rpc_deadline` seconds (FLAGS_rpc_deadline —
the reference's client-side deadline, operators/distributed/
rpc_client.cc FLAGS_rpc_deadline, applied server-side where this
design keeps the round state). Retired-dead trainers are recorded in
`dead_tids`; the cluster finishes with the survivors instead of
deadlocking, and the server can shut down once every trainer is
accounted for (completed or dead).

Sparse merge: SelectedRows from several trainers concatenate rows/values
(duplicate rows are legal — optimizer scatter-adds merge them), then
values scale by 1/num_trainers in sync mode (or 1/live_count under
FLAGS_ps_average_live — see _merge).

Idempotent replay: a reconnecting PSClient replays a request whose
reply was lost (see distributed/rpc.py). Every mutating handler
(SEND_VAR / BATCH_BARRIER / CHECKPOINT) consults a bounded per-trainer
dedup window keyed on the request's (incarnation, seq) token: an
already-applied mutation is acknowledged WITHOUT re-applying, so a
retried gradient or barrier never double-counts in a sync round
(`FLAGS_rpc_dedup_window` bounds the memory). Read-only handlers
(GET_VAR / PREFETCH) simply re-execute; COMPLETE is naturally
idempotent.

Elastic recovery — either side of the connection may DIE and
come back:

**Trainer rejoin with incarnation fencing.** Every message carries the
trainer's *incarnation* number (`FLAGS_trainer_incarnation`, bumped by
the supervisor on each restart). A message whose incarnation is LOWER
than the registered one is a zombie from before a restart and is
rejected with the non-retryable `StaleIncarnationError`; one with a
HIGHER incarnation triggers `_rejoin_locked` — the permanent
`dead_tids` ban is lifted, the trainer's stale pending grads and
barrier are scrubbed, its dedup window is reset, and it re-enters the
live set at the next round boundary. The REGISTER handshake tells the
restarted trainer which step to resume from (`_trainer_rounds[tid]`);
SEND_VAR / BATCH_BARRIER additionally carry the trainer's step index
(`round_idx`) so a server that already closed that round ack-ignores
the replayed contribution instead of double-counting it — that is what
makes recovery land on bit-exact weights.

**Pserver durability.** With a `snapshot_path`, the service snapshots
params + round counters + dedup windows + incarnations to an atomic
on-disk file every `snapshot_every` rounds (statefile.atomic_replace,
mirroring Master.save_state), and journals every applied mutation
between snapshots as raw wire frames (wire.pack_msg) to
`<snapshot_path>.journal`, flushed per record. A restarted server
restores the snapshot, replays the journal through the same handlers
(`_replaying` suppresses re-journaling and re-snapshotting), and is
bit-exactly back at the kill point: the only in-flight request the
journal can miss is the one whose reply was never sent, and the
client's retry layer replays exactly that one. A crash BETWEEN the
snapshot replace and the journal rotation is safe too — replayed
pre-snapshot records are absorbed by the snapshotted dedup windows and
round tags.

**Corruption defense.** Every snapshot carries a crc32 digest sidecar
(statefile.write_digest) and every journal record carries the wire
frame's own CRC. Snapshots rotate through two generations: writing
snapshot S_k moves the previous one to `<path>.prev` and the journal
(covering [S_{k-1}, S_k)) to `<path>.journal.prev`, so restore can fall
back a full generation: a snapshot that fails its digest (or does not
load) is quarantined to `<path>.corrupt` — kept on disk for
post-mortem — and the `.prev` snapshot plus BOTH journals replay to the
exact same state (pre-snapshot records are absorbed, same argument as
the crash window above). A journal frame that fails its CRC ends
replay at the last good record — the consistent prefix — with a loud
warning, and the damaged file is quarantined. After any quarantine the
service immediately persists a fresh verified snapshot and retires the
older generation (its journal continuity is broken: pairing a stale
snapshot with a later-era journal would silently lose the recovered
prefix). If every generation is corrupt, the service starts from
initial state LOUDLY rather than replay journal deltas against a lost
base. A torn trailing journal record (mid-write crash) is truncated
before the journal reopens for append — appending after torn bytes
would corrupt the framing of everything that follows.

With `check_grad_finite` (FLAGS_ps_check_grad_finite, default on), a
SEND_VAR whose float payload contains NaN/Inf is rejected BEFORE it is
journaled or applied, with a retryable error: a poisoned gradient (bit
corruption that survived transport, or a diverging trainer) never
enters the durable state, and the client's in-place retry re-sends the
value it actually computed — if that one is clean (transient fault),
training proceeds bit-exactly.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque

import numpy as np
import torch

from .. import profiler as _prof
from ..obs import telemetry as _tm

__all__ = ['ParameterService']

# pserver durability + dedup health (no-ops while FLAGS_obs_dir is
# unset): a chaos-run rollup with nonzero replay/journal/snapshot
# counters is the evidence the recovery machinery actually fired
_DEDUP_HITS = _tm.counter('ps.dedup_replay_hits')
_STALE_ROUND_ACKS = _tm.counter('ps.stale_round_acks')
_NONFINITE_REJECTED = _tm.counter('ps.nonfinite_grads_rejected')
_ROUNDS = _tm.counter('ps.rounds_completed')
_JOURNAL_APPENDS = _tm.counter('ps.journal.appends')
_JOURNAL_REPLAYED = _tm.counter('ps.journal.replayed_frames')
_SNAP_WRITES = _tm.counter('ps.snapshot.writes')
_SNAP_RESTORES = _tm.counter('ps.snapshot.restores')
# online refresh (the JAX package's online/): the version this shard currently
# publishes, and how many GET_VARS shard pulls it served
_PARAM_VERSION = _tm.gauge('ps.param_version')
_VERSION_PULLS = _tm.counter('ps.version_pulls')


def _scalar(value, dtype):
    """A 0-d tensor of `dtype`: the scale rounded to the values' dtype
    first, as numpy rounds a Python float against a float32 array."""
    return torch.tensor(value, dtype=dtype)


def _snapshot_arrays(state):
    """{name: value} -> npz entries. A bf16 tensor (numpy has no bf16)
    is kept as its 2-byte pattern under 'p16:'; the rest under 'p:'."""
    arrays = {}
    for name, val in state.items():
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu()
            if val.dtype == torch.bfloat16:
                arrays['p16:' + name] = val.view(torch.int16).numpy()
                continue
            val = val.numpy()
        arrays['p:' + name] = np.asarray(val)
    return arrays


def _snapshot_params(z):
    """Inverse of _snapshot_arrays over an open npz: {name: value}."""
    params = {}
    for k in z.files:
        if k.startswith('p:'):
            params[k[len('p:'):]] = np.array(z[k])
        elif k.startswith('p16:'):
            params[k[len('p16:'):]] = torch.from_numpy(
                np.array(z[k])).view(torch.bfloat16)
    return params


class ParameterService(object):
    def __init__(self, num_trainers, sync_mode, get_param, run_round,
                 run_one_grad=None, prefetch=None, save_params=None,
                 rpc_deadline=None, snapshot_path=None,
                 snapshot_every=None, dump_state=None, load_state=None,
                 average_live=None, param_names=None):
        """get_param(name) -> value; run_round(merged: {grad: value});
        run_one_grad(grad_name, value) for async; prefetch(table, ids);
        save_params(dirname) checkpoints this server's shard (the
        reference's RequestCheckpointHandler running the save block —
        listen_and_serv_op.cc:251 checkpoint_point_block_id).
        rpc_deadline: seconds of silence after which a trainer is
        declared dead and retired (None -> FLAGS_rpc_deadline).
        snapshot_path (None -> FLAGS_ps_state_path): enables crash
        durability — dump_state() -> {name: array} and
        load_state({name: array}) must then round-trip this shard's
        persistable scope; snapshot_every (None ->
        FLAGS_ps_snapshot_every) is the round period. average_live
        (None -> FLAGS_ps_average_live) switches _merge to the live-set
        denominator. param_names: the parameter block names this shard
        hosts — enables online-refresh version publication (GET_VERSION
        manifests + GET_VARS multi-pulls); None leaves those handlers
        serving an empty manifest."""
        import time
        from ..flags import get_flag
        self.num_trainers = num_trainers
        self.sync_mode = sync_mode
        self._get_param = get_param
        self._save_params = save_params
        self._run_round = run_round
        self._run_one_grad = run_one_grad
        self._prefetch = prefetch
        if rpc_deadline is None:
            rpc_deadline = float(get_flag('rpc_deadline', 180.0))
        self.rpc_deadline = rpc_deadline
        # a trainer that has NEVER connected gets the larger of the
        # deadline and this grace: process spawn + jit compile of the
        # first step must not count as "silent death"
        self.first_contact_grace = max(rpc_deadline, 120.0)
        if average_live is None:
            average_live = bool(get_flag('ps_average_live', False))
        self.average_live = average_live
        self.check_grad_finite = bool(get_flag('ps_check_grad_finite',
                                               True))

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = {}            # grad name -> {tid: value}
        self._barrier_tids = set()    # tids whose BATCH_BARRIER arrived
        self._trainer_rounds = {}     # tid -> rounds contributed
        self._completed_rounds = 0
        self._done_tids = set()
        self.dead_tids = set()        # retired by the liveness deadline
        self._incarnations = {}       # tid -> highest registered inc
        self._error = None
        # every expected trainer's clock starts now: one that NEVER
        # connects must still be retireable
        self._start = time.monotonic()
        self._last_seen = {}          # tid -> monotonic last message
        self._barrier_ever = set()    # tids past their FIRST barrier
        # replay dedup: per-trainer window of applied (cli, seq) tokens
        self._dedup_window = int(get_flag('rpc_dedup_window', 512))
        self._seq_seen = {}           # tid -> set of tokens
        self._seq_order = {}          # tid -> deque (eviction order)
        # -- online refresh ------------------------------------------------
        # monotonically increasing param version this shard publishes:
        # bumped at every sync round close (and per applied async grad),
        # so version == completed optimizer rounds on a fresh server.
        # The digest manifest (per-param crc32 over the exact bytes a
        # GET_VARS pull ships) is computed lazily per version and cached
        # — pollers pay the hash at most once per round, not per poll.
        self.param_names = list(param_names or ())
        self._param_version = 0
        self._manifest_cache = None   # (version, {name: crc32}) or None
        # -- durability ----------------------------------------------------
        if snapshot_path is None:
            snapshot_path = get_flag('ps_state_path', '') or None
        self.snapshot_path = snapshot_path
        if snapshot_every is None:
            snapshot_every = int(get_flag('ps_snapshot_every', 1))
        self.snapshot_every = max(1, int(snapshot_every))
        self._dump_state = dump_state
        self._load_state = load_state
        self._replaying = False
        self._journal_f = None
        self._async_applied = 0       # async mode: sends since snapshot
        self._restore_dirty = False   # restore quarantined corruption
        if self.snapshot_path:
            self._restore()
            if self._restore_dirty and self._dump_state is not None:
                # corruption was quarantined during restore: the
                # in-memory state (surviving snapshot + journal prefix)
                # is the only trustworthy copy — persist it as a fresh
                # verified generation before serving
                with self._lock:
                    self._recover_generations_locked()
            if self._journal_f is None:
                self._journal_open()

    # -- helpers -----------------------------------------------------------
    def _live_count(self):
        return self.num_trainers - len(self._done_tids)

    def _touch(self, tid):
        import time
        with self._lock:
            self._last_seen[tid] = time.monotonic()

    def _retire_dead_locked(self):
        """Retire every trainer silent past the deadline (the silent-
        death path: no COMPLETE will ever come). Known tids use their
        last message time; never-connected tids use service start."""
        import time
        now = time.monotonic()
        changed = False
        for tid in range(self.num_trainers):
            if tid in self._done_tids:
                continue
            # the tight deadline applies only once a trainer is in
            # steady state: past its FIRST barrier in sync mode (the
            # startup recv is followed by client-side program compile,
            # which must not count as silent death), or simply once
            # seen in async mode (which has no barriers at all)
            seen = self._last_seen.get(tid, self._start)
            steady = (tid in self._barrier_ever if self.sync_mode
                      else tid in self._last_seen)
            limit = (self.rpc_deadline if steady
                     else self.first_contact_grace)
            if now - seen > limit:
                self._done_tids.add(tid)
                self.dead_tids.add(tid)
                self._barrier_tids.discard(tid)
                # a trainer that died MID-PUSH must not contribute its
                # stale partial gradients to a round it never
                # barriered into
                for per_tid in self._pending.values():
                    per_tid.pop(tid, None)
                changed = True
        if changed:
            self._maybe_run_round_locked()
            self._cond.notify_all()
        return changed

    def _check_not_dead(self, tid):
        """Reject messages from a trainer already retired by the
        deadline: a slow-but-alive 'zombie' must fail loudly (the
        client surfaces the REPLY_ERR) instead of silently joining
        rounds whose live set no longer counts it. Rejoining is
        possible, but only as a FRESH incarnation (restart with a
        higher FLAGS_trainer_incarnation and re-register)."""
        if tid in self.dead_tids:
            raise RuntimeError(
                'trainer %d was retired by the liveness deadline '
                '(%.0f s silent) and may not rejoin this sync session '
                'with the same incarnation; restart it with a higher '
                'FLAGS_trainer_incarnation to re-register'
                % (tid, self.rpc_deadline))

    def _fence_locked(self, tid, inc):
        """Incarnation fence. A LOWER incarnation than the registered
        one is a zombie process from before a restart: reject it
        non-retryably. A HIGHER one is the restarted trainer announcing
        itself — rejoin it on the spot (REGISTER is the polite path,
        but any message may arrive first after a restart)."""
        from .resilience import StaleIncarnationError
        inc = int(inc or 0)
        cur = self._incarnations.get(tid, 0)
        if inc < cur:
            raise StaleIncarnationError(
                'trainer %d message carries incarnation %d but '
                'incarnation %d is registered: stale pre-restart '
                'zombie, not retryable' % (tid, inc, cur))
        if inc > cur:
            self._rejoin_locked(tid, inc)
            return True
        return False

    def _rejoin_locked(self, tid, inc):
        """Re-admit a restarted trainer under a new incarnation: lift
        the dead ban, scrub every trace of the previous incarnation
        (pending grads, barrier membership, dedup window), and restart
        the first-contact grace clock — the fresh process has to re-jit
        before its first barrier, exactly like a cold start. The
        trainer re-enters the live set immediately, so the next round
        boundary waits for its barrier. Returns whether the tid had
        been retired as dead."""
        import time
        was_dead = tid in self.dead_tids
        self._incarnations[tid] = int(inc)
        self.dead_tids.discard(tid)
        self._done_tids.discard(tid)
        self._barrier_tids.discard(tid)
        for per_tid in self._pending.values():
            per_tid.pop(tid, None)
        self._barrier_ever.discard(tid)
        self._last_seen[tid] = time.monotonic()
        self._seq_seen.pop(tid, None)
        self._seq_order.pop(tid, None)
        self._cond.notify_all()
        return was_dead

    def check_liveness(self):
        """Periodic liveness sweep (PSServer reaper thread). Returns
        True when every trainer is accounted for (completed or dead) —
        the server's shutdown condition. A retired-then-rejoined
        trainer is live again (rejoin removed it from _done_tids), so
        the server keeps serving while its new incarnation is in
        flight."""
        with self._lock:
            self._retire_dead_locked()
            return len(self._done_tids) >= self.num_trainers

    def _merge(self, values):
        """Merge one grad's per-trainer values: sum, then average.

        Default denominator is the ORIGINAL `num_trainers` — a retired
        trainer's mean-grad contribution is treated as zero, which
        silently SHRINKS the effective LR as trainers die but keeps
        surviving-set runs bit-comparable to the full-set run.
        `FLAGS_ps_average_live` switches to the live-set denominator:
        the update stays a true mean of the contributions (constant
        effective LR), at the cost of weights diverging from the
        full-set baseline the moment a trainer dies.

        The sum runs in arrival-map order, left to right, and the scale
        is rounded to the values' dtype before the multiply, as numpy
        does with a Python float: the JAX package's bits."""
        from ..selected_rows import SelectedRows
        denom = self._live_count() if self.average_live \
            else self.num_trainers
        scale = 1.0 / float(max(1, denom))
        vs = list(values)
        if isinstance(vs[0], SelectedRows):
            if not isinstance(vs[0].values, torch.Tensor):
                rows = np.concatenate([np.asarray(v.rows) for v in vs])
                vals = np.concatenate([np.asarray(v.values) for v in vs])
                return SelectedRows(vals * scale, rows.astype('int32'),
                                    vs[0].height)
            rows = torch.cat([torch.as_tensor(v.rows) for v in vs])
            vals = torch.cat([torch.as_tensor(v.values) for v in vs])
            return SelectedRows(vals * _scalar(scale, vals.dtype),
                                rows.to(torch.int32), vs[0].height)
        if not isinstance(vs[0], torch.Tensor):
            out = np.asarray(vs[0], dtype=np.result_type(vs[0]))
            for v in vs[1:]:
                out = out + np.asarray(v)
            return out * scale
        out = vs[0]
        for v in vs[1:]:
            out = out + torch.as_tensor(v)
        return out * _scalar(scale, out.dtype)

    def _maybe_run_round_locked(self):
        if not self._barrier_tids:
            return
        if len(self._barrier_tids) < self._live_count():
            return
        # one sync round, merge to snapshot, as a profiler scope
        with _prof.RecordEvent('param_service:round'):
            self._run_merged_round_locked()

    def _run_merged_round_locked(self):
        merged = {g: self._merge(per_tid.values())
                  for g, per_tid in self._pending.items() if per_tid}
        try:
            self._run_round(merged)
        except Exception as e:
            self._error = e
            raise
        finally:
            self._pending.clear()
            self._barrier_tids.clear()
            self._completed_rounds += 1
            _ROUNDS.inc()
            # the round's weights are final RIGHT HERE: publish them as
            # a new param version (online subscribers poll GET_VERSION
            # and pull the freshly-closed round's params)
            self._bump_version_locked()
            # pending is empty RIGHT NOW — the cheapest instant for a
            # consistent snapshot; the barrier that closed this round
            # is acked only after the snapshot is durable
            self._maybe_snapshot_locked()
            self._cond.notify_all()

    def _wait_for_trainer_round_locked(self, tid):
        """Block until every round this trainer contributed to is applied
        (its own GET arrives, by per-connection ordering, after its
        BATCH_BARRIER). Each wakeup sweeps for dead peers so a silently
        dying trainer cannot stall the waiters forever."""
        import time
        while self._completed_rounds < self._trainer_rounds.get(tid, 0):
            if self._error is not None:
                raise RuntimeError('pserver optimize failed: %s'
                                   % self._error)
            # the waiter itself is NOT silent — it has an in-flight
            # request parked here; without this refresh a long round
            # wait would get the live waiter retired as dead
            self._last_seen[tid] = time.monotonic()
            self._retire_dead_locked()
            if self._completed_rounds >= self._trainer_rounds.get(tid, 0):
                break
            self._cond.wait(timeout=1.0)

    # -- online refresh ----------------------------------------------------
    def _bump_version_locked(self):
        self._param_version += 1
        self._manifest_cache = None
        _PARAM_VERSION.set(self._param_version)

    def _manifest_locked(self):
        """{param block name: crc32 of its wire payload bytes} for the
        CURRENT version, cached until the next bump. The digest covers
        the exact canonical bytes a GET_VARS pull ships (_payload_of),
        so subscriber-side verification is a byte-identity check, not a
        float comparison."""
        if self._manifest_cache is not None \
                and self._manifest_cache[0] == self._param_version:
            return self._manifest_cache[1]
        from . import wire
        from ..integrity import crc32
        digests = {}
        for name in self.param_names:
            _, payload = wire._payload_of(self._get_param(name))
            digests[name] = crc32(payload)
        self._manifest_cache = (self._param_version, digests)
        return digests

    def on_get_version(self, tid, inc=None, with_manifest=False):
        """Current published param version (reply meta). With
        with_manifest, the per-param digest manifest rides along — the
        subscriber learns WHAT this shard hosts and what bytes version
        N's params must hash to."""
        with self._lock:
            self._enter_locked(tid, inc)
            out = {'version': self._param_version}
            if with_manifest:
                out['manifest'] = self._manifest_locked()
            return out

    def on_get_vars(self, names, tid, inc=None):
        """Atomic multi-param read for an online subscriber: every
        requested param plus its digest, all read under ONE lock hold —
        a version-consistent shard image even while trainers are
        pushing the next round. Returns (version, [(entry_meta, value),
        ...]) for the server to pack into one REPLY_VAR frame."""
        with self._lock:
            self._enter_locked(tid, inc)
            manifest = self._manifest_locked()
            items = []
            for name in names:
                e = {'name': name}
                if name in manifest:
                    e['digest'] = manifest[name]
                items.append((e, self._get_param(name)))
            _VERSION_PULLS.inc()
            return self._param_version, items

    def _enter_locked(self, tid, inc=None):
        """Fence + touch + liveness check under the CALLER's lock:
        check and state mutation must be one atomic section, or a
        handler thread descheduled between them can re-insert a retired
        trainer's state after the reaper cleaned it."""
        import time
        self._fence_locked(tid, inc)
        self._last_seen[tid] = time.monotonic()
        self._check_not_dead(tid)

    def _is_replay_locked(self, tid, token):
        """Has this (cli, seq) token already been applied for tid?"""
        hit = token is not None and token in self._seq_seen.get(tid, ())
        if hit:
            _DEDUP_HITS.inc()
        return hit

    def _record_seq_locked(self, tid, token):
        """Record an APPLIED mutation token; evict the oldest past the
        window. Recording happens after the mutation so a handler that
        raised leaves the token unrecorded — the client's replay gets a
        real re-attempt, not a phantom ack."""
        if token is None:
            return
        token = tuple(token)
        seen = self._seq_seen.setdefault(tid, set())
        if token in seen:
            return
        order = self._seq_order.setdefault(tid, deque())
        seen.add(token)
        order.append(token)
        while len(order) > self._dedup_window:
            seen.discard(order.popleft())

    def _stale_round_locked(self, tid, round_idx):
        """True when a SEND_VAR/BATCH_BARRIER carries a step index from
        a round this server already closed for the trainer — a
        restarted trainer resuming at the min-across-servers step
        replays rounds an ahead server has applied; ack-ignoring them
        (rather than erroring) lets the trainer's step counter catch up
        to every shard without double-counting anywhere."""
        stale = (round_idx is not None
                 and int(round_idx) < self._trainer_rounds.get(tid, 0))
        if stale:
            _STALE_ROUND_ACKS.inc()
        return stale

    # -- durability --------------------------------------------------------
    def _journal_path(self):
        return self.snapshot_path + '.journal'

    def _journal_open(self):
        self._journal_f = open(self._journal_path(), 'ab')

    def _journal_rotate_locked(self):
        """Move the journal to `.prev`, pairing it with the snapshot
        generation that was just rotated to `.prev`: everything in it
        is covered by the snapshot that was just written, and a
        fallback restore replays it on the `.prev` snapshot."""
        jpath = self._journal_path()
        if self._journal_f is not None:
            self._journal_f.close()
        if os.path.exists(jpath):
            os.replace(jpath, jpath + '.prev')
        self._journal_f = open(jpath, 'wb')

    def _journal_locked(self, msg_type, meta, value=None):
        """Append one applied mutation as a wire frame, flushed to the
        OS before the handler returns (and therefore before the client
        sees the ack). flush — not fsync — is deliberate: os._exit /
        kill -9 cannot lose kernel page-cache data, and process death
        is the failure mode this journal exists for."""
        if self._journal_f is None or self._replaying:
            return
        from . import wire
        self._journal_f.write(wire.pack_msg(msg_type, meta, value=value))
        self._journal_f.flush()
        _JOURNAL_APPENDS.inc()

    def _maybe_snapshot_locked(self):
        if (self.snapshot_path and self._dump_state is not None
                and not self._replaying
                and self._completed_rounds % self.snapshot_every == 0):
            self._snapshot_locked()

    def _snapshot_locked(self, rotate=True):
        """Atomically persist params + every piece of round/replay state
        a restarted server needs to keep serving mid-session, with a
        crc32 digest sidecar. `rotate` keeps a `.prev` generation of
        both the snapshot and the journal for corruption fallback;
        recovery-time snapshots pass rotate=False because the retired
        generations' journal continuity is broken."""
        from . import statefile
        from .statefile import atomic_replace
        state = {
            'completed_rounds': self._completed_rounds,
            'trainer_rounds': {str(k): v
                               for k, v in self._trainer_rounds.items()},
            'done_tids': sorted(self._done_tids),
            'dead_tids': sorted(self.dead_tids),
            'barrier_ever': sorted(self._barrier_ever),
            'incarnations': {str(k): v
                             for k, v in self._incarnations.items()},
            'seq_order': {str(k): [list(t) for t in v]
                          for k, v in self._seq_order.items()},
            'param_version': self._param_version,
        }
        arrays = _snapshot_arrays(self._dump_state())
        arrays['__state__'] = np.frombuffer(
            json.dumps(state).encode('utf-8'), dtype=np.uint8)
        # np.savez appends '.npz' to a path STRING but writes an open
        # handle verbatim — go through the handle so the atomic-replace
        # target name is exact. Stage under `.next` so the generation
        # rotation below is rename-only (no window where the current
        # snapshot is gone and the new one is half-written).
        staging = self.snapshot_path + '.next'
        with atomic_replace(staging) as f:
            np.savez(f, **arrays)
        statefile.write_digest(staging)
        if rotate:
            if os.path.exists(self.snapshot_path):
                statefile.move_with_digest(self.snapshot_path,
                                           self.snapshot_path + '.prev')
            statefile.move_with_digest(staging, self.snapshot_path)
            self._journal_rotate_locked()
        else:
            statefile.move_with_digest(staging, self.snapshot_path)
            if self._journal_f is not None:
                self._journal_f.close()
            self._journal_f = open(self._journal_path(), 'wb')
        _SNAP_WRITES.inc()

    def _recover_generations_locked(self):
        """After a restore that quarantined corruption: retire every
        older on-disk generation and persist the recovered in-memory
        state as a fresh verified snapshot. The old `.prev`/journal
        files must go — after recovery their continuity is broken, and
        a stale snapshot paired with a later-era journal would
        silently lose the recovered prefix on a future fallback."""
        from . import statefile
        jpath = self._journal_path()
        for p in (self.snapshot_path + '.prev', jpath + '.prev', jpath):
            for q in (p, statefile.digest_path(p)):
                try:
                    os.remove(q)
                except OSError:
                    pass
        self._snapshot_locked(rotate=False)

    def _restore(self):
        """Snapshot + journal replay: called once from __init__, before
        any connection is accepted.

        Corruption policy: a snapshot that fails its digest sidecar (or
        does not load) is quarantined and restore falls back to the
        `.prev` generation; replaying `.journal.prev` + `.journal` on
        it reaches the exact same state (pre-snapshot records are
        absorbed by the snapshotted dedup windows and round tags). If
        every generation is corrupt, the journals are quarantined too
        and the service starts from initial state LOUDLY — journal
        records are deltas against a lost base, and replaying them on
        fresh params would fabricate a state that never existed."""
        import sys
        from . import statefile
        snap = self.snapshot_path
        jpath = self._journal_path()
        loaded, existed = None, False
        for cand in (snap, snap + '.prev'):
            if not os.path.exists(cand):
                continue
            existed = True
            status = statefile.verify_digest(cand)
            if status == 'mismatch':
                statefile.quarantine(cand, 'snapshot digest mismatch')
                self._restore_dirty = True
                continue
            if status == 'missing':
                sys.stderr.write(
                    'WARNING: snapshot %s has no digest sidecar '
                    '(pre-digest file or a crash before the sidecar '
                    'write); accepting it unverified\n' % cand)
            try:
                with np.load(cand) as z:
                    state = json.loads(bytes(z['__state__'].data)
                                       .decode('utf-8'))
                    params = _snapshot_params(z)
            except Exception as e:
                statefile.quarantine(cand, 'unreadable snapshot: %r' % e)
                self._restore_dirty = True
                continue
            if self._load_state is not None:
                self._load_state(params)
            self._completed_rounds = int(state['completed_rounds'])
            self._trainer_rounds = {int(k): v for k, v
                                    in state['trainer_rounds'].items()}
            self._done_tids = set(state['done_tids'])
            self.dead_tids = set(state['dead_tids'])
            self._barrier_ever = set(state['barrier_ever'])
            self._incarnations = {int(k): v for k, v
                                  in state['incarnations'].items()}
            for k, toks in state['seq_order'].items():
                tid = int(k)
                self._seq_order[tid] = deque(tuple(t) for t in toks)
                self._seq_seen[tid] = set(self._seq_order[tid])
            # pre-online snapshots carry no version: resume publication
            # at the restored round count (the fresh-server identity)
            self._param_version = int(
                state.get('param_version', self._completed_rounds))
            self._manifest_cache = None
            loaded = cand
            _SNAP_RESTORES.inc()
            if cand != snap:
                sys.stderr.write('WARNING: restored from previous '
                                 'snapshot generation %s\n' % cand)
            break
        if existed and loaded is None:
            sys.stderr.write(
                'WARNING: every snapshot generation of %s is corrupt '
                '(quarantined); the journals are deltas against the '
                'lost snapshots and cannot be replayed — starting from '
                'initial state\n' % snap)
            for jp in (jpath + '.prev', jpath):
                if os.path.exists(jp):
                    statefile.quarantine(jp, 'journal without a '
                                             'replayable base snapshot')
            return
        # replay oldest-first; records already covered by the loaded
        # snapshot are absorbed (dedup windows + round tags)
        for jp in (jpath + '.prev', jpath):
            if not os.path.exists(jp):
                continue
            if not self._replay_journal(jp):
                # corruption ends replay at the consistent prefix: the
                # damaged file AND anything after it (a later era that
                # cannot be applied over the gap) are quarantined
                self._restore_dirty = True
                statefile.quarantine(jp, 'corrupt journal frame')
                if jp != jpath and os.path.exists(jpath):
                    statefile.quarantine(
                        jpath, 'era follows a corrupt journal')
                return

    def _replay_journal(self, jp):
        """Replay one journal file through the live handlers. Returns
        False when a corrupt (CRC-failing) frame ended replay early; a
        torn trailing record is truncated in place (appending after
        torn bytes would corrupt the framing of every later record)."""
        import sys
        from . import wire
        with open(jp, 'rb') as f:
            buf = f.read()
        consumed = 0
        self._replaying = True
        try:
            for msg_type, meta, value, end in wire.scan_msgs(buf):
                self._replay_msg(msg_type, meta, value)
                consumed = end
                _JOURNAL_REPLAYED.inc()
        except wire.FrameCorruptError as e:
            sys.stderr.write(
                'WARNING: journal %s corrupt after %d clean bytes (%s); '
                'keeping the consistent prefix, quarantining the file\n'
                % (jp, consumed, e))
            return False
        finally:
            self._replaying = False
        if consumed < len(buf):
            sys.stderr.write(
                'WARNING: journal %s ends in a torn record (%d of %d '
                'bytes replayed) — expected after a mid-write crash; '
                'truncating the tail\n' % (jp, consumed, len(buf)))
            with open(jp, 'r+b') as f:
                f.truncate(consumed)
        return True

    def _replay_msg(self, msg_type, meta, value):
        """Re-dispatch one journaled mutation through the live
        handlers. CHECKPOINT replays token-only (re-saving the shard
        to a possibly-gone dirname is a side effect, not state)."""
        from . import wire
        tid = int(meta['tid'])
        tok = tuple(meta['tok']) if meta.get('tok') else None
        inc = meta.get('inc')
        if msg_type == wire.SEND_VAR:
            self.on_send_var(meta['name'], tid, value, seq=tok, inc=inc,
                             round_idx=meta.get('round'))
        elif msg_type == wire.BATCH_BARRIER:
            self.on_batch_barrier(tid, seq=tok, inc=inc,
                                  round_idx=meta.get('round'))
        elif msg_type == wire.COMPLETE:
            self.on_complete(tid, inc=inc)
        elif msg_type == wire.REGISTER:
            self.on_register(tid, inc=inc)
        elif msg_type == wire.CHECKPOINT:
            with self._lock:
                self._record_seq_locked(tid, tok)

    @staticmethod
    def _tok_meta(tid, seq, inc, round_idx=None, name=None):
        meta = {'tid': tid, 'tok': list(seq) if seq else None}
        if inc is not None:
            meta['inc'] = int(inc)
        if round_idx is not None:
            meta['round'] = int(round_idx)
        if name is not None:
            meta['name'] = name
        return meta

    # -- service interface (called from PSServer threads) ------------------
    def on_send_var(self, name, tid, value, seq=None, inc=None,
                    round_idx=None):
        from . import wire
        if (self.check_grad_finite and value is not None
                and not wire.value_is_finite(value)):
            # rejected BEFORE the journal write and BEFORE the dedup
            # window records the token: a poisoned gradient never
            # enters durable state, and the retryable classification
            # makes the client re-send the value it actually computed
            from .resilience import TransientError
            _NONFINITE_REJECTED.inc()
            raise TransientError(
                'non-finite gradient %r from trainer %s rejected '
                '(FLAGS_ps_check_grad_finite): corrupted or diverging '
                'update; the retry resends the computed value'
                % (name, tid))
        with self._lock:
            self._enter_locked(tid, inc)
            if self._is_replay_locked(tid, seq):
                return   # applied already; the lost reply is re-acked
            if self._stale_round_locked(tid, round_idx):
                return   # a resumed trainer replaying a closed round
            self._journal_locked(
                wire.SEND_VAR,
                self._tok_meta(tid, seq, inc, round_idx, name), value)
            if not self.sync_mode and self._run_one_grad is not None:
                self._run_one_grad(name, value)
                self._record_seq_locked(tid, seq)
                self._async_applied += 1
                # async has no rounds: every applied grad IS a publish
                # point (the reference's async-SGD staleness model)
                self._bump_version_locked()
                # async has no round boundary; snapshot on a send count
                if (self.snapshot_path and not self._replaying
                        and self._async_applied % 256 == 0):
                    self._snapshot_locked()
                return
            self._pending.setdefault(name, {})[tid] = value
            self._record_seq_locked(tid, seq)

    def on_send_vars(self, tid, entries, values, cli=None, inc=None):
        """Apply a batched SEND_VARS frame: each contained var carries
        its OWN (cli, seq) dedup token and round tag and goes through
        on_send_var exactly as an individual push would — including its
        own journal record, so the journal format (and crash replay)
        is unchanged. A replayed batch re-acks the already-applied vars
        and applies the rest: per-var at-most-once. A non-finite var
        rejects the whole frame (retryable); the vars applied before it
        were journaled + token-recorded, so the client's replay of the
        batch cannot double-apply them."""
        for e, value in zip(entries, values):
            tok = ((cli, e['seq']) if e.get('seq') is not None
                   else None)
            self.on_send_var(e['name'], tid, value, seq=tok, inc=inc,
                             round_idx=e.get('round'))

    def on_batch_barrier(self, tid, seq=None, inc=None, round_idx=None):
        from . import wire
        with self._lock:
            self._enter_locked(tid, inc)
            if self._is_replay_locked(tid, seq):
                return   # the round this barrier closed already ran
            if self._stale_round_locked(tid, round_idx):
                return   # ahead of a resumed trainer: round already ran
            self._journal_locked(
                wire.BATCH_BARRIER,
                self._tok_meta(tid, seq, inc, round_idx))
            self._barrier_ever.add(tid)
            self._barrier_tids.add(tid)
            if round_idx is not None:
                self._trainer_rounds[tid] = max(
                    self._trainer_rounds.get(tid, 0), int(round_idx) + 1)
            else:
                self._trainer_rounds[tid] = \
                    self._trainer_rounds.get(tid, 0) + 1
            self._record_seq_locked(tid, seq)
            self._maybe_run_round_locked()

    def on_get_var(self, name, tid, inc=None):
        with self._lock:
            self._enter_locked(tid, inc)
            if self.sync_mode:
                self._wait_for_trainer_round_locked(tid)
            return self._get_param(name)

    def on_prefetch(self, name, tid, ids, inc=None):
        if self._prefetch is None:
            raise RuntimeError('this pserver hosts no lookup table')
        with self._lock:
            self._enter_locked(tid, inc)
            if self.sync_mode:
                self._wait_for_trainer_round_locked(tid)
            return self._prefetch(name, ids)

    def on_checkpoint(self, dirname, tid, seq=None, inc=None):
        from . import wire
        if self._save_params is None:
            raise RuntimeError('this pserver has no checkpoint support')
        with self._lock:
            self._enter_locked(tid, inc)
            if self._is_replay_locked(tid, seq):
                return   # shard already saved for this request
            if self.sync_mode:
                self._wait_for_trainer_round_locked(tid)
            self._save_params(dirname)
            self._journal_locked(wire.CHECKPOINT,
                                 self._tok_meta(tid, seq, inc))
            self._record_seq_locked(tid, seq)

    def on_fetch_barrier(self, tid, inc=None):
        # the round already closed by the on_get_var wait, but a zombie
        # or stale-incarnation FETCH_BARRIER must still fail loudly —
        # same _enter_locked gate as every other handler
        with self._lock:
            self._enter_locked(tid, inc)

    def on_register(self, tid, inc=None, seq=None):
        """The (re)join handshake. Reply tells the trainer where it
        stands on THIS shard: `round` (server rounds applied),
        `expected` (the step index this server expects from the trainer
        next — its resume point), `rejoined` (whether the tid had been
        retired as dead). A restarted trainer resumes at the MINIMUM
        `expected` across shards and relies on the stale-round
        ack-ignore to catch the ahead ones up."""
        import time
        from . import wire
        from .resilience import StaleIncarnationError
        with self._lock:
            inc = int(inc or 0)
            cur = self._incarnations.get(tid, 0)
            if inc < cur:
                raise StaleIncarnationError(
                    'trainer %d REGISTER carries incarnation %d but '
                    'incarnation %d is registered: stale pre-restart '
                    'zombie, not retryable' % (tid, inc, cur))
            rejoined = False
            if inc > cur:
                self._journal_locked(wire.REGISTER,
                                     self._tok_meta(tid, seq, inc))
                rejoined = self._rejoin_locked(tid, inc)
            else:
                # first contact (inc == cur == 0) or a replayed
                # REGISTER whose rejoin already happened: idempotent
                self._check_not_dead(tid)
                self._incarnations.setdefault(tid, inc)
                self._last_seen[tid] = time.monotonic()
            return {'round': self._completed_rounds,
                    'expected': self._trainer_rounds.get(tid, 0),
                    'rejoined': rejoined}

    def on_complete(self, tid, inc=None):
        from . import wire
        with self._lock:
            if tid >= self.num_trainers:
                # a serving-side client (rpc.SERVING_TID_BASE range)
                # closing its connection: it was never part of the
                # training contract, so its COMPLETE must not count
                # toward (or trip) the all-trainers-done shutdown
                return False
            # same zombie rejection as every other handler: a
            # deadline-retired trainer's COMPLETE must fail loudly, not
            # silently shrink the expected-completions set
            self._enter_locked(tid, inc)
            self._journal_locked(wire.COMPLETE,
                                 self._tok_meta(tid, None, inc))
            self._done_tids.add(tid)
            self._barrier_tids.discard(tid)
            # a straggler-free round may now be unblocked
            self._maybe_run_round_locked()
            return len(self._done_tids) >= self.num_trainers
