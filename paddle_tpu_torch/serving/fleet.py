"""FleetRouter: health-checked serving fleet with admission control,
transparent mid-stream failover, and zero-drop rolling weight deploys
(counterpart of paddle_tpu/serving/fleet.py). The router is host code
over the SRV_* wire types and touches no tensor: token ids go out as
int64 arrays, and replies carry lists.

The "millions of users" topology (ROADMAP item 1): one router in front
of N ReplicaServer processes (`python -m
paddle_tpu_torch.tools.serve_replica`, each wrapping an LMServer),
speaking the SRV_* wire types. Four responsibilities:

dispatch    queue-depth/occupancy-aware: a held request goes to the
            least-loaded healthy, non-draining replica (router-side
            in-flight count + the replica's own serving.queue_depth
            from the SRV_HEALTH probe, normalized by capacity), with
            session affinity — a multi-turn session sticks to its
            replica while that replica stays eligible. The hold queue
            is tiered by priority (submit(priority=), higher = more
            important): dispatch always serves the highest non-empty
            tier first, and a replica's count of swapped-out preempted
            streams (SRV_HEALTH) raises its load score — a replica
            busy preempting is already out of cache headroom.

failover    greedy decode is deterministic, so a stream is fully
            described by (original prompt + tokens so far, remaining
            budget). When a replica dies (failed poll/submit, or
            fleet_probe_fails consecutive failed probes), every live
            stream it held is re-submitted to a healthy replica with
            its accumulated prefix as the prompt — the continuation is
            bit-exact with the unkilled run (tests/test_fleet.py), and
            the client's FleetRequest never notices beyond latency.

admission   obs/slo.py rules evaluated every control tick against the
            router's OWN fleet.* snapshot (local accounting, so the
            trigger works whether or not telemetry export is enabled).
            A rule breached fleet_shed_consecutive ticks flips the
            router into shedding: submit() raises a typed
            OverloadError (counted in fleet.shed) instead of letting
            queue depth grow until the TTFT SLO breaks. The hold-queue
            bound (fleet_max_hold) is a hard backstop. BOTH rejections
            apply only to the lowest tier (priority <= 0): a paying
            tier is always admitted — under pressure the replicas
            preempt lowest-tier streams to make room rather than the
            router turning important work away at the door.

gray        the fail-SLOW half of the failure model (Huang et al.
            "Gray Failure"; Dean & Barroso "The Tail at Scale"): a
            replica that answers SRV_HEALTH while its streams hang. A
            progress watchdog (FLAGS_fleet_progress_timeout_secs)
            gray-marks a replica whose streams — or whose in-flight
            RPC — made no progress within the horizon, fails its
            streams over through the same bit-exact re-prefill path,
            and interrupts the wedged connection so the pump never
            waits out the full RPC timeout. Gray replicas keep
            answering probes on a DEDICATED short-timeout probe
            connection (FLAGS_fleet_probe_timeout) in half-open
            probation and rejoin after FLAGS_fleet_gray_probes clean
            probes (a circuit breaker over a probe-latency EWMA +
            progress strikes). Hedged dispatch
            (FLAGS_fleet_hedge_ms) covers the slow-prefill tail: a
            stream with no first token past the horizon is duplicated
            to a second replica, first token wins, the loser is
            SRV_CANCELled — greedy determinism makes both copies
            identical, so hedging can never change output. Optional
            end-to-end deadlines (submit(deadline_ms=)) ride the
            SRV_SUBMIT meta with the ELAPSED time deducted at every
            failover/hedge re-dispatch; expiry is a typed,
            non-retryable DeadlineExceededError.

deploys     rolling_deploy(): one replica at a time — stop dispatching
            to it (+ SRV_DRAIN fence), wait for its in-flight streams,
            SRV_REFRESH (the PR-9 ParamSubscriber pull/verify/install
            path, orchestrator-driven on paused subscribers),
            health-check the installed version, rejoin. A param
            version bump drops zero streams. enable_rolling_deploys()
            watches the pservers' published version and rolls
            automatically.

FleetAutoscaler drives replica count from the same snapshot: sustained
up-rule breach -> scale_up() (spawn a replica — Supervisor.add_role —
and router.add_replica), sustained idle -> drain + remove + scale_down.

Telemetry (exported when FLAGS_obs_dir is set; the router ALSO keeps
local counts for stats() and the admission snapshot):
  fleet.requests.{submitted,completed,failed,cancelled} / fleet.shed /
  fleet.cache_sheds / fleet.failovers / fleet.replica_deaths /
  fleet.dispatches / fleet.deploys / fleet.tokens_generated /
  fleet.hedges / fleet.hedge_wins / fleet.gray_marks /
  fleet.deadline_expired                   counters;
  fleet.queue_depth / fleet.active_streams / fleet.replicas_healthy /
  fleet.replicas_total / fleet.shedding /
  fleet.pages_shipped / fleet.ship_bytes / fleet.prefix_hit_rate
                                           gauges;
  fleet.ttft / fleet.dispatch_wait / fleet.probe_latency  histograms;
  fleet.deploy / fleet.drain               spans.
"""
from __future__ import annotations

import collections
import itertools
import os
import socket
import threading
import time

import numpy as np

from ..distributed import wire
from ..flags import get_flag
from ..obs import telemetry
from ..obs import trace as _trace
from .engine import QUEUED, RUNNING, DONE, CANCELLED, FAILED

__all__ = ['FleetRouter', 'FleetAutoscaler', 'FleetRequest',
           'OverloadError', 'FleetDeployError']

_submitted = telemetry.counter('fleet.requests.submitted')
_completed = telemetry.counter('fleet.requests.completed')
_failed = telemetry.counter('fleet.requests.failed')
_cancelled = telemetry.counter('fleet.requests.cancelled')
_shed = telemetry.counter('fleet.shed')
_cache_sheds = telemetry.counter('fleet.cache_sheds')
_failovers = telemetry.counter('fleet.failovers')
_deaths = telemetry.counter('fleet.replica_deaths')
_dispatches = telemetry.counter('fleet.dispatches')
_deploys = telemetry.counter('fleet.deploys')
_tokens_out = telemetry.counter('fleet.tokens_generated')
_queue_depth = telemetry.gauge('fleet.queue_depth')
_active_streams = telemetry.gauge('fleet.active_streams')
_replicas_healthy = telemetry.gauge('fleet.replicas_healthy')
_replicas_total = telemetry.gauge('fleet.replicas_total')
_shedding_g = telemetry.gauge('fleet.shedding')
_ttft = telemetry.histogram('fleet.ttft')
_dispatch_wait = telemetry.histogram('fleet.dispatch_wait')
_hedges = telemetry.counter('fleet.hedges')
_hedge_wins = telemetry.counter('fleet.hedge_wins')
_gray_marks = telemetry.counter('fleet.gray_marks')
_deadline_expired = telemetry.counter('fleet.deadline_expired')
_probe_latency = telemetry.histogram('fleet.probe_latency')
# disaggregated prefill/decode (serving/disagg.py): fleet-wide totals
# aggregated from SRV_HEALTH each control tick — gauges, because the
# replicas own the counters and the router only mirrors their sum
_pages_shipped_g = telemetry.gauge('fleet.pages_shipped')
_ship_bytes_g = telemetry.gauge('fleet.ship_bytes')
_prefix_hit_rate_g = telemetry.gauge('fleet.prefix_hit_rate')


class OverloadError(RuntimeError):
    """Typed admission-control rejection: the fleet is shedding load
    (an obs/slo.py admission rule breached for a sustained window) or
    the hold queue hit its hard bound. Back off and retry — accepted
    streams are being protected, not dropped."""


class FleetDeployError(RuntimeError):
    """A rolling deploy step could not complete inside its deadline
    (drain stuck, refresh failing, or the post-refresh health check
    disagreeing about the installed version). The replica is
    un-drained and keeps serving its OLD verified weights."""


class _ReplicaError(RuntimeError):
    """REPLY_ERR from a replica; retryable mirrors the wire field."""

    def __init__(self, msg, retryable=False):
        super(_ReplicaError, self).__init__(msg)
        self.retryable = retryable


class _LocalHist(object):
    """telemetry.Histogram's bucket layout, always-on: the admission
    rules must see fleet.ttft whether or not export is enabled, so the
    router keeps its own accounting and feeds SLORule.evaluate
    snapshot-shaped dicts."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float('inf')
        self.max = float('-inf')
        self.buckets = [0] * (len(telemetry._BOUNDS) + 1)

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        i = 0
        for bound in telemetry._BOUNDS:
            if v <= bound:
                break
            i += 1
        self.buckets[i] += 1

    def snapshot(self):
        return {'count': self.count, 'sum': self.sum, 'min': self.min,
                'max': self.max, 'buckets': list(self.buckets)}


class FleetRequest(object):
    """One fleet-level generation stream. `tokens` accumulates ACROSS
    failover segments; wait()/result() match engine.Request."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, eos_id, session,
                 priority=0, deadline_ms=None):
        self.id = next(FleetRequest._ids)
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.session = session
        self.priority = int(priority)
        self.state = QUEUED
        self.tokens = []
        self.error = None
        self.replica = None           # endpoint currently serving it
        self.segment = 0              # bumps on every failover
        self.cache_sheds = 0          # CacheExhausted retry budget used
        self.base = 0                 # len(tokens) at segment dispatch
        self.rid = None
        self.submitted_at = time.perf_counter()
        # end-to-end budget: absolute perf_counter expiry, None = no
        # deadline. Every re-dispatch (failover, hedge) forwards only
        # the REMAINING milliseconds — elapsed time is never refunded.
        self.deadline_at = (None if deadline_ms is None
                            else self.submitted_at
                            + float(deadline_ms) / 1000.0)
        # progress clock for the gray-failure watchdog: stamped at
        # dispatch and on every token growth
        self.last_progress_at = None
        self.hedge_ep = None          # endpoint holding the duplicate
        self.hedge_rid = None
        self._ck_cache = None         # (page_tokens, chain keys) memo
        #                               for the prefix-affinity score
        self.dispatched_at = None
        self.first_token_at = None
        self.done_at = None
        self._done = threading.Event()

    def _finish(self, state, error=None):
        self.state = state
        self.error = error
        self.done_at = time.perf_counter()
        self._done.set()

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def result(self, timeout=None):
        if not self.wait(timeout):
            raise TimeoutError('fleet request %d still %s after %rs'
                               % (self.id, self.state, timeout))
        if self.state == FAILED:
            raise RuntimeError('fleet request %d failed: %s'
                               % (self.id, self.error))
        return list(self.tokens)


class _ReplicaClient(object):
    """One blocking wire connection to a replica (reconnect on demand,
    serialized calls, seq-echo desync check). NO retry layer: a failed
    call IS the router's death signal for that replica."""

    def __init__(self, endpoint, timeout=10.0):
        self.endpoint = endpoint
        self._timeout = float(timeout)
        self._sock = None
        self._mu = threading.Lock()
        self._seq = itertools.count()
        # perf_counter at the start of the in-flight call, None when
        # idle — the gray-failure watchdog reads this (racily, without
        # the lock: a stale glimpse only delays detection one tick) to
        # catch a replica that accepted a request and then went silent
        self.inflight_since = None

    def call(self, msg_type, meta=None, value=None, timeout=None):
        with self._mu:
            self.inflight_since = time.perf_counter()
            try:
                return self._call_locked(msg_type, meta, value, timeout)
            finally:
                self.inflight_since = None

    def _call_locked(self, msg_type, meta, value, timeout):
        seq = next(self._seq)
        m = dict(meta or {})
        m['seq'] = seq
        try:
            if self._sock is None:
                host, port = self.endpoint.rsplit(':', 1)
                # the dial honors the caller's budget: a short-timeout
                # probe must not spend the full connect allowance on a
                # SYN blackhole (FLAGS_fleet_connect_timeout caps the
                # dial fleet-wide; the per-call timeout caps it tighter)
                dial = min(float(timeout or self._timeout),
                           float(get_flag('fleet_connect_timeout')))
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=dial)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
            self._sock.settimeout(timeout or self._timeout)
            wire.write_msg(self._sock, msg_type, m, value)
            rt, rmeta, _rv = wire.read_msg(self._sock)
        except (ConnectionError, OSError):
            self._reset_locked()
            raise
        if rmeta.get('seq') != seq:
            self._reset_locked()
            raise ConnectionError(
                'replica %s reply seq %r != %d — desynced'
                % (self.endpoint, rmeta.get('seq'), seq))
        if rt == wire.REPLY_ERR:
            raise _ReplicaError(
                '%s: %s' % (self.endpoint, rmeta.get('error')),
                retryable=bool(rmeta.get('retryable')))
        return rmeta

    def _reset_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def interrupt(self):
        """Unblock a stalled in-flight call WITHOUT taking the call
        lock — the stalled caller HOLDS it, so close() here would
        deadlock the watchdog behind the very stall it is breaking.
        shutdown() makes the blocked read raise immediately; the
        call's own error path then closes and resets the socket."""
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self):
        with self._mu:
            self._reset_locked()


class _Replica(object):
    __slots__ = ('endpoint', 'client', 'probe', 'order', 'healthy',
                 'draining', 'fails', 'active', 'hedges', 'capacity',
                 'queue_depth', 'max_len', 'param_version', 'hold_until',
                 'gray', 'strikes', 'clean_probes', 'probe_ewma',
                 'cache_tokens', 'cache_capacity',
                 'effective_tokens_per_step', 'spec_accept_rate',
                 'preemptions', 'preempted_streams', 'role',
                 'mesh_shape', 'mesh_devices',
                 'page_tokens', 'prefix_hits', 'prefix_misses',
                 'prefix_entries', 'prefix_pages', 'pages_shipped',
                 'ship_bytes', 'pages_installed', 'pages_deduped',
                 'local_reprefills')

    def __init__(self, endpoint, order, timeout, role='serve'):
        self.endpoint = endpoint
        self.client = _ReplicaClient(endpoint, timeout=timeout)
        # health probes ride a DEDICATED connection: a gray replica
        # stalls its data connection while this one keeps answering —
        # exactly the split that lets the router keep measuring a
        # replica it no longer trusts with streams
        self.probe = _ReplicaClient(endpoint, timeout=timeout)
        self.order = order
        self.healthy = False          # flips on the first good probe
        self.draining = False
        self.fails = 0
        self.active = {}              # req.id -> FleetRequest
        self.hedges = {}              # req.id -> FleetRequest (duplicates
        #                               hedged ONTO this replica)
        self.gray = False             # gray-marked: probe-only probation
        self.strikes = 0              # consecutive slow-probe strikes
        self.clean_probes = 0         # clean probes while gray
        self.probe_ewma = None        # probe-latency EWMA (secs)
        self.capacity = 1
        self.queue_depth = 0
        self.max_len = None
        self.param_version = None
        self.hold_until = 0.0         # brief dispatch backoff (full)
        self.cache_tokens = 0         # tokens held in the KV cache
        self.cache_capacity = None    # total cache tokens (paged)
        # speculative replicas: mean tokens emitted per decode step
        # (>= 1.0 once speculation engages; 1.0 == plain decode) and
        # the measured draft accept rate, both from SRV_HEALTH
        self.effective_tokens_per_step = 1.0
        self.spec_accept_rate = None
        # preempt-first replicas: lifetime preemptions plus streams
        # currently swapped out awaiting resume (both from SRV_HEALTH)
        self.preemptions = 0
        self.preempted_streams = 0
        # disaggregated serving: 'prefill' replicas answer
        # SRV_PAGE_FETCH and never take decode streams; 'serve' (the
        # default) is the decode/colocated tier. The prefix/ship
        # numbers mirror the replica's SRV_HEALTH truth.
        self.role = role
        # mesh-sharded replicas: axis spec + chip count their SPMD
        # decode programs span (SRV_HEALTH; '' / 1 = single-chip)
        self.mesh_shape = ''
        self.mesh_devices = 1
        self.page_tokens = None
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_entries = 0
        self.prefix_pages = 0
        self.pages_shipped = 0
        self.ship_bytes = 0
        self.pages_installed = 0
        self.pages_deduped = 0
        self.local_reprefills = 0


class FleetAutoscaler(object):
    """Replica-count policy over the router's admission snapshot.

    scale_up() -> endpoint of a freshly launched replica (the caller
    owns process lifecycle — Supervisor.add_role in production); the
    router add_replica()s it. scale_down(endpoint) is called AFTER the
    router drained and removed the replica. Sustained up-rule breach
    (default: fleet.queue_depth > 0) scales out; a fully idle fleet
    (no held or active streams) for `sustain` ticks scales in, down to
    min_replicas. cooldown_secs separates consecutive actions."""

    def __init__(self, scale_up=None, scale_down=None, min_replicas=1,
                 max_replicas=8, up_rules=None, sustain=3,
                 cooldown_secs=5.0):
        from ..obs import slo as _slo
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.sustain = int(sustain)
        self.cooldown_secs = float(cooldown_secs)
        if up_rules is None:
            up_rules = [{'name': 'fleet_backlog',
                         'metric': 'fleet.queue_depth',
                         'kind': 'gauge_max', 'threshold': 0}]
        self.up_rules = _slo.parse_rules(up_rules)
        self._up_streak = 0
        self._idle_streak = 0
        self._cool_until = 0.0
        self.events = []              # [(monotonic, action, endpoint)]

    def tick(self, router, snap, prev, dt):
        gauges = snap.get('gauges', {})
        breach = False
        for rule in self.up_rules:
            out = rule.evaluate(snap, prev=prev, dt=dt)
            if out is not None and out[1]:
                breach = True
        idle = (not gauges.get('fleet.queue_depth')
                and not gauges.get('fleet.active_streams'))
        if breach:
            self._up_streak += 1
            self._idle_streak = 0
        elif idle:
            self._idle_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._idle_streak = 0
        now = time.monotonic()
        if now < self._cool_until:
            return
        n = len(router.replicas())
        if (self._up_streak >= self.sustain and n < self.max_replicas
                and self.scale_up is not None):
            ep = self.scale_up()
            if ep:
                router.add_replica(ep)
                self.events.append((now, 'scale_up', ep))
                _trace.event('fleet.scale_up', endpoint=ep, replicas=n + 1)
            self._up_streak = 0
            self._cool_until = now + self.cooldown_secs
        elif self._idle_streak >= self.sustain and n > self.min_replicas:
            victim = router.idle_replica()
            if victim is None:
                return
            try:
                router.remove_replica(victim, drain=True, timeout=10.0)
            except FleetDeployError:
                return                # streams arrived mid-drain: keep it
            if self.scale_down is not None:
                self.scale_down(victim)
            self.events.append((now, 'scale_down', victim))
            _trace.event('fleet.scale_down', endpoint=victim,
                         replicas=n - 1)
            self._idle_streak = 0
            self._cool_until = now + self.cooldown_secs


class FleetRouter(object):
    def __init__(self, replicas, pservers=None, poll_secs=None,
                 probe_secs=None, max_hold=None, admission_rules=None,
                 shed_consecutive=None, probe_fail_threshold=None,
                 call_timeout=10.0, subscriber_id=900,
                 prefill_replicas=None):
        """replicas: ReplicaServer endpoints ('host:port'). pservers:
        the parameter-server fleet (only needed for published-version
        watching / enable_rolling_deploys). admission_rules: obs/slo.py
        rule list (objects, dicts, JSON, or @path — parse_rules) over
        the fleet.* snapshot; default is a fleet.queue_depth gauge_max
        rule at max_hold/2. prefill_replicas: endpoints of the PREFILL
        TIER (serving/disagg.py) — probed for health like any replica
        but never dispatched decode streams; defaults from
        FLAGS_fleet_prefill_endpoints ('' = colocated, no tier)."""
        from ..obs import slo as _slo
        self._poll_secs = float(poll_secs if poll_secs is not None
                                else get_flag('fleet_poll_secs'))
        self._probe_secs = float(probe_secs if probe_secs is not None
                                 else get_flag('fleet_probe_secs'))
        self._max_hold = int(max_hold or get_flag('fleet_max_hold'))
        self._shed_consecutive = int(
            shed_consecutive if shed_consecutive is not None
            else get_flag('fleet_shed_consecutive'))
        self._probe_fail_threshold = int(
            probe_fail_threshold if probe_fail_threshold is not None
            else get_flag('fleet_probe_fails'))
        self._call_timeout = float(call_timeout)
        self._probe_timeout = min(
            float(get_flag('fleet_probe_timeout')), self._call_timeout)
        self._progress_timeout = float(
            get_flag('fleet_progress_timeout_secs'))
        self._hedge_ms = float(get_flag('fleet_hedge_ms'))
        self._gray_probes = max(1, int(get_flag('fleet_gray_probes')))
        if admission_rules is None:
            admission_rules = get_flag('fleet_admission_rules') or [
                {'name': 'fleet_queue_depth',
                 'metric': 'fleet.queue_depth', 'kind': 'gauge_max',
                 'threshold': max(1, self._max_hold // 2)}]
        self._admission_rules = _slo.parse_rules(admission_rules)
        self._pservers = list(pservers or [])
        self._subscriber_id = int(subscriber_id)
        self._mu = threading.Condition()
        self._hold = {}               # priority tier -> deque
        self._reps = {}
        self._order = itertools.count()
        self._sessions = {}           # session -> endpoint
        self._nonce = os.urandom(4).hex()
        self._ttft_local = _LocalHist()
        self._submitted_n = 0
        self._completed_n = 0
        self._failed_n = 0
        self._cancelled_n = 0
        self._shed_n = 0
        self._cache_sheds_n = 0
        self._failovers_n = 0
        self._deploys_n = 0
        self._tokens_n = 0
        self._dispatches_n = 0
        self._hedges_n = 0
        self._hedge_wins_n = 0
        self._gray_marks_n = 0
        self._deadline_expired_n = 0
        self._cancelq = []            # [(endpoint, rid)] — loser rids
        #                               the pump SRV_CANCELs best-effort
        self._pollers = {}            # endpoint -> poller thread
        self._shedding = False
        self._breach_streak = 0
        self._breach_rule = None
        self._prev_snap = None
        self._prev_snap_t = None
        self._deployed_version = 0
        self._autoscaler = None
        self._stop_evt = threading.Event()
        self._threads = []
        # disaggregated serving: the fleet-wide prefix directory — hex
        # chain key -> set of endpoints whose PrefixCache holds that
        # page (reconciled from SRV_HEALTH new/evicted deltas,
        # invalidated wholesale on death/gray-mark) — plus the
        # prefix-affinity weight feeding _pick_locked
        self._prefix_dir = {}
        self._prefix_affinity = float(get_flag('fleet_prefix_affinity'))
        for ep in replicas:
            self.add_replica(ep)
        if prefill_replicas is None:
            raw = str(get_flag('fleet_prefill_endpoints') or '')
            prefill_replicas = [e.strip() for e in raw.split(',')
                                if e.strip()]
        for ep in prefill_replicas:
            self.add_replica(ep, role='prefill')

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._threads:
            return self
        self._stop_evt.clear()
        self._threads = [
            threading.Thread(target=self._pump_loop,
                             name='fleet-pump', daemon=True),
            threading.Thread(target=self._control_loop,
                             name='fleet-control', daemon=True)]
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop_evt.set()
        with self._mu:
            reps = list(self._reps.values())
        for rep in reps:
            # unblock any poller/pump call wedged on a stalled replica
            # so the joins below do not wait out a full RPC timeout
            rep.client.interrupt()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        for t in self._pollers.values():
            t.join(timeout=5.0)
        self._pollers.clear()
        with self._mu:
            victims = [r for q in self._hold.values() for r in q]
            self._hold.clear()
            for rep in self._reps.values():
                victims.extend(rep.active.values())
                rep.active.clear()
                rep.hedges.clear()
        for req in victims:
            if req.state in (QUEUED, RUNNING):
                req._finish(CANCELLED)
                self._cancelled_n += 1
                _cancelled.inc()
        for rep in self._reps.values():
            rep.client.close()
            rep.probe.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- fleet membership --------------------------------------------------
    def add_replica(self, endpoint, role='serve'):
        with self._mu:
            if endpoint in self._reps:
                return
            self._reps[endpoint] = _Replica(endpoint,
                                            next(self._order),
                                            self._call_timeout,
                                            role=role)
        _replicas_total.set(len(self._reps))

    def remove_replica(self, endpoint, drain=True, timeout=30.0):
        """Scale-in: stop dispatching to the replica, optionally wait
        for its in-flight streams, drop it. The process itself belongs
        to the caller (Supervisor.remove_role)."""
        with self._mu:
            rep = self._reps.get(endpoint)
            if rep is None:
                return
            rep.draining = True
        if drain:
            deadline = time.monotonic() + timeout
            while True:
                with self._mu:
                    n = len(rep.active)
                if not n:
                    break
                if time.monotonic() >= deadline:
                    with self._mu:
                        rep.draining = False
                    raise FleetDeployError(
                        'replica %s still has %d in-flight streams '
                        'after %.1fs drain' % (endpoint, n, timeout))
                time.sleep(0.01)
        with self._mu:
            # no drain (or a dead replica): surviving streams fail over
            for req in list(rep.active.values()):
                rep.active.pop(req.id, None)
                self._requeue_locked(req)
            for req in list(rep.hedges.values()):
                self._drop_hedge_locked(req, cancel=False)
            self._reps.pop(endpoint, None)
            self._dir_forget_locked(endpoint)
            for s, ep in list(self._sessions.items()):
                if ep == endpoint:
                    del self._sessions[s]
        rep.client.close()
        rep.probe.close()
        _replicas_total.set(len(self._reps))

    def replicas(self):
        with self._mu:
            return list(self._reps)

    def idle_replica(self):
        """A healthy replica with no in-flight streams (scale-in
        victim), preferring the newest; None when all are busy."""
        with self._mu:
            idle = [r for r in self._reps.values()
                    if r.healthy and not r.active and not r.draining
                    and r.role != 'prefill']
            if not idle:
                return None
            return max(idle, key=lambda r: r.order).endpoint

    def wait_healthy(self, n=None, timeout=60.0):
        """Block until `n` replicas (default: all) answered a probe."""
        if n is None:
            n = len(self._reps)
        deadline = time.monotonic() + timeout
        while True:
            with self._mu:
                healthy = sum(1 for r in self._reps.values()
                              if r.healthy)
            if healthy >= n:
                return healthy
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    'only %d/%d replicas healthy after %.1fs'
                    % (healthy, n, timeout))
            time.sleep(0.02)

    def attach_autoscaler(self, autoscaler):
        self._autoscaler = autoscaler
        return autoscaler

    # -- hold queue (tiered by priority) -----------------------------------
    def _hold_len_locked(self):
        return sum(len(q) for q in self._hold.values())

    def _hold_push_locked(self, req, front=False):
        q = self._hold.get(req.priority)
        if q is None:
            q = self._hold[req.priority] = collections.deque()
        (q.appendleft if front else q.append)(req)
        _queue_depth.set(self._hold_len_locked())

    def _hold_front_locked(self):
        """The highest non-empty tier's deque, or None."""
        for prio in sorted(self._hold, reverse=True):
            if self._hold[prio]:
                return self._hold[prio]
        return None

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None,
               session=None, priority=0, deadline_ms=None):
        """Admit a stream into the fleet. priority is the SLO tier
        (higher = more important, 0 = the default lowest). Raises
        OverloadError while shedding (or when the hold queue is at its
        hard bound) — but only for the lowest tier (priority <= 0):
        higher tiers are always admitted, and the replicas preempt
        lowest-tier streams to make room for them. deadline_ms is the
        optional end-to-end budget (None = no deadline): expiry fails
        the stream with a typed, non-retryable DeadlineExceededError —
        at dispatch (before wasting a prefill) or replica-side at
        dequeue / per decode step — and the REMAINING budget, elapsed
        deducted, rides every failover or hedge re-dispatch."""
        req = FleetRequest(prompt, max_new_tokens, eos_id, session,
                           priority=priority, deadline_ms=deadline_ms)
        if not req.prompt:
            raise ValueError('empty prompt')
        with self._mu:
            if req.priority <= 0:
                if self._shedding:
                    self._shed_n += 1
                    _shed.inc()
                    raise OverloadError(
                        'fleet is shedding: admission rule %r breached '
                        '%d consecutive checks' % (self._breach_rule,
                                                   self._breach_streak))
                if self._hold_len_locked() >= self._max_hold:
                    self._shed_n += 1
                    _shed.inc()
                    raise OverloadError('fleet hold queue full (%d)'
                                        % self._max_hold)
            self._hold_push_locked(req)
            self._submitted_n += 1
            _submitted.inc()
            self._mu.notify_all()
        return req

    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 session=None, priority=0, timeout=None):
        return self.submit(prompt, max_new_tokens, eos_id=eos_id,
                           session=session,
                           priority=priority).result(timeout)

    def cancel(self, req):
        with self._mu:
            if req.state == QUEUED and req.replica is None:
                try:
                    self._hold.get(req.priority,
                                   collections.deque()).remove(req)
                except ValueError:
                    pass
                else:
                    req._finish(CANCELLED)
                    self._cancelled_n += 1
                    _cancelled.inc()
                    return req
            rep = self._reps.get(req.replica)
            rid = req.rid
        if rep is not None and rid is not None:
            try:
                rep.client.call(wire.SRV_CANCEL, {'rid': rid})
            except (ConnectionError, OSError, _ReplicaError):
                pass                  # the pump will finalize either way
        return req

    def stats(self):
        with self._mu:
            reps = {ep: {'healthy': r.healthy, 'draining': r.draining,
                         'gray': r.gray,
                         'active': len(r.active),
                         'capacity': r.capacity,
                         'queue_depth': r.queue_depth,
                         'param_version': r.param_version,
                         'effective_tokens_per_step':
                             r.effective_tokens_per_step,
                         'spec_accept_rate': r.spec_accept_rate,
                         'preemptions': r.preemptions,
                         'preempted_streams': r.preempted_streams,
                         'role': r.role,
                         'mesh_shape': r.mesh_shape,
                         'mesh_devices': r.mesh_devices,
                         'prefix_entries': r.prefix_entries,
                         'prefix_hits': r.prefix_hits,
                         'prefix_misses': r.prefix_misses,
                         'pages_shipped': r.pages_shipped,
                         'local_reprefills': r.local_reprefills}
                    for ep, r in self._reps.items()}
            hits = sum(r.prefix_hits for r in self._reps.values()
                       if r.role != 'prefill')
            misses = sum(r.prefix_misses for r in self._reps.values()
                         if r.role != 'prefill')
            return {'replicas': reps,
                    'prefill_replicas': sum(
                        1 for r in self._reps.values()
                        if r.role == 'prefill'),
                    'pages_shipped': sum(r.pages_shipped
                                         for r in self._reps.values()),
                    'ship_bytes': sum(r.ship_bytes
                                      for r in self._reps.values()),
                    'pages_installed': sum(
                        r.pages_installed for r in self._reps.values()),
                    'pages_deduped': sum(
                        r.pages_deduped for r in self._reps.values()),
                    'local_reprefills': sum(
                        r.local_reprefills
                        for r in self._reps.values()),
                    'prefix_hits': hits,
                    'prefix_misses': misses,
                    'prefix_hit_rate': (hits / (hits + misses)
                                        if hits + misses else 0.0),
                    'prefix_dir_entries': len(self._prefix_dir),
                    'queue_depth': self._hold_len_locked(),
                    'active': sum(len(r.active)
                                  for r in self._reps.values()),
                    'submitted': self._submitted_n,
                    'completed': self._completed_n,
                    'failed': self._failed_n,
                    'cancelled': self._cancelled_n,
                    'shed': self._shed_n,
                    'cache_sheds': self._cache_sheds_n,
                    'preemptions': sum(r.preemptions
                                       for r in self._reps.values()),
                    'failovers': self._failovers_n,
                    'deploys': self._deploys_n,
                    'dispatches': self._dispatches_n,
                    'tokens': self._tokens_n,
                    'hedges': self._hedges_n,
                    'hedge_wins': self._hedge_wins_n,
                    'gray_marks': self._gray_marks_n,
                    'deadline_expired': self._deadline_expired_n,
                    'shedding': self._shedding}

    def admission_snapshot(self):
        """The snapshot-dict the admission rules (and any external SLO
        check) evaluate — fleet.* series from the router's local
        accounting, telemetry-shaped."""
        with self._mu:
            return self._snapshot_locked()

    def _snapshot_locked(self):
        active = sum(len(r.active) for r in self._reps.values())
        healthy = sum(1 for r in self._reps.values() if r.healthy)
        return {
            'counters': {'fleet.requests.submitted': self._submitted_n,
                         'fleet.requests.completed': self._completed_n,
                         'fleet.shed': self._shed_n,
                         'fleet.failovers': self._failovers_n,
                         'fleet.tokens_generated': self._tokens_n},
            'gauges': {'fleet.queue_depth':
                           float(self._hold_len_locked()),
                       'fleet.active_streams': float(active),
                       'fleet.replicas_healthy': float(healthy)},
            'hists': {'fleet.ttft': self._ttft_local.snapshot()}}

    # -- pump: dispatch + stream progress ----------------------------------
    def _pump_loop(self):
        while not self._stop_evt.is_set():
            try:
                self._ensure_pollers()
                self._dispatch_held()
                self._drain_cancelq()
            except Exception as e:    # noqa: BLE001 — router survives
                _trace.event('fleet.pump_error', error=repr(e))
            self._stop_evt.wait(self._poll_secs)

    def _ensure_pollers(self):
        """One poll thread PER replica (started lazily here, pump
        thread only): a gray replica stalls its own poll for the full
        RPC timeout, and with a shared poll loop that stall would
        freeze progress for every healthy replica too — the exact
        amplification gray failures are famous for."""
        with self._mu:
            reps = list(self._reps.values())
        for rep in reps:
            t = self._pollers.get(rep.endpoint)
            if t is not None and t.is_alive():
                continue
            t = threading.Thread(target=self._poller_loop, args=(rep,),
                                 name='fleet-poll-%s' % rep.endpoint,
                                 daemon=True)
            self._pollers[rep.endpoint] = t
            t.start()

    def _poller_loop(self, rep):
        while not self._stop_evt.is_set():
            if self._reps.get(rep.endpoint) is not rep:
                return                # replica removed (or replaced)
            try:
                self._poll_one(rep)
            except Exception as e:    # noqa: BLE001 — router survives
                _trace.event('fleet.pump_error', error=repr(e))
            self._stop_evt.wait(self._poll_secs)

    def _drain_cancelq(self):
        """Best-effort SRV_CANCEL of hedge-loser rids, off the poller
        threads so a slow loser cannot block progress accounting."""
        while True:
            with self._mu:
                if not self._cancelq:
                    return
                ep, rid = self._cancelq.pop(0)
                rep = self._reps.get(ep)
            if rep is None:
                continue
            try:
                rep.client.call(wire.SRV_CANCEL, {'rid': rid})
            except (ConnectionError, OSError, _ReplicaError):
                pass                  # loser dies with its replica

    def _dispatch_held(self):
        while not self._stop_evt.is_set():
            with self._mu:
                q = self._hold_front_locked()
                if q is None:
                    return
                req = q[0]
                if req.state == CANCELLED:
                    q.popleft()
                    req._finish(CANCELLED)
                    self._cancelled_n += 1
                    _cancelled.inc()
                    continue
                if req.deadline_at is not None and \
                        time.perf_counter() > req.deadline_at:
                    # spent budget: fail BEFORE wasting a prefill
                    q.popleft()
                    _queue_depth.set(self._hold_len_locked())
                    self._deadline_expired_n += 1
                    _deadline_expired.inc()
                    self._finalize_locked(
                        req, FAILED,
                        'DeadlineExceededError: expired before dispatch')
                    continue
                remaining = req.max_new_tokens - len(req.tokens)
                if remaining <= 0:    # failover landed exactly at budget
                    q.popleft()
                    self._finalize_locked(req, DONE)
                    continue
                rep = self._pick_locked(req)
                if rep is None:
                    return            # no eligible replica right now
                q.popleft()
                _queue_depth.set(self._hold_len_locked())
                req.replica = rep.endpoint
                req.base = len(req.tokens)
                req.rid = '%s/%d/%d' % (self._nonce, req.id,
                                        req.segment)
                rep.active[req.id] = req
                # the progress clock starts NOW, covering the submit
                # RPC itself: a replica that accepts the connection and
                # never replies is as gray as one that stops decoding
                req.last_progress_at = time.perf_counter()
                if req.session is not None:
                    self._sessions[req.session] = rep.endpoint
                prompt = req.prompt + req.tokens
                rid, mnt, eos = req.rid, remaining, req.eos_id
                prio = req.priority
                meta = {'rid': rid, 'mnt': mnt, 'eos': eos,
                        'prio': prio}
                if req.deadline_at is not None:
                    # forward only the REMAINING budget — elapsed time
                    # (queueing, earlier segments) is never refunded
                    meta['deadline_ms'] = max(
                        1.0, (req.deadline_at - req.last_progress_at)
                        * 1000.0)
                # disaggregated dispatch: name a prefill peer so the
                # decode replica pulls the prompt's pages instead of
                # prefilling (serving/disagg.py). No healthy prefill
                # tier -> key absent -> today's colocated path.
                pf = self._pick_prefill_locked(req)
                if pf is not None:
                    meta['prefill_from'] = pf.endpoint
                if rep.max_len is not None and len(prompt) > rep.max_len:
                    # a failover prefix past the context window cannot
                    # be re-prefilled bit-exactly (ring slide)
                    rep.active.pop(req.id, None)
                    self._finalize_locked(
                        req, FAILED,
                        'failover prefix %d exceeds replica max_len %d'
                        % (len(prompt), rep.max_len))
                    continue
            try:
                rep.client.call(wire.SRV_SUBMIT, meta,
                                value=np.asarray(prompt, np.int64))
            except _ReplicaError as e:
                with self._mu:
                    if rep.active.get(req.id) is not req:
                        # superseded while the submit was in flight (a
                        # hedge won, or the watchdog failed it over):
                        # this reply belongs to a dead dispatch
                        continue
                    rep.active.pop(req.id, None)
                    req.replica = None
                    if e.retryable:   # full / draining: try elsewhere
                        rep.hold_until = time.monotonic() + 0.05
                        self._hold_push_locked(req, front=True)
                    else:
                        if 'DeadlineExceeded' in str(e):
                            self._deadline_expired_n += 1
                            _deadline_expired.inc()
                        self._finalize_locked(req, FAILED, str(e))
            except (ConnectionError, OSError):
                self._on_replica_down(rep)
            else:
                with self._mu:
                    req.state = RUNNING
                    if req.dispatched_at is None:
                        req.dispatched_at = time.perf_counter()
                        _dispatch_wait.observe(req.dispatched_at
                                               - req.submitted_at)
                    self._dispatches_n += 1
                _dispatches.inc()

    def _pick_locked(self, req, exclude=None):
        now = time.monotonic()
        elig = [r for r in self._reps.values()
                if r.healthy and not r.draining and not r.gray
                and r.role != 'prefill'
                and r.endpoint != exclude
                and now >= r.hold_until
                and len(r.active) < max(1, r.capacity)]
        if not elig:
            return None
        if req.session is not None:
            ep = self._sessions.get(req.session)
            for r in elig:
                if r.endpoint == ep:
                    return r
        return min(elig, key=lambda r: (
            ((len(r.active) + r.queue_depth) / max(1, r.capacity)
             # cache-pressure term (paged replicas report token
             # occupancy): two replicas with equal lane counts tie-break
             # toward the one holding fewer KV tokens, so long streams
             # spread out instead of stacking onto one page pool
             + (r.cache_tokens / r.cache_capacity
                if r.cache_capacity else 0.0)
             # preemption-pressure term: every stream a replica has
             # swapped out is a stream its cache could NOT hold — count
             # it like an active lane so new work flows to replicas
             # that are not already evicting
             + r.preempted_streams / max(1, r.capacity))
            # speculative replicas retire a lane's tokens in fewer
            # steps: divide the load score by the measured tokens per
            # step so a high-accept-rate replica absorbs more streams
            # (neutral 1.0 for plain replicas keeps the old ordering)
            / max(1.0, r.effective_tokens_per_step)
            # prefix-affinity term (FLAGS_fleet_prefix_affinity): the
            # directory says this replica already holds a leading run
            # of the request's page chain — landing there turns the
            # prefill into a PrefixCache hit (or a near-free dedup
            # ship). Subtractive, so a stale directory entry only
            # nudges the ordering and dispatch still falls back to any
            # healthy replica.
            - self._prefix_affinity * self._affinity_locked(req, r),
            r.order))

    def _affinity_locked(self, req, rep):
        """Fraction [0, 1] of the request's full-page hash chain the
        directory believes `rep` holds as a LEADING run (only leading
        pages are adoptable — the chain breaks at the first miss)."""
        if self._prefix_affinity <= 0 or not self._prefix_dir:
            return 0.0
        pt = rep.page_tokens
        if not pt:
            return 0.0
        cache = req._ck_cache
        if cache is None or cache[0] != pt:
            from .paging import chain_keys
            prompt = req.prompt + req.tokens
            req._ck_cache = cache = (
                pt, chain_keys(prompt, pt, limit=len(prompt) - 1))
        keys = cache[1]
        if not keys:
            return 0.0
        matched = 0
        for k in keys:
            if rep.endpoint not in self._prefix_dir.get(k, ()):
                break
            matched += 1
        return matched / len(keys)

    def _pick_prefill_locked(self, req):
        """The prefill-tier replica a dispatch names in
        meta['prefill_from'] — prefix-affine first (the peer that
        already computed this chain ships it from cache), then
        least-loaded. None when no prefill tier is configured or none
        of it is currently trustworthy (the decode replica then
        prefills locally: today's colocated path)."""
        now = time.monotonic()
        elig = [r for r in self._reps.values()
                if r.role == 'prefill' and r.healthy and not r.draining
                and not r.gray and now >= r.hold_until]
        if not elig:
            return None
        return min(elig, key=lambda r: (
            -self._affinity_locked(req, r),
            (len(r.active) + r.queue_depth) / max(1, r.capacity),
            r.order))

    # -- fleet prefix directory (serving/disagg.py) ------------------------
    def _dir_apply_locked(self, rep, health):
        """Fold one replica's SRV_HEALTH prefix/disagg fields into the
        router's view: mirror the counters, then reconcile the
        directory from the replica's own registered/evicted key deltas
        — replica truth, not dispatch bookkeeping."""
        rep.page_tokens = health.get('page_tokens') or rep.page_tokens
        rep.prefix_hits = int(health.get('prefix_hits', 0) or 0)
        rep.prefix_misses = int(health.get('prefix_misses', 0) or 0)
        rep.prefix_entries = int(health.get('prefix_entries', 0) or 0)
        rep.prefix_pages = int(health.get('prefix_pages', 0) or 0)
        rep.pages_shipped = int(health.get('pages_shipped', 0) or 0)
        rep.ship_bytes = int(health.get('ship_bytes', 0) or 0)
        rep.pages_installed = int(health.get('pages_installed', 0) or 0)
        rep.pages_deduped = int(health.get('pages_deduped', 0) or 0)
        rep.local_reprefills = int(health.get('local_reprefills', 0)
                                   or 0)
        ep = rep.endpoint
        for k in health.get('prefix_new') or ():
            self._prefix_dir.setdefault(str(k), set()).add(ep)
        for k in health.get('prefix_evicted') or ():
            eps = self._prefix_dir.get(str(k))
            if eps is not None:
                eps.discard(ep)
                if not eps:
                    del self._prefix_dir[str(k)]

    def _dir_forget_locked(self, endpoint):
        """Drop every directory entry naming `endpoint` (replica death,
        gray-mark, removal): its pages may be gone, and a stale entry
        must only ever cost a dedup round trip, never a dispatch."""
        for k in list(self._prefix_dir):
            eps = self._prefix_dir[k]
            eps.discard(endpoint)
            if not eps:
                del self._prefix_dir[k]

    def _poll_one(self, rep):
        with self._mu:
            pairs = {r.rid: (r, False) for r in rep.active.values()}
            for r in rep.hedges.values():
                pairs[r.hedge_rid] = (r, True)
        if not pairs:
            return
        try:
            reply = rep.client.call(wire.SRV_POLL,
                                    {'rids': list(pairs)})
        except (ConnectionError, OSError):
            self._on_replica_down(rep)
            return
        except _ReplicaError:
            return
        streams = reply.get('streams', {})
        for rid, (req, hedged) in pairs.items():
            st = streams.get(rid)
            if st is not None:
                self._apply_poll(rep, req, st, hedged=hedged)

    def _apply_poll(self, rep, req, st, hedged=False):
        state = st.get('state')
        toks = [int(t) for t in st.get('tokens', ())]
        with self._mu:
            if req.state not in (QUEUED, RUNNING):
                (rep.hedges if hedged else rep.active).pop(req.id, None)
                return
            if hedged:
                if rep.hedges.get(req.id) is not req:
                    return            # hedge already resolved away
                if state == 'UNKNOWN' or state in (CANCELLED, FAILED):
                    # the duplicate died (replica restart, cache
                    # pressure, its own deadline): drop it quietly —
                    # the primary stream is untouched
                    self._drop_hedge_locked(req, cancel=False)
                    return
                if not toks:
                    return            # duplicate has nothing yet
                # first token came from the DUPLICATE: the hedge wins.
                # Promote it to primary — queue a cancel for the slow
                # copy, rebind the stream — then fall through to plain
                # token accounting. Greedy determinism makes both
                # copies emit identical tokens, so whichever side wins
                # the stream is the same.
                prim = self._reps.get(req.replica)
                if prim is not None and prim.active.get(req.id) is req:
                    prim.active.pop(req.id, None)
                    self._cancelq.append((req.replica, req.rid))
                rep.hedges.pop(req.id, None)
                req.replica = rep.endpoint
                req.rid = req.hedge_rid
                req.hedge_ep = req.hedge_rid = None
                rep.active[req.id] = req
                if req.session is not None:
                    self._sessions[req.session] = rep.endpoint
                self._hedge_wins_n += 1
                _hedge_wins.inc()
            elif rep.active.get(req.id) is not req:
                return                # already failed over elsewhere
            if state == 'UNKNOWN':
                # replica restarted underneath its streams: same
                # failover as a dead connection, per stream
                rep.active.pop(req.id, None)
                self._requeue_locked(req)
                return
            old = len(req.tokens)
            if toks:
                req.tokens[req.base:] = toks
            new = len(req.tokens)
            if new > old:
                req.last_progress_at = time.perf_counter()
                if req.hedge_ep is not None:
                    # the PRIMARY produced the first token: its
                    # duplicate loses and is cancelled
                    self._drop_hedge_locked(req)
                self._tokens_n += new - old
                _tokens_out.inc(new - old)
                if req.first_token_at is None:
                    req.first_token_at = time.perf_counter()
                    ttft = req.first_token_at - req.submitted_at
                    self._ttft_local.observe(ttft)
                    _ttft.observe(ttft)
            shed_budget = int(get_flag('fleet_cache_shed_budget'))
            if state == FAILED and req.cache_sheds < shed_budget and \
                    'CacheExhausted' in (st.get('error') or ''):
                # typed retryable shed (COVERAGE divergence 8): the
                # replica's page pool was dry, not the stream's fault —
                # requeue onto a (hopefully cooler) replica with a brief
                # hold on this one; FLAGS_fleet_cache_shed_budget bounds
                # the livelock when the whole fleet is saturated
                rep.active.pop(req.id, None)
                rep.hold_until = time.monotonic() + 0.05
                req.cache_sheds += 1
                self._cache_sheds_n += 1
                _cache_sheds.inc()
                self._requeue_locked(req)
                return
            if state in (DONE, CANCELLED, FAILED):
                rep.active.pop(req.id, None)
                self._drop_hedge_locked(req)
                if state == FAILED and \
                        'DeadlineExceeded' in (st.get('error') or ''):
                    self._deadline_expired_n += 1
                    _deadline_expired.inc()
                self._finalize_locked(req, state, st.get('error'))

    def _finalize_locked(self, req, state, error=None):
        req._finish(state, error)
        if state == DONE:
            self._completed_n += 1
            _completed.inc()
        elif state == CANCELLED:
            self._cancelled_n += 1
            _cancelled.inc()
        else:
            self._failed_n += 1
            _failed.inc()

    def _drop_hedge_locked(self, req, cancel=True):
        """Forget a stream's pending duplicate (under _mu). cancel=True
        queues the loser's rid for a best-effort SRV_CANCEL by the
        pump — never inline, so a slow loser cannot block the caller."""
        ep, rid = req.hedge_ep, req.hedge_rid
        req.hedge_ep = req.hedge_rid = None
        if ep is None:
            return
        hrep = self._reps.get(ep)
        if hrep is not None:
            hrep.hedges.pop(req.id, None)
        if cancel and rid is not None:
            self._cancelq.append((ep, rid))

    def _requeue_locked(self, req):
        if req.state not in (QUEUED, RUNNING):
            return
        self._drop_hedge_locked(req)
        req.segment += 1
        req.replica = None
        req.state = QUEUED
        # front of the request's OWN tier: a failover victim already
        # waited its turn once — but it must not cut ahead of a higher
        # tier, nor be buried behind its own tier's backlog
        self._hold_push_locked(req, front=True)
        self._failovers_n += 1
        _failovers.inc()

    def _on_replica_down(self, rep):
        with self._mu:
            if rep is not self._reps.get(rep.endpoint):
                return                # already removed
            was_live = rep.healthy or bool(rep.active)
            rep.healthy = False
            rep.fails = max(rep.fails, self._probe_fail_threshold)
            victims = list(rep.active.values())
            rep.active.clear()
            # duplicates hedged ONTO the dead replica die with it; their
            # primaries are untouched
            for req in list(rep.hedges.values()):
                self._drop_hedge_locked(req, cancel=False)
            for s, ep in list(self._sessions.items()):
                if ep == rep.endpoint:
                    del self._sessions[s]
            for req in victims:
                self._requeue_locked(req)
            self._dir_forget_locked(rep.endpoint)
        rep.client.close()
        if was_live:
            self._deaths_inc(rep, len(victims))

    def _deaths_inc(self, rep, n_streams):
        _deaths.inc()
        _trace.event('fleet.replica_down', endpoint=rep.endpoint,
                     failover_streams=n_streams)

    # -- control: probes, admission, autoscale, auto-deploy ----------------
    def _control_loop(self):
        while not self._stop_evt.is_set():
            try:
                self._control_once()
            except Exception as e:    # noqa: BLE001 — router survives
                _trace.event('fleet.control_error', error=repr(e))
            self._stop_evt.wait(self._probe_secs)

    def _control_once(self):
        for rep in list(self._reps.values()):
            t0 = time.perf_counter()
            try:
                # the dedicated probe connection with its OWN short
                # timeout (FLAGS_fleet_probe_timeout): liveness checks
                # must stay cheap and honest while the data connection
                # is wedged behind a gray stall
                h = rep.probe.call(wire.SRV_HEALTH, {},
                                   timeout=self._probe_timeout)
            except (ConnectionError, OSError, _ReplicaError):
                with self._mu:
                    rep.fails += 1
                    rep.clean_probes = 0
                    dead = (rep.fails >= self._probe_fail_threshold
                            and (rep.healthy or rep.active))
                if dead:
                    self._on_replica_down(rep)
                continue
            lat = time.perf_counter() - t0
            _probe_latency.observe(lat)
            with self._mu:
                self._probe_ok_locked(rep, lat)
                rep.fails = 0
                rep.queue_depth = int(h.get('queue_depth', 0))
                rep.capacity = int(h.get('capacity') or rep.capacity)
                rep.max_len = h.get('max_len', rep.max_len)
                rep.param_version = h.get('param_version')
                rep.cache_tokens = int(h.get('cache_tokens', 0))
                rep.cache_capacity = (h.get('cache_capacity')
                                      or rep.cache_capacity)
                eff = h.get('effective_tokens_per_step')
                # a replica that has not decoded yet reports 0.0 — keep
                # the neutral weight until speculation actually engages
                rep.effective_tokens_per_step = (float(eff)
                                                 if eff else 1.0)
                rep.spec_accept_rate = h.get('spec_accept_rate')
                rep.preemptions = int(h.get('preemptions', 0) or 0)
                rep.preempted_streams = int(
                    h.get('preempted_streams', 0) or 0)
                rep.mesh_shape = h.get('mesh_shape', '') or ''
                rep.mesh_devices = int(h.get('mesh_devices', 1) or 1)
                self._dir_apply_locked(rep, h)
                rep.healthy = True
        with self._mu:
            shipped = sum(r.pages_shipped for r in self._reps.values())
            sbytes = sum(r.ship_bytes for r in self._reps.values())
            # hit rate over the DECODE tier only: the prefill tier's
            # cache exists to feed ships, and counting its warm hits
            # would flatter the number the bench gates on
            hits = sum(r.prefix_hits for r in self._reps.values()
                       if r.role != 'prefill')
            misses = sum(r.prefix_misses for r in self._reps.values()
                         if r.role != 'prefill')
        _pages_shipped_g.set(shipped)
        _ship_bytes_g.set(sbytes)
        _prefix_hit_rate_g.set(hits / (hits + misses)
                               if hits + misses else 0.0)
        self._watchdog_tick()
        self._hedge_tick()
        now = time.monotonic()
        snap = self.admission_snapshot()
        dt = (now - self._prev_snap_t) if self._prev_snap_t else None
        self._evaluate_admission(snap, dt)
        if self._autoscaler is not None:
            self._autoscaler.tick(self, snap, self._prev_snap, dt)
        self._prev_snap, self._prev_snap_t = snap, now
        gauges = snap['gauges']
        _active_streams.set(gauges['fleet.active_streams'])
        _replicas_healthy.set(gauges['fleet.replicas_healthy'])
        _replicas_total.set(len(self._reps))

    # -- gray-failure machinery --------------------------------------------
    def _probe_ok_locked(self, rep, lat):
        """Probe-latency circuit breaker + half-open probation. A probe
        that answered but took far longer than the replica's own EWMA
        (and a floor of half the probe timeout — cold-start latency
        must not poison the baseline) is a STRIKE; three consecutive
        strikes gray-mark without waiting for a stream to starve. A
        gray replica rejoins after FLAGS_fleet_gray_probes consecutive
        clean probes. The strike path rides the watchdog arm
        (FLAGS_fleet_progress_timeout_secs > 0): an unarmed router
        must never gray-mark — a host-wide compile or GC pause slows
        probes 4x without the replica being at fault. The EWMA warms
        either way so arming starts from a real baseline."""
        if rep.probe_ewma is None:
            rep.probe_ewma = lat
        slow = lat > max(4.0 * rep.probe_ewma,
                         0.5 * self._probe_timeout)
        rep.probe_ewma += 0.2 * (lat - rep.probe_ewma)
        if self._progress_timeout <= 0:
            return
        if rep.gray:
            if slow:
                rep.clean_probes = 0
            else:
                rep.clean_probes += 1
                if rep.clean_probes >= self._gray_probes:
                    rep.gray = False
                    rep.strikes = 0
                    rep.clean_probes = 0
                    _trace.event('fleet.gray_rejoin',
                                 endpoint=rep.endpoint)
            return
        if slow:
            rep.strikes += 1
            if rep.strikes >= 3:
                self._gray_mark_locked(
                    rep, 'probe latency %.3fs vs ewma %.3fs (3 strikes)'
                    % (lat, rep.probe_ewma))
        else:
            rep.strikes = 0

    def _gray_mark_locked(self, rep, reason):
        """Stop trusting a live-but-stalled replica: fail its streams
        over (the same bit-exact re-prefill path a death takes), drop
        duplicates hedged onto it, and demote it to probe-only
        probation. Its data connection is interrupted by the CALLER
        (outside _mu) so a wedged pump/poller call surfaces now
        instead of after the full RPC timeout."""
        fresh = not rep.gray
        rep.gray = True
        rep.strikes = 0
        rep.clean_probes = 0
        victims = list(rep.active.values())
        rep.active.clear()
        for req in list(rep.hedges.values()):
            self._drop_hedge_locked(req, cancel=False)
        for s, ep in list(self._sessions.items()):
            if ep == rep.endpoint:
                del self._sessions[s]
        for req in victims:
            self._requeue_locked(req)
        self._dir_forget_locked(rep.endpoint)
        if fresh:
            self._gray_marks_n += 1
            _gray_marks.inc()
            _trace.event('fleet.gray_mark', endpoint=rep.endpoint,
                         reason=reason, failover_streams=len(victims))

    def _watchdog_tick(self):
        """The progress watchdog — the anti-gray-failure check health
        probes cannot make: a replica is only as healthy as its
        streams. No token growth (and no reply to an in-flight RPC)
        within FLAGS_fleet_progress_timeout_secs gray-marks the
        replica even though SRV_HEALTH still answers."""
        horizon = self._progress_timeout
        if horizon <= 0:
            return                    # watchdog disabled (default)
        now = time.perf_counter()
        for rep in list(self._reps.values()):
            stuck = None
            with self._mu:
                if self._reps.get(rep.endpoint) is not rep or rep.gray:
                    continue
                inflight = rep.client.inflight_since
                if inflight is not None and now - inflight > horizon:
                    stuck = 'rpc in flight %.2fs' % (now - inflight)
                else:
                    for r in rep.active.values():
                        lp = r.last_progress_at
                        if lp is not None and now - lp > horizon:
                            stuck = ('stream %d no progress %.2fs'
                                     % (r.id, now - lp))
                            break
                if stuck:
                    self._gray_mark_locked(rep, stuck)
            if stuck:
                rep.client.interrupt()

    def _hedge_tick(self):
        """Hedged dispatch for the slow-prefill tail: a RUNNING stream
        with no first token FLAGS_fleet_hedge_ms after dispatch is
        duplicated to a second replica; whichever copy produces a
        token first becomes the stream, the loser is SRV_CANCELled.
        Greedy determinism makes both copies identical, so hedging
        never changes output — it only moves the tail."""
        hedge_ms = self._hedge_ms
        if hedge_ms <= 0:
            return                    # hedging disabled (default)
        now = time.perf_counter()
        jobs = []
        with self._mu:
            for rep in list(self._reps.values()):
                for req in list(rep.active.values()):
                    # anything registered in rep.active is dispatched
                    # (or dispatchING — a stream whose SRV_SUBMIT is
                    # itself wedged on a gray replica is still QUEUED
                    # and needs the hedge MOST)
                    if req.state not in (QUEUED, RUNNING) \
                            or req.hedge_ep is not None:
                        continue
                    if len(req.tokens) > req.base:
                        continue      # first token already landed
                    lp = req.last_progress_at
                    if lp is None or (now - lp) * 1000.0 < hedge_ms:
                        continue
                    second = self._pick_locked(req,
                                               exclude=rep.endpoint)
                    if second is None:
                        continue
                    rid = '%s/%d/%dh' % (self._nonce, req.id,
                                         req.segment)
                    req.hedge_ep = second.endpoint
                    req.hedge_rid = rid
                    second.hedges[req.id] = req
                    meta = {'rid': rid,
                            'mnt': req.max_new_tokens - len(req.tokens),
                            'eos': req.eos_id, 'prio': req.priority}
                    if req.deadline_at is not None:
                        meta['deadline_ms'] = max(
                            1.0, (req.deadline_at - now) * 1000.0)
                    prompt = np.asarray(req.prompt + req.tokens,
                                        np.int64)
                    jobs.append((req, second, meta, prompt))
                    self._hedges_n += 1
                    _hedges.inc()
        for req, second, meta, prompt in jobs:
            try:
                second.client.call(wire.SRV_SUBMIT, meta, value=prompt)
            except _ReplicaError:
                with self._mu:
                    self._drop_hedge_locked(req, cancel=False)
            except (ConnectionError, OSError):
                with self._mu:
                    self._drop_hedge_locked(req, cancel=False)
                self._on_replica_down(second)

    def _evaluate_admission(self, snap, dt):
        breached = None
        for rule in self._admission_rules:
            out = rule.evaluate(snap, prev=self._prev_snap, dt=dt)
            if out is not None and out[1]:
                breached = rule.name
        with self._mu:
            if breached is not None:
                self._breach_streak += 1
                self._breach_rule = breached
            else:
                self._breach_streak = 0
            shed = self._breach_streak >= self._shed_consecutive
            flipped = shed != self._shedding
            self._shedding = shed
        if flipped:
            _shedding_g.set(1.0 if shed else 0.0)
            _trace.event('fleet.shed_on' if shed else 'fleet.shed_off',
                         rule=self._breach_rule or '',
                         streak=self._breach_streak)

    # -- rolling deploys ---------------------------------------------------
    def rolling_deploy(self, min_version=None, timeout=None):
        """One replica at a time: drain -> refresh -> health-check ->
        rejoin. Returns {endpoint: installed version} (None for a
        replica that was down and skipped). Raises FleetDeployError
        when a step misses its per-replica deadline — the replica is
        un-drained and keeps serving its old verified weights; already-
        deployed replicas keep the new ones (versions are
        forward-compatible by the PR-9 contract)."""
        timeout = float(timeout if timeout is not None
                        else get_flag('fleet_deploy_timeout'))
        results = {}
        with _trace.span('fleet.deploy', kind='fleet',
                         replicas=len(self._reps),
                         min_version=min_version or 0):
            for ep in self.replicas():
                with self._mu:
                    rep = self._reps.get(ep)
                    if rep is None or not rep.healthy:
                        results[ep] = None
                        continue
                    rep.draining = True
                try:
                    results[ep] = self._deploy_one(rep, min_version,
                                                   timeout)
                finally:
                    with self._mu:
                        rep.draining = False
                    try:
                        rep.client.call(wire.SRV_DRAIN, {'on': False})
                    except (ConnectionError, OSError, _ReplicaError):
                        pass
        self._deploys_n += 1
        _deploys.inc()
        return results

    def _deploy_one(self, rep, min_version, timeout):
        deadline = time.monotonic() + timeout
        try:
            rep.client.call(wire.SRV_DRAIN, {'on': True})
        except (ConnectionError, OSError):
            self._on_replica_down(rep)
            return None
        # drain ordering: lowest-tier streams fail over to another
        # replica right away (their prefix re-prefills elsewhere,
        # bit-exact), so the wait below covers only the higher-tier
        # streams finishing in place — the most important streams are
        # the last ones a deploy disturbs
        with self._mu:
            for req in list(rep.active.values()):
                if req.priority <= 0:
                    rep.active.pop(req.id, None)
                    self._requeue_locked(req)
        with _trace.span('fleet.drain', kind='fleet',
                         endpoint=rep.endpoint):
            while True:
                with self._mu:
                    n = len(rep.active)
                if not n:
                    break
                if time.monotonic() >= deadline:
                    raise FleetDeployError(
                        'deploy drain of %s timed out with %d streams '
                        'in flight' % (rep.endpoint, n))
                time.sleep(0.01)
        version = None
        while True:
            try:
                r = rep.client.call(wire.SRV_REFRESH, {},
                                    timeout=max(5.0, timeout))
                version = int(r['param_version'])
                if min_version is None or version >= int(min_version):
                    break
            except _ReplicaError as e:
                if not e.retryable:
                    raise FleetDeployError(
                        'refresh of %s failed: %s' % (rep.endpoint, e))
            except (ConnectionError, OSError):
                self._on_replica_down(rep)
                return None
            if time.monotonic() >= deadline:
                raise FleetDeployError(
                    'refresh of %s did not reach version %r in %.1fs '
                    '(installed %r)' % (rep.endpoint, min_version,
                                        timeout, version))
            time.sleep(0.05)
        # the rejoin health check: the replica must REPORT the version
        # it claims it installed before it takes traffic again
        try:
            h = rep.client.call(wire.SRV_HEALTH, {})
        except (ConnectionError, OSError):
            self._on_replica_down(rep)
            return None
        if h.get('param_version') != version:
            raise FleetDeployError(
                'replica %s installed version %d but reports %r'
                % (rep.endpoint, version, h.get('param_version')))
        with self._mu:
            rep.param_version = version
        return version

    def published_version(self):
        """max published param version across the pserver fleet (None
        when unreachable / no pservers configured)."""
        from ..distributed import rpc
        out = []
        for ep in self._pservers:
            try:
                r = rpc.get_serving_client(
                    ep, self._subscriber_id).get_version()
                out.append(int(r.get('version', 0)))
            except (ConnectionError, OSError, RuntimeError):
                continue
        return max(out) if out else None

    def enable_rolling_deploys(self, poll_secs=1.0):
        """Watch the pservers' published version; on a bump, run a
        rolling deploy targeting it. Requires pservers=[...]."""
        if not self._pservers:
            raise ValueError('enable_rolling_deploys needs pservers')
        t = threading.Thread(target=self._deploy_watch,
                             args=(float(poll_secs),),
                             name='fleet-deploy-watch', daemon=True)
        self._threads.append(t)
        t.start()
        return t

    def _deploy_watch(self, poll_secs):
        while not self._stop_evt.is_set():
            try:
                v = self.published_version()
                if v is not None and v > self._deployed_version:
                    self.rolling_deploy(min_version=v)
                    self._deployed_version = v
            except FleetDeployError as e:
                _trace.event('fleet.deploy_error', error=str(e))
            except Exception as e:    # noqa: BLE001 — router survives
                _trace.event('fleet.control_error', error=repr(e))
            self._stop_evt.wait(poll_secs)
