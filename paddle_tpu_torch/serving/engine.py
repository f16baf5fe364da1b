"""ServingEngine: continuous batching over a fixed slot pool
(counterpart of paddle_tpu/serving/engine.py). stats() carries the
predictors' serving mesh (mesh_shape, mesh_devices; serving/mesh.py).

Iteration-level scheduling: the decode step is ONE program over all
`slots` lanes, so admission and eviction never change a shape. A
request joining the running batch is a prefill between two decode
steps (dense: a whole-row cache overwrite for its slot; paged: chunked,
at most one chunk an iteration); a finished or cancelled request is a
lane the scheduler stops reading. Worker threads each own a
DecodePredictor clone (private caches and executor, weights shared
through the parent Scope) and pull from one set of queues.

Requests carry a PRIORITY tier (submit(priority=), higher = more
important, 0 = the default lowest tier): one queue a tier, popped
highest tier first, and the queue-full bound applies only to the lowest
tier. A deadline_ms budget rejects an expired request before its
prefill and evicts an expired lane between steps (typed
DeadlineExceededError). On paged-cache exhaustion the engine preempts
the lowest-tier longest-idle stream (serving/preempt.py: swap its pages
to host RAM or drop them for re-prefill) instead of shedding it; the
victim re-enters the FRONT of its own tier. request_swap() runs a
weight install with every worker quiesced at a step boundary.

Telemetry (obs/telemetry.py): serving.requests.{submitted,admitted,
completed,cancelled,rejected,failed}, serving.tokens_generated,
serving.decode_steps, serving.prefills, serving.weight_swaps,
serving.cache_exhausted, serving.deadline_expired counters;
serving.queue_depth, serving.slot_occupancy gauges; serving.ttft,
serving.token_latency, serving.decode_batch, serving.swap_wait
histograms; plus serving/preempt.py's preemption series. When
FLAGS_slo_rules is set, start() arms an SLO watchdog (obs/slo.py) over
these series for the engine's lifetime, and stop() runs its final
check and releases it. stats() also
keeps its own lifetime counts (submitted, admitted, completed,
cancelled, failed, rejected, prefills, decode_steps, tokens_generated),
telemetry on or off.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import numpy as np

from ..flags import get_flag
from ..obs import telemetry
from . import preempt as _preempt
from .paging import CacheExhaustedError
from .preempt import HostSwapBudget, pick_victim, preempt_policy

__all__ = ['Request', 'ServingEngine', 'DeadlineExceededError']

QUEUED, RUNNING, DONE, CANCELLED, FAILED = \
    'QUEUED', 'RUNNING', 'DONE', 'CANCELLED', 'FAILED'


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end deadline_ms budget expired before it
    finished. Typed and NON-retryable: retrying elsewhere can only
    spend more of a budget that is already gone. As a lane or queue
    failure it crosses poll() as a FAILED state whose error string
    leads with this class name."""

# stats() key -> telemetry counter: ServingEngine._count bumps both
_COUNTED = {name: telemetry.counter(series) for name, series in (
    ('submitted', 'serving.requests.submitted'),
    ('admitted', 'serving.requests.admitted'),
    ('completed', 'serving.requests.completed'),
    ('cancelled', 'serving.requests.cancelled'),
    ('rejected', 'serving.requests.rejected'),
    ('failed', 'serving.requests.failed'),
    ('tokens_generated', 'serving.tokens_generated'),
    ('decode_steps', 'serving.decode_steps'),
    ('prefills', 'serving.prefills'))}
_queue_depth = telemetry.gauge('serving.queue_depth')
_occupancy = telemetry.gauge('serving.slot_occupancy')
_ttft = telemetry.histogram('serving.ttft')
_token_latency = telemetry.histogram('serving.token_latency')
_decode_batch = telemetry.histogram('serving.decode_batch')
_weight_swaps = telemetry.counter('serving.weight_swaps')
_swap_wait = telemetry.histogram('serving.swap_wait')
_cache_exhausted = telemetry.counter('serving.cache_exhausted')
_deadline_expired = telemetry.counter('serving.deadline_expired')


class _StepGate(object):
    """Writer-preferring read/write gate around engine steps.

    Every worker iteration (admission prefills + the decode step) runs
    as a READER; a weight install (request_swap) runs as the SOLE
    WRITER. A waiting writer blocks new iterations from starting,
    drains the in-flight ones, runs between two steps, and releases:
    the step-boundary swap contract. In-flight
    decode steps finish on the old weights, the next step reads the
    new ones, and the writer's critical section is only the staged
    pointer swap (never a network pull)."""

    def __init__(self):
        self._mu = threading.Condition()
        self._readers = 0
        self._writers_waiting = 0
        self._writing = False

    @contextlib.contextmanager
    def read(self):
        with self._mu:
            while self._writing or self._writers_waiting:
                self._mu.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._mu:
                self._readers -= 1
                if not self._readers:
                    self._mu.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._mu:
            self._writers_waiting += 1
            while self._writing or self._readers:
                self._mu.wait()
            self._writers_waiting -= 1
            self._writing = True
        try:
            yield
        finally:
            with self._mu:
                self._writing = False
                self._mu.notify_all()


class Request(object):
    """One generation request. tokens grows as the stream decodes;
    wait() blocks until a terminal state (DONE/CANCELLED/FAILED).
    priority is the SLO tier (higher = more important, 0 = the default
    lowest tier — the only tier queue-full admission rejects)."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, eos_id, priority=0,
                 deadline_ms=None):
        self.id = next(Request._ids)
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.priority = int(priority)
        self.state = QUEUED
        self.tokens = []
        self.error = None
        self.snapshot = None          # swapped pages while preempted
        self.preempted_at = None      # set while waiting to resume
        self.submitted_at = time.perf_counter()
        # end-to-end budget, absolute against THIS process's clock from
        # arrival — None (the old-peer / no-key path) means no deadline
        self.deadline_at = None if deadline_ms is None \
            else self.submitted_at + float(deadline_ms) / 1000.0
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
        """Block for the generated tokens; raises on FAILED, returns
        the partial stream on CANCELLED."""
        if not self.wait(timeout):
            raise TimeoutError('request %d still %s after %rs'
                               % (self.id, self.state, timeout))
        if self.state == FAILED:
            raise RuntimeError('request %d failed: %s'
                               % (self.id, self.error))
        return list(self.tokens)


class _Lane(object):
    """One occupied slot: the request plus the position its NEXT token
    will be appended at (== absolute position of the token being fed).
    `ready` is False while a paged stream is still prefilling in
    chunks — the lane occupies its slot but sits out decode steps.
    `last_active` (last accepted-token time) is the idleness key the
    preemption policy sorts victims by within a tier."""
    __slots__ = ('req', 'pos', 'tok', 'ready', 'last_active')

    def __init__(self, req, pos, tok, ready=True):
        self.req, self.pos, self.tok = req, pos, tok
        self.ready = ready
        self.last_active = time.perf_counter()


class ServingEngine(object):
    def __init__(self, predictor, workers=1, max_queue=None,
                 idle_wait=None):
        """predictor: a DecodePredictor (AnalysisPredictor
        .prepare_decoding()); workers > 1 adds clone()-shared-weight
        worker threads, each with its own slot pool."""
        self._predictors = [predictor]
        for _ in range(1, int(workers)):
            self._predictors.append(predictor.clone())
        self._max_queue = int(max_queue
                              or get_flag('serving_max_queue'))
        self._idle_wait = float(idle_wait
                                if idle_wait is not None
                                else get_flag('serving_idle_wait'))
        self._queues = {}             # priority tier -> deque
        self._cond = threading.Condition()
        self._running = False
        self._threads = []
        self._active_total = 0
        self._inflight = {}           # req.id -> RUNNING Request
        self._accepting = True        # False once a drain/stop began
        self._gate = _StepGate()
        self._swaps = 0
        self._slot_tokens = {}        # worker idx -> {slot: tokens held}
        self._swap_budget = HostSwapBudget()
        self._preempted = 0           # streams waiting to resume
        self._preemptions_n = 0
        self._resumes_n = 0
        self._counts = collections.Counter()
        self._slo = None

    def _count(self, name, n=1):
        with self._cond:
            self._counts[name] += n
        _COUNTED[name].inc(n)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._running:
            return self
        self._running = True
        self._accepting = True
        # serving SLOs (obs/slo.py): when FLAGS_slo_rules is set, a
        # watchdog re-checks TTFT/token-latency percentiles and token
        # rates against the declared thresholds for the engine's
        # lifetime, emitting slo.breach events
        from ..obs import slo as _slo
        self._slo = _slo.watchdog_from_flags()
        if self._slo is not None:
            self._slo.start()
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(i, p),
                             name='serving-worker-%d' % i, daemon=True)
            for i, p in enumerate(self._predictors)]
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout=None):
        """Block until no queued or running work remains, leaving the
        engine serving. Returns True once idle, False if `timeout`
        expired first (nothing is cancelled — the caller decides
        whether to escalate). On a never-started engine the queue has
        no one to drain it: returns immediately."""
        if not self._threads:
            return not self._qsize_locked() and not self._inflight
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            with self._cond:
                if not self._qsize_locked() and not self._inflight:
                    return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def stop(self, drain=True, timeout=None):
        """drain=True finishes queued + running requests first;
        drain=False cancels everything still queued. A `timeout` bounds
        the drain: past it the stop ESCALATES — every still-queued and
        still-running request is cancelled (partial tokens stay
        readable) and the workers are joined with a bound instead of
        hanging forever on a stuck stream. Returns True for a clean
        drain, False when the escalation fired."""
        self._accepting = False
        clean = True
        if drain and timeout is not None:
            clean = self.drain(timeout)
        with self._cond:
            if not drain or not clean:
                for q in self._queues.values():
                    while q:
                        req = q.popleft()
                        self._forget_preempted(req)
                        req._finish(CANCELLED)
                        self._count('cancelled')
                if not clean:
                    # running lanes notice the CANCELLED state at the
                    # next step boundary and evict (cancel() semantics)
                    for req in list(self._inflight.values()):
                        if req.state == RUNNING:
                            req.state = CANCELLED
            self._running = False
            self._cond.notify_all()
        join_deadline = None if timeout is None \
            else time.monotonic() + max(5.0, timeout)
        for t in self._threads:
            t.join(None if join_deadline is None
                   else max(0.1, join_deadline - time.monotonic()))
            if t.is_alive():
                # a wedged decode step: the daemon thread dies with the
                # process — surfacing a False beats hanging the caller
                clean = False
        self._threads = []
        if self._slo is not None:
            # final check covers the tail between the last periodic
            # evaluation and drain
            self._slo.stop(final_check=True)
            self._slo = None
        return clean

    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None,
               priority=0, deadline_ms=None):
        """priority: SLO tier, higher = more important (default 0 =
        the lowest tier). Tiers dequeue highest-first, and the
        queue-full rejection applies only to the lowest tier — shed
        rules cost low-tier latency, never high-tier admission.

        deadline_ms: optional end-to-end budget. An expired request is
        rejected at dequeue (before its prefill is wasted) and an
        expired lane is cancelled between decode steps with its pages
        freed — both FAILED with a typed, non-retryable
        DeadlineExceededError. None = no deadline."""
        prompt = np.asarray(prompt).reshape(-1)
        max_len = self._predictors[0].max_len
        if not 1 <= prompt.size <= max_len:
            self._count('rejected')
            raise ValueError('prompt length %d outside [1, %d] '
                             '(max_len)' % (prompt.size, max_len))
        if max_new_tokens < 1:
            self._count('rejected')
            raise ValueError('max_new_tokens must be >= 1')
        if deadline_ms is not None and float(deadline_ms) <= 0:
            self._count('rejected')
            _deadline_expired.inc()
            raise DeadlineExceededError(
                'deadline_ms %r already spent at submit'
                % (deadline_ms,))
        req = Request(prompt, max_new_tokens, eos_id,
                      priority=priority, deadline_ms=deadline_ms)
        with self._cond:
            if self._running and not self._accepting:
                self._count('rejected')
                raise RuntimeError(
                    'serving engine is draining — submission rejected')
            if req.priority <= 0 and \
                    self._qsize_locked() >= self._max_queue:
                self._count('rejected')
                raise RuntimeError('serving queue full (%d)'
                                   % self._max_queue)
            self._push_locked(req)
        self._count('submitted')
        return req

    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 timeout=None):
        return self.submit(prompt, max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def cancel(self, req):
        """Mark a request cancelled; a queued one never runs, a running
        one is evicted at the next step boundary (its partial tokens
        remain readable)."""
        if req.state in (QUEUED, RUNNING):
            req.state = CANCELLED
        return req

    def request_swap(self, fn, label='weights'):
        """Run fn() with every worker quiesced at a step boundary and
        return its result. fn must be CHEAP (staged-pointer installs,
        not pulls): it holds up every decode lane while it runs. With
        the engine stopped there are no steps in flight and fn runs
        inline. The wait-for-boundary time lands in serving.swap_wait;
        serving.weight_swaps counts completed swaps."""
        t0 = time.perf_counter()
        if not self._threads:
            out = fn()
            self._swaps += 1
            _weight_swaps.inc()
            return out
        with self._gate.exclusive():
            _swap_wait.observe(time.perf_counter() - t0)
            out = fn()
            self._swaps += 1
            _weight_swaps.inc()
            return out

    # -- prefix export / install (quiesced page copies) --------------------
    def export_prefix(self, prompt):
        """Gather the longest resident full-page chain for `prompt`
        across workers into host copies (quiesced at a step boundary —
        save_pages reads device pools). None on a non-paged engine or
        a cold cache."""
        if not getattr(self._predictors[0], 'paged', False):
            return None

        def _gather():
            best = None
            for p in self._predictors:
                got = p.export_prefix(prompt)
                if got and (best is None
                            or len(got['keys']) > len(best['keys'])):
                    best = got
            return best
        return self.request_swap(_gather, label='export_prefix')

    def install_prefix(self, prompt, keys, data, skip=0):
        """Install shipped pages into worker 0's pool + prefix cache
        (quiesced — restore_pages functionally rewrites device pools).
        Streams admitted by other workers simply re-prefill locally;
        correctness never depends on the install. Returns (installed,
        deduped)."""
        if not getattr(self._predictors[0], 'paged', False):
            raise ValueError('install_prefix needs a paged engine')
        return self.request_swap(
            lambda: self._predictors[0].install_prefix(prompt, keys,
                                                       data, skip=skip),
            label='install_prefix')

    def resident_keys(self, prompt):
        """Worker 0's resident leading chain run for `prompt` (hex) —
        advisory, lock-free (see PagedDecodePredictor.resident_keys)."""
        p0 = self._predictors[0]
        if not getattr(p0, 'paged', False):
            return []
        return p0.resident_keys(prompt)

    def prefix_report(self):
        """Drain registered/evicted prefix-chain deltas from every
        worker (merged)."""
        new, gone = [], []
        for p in self._predictors:
            if not getattr(p, 'paged', False):
                continue
            got = p.prefix_report()
            new.extend(got['new'])
            gone.extend(got['evicted'])
        return {'new': new, 'evicted': gone}

    def stats(self):
        with self._cond:
            depth = self._qsize_locked()
            preempted = self._preempted
            counts = dict.fromkeys(_COUNTED, 0)
            counts.update(self._counts)
        p0 = self._predictors[0]
        paged = getattr(p0, 'paged', False)
        slot_tokens = [dict(self._slot_tokens.get(i, {}))
                       for i in range(len(self._predictors))]
        out = {'queue_depth': depth, 'active': self._active_total,
               'workers': len(self._predictors),
               'slots_per_worker': p0.slots,
               'weight_swaps': self._swaps,
               # preempt-first capacity (serving/preempt.py): lifetime
               # preemptions/resumes, streams currently swapped out or
               # waiting to re-prefill, and host RAM held by swaps
               'preemptions': self._preemptions_n,
               'resumes': self._resumes_n,
               'preempted_streams': preempted,
               'swap_host_bytes': self._swap_budget.used_bytes,
               'paged': paged,
               # the serving mesh the predictors run over ('' and 1:
               # one device)
               'mesh_shape': getattr(p0, 'mesh_shape', ''),
               'mesh_devices': int(getattr(p0, 'mesh_devices', 1)),
               # per-worker {slot: tokens held}: actual cache pressure
               'slot_tokens': slot_tokens,
               'cache_tokens': sum(sum(d.values()) for d in slot_tokens),
               'jit': p0.jit_cache_stats()}
        if paged:
            kv = {'pages_in_use': 0, 'pages_free': 0, 'prefix_hits': 0,
                  'prefix_misses': 0, 'prefix_pages': 0,
                  'prefix_tokens_reused': 0, 'prefix_entries': 0}
            for p in self._predictors:
                for key in kv:
                    kv[key] += p.pool_stats()[key]
            kv['page_tokens'] = p0.page_tokens
            kv['num_pages'] = p0.num_pages
            out['kv'] = kv
            out['cache_capacity'] = (len(self._predictors)
                                     * (p0.num_pages - 1) * p0.page_tokens)
        else:
            out['cache_capacity'] = (len(self._predictors)
                                     * p0.slots * p0.max_len)
        if getattr(p0, 'speculative', False):
            sp = [p.spec_stats() for p in self._predictors]
            drafted = sum(s['draft_tokens'] for s in sp)
            accepted = sum(s['accepted_tokens'] for s in sp)
            steps = sum(s['steps'] for s in sp)
            emitted = sum(s['effective_tokens_per_step'] * s['steps']
                          for s in sp)
            out['spec'] = {
                'spec_k': sp[0]['spec_k'],
                'k_live': sp[0]['k_live'],
                'steps': steps,
                'draft_tokens': drafted,
                'accepted_tokens': accepted,
                'rejected_tokens': drafted - accepted,
                'fallback_steps': sum(s['fallback_steps'] for s in sp),
                'accept_rate': (accepted / drafted if drafted else 0.0)}
            # tokens emitted per verify iteration (1.0 would be plain
            # decode)
            out['effective_tokens_per_step'] = (emitted / steps
                                                if steps else 0.0)
            out['spec']['effective_tokens_per_step'] = \
                out['effective_tokens_per_step']
        out.update(counts)
        return out

    # -- scheduler ---------------------------------------------------------
    def _qsize_locked(self):
        return sum(len(q) for q in self._queues.values())

    def _push_locked(self, req, front=False):
        """Enqueue into the request's own tier (front=True: a
        requeued exhaustion victim or preempted stream resumes ahead
        of its tier's waiting admissions — but never jumps a higher
        tier, which is always drained first)."""
        q = self._queues.get(req.priority)
        if q is None:
            q = self._queues[req.priority] = collections.deque()
        if front:
            q.appendleft(req)
        else:
            q.append(req)
        _queue_depth.set(self._qsize_locked())
        self._cond.notify_all()

    def _pop_next(self):
        with self._cond:
            for prio in sorted(self._queues, reverse=True):
                q = self._queues[prio]
                while q:
                    req = q.popleft()
                    _queue_depth.set(self._qsize_locked())
                    if req.state == CANCELLED:
                        self._forget_preempted(req)
                        req._finish(CANCELLED)
                        self._count('cancelled')
                        continue
                    if req.deadline_at is not None and \
                            time.perf_counter() > req.deadline_at:
                        # expired while queued: reject BEFORE wasting a
                        # prefill on tokens nobody is waiting for
                        self._forget_preempted(req)
                        req._finish(FAILED,
                                    error='DeadlineExceededError: '
                                          'expired in queue')
                        self._count('failed')
                        _deadline_expired.inc()
                        continue
                    return req
        return None

    # -- preemption (serving/preempt.py) -----------------------------------
    def _forget_preempted(self, req):
        """A preempted request leaving the queue for a terminal state:
        give back its host budget and the preempted-streams gauge."""
        snap, req.snapshot = req.snapshot, None
        if snap is not None:
            self._swap_budget.release(snap['nbytes'])
        if req.preempted_at is not None:
            req.preempted_at = None
            with self._cond:
                self._preempted -= 1
            _preempt.preempted_streams.set(self._preempted)

    def _resume(self, req):
        """Preempt -> back-in-a-slot accounting (the request is being
        re-admitted; its snapshot, if any, was already restored)."""
        if req.preempted_at is None:
            return
        _preempt.resume_latency.observe(time.perf_counter()
                                        - req.preempted_at)
        req.preempted_at = None
        with self._cond:
            self._preempted -= 1
            self._resumes_n += 1
        _preempt.preempted_streams.set(self._preempted)

    def _preempt_lane(self, pred, lanes, slot, wstate, policy):
        """Preempt one READY lane: swap its pages to pinned host memory
        (budget permitting) or drop them for re-prefill, release the
        slot, and requeue the request at the FRONT of its own tier.
        Admission then waits (cache_wait) until a live stream releases
        pages, so the victim cannot immediately steal back what it
        just gave up."""
        lane = lanes.pop(slot)
        req = lane.req
        snap = None
        if policy == 'swap':
            snap = pred.save_stream(slot)
            if self._swap_budget.reserve(snap['nbytes']):
                _preempt.swapped_pages.inc(snap['pages'])
                _preempt.swap_bytes.inc(snap['nbytes'])
            else:
                snap = None       # host budget dry: re-prefill instead
        pred.release(slot)
        self._inflight.pop(req.id, None)
        self._active_total -= 1
        with self._cond:
            self._preempted += 1
            self._preemptions_n += 1
            req.state = QUEUED
            req.snapshot = snap
            req.preempted_at = time.perf_counter()
            self._push_locked(req, front=True)
        _preempt.preemptions.inc()
        _preempt.preempted_streams.set(self._preempted)
        wstate['cache_wait'] = True

    def _finish_lane(self, lanes, slot, state, error=None, pred=None,
                     wstate=None):
        lane = lanes.pop(slot)
        self._inflight.pop(lane.req.id, None)
        lane.req._finish(state, error)
        self._active_total -= 1
        if pred is not None and getattr(pred, 'paged', False):
            # freed pages un-stick any admission waiting on the pool
            pred.release(slot)
            if wstate is not None:
                wstate['cache_wait'] = False
        if state == DONE:
            self._count('completed')
        elif state == CANCELLED:
            self._count('cancelled')
        else:
            self._count('failed')

    def _lane_accept(self, lanes, slot, tok, pred=None, wstate=None):
        """Record one generated token; returns False if the lane is
        done (eos / budget / cancelled) and was evicted."""
        lane = lanes[slot]
        req = lane.req
        if req.state == CANCELLED:
            self._finish_lane(lanes, slot, CANCELLED, pred=pred,
                              wstate=wstate)
            return False
        req.tokens.append(int(tok))
        self._count('tokens_generated')
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
            _ttft.observe(req.first_token_at - req.submitted_at)
        if len(req.tokens) >= req.max_new_tokens or \
                (req.eos_id is not None and int(tok) == req.eos_id):
            self._finish_lane(lanes, slot, DONE, pred=pred,
                              wstate=wstate)
            return False
        lane.tok = int(tok)
        lane.last_active = time.perf_counter()
        return True

    def _admit(self, pred, lanes):
        """Fill free slots from the queue; one prefill per admitted
        request (prefill_batch > 1 batches them)."""
        free = [s for s in range(pred.slots) if s not in lanes]
        batch = []
        while free:
            req = self._pop_next()
            if req is None:
                break
            req.state = RUNNING
            self._inflight[req.id] = req
            slot = free.pop(0)
            batch.append((req, slot))
            self._active_total += 1
            self._count('admitted')
        for i in range(0, len(batch), pred.prefill_batch):
            chunk = batch[i:i + pred.prefill_batch]
            try:
                ids = pred.prefill([r.prompt for r, _ in chunk],
                                   [s for _, s in chunk])
            except Exception as e:     # noqa: BLE001 — lane-fatal only
                for req, _slot in chunk:
                    self._inflight.pop(req.id, None)
                    req._finish(FAILED, error=repr(e))
                    self._active_total -= 1
                    self._count('failed')
                continue
            self._count('prefills', len(chunk))
            for (req, slot), tok in zip(chunk, ids):
                lanes[slot] = _Lane(req, pos=len(req.prompt),
                                    tok=int(tok))
                self._lane_accept(lanes, slot, int(tok))

    def _admit_paged(self, pred, lanes, prefilling, wstate):
        """Paged admission: open a stream per free slot (a prefix-cache
        match + read-only page adoption — allocates nothing, so
        admission itself can never exhaust the pool) and queue it for
        chunked prefill. While cache_wait is set, a requeued
        exhaustion victim is waiting for a live stream to release
        pages — admitting more streams would only deepen the hole.

        A resuming PREEMPTED stream takes one of two paths: a swap
        snapshot restores its pages device-side before the next decode
        step it joins (the same bits: float32 bytes round-trip
        exactly); without one, the stream re-prefills (prompt + tokens
        so far), and the final chunk's output token IS its next stream
        token (greedy determinism; serving/preempt.py says how far the
        bits carry)."""
        if wstate['cache_wait'] and lanes:
            return
        wstate['cache_wait'] = False
        free = [s for s in range(pred.slots) if s not in lanes]
        while free:
            req = self._pop_next()
            if req is None:
                break
            slot = free.pop(0)
            # a resumed stream continues from its accumulated tokens;
            # a fresh one has none and seq is just its prompt
            seq = req.prompt + req.tokens
            if req.snapshot is not None:
                try:
                    pred.restore_stream(slot, req.snapshot, prompt=seq)
                except CacheExhaustedError:
                    if lanes:
                        # pool still too tight: back to the tier front
                        # until a live stream releases
                        with self._cond:
                            self._push_locked(req, front=True)
                        wstate['cache_wait'] = True
                        return
                    # nothing live will ever free pages for this
                    # snapshot: drop it and re-prefill instead (the
                    # pool may fit a chunked prefill it cannot fit
                    # whole)
                    self._swap_budget.release(req.snapshot['nbytes'])
                    req.snapshot = None
                except Exception as e:  # noqa: BLE001 — lane-fatal
                    self._forget_preempted(req)
                    req._finish(FAILED, error=repr(e))
                    self._count('failed')
                    continue
                else:
                    self._swap_budget.release(req.snapshot['nbytes'])
                    req.snapshot = None
                    self._resume(req)
                    req.state = RUNNING
                    self._inflight[req.id] = req
                    self._active_total += 1
                    lanes[slot] = _Lane(req, pos=len(seq) - 1,
                                        tok=req.tokens[-1])
                    self._count('admitted')
                    continue
            req.state = RUNNING
            self._inflight[req.id] = req
            self._active_total += 1
            try:
                pred.open_stream(slot, seq)
            except Exception as e:  # noqa: BLE001 — lane-fatal only
                self._forget_preempted(req)
                self._inflight.pop(req.id, None)
                req._finish(FAILED, error=repr(e))
                self._active_total -= 1
                self._count('failed')
                continue
            self._resume(req)
            lanes[slot] = _Lane(req, pos=len(seq), tok=0,
                                ready=False)
            prefilling.append(slot)
            self._count('admitted')

    def _prefill_tick(self, pred, lanes, prefilling, wstate):
        """Advance chunked prefill by AT MOST one chunk per engine
        iteration — the head-of-line bound: a 4k-token prompt costs
        the live decode lanes one chunk's latency per step, never a
        whole-prompt stall. Pool exhaustion mid-prefill first tries to
        PREEMPT a strictly lower-tier ready lane (the prefilling
        stream keeps its slot and retries the same chunk next
        iteration); with no lower-tier victim, it requeues at the
        front of its OWN tier — never jumping a higher tier's waiting
        admissions — and admission pauses until a live stream releases
        (with no live stream left to wait on, the request can never
        fit and fails with the typed error)."""
        while prefilling:
            slot = prefilling[0]
            lane = lanes.get(slot)
            if lane is None:
                prefilling.popleft()
                continue
            req = lane.req
            if req.state == CANCELLED:
                prefilling.popleft()
                self._finish_lane(lanes, slot, CANCELLED, pred=pred,
                                  wstate=wstate)
                continue
            if req.deadline_at is not None and \
                    time.perf_counter() > req.deadline_at:
                prefilling.popleft()
                self._finish_lane(lanes, slot, FAILED,
                                  error='DeadlineExceededError: '
                                        'expired mid-prefill',
                                  pred=pred, wstate=wstate)
                _deadline_expired.inc()
                continue
            try:
                out = pred.prefill_step(slot)
            except CacheExhaustedError as e:
                _cache_exhausted.inc()
                policy = preempt_policy()
                if policy != 'off':
                    victim = pick_victim(lanes, below=req.priority)
                    if victim is not None:
                        # a lower-tier stream gives way; this prefill
                        # keeps its slot and retries the same chunk
                        # next iteration
                        self._preempt_lane(pred, lanes, victim,
                                           wstate, policy)
                        return
                prefilling.popleft()
                lanes.pop(slot)
                pred.release(slot)
                self._inflight.pop(req.id, None)
                self._active_total -= 1
                if lanes:
                    req.state = QUEUED
                    with self._cond:
                        self._push_locked(req, front=True)
                    wstate['cache_wait'] = True
                else:
                    req._finish(FAILED,
                                error='CacheExhaustedError: %s' % e)
                    self._count('failed')
                return
            except Exception as e:  # noqa: BLE001 — lane-fatal only
                prefilling.popleft()
                self._finish_lane(lanes, slot, FAILED, error=repr(e),
                                  pred=pred, wstate=wstate)
                return
            self._count('prefills')
            if out is None:
                return               # more chunks remain — next iteration
            prefilling.popleft()
            lane.ready = True
            self._lane_accept(lanes, slot, int(out), pred=pred,
                              wstate=wstate)
            return

    def _worker_loop(self, wid, pred):
        paged = getattr(pred, 'paged', False)
        # a speculative predictor's step is one draft->verify iteration
        # (serving/speculative.py): same feed ABI, but each live lane
        # gets 1..k+1 tokens back instead of exactly one
        speculative = getattr(pred, 'speculative', False)
        lanes = {}                       # slot -> _Lane
        prefilling = collections.deque()  # paged: slots mid-prefill
        wstate = {'cache_wait': False}
        tokens = np.zeros((pred.slots,), np.int64)
        positions = np.zeros((pred.slots,), np.int32)
        while True:
            with self._cond:
                while self._running and not self._qsize_locked() \
                        and not lanes:
                    self._cond.wait(self._idle_wait)
                if not self._running and not self._qsize_locked() \
                        and not lanes:
                    return
            # one gate-read section per iteration: a waiting weight
            # swap (request_swap) runs between iterations — i.e. at a
            # step boundary — never under a prefill or decode step
            with self._gate.read():
                if paged:
                    self._admit_paged(pred, lanes, prefilling, wstate)
                    self._prefill_tick(pred, lanes, prefilling, wstate)
                else:
                    self._admit(pred, lanes)
                _occupancy.set(self._active_total)
                self._slot_tokens[wid] = {s: ln.pos
                                          for s, ln in lanes.items()}
                # deadline check at the step boundary: an expired ready
                # lane is evicted (pages freed) before it buys another
                # decode step. Prefilling lanes are checked at the
                # prefill-queue head (_prefill_tick), matching how
                # cancellation reaches them.
                now = time.perf_counter()
                for slot, ln in list(lanes.items()):
                    if ln.ready and ln.req.deadline_at is not None \
                            and now > ln.req.deadline_at:
                        self._finish_lane(
                            lanes, slot, FAILED,
                            error='DeadlineExceededError: expired '
                                  'mid-decode',
                            pred=pred, wstate=wstate)
                        _deadline_expired.inc()
                ready = [s for s, ln in lanes.items() if ln.ready]
                if not ready:
                    continue
                for slot in ready:
                    tokens[slot] = lanes[slot].tok
                    positions[slot] = lanes[slot].pos
                t0 = time.perf_counter()
                try:
                    if speculative:
                        emitted = pred.spec_step(tokens, positions)
                    else:
                        ids = pred.decode_step(tokens, positions)
                except CacheExhaustedError as e:
                    # preempt-first (serving/preempt.py): instead of
                    # failing the named victims, the lowest-tier
                    # longest-idle stream gives its pages back (swap or
                    # drop) and every survivor retries the IDENTICAL
                    # step next iteration — the transactional rollback
                    # already undid this call's allocations, so the
                    # retry gives the same bits. policy 'off' fails the
                    # victims with the typed error instead.
                    _cache_exhausted.inc()
                    policy = preempt_policy()
                    preempted = False
                    if policy != 'off':
                        for slot in list(e.slots):
                            lane = lanes.get(slot)
                            if lane is not None and \
                                    lane.pos + 1 > pred.window:
                                # outgrew its own page window: no
                                # preemption can ever make it fit
                                self._finish_lane(
                                    lanes, slot, FAILED,
                                    error='CacheExhaustedError: %s' % e,
                                    pred=pred, wstate=wstate)
                        victim = pick_victim(lanes)
                        if victim is not None:
                            self._preempt_lane(pred, lanes, victim,
                                               wstate, policy)
                            preempted = True
                    if not preempted:
                        for slot in e.slots:
                            if slot in lanes:
                                self._finish_lane(
                                    lanes, slot, FAILED,
                                    error='CacheExhaustedError: %s' % e,
                                    pred=pred, wstate=wstate)
                    continue
                except Exception as e:   # noqa: BLE001 — engine survives
                    for slot in ready:
                        if slot in lanes:
                            self._finish_lane(lanes, slot, FAILED,
                                              error=repr(e), pred=pred,
                                              wstate=wstate)
                    continue
                dt = time.perf_counter() - t0
                self._count('decode_steps')
                _token_latency.observe(dt)
                _decode_batch.observe(len(ready))
                if speculative:
                    # per-slot mixed accept lengths in the SAME
                    # iteration: each lane consumes its own emitted
                    # prefix, stopping early on eos/budget/cancel
                    for slot in ready:
                        for tok in emitted.get(slot, ()):
                            lanes[slot].pos += 1
                            if not self._lane_accept(lanes, slot,
                                                     int(tok),
                                                     pred=pred,
                                                     wstate=wstate):
                                break
                else:
                    for slot in ready:
                        lanes[slot].pos += 1
                        self._lane_accept(lanes, slot, int(ids[slot]),
                                          pred=pred, wstate=wstate)
                _occupancy.set(self._active_total)
                # re-snapshot after evictions so an idle worker reports
                # zero held tokens, not its last busy state
                self._slot_tokens[wid] = {s: ln.pos
                                          for s, ln in lanes.items()}
