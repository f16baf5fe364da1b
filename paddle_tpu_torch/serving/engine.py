"""ServingEngine: continuous batching over a fixed slot pool
(counterpart of paddle_tpu/serving/engine.py, dense cache and FIFO
admission).

The decode step is ONE program over all `slots` lanes, so admission and
eviction never change a shape: a request joining the running batch is a
prefill (whole-row cache overwrite for its slot) between two decode
steps; a finished or cancelled request is a lane the scheduler stops
reading (decode_mask hides whatever the dead lane writes). Worker
threads each own a DecodePredictor clone — private caches and executor,
weights shared through the parent Scope — and pull from one FIFO queue.

Not ported yet (ROADMAP): paged admission, priority tiers, preemption,
deadlines, weight swap, prefix export and telemetry.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import numpy as np

from ..flags import get_flag

__all__ = ['Request', 'ServingEngine']

QUEUED, RUNNING, DONE, CANCELLED, FAILED = \
    'QUEUED', 'RUNNING', 'DONE', 'CANCELLED', 'FAILED'


class Request(object):
    """One generation request. tokens grows as the stream decodes;
    wait() blocks until a terminal state (DONE/CANCELLED/FAILED)."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, eos_id):
        self.id = next(Request._ids)
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.state = QUEUED
        self.tokens = []
        self.error = None
        self.submitted_at = time.perf_counter()
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
        """Block for the generated tokens; raises on FAILED, returns the
        partial stream on CANCELLED."""
        if not self.wait(timeout):
            raise TimeoutError('request %d still %s after %rs'
                               % (self.id, self.state, timeout))
        if self.state == FAILED:
            raise RuntimeError('request %d failed: %s'
                               % (self.id, self.error))
        return list(self.tokens)


class _Lane(object):
    """One occupied slot: the request plus the position its NEXT token
    is appended at (the absolute position of the token being fed)."""
    __slots__ = ('req', 'pos', 'tok')

    def __init__(self, req, pos, tok):
        self.req, self.pos, self.tok = req, pos, tok


class ServingEngine(object):
    def __init__(self, predictor, workers=1, max_queue=None,
                 idle_wait=None):
        """predictor: a DecodePredictor (AnalysisPredictor
        .prepare_decoding()); workers > 1 adds clone()d worker threads,
        each with its own slot pool."""
        self._predictors = [predictor]
        for _ in range(1, int(workers)):
            self._predictors.append(predictor.clone())
        self._max_queue = int(max_queue or get_flag('serving_max_queue'))
        self._idle_wait = float(idle_wait if idle_wait is not None
                                else get_flag('serving_idle_wait'))
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._running = False
        self._accepting = True
        self._threads = []
        self._active = 0
        self._inflight = {}           # req.id -> RUNNING Request
        self._counts = collections.Counter()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._running:
            return self
        self._running = True
        self._accepting = True
        self._threads = [
            threading.Thread(target=self._worker_loop, args=(p,),
                             name='serving-worker-%d' % i, daemon=True)
            for i, p in enumerate(self._predictors)]
        for t in self._threads:
            t.start()
        return self

    def drain(self, timeout=None):
        """Block until no queued or running work remains, leaving the
        engine serving. True once idle, False if `timeout` expired."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                if not self._threads:
                    return False
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(0.1 if left is None else min(left, 0.1))
        return True

    def stop(self, drain=True, timeout=None):
        """drain=True finishes queued + running requests first;
        drain=False cancels everything still queued. Past `timeout` the
        drain escalates: remaining requests are cancelled (partial
        tokens stay readable). Returns True for a clean drain."""
        self._accepting = False
        clean = True
        if drain and timeout is not None:
            clean = self.drain(timeout)
        with self._cond:
            if not drain or not clean:
                while self._queue:
                    req = self._queue.popleft()
                    req._finish(CANCELLED)
                    self._counts['cancelled'] += 1
            if not clean:
                # running lanes see CANCELLED at the next step boundary
                for req in self._inflight.values():
                    req.state = CANCELLED
            self._running = False
            self._cond.notify_all()
        for t in self._threads:
            t.join(None if timeout is None else max(5.0, timeout))
            if t.is_alive():
                clean = False
        self._threads = []
        return clean

    close = stop

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None):
        prompt = np.asarray(prompt).reshape(-1)
        max_len = self._predictors[0].max_len
        if not 1 <= prompt.size <= max_len:
            raise ValueError('prompt length %d outside [1, %d] (max_len)'
                             % (prompt.size, max_len))
        if max_new_tokens < 1:
            raise ValueError('max_new_tokens must be >= 1')
        req = Request(prompt, max_new_tokens, eos_id)
        with self._cond:
            if self._running and not self._accepting:
                raise RuntimeError(
                    'serving engine is draining — submission rejected')
            if len(self._queue) >= self._max_queue:
                raise RuntimeError('serving queue full (%d)'
                                   % self._max_queue)
            self._queue.append(req)
            self._counts['submitted'] += 1
            self._cond.notify_all()
        return req

    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 timeout=None):
        return self.submit(prompt, max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def cancel(self, req):
        """A queued request never runs; a running one is evicted at the
        next step boundary (its partial tokens stay readable)."""
        if req.state in (QUEUED, RUNNING):
            req.state = CANCELLED
        return req

    def stats(self):
        p0 = self._predictors[0]
        with self._cond:
            out = {'queue_depth': len(self._queue), 'active': self._active,
                   'workers': len(self._predictors),
                   'slots_per_worker': p0.slots,
                   'cache_capacity': (len(self._predictors) * p0.slots
                                      * p0.max_len),
                   'jit': p0.jit_cache_stats()}
            out.update(self._counts)
        return out

    # -- scheduler ---------------------------------------------------------
    def _pop_next(self):
        with self._cond:
            while self._queue:
                req = self._queue.popleft()
                if req.state == CANCELLED:
                    req._finish(CANCELLED)
                    self._counts['cancelled'] += 1
                    continue
                req.state = RUNNING
                self._inflight[req.id] = req
                self._active += 1
                self._counts['admitted'] += 1
                return req
        return None

    def _finish_lane(self, lanes, slot, state, error=None):
        req = lanes.pop(slot).req
        with self._cond:
            self._inflight.pop(req.id, None)
            self._active -= 1
            self._counts[{DONE: 'completed', CANCELLED: 'cancelled',
                          FAILED: 'failed'}[state]] += 1
            req._finish(state, error)
            self._cond.notify_all()

    def _lane_accept(self, lanes, slot, tok):
        """Record one generated token; evicts the lane when it is done
        (eos / budget / cancelled)."""
        lane = lanes[slot]
        req = lane.req
        if req.state == CANCELLED:
            self._finish_lane(lanes, slot, CANCELLED)
            return
        req.tokens.append(int(tok))
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        with self._cond:
            self._counts['tokens_generated'] += 1
        if len(req.tokens) >= req.max_new_tokens or \
                (req.eos_id is not None and int(tok) == req.eos_id):
            self._finish_lane(lanes, slot, DONE)
            return
        lane.tok = int(tok)

    def _admit(self, pred, lanes):
        """Fill free slots from the queue, one prefill per prefill_batch
        admitted requests."""
        free = [s for s in range(pred.slots) if s not in lanes]
        batch = []
        while free:
            req = self._pop_next()
            if req is None:
                break
            batch.append((req, free.pop(0)))
        for i in range(0, len(batch), pred.prefill_batch):
            chunk = batch[i:i + pred.prefill_batch]
            for req, slot in chunk:
                lanes[slot] = _Lane(req, pos=len(req.prompt), tok=0)
            try:
                ids = pred.prefill([r.prompt for r, _ in chunk],
                                   [s for _, s in chunk])
            except Exception as e:     # noqa: BLE001 — lane-fatal only
                for _req, slot in chunk:
                    self._finish_lane(lanes, slot, FAILED, error=repr(e))
                continue
            with self._cond:
                self._counts['prefills'] += len(chunk)
            for (_req, slot), tok in zip(chunk, ids):
                self._lane_accept(lanes, slot, int(tok))

    def _worker_loop(self, pred):
        lanes = {}                       # slot -> _Lane
        tokens = np.zeros((pred.slots,), np.int64)
        positions = np.zeros((pred.slots,), np.int32)
        while True:
            with self._cond:
                while self._running and not self._queue and not lanes:
                    self._cond.wait(self._idle_wait)
                if not self._running and not self._queue and not lanes:
                    return
            self._admit(pred, lanes)
            if not lanes:
                continue
            for slot, lane in lanes.items():
                tokens[slot] = lane.tok
                positions[slot] = lane.pos
            live = list(lanes)
            try:
                ids = pred.decode_step(tokens, positions)
            except Exception as e:   # noqa: BLE001 — the engine survives
                for slot in live:
                    self._finish_lane(lanes, slot, FAILED, error=repr(e))
                continue
            with self._cond:
                self._counts['decode_steps'] += 1
            for slot in live:
                lanes[slot].pos += 1
                self._lane_accept(lanes, slot, int(ids[slot]))
