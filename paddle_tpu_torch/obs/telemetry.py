"""Process-wide telemetry registry: Counters, Gauges, bucketed
Histograms (counterpart of paddle_tpu/obs/telemetry.py, copied: it is
plain Python).

Instruments are module-level objects created at import time by the
modules they measure (serving/paged.py, serving/preempt.py,
serving/speculative.py, serving/engine.py register their serving.* and
spec.* series here); recording on them is a no-op while telemetry is
disabled (`FLAGS_obs_dir` unset and enable() not called): one
module-global boolean check, no lock, no allocation.

When `FLAGS_obs_dir` is set the registry is enabled at import and an
exporter thread appends a full `snapshot()` line to
`<obs_dir>/metrics-<role>-<pid>.jsonl` every `FLAGS_obs_flush_secs`
seconds, plus a final line at interpreter exit.

Naming convention: dotted series names, subsystem first
(`serving.preemptions`, `spec.accept_rate`).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time

__all__ = ['Counter', 'Gauge', 'Histogram', 'counter', 'gauge',
           'histogram', 'hist_quantile', 'snapshot', 'flush',
           'enabled', 'enable', 'disable', 'reset']

_lock = threading.Lock()
_enabled = False
_counters = {}
_gauges = {}
_hists = {}
_exporter = None


class Counter(object):
    """Monotonic event count. inc() is the disabled-mode fast path the
    whole registry is designed around: one global bool read, return."""
    __slots__ = ('name', 'value')

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        if not _enabled:
            return
        with _lock:
            self.value += n


class Gauge(object):
    """Last-written level (queue depth, leaked workers)."""
    __slots__ = ('name', 'value')

    def __init__(self, name):
        self.name = name
        self.value = 0

    def set(self, v):
        if not _enabled:
            return
        with _lock:
            self.value = v


# exponential bucket bounds in seconds: 100us .. ~100s, x4 per bucket
# (step latencies and RPC round trips both land mid-range); the last
# bucket is the +Inf overflow
_BOUNDS = tuple(1e-4 * (4.0 ** i) for i in range(11))


class Histogram(object):
    """Bucketed distribution (fixed exponential bounds) + running
    count/sum/min/max — enough for a latency rollup without reservoir
    sampling."""
    __slots__ = ('name', 'count', 'sum', 'min', 'max', 'buckets')

    def __init__(self, name):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float('inf')
        self.max = 0.0
        self.buckets = [0] * (len(_BOUNDS) + 1)

    def observe(self, v):
        if not _enabled:
            return
        v = float(v)
        with _lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            i = 0
            for bound in _BOUNDS:
                if v <= bound:
                    break
                i += 1
            self.buckets[i] += 1


def hist_quantile(hist, q):
    """Estimate the q-quantile (0 < q <= 1) of a histogram given in
    snapshot-dict form ({'count','min','max','buckets'}). Linear
    interpolation inside the owning exponential bucket, clamped to the
    observed min/max so a single-sample histogram reports that sample
    exactly. Returns None for an empty histogram.

    Works on any snapshot of the registry (every histogram carries the
    same bucket layout)."""
    count = hist.get('count', 0)
    if not count:
        return None
    buckets = hist['buckets']
    mn = hist.get('min') or 0.0
    mx = hist.get('max', 0.0)
    rank = q * count
    cum = 0
    for i, n in enumerate(buckets):
        if n and cum + n >= rank:
            lo = _BOUNDS[i - 1] if i > 0 else 0.0
            hi = _BOUNDS[i] if i < len(_BOUNDS) else mx
            frac = (rank - cum) / n
            v = lo + frac * max(hi - lo, 0.0)
            return min(max(v, mn), mx)
        cum += n
    return mx


def _hist_dict(h):
    d = {'count': h.count, 'sum': h.sum,
         'min': (None if h.count == 0 else h.min),
         'max': h.max, 'buckets': list(h.buckets)}
    for key, q in (('p50', 0.50), ('p95', 0.95), ('p99', 0.99)):
        d[key] = hist_quantile(d, q)
    return d


def _get(table, cls, name):
    with _lock:
        inst = table.get(name)
        if inst is None:
            inst = table[name] = cls(name)
        return inst


def counter(name):
    return _get(_counters, Counter, name)


def gauge(name):
    return _get(_gauges, Gauge, name)


def histogram(name):
    return _get(_hists, Histogram, name)


def enabled():
    return _enabled


def snapshot():
    """One consistent dict of every registered series. Untouched series
    are included at zero — the rollup sums them away for free and the
    catalog stays visible in every export."""
    with _lock:
        return {
            'counters': {n: c.value for n, c in _counters.items()},
            'gauges': {n: g.value for n, g in _gauges.items()},
            'hists': {n: _hist_dict(h) for n, h in _hists.items()},
        }


def reset():
    """Zero every registered series IN PLACE (instrument objects are
    held by the instrumented modules — they must stay valid). Test
    isolation helper."""
    with _lock:
        for c in _counters.values():
            c.value = 0
        for g in _gauges.values():
            g.value = 0
        for h in _hists.values():
            h.count, h.sum, h.min, h.max = 0, 0.0, float('inf'), 0.0
            h.buckets = [0] * (len(_BOUNDS) + 1)


class _Exporter(object):
    """Daemon thread appending metric snapshots as JSONL."""

    def __init__(self, obs_dir, role, period):
        self.path = os.path.join(
            obs_dir, 'metrics-%s-%d.jsonl' % (role, os.getpid()))
        self.role = role
        self.period = max(float(period), 0.05)
        self._stop = threading.Event()
        self._wlock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(timeout=self.period):
            try:
                self.write_line()
            except OSError:
                pass   # a torn-down obs dir must not kill the process

    def write_line(self):
        rec = snapshot()
        rec['ts'] = time.time()
        rec['role'] = self.role
        rec['pid'] = os.getpid()
        line = json.dumps(rec) + '\n'
        with self._wlock:
            with open(self.path, 'a') as f:
                f.write(line)

    def stop(self, final_flush=True):
        self._stop.set()
        self._thread.join(timeout=5.0)
        if final_flush:
            try:
                self.write_line()
            except OSError:
                pass


def flush():
    """Force a metric-snapshot line now."""
    if _exporter is not None:
        _exporter.write_line()


def _default_role():
    from ..flags import get_flag
    return get_flag('obs_role', '') or ('pid%d' % os.getpid())


def enable(obs_dir=None, role=None, period=None):
    """Turn recording on; with an obs_dir, also start the JSONL
    exporter. Idempotent; re-enabling with a different dir retargets
    the exporter (test harnesses toggle this per-case)."""
    global _enabled, _exporter
    from ..flags import get_flag
    disable(final_flush=False)
    _enabled = True
    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        _exporter = _Exporter(
            obs_dir, role or _default_role(),
            period if period is not None
            else float(get_flag('obs_flush_secs', 2.0)))


def disable(final_flush=True):
    global _enabled, _exporter
    _enabled = False
    if _exporter is not None:
        _exporter.stop(final_flush=final_flush)
        _exporter = None


@atexit.register
def _atexit_flush():
    if _exporter is not None:
        try:
            _exporter.stop()
        except Exception:
            pass


def _bootstrap_from_flags():
    """Enabled-at-import when FLAGS_obs_dir is set (the Supervisor
    plants it in each role's environment) — worker processes need no
    code changes to start exporting."""
    from ..flags import get_flag
    obs_dir = get_flag('obs_dir', '')
    if obs_dir:
        enable(obs_dir)


_bootstrap_from_flags()
