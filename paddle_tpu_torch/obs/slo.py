"""Declarative SLO rules evaluated live against the telemetry
registry (counterpart of paddle_tpu/obs/slo.py, copied: it is plain
Python).

A rule names one metric series, a comparison kind, and a threshold:

    {"name": "mfu_floor",    "metric": "perf.mfu",
     "kind": "gauge_min",    "threshold": 0.45}
    {"name": "step_p99",     "metric": "perf.step_latency",
     "kind": "p99_max",      "threshold": 0.250, "min_count": 20}
    {"name": "ttft",         "metric": "serving.ttft",
     "kind": "p95_max",      "threshold": 1.5}
    {"name": "tokens_floor", "metric": "serving.tokens_generated",
     "kind": "rate_min",     "threshold": 100.0}

Kinds:
  gauge_min / gauge_max      — last-written gauge level vs threshold
  p50_max / p95_max / p99_max— histogram percentile (exponential-
                               bucket estimate, telemetry.hist_quantile)
  mean_max                   — histogram sum/count
  rate_min / rate_max        — counter delta per second between two
                               consecutive checks (first check only
                               primes the baseline)

`min_count` (default 1) suppresses judgement until a histogram has
that many observations / a gauge-family rule sees a nonzero snapshot
— a cold registry should not page anyone.

The watchdog re-evaluates every FLAGS_slo_check_secs from a daemon
thread (`SLOWatchdog.start()`), or on demand (`check_now()`).
A breach emits a `slo.breach` instant event into the trace stream
(rule, metric, observed value, threshold — it lands on the merged
timeline next to whatever caused it) and bumps the `slo.breaches`
counter; `slo.breaching` holds the number of currently-failing rules.

Wiring: serving.ServingEngine.start()/stop() own a watchdog when
FLAGS_slo_rules is set; training runs arm one lazily from
obs.perf.step_end. FLAGS_slo_rules is either inline JSON (a list of
rule dicts) or `@/path/to/rules.json`.
"""
from __future__ import annotations

import json
import threading
import time

from . import telemetry, trace
from .. import flags

__all__ = ['SLORule', 'SLOWatchdog', 'parse_rules',
           'watchdog_from_flags', 'maybe_start_global', 'stop_global']

_breaches = telemetry.counter('slo.breaches')
_breaching = telemetry.gauge('slo.breaching')

_GAUGE_KINDS = ('gauge_min', 'gauge_max')
_HIST_KINDS = ('p50_max', 'p95_max', 'p99_max', 'mean_max')
_RATE_KINDS = ('rate_min', 'rate_max')
_KINDS = _GAUGE_KINDS + _HIST_KINDS + _RATE_KINDS


class SLORule(object):
    """One named threshold over one telemetry series."""

    def __init__(self, name, metric, kind, threshold, min_count=1):
        if kind not in _KINDS:
            raise ValueError('unknown SLO kind %r (one of %s)'
                             % (kind, ', '.join(_KINDS)))
        self.name = name
        self.metric = metric
        self.kind = kind
        self.threshold = float(threshold)
        self.min_count = int(min_count)

    @classmethod
    def from_dict(cls, d):
        return cls(d['name'], d['metric'], d['kind'], d['threshold'],
                   d.get('min_count', 1))

    def to_dict(self):
        return {'name': self.name, 'metric': self.metric,
                'kind': self.kind, 'threshold': self.threshold,
                'min_count': self.min_count}

    def evaluate(self, snap, prev=None, dt=None):
        """(observed_value, breached) against one registry snapshot,
        or None when the rule can't be judged yet (series absent,
        min_count unmet, no rate baseline)."""
        kind = self.kind
        if kind in _GAUGE_KINDS:
            if self.metric not in snap['gauges']:
                return None
            v = float(snap['gauges'][self.metric])
            if kind == 'gauge_min':
                return (v, v < self.threshold)
            return (v, v > self.threshold)
        if kind in _HIST_KINDS:
            h = snap['hists'].get(self.metric)
            if not h or h['count'] < self.min_count:
                return None
            if kind == 'mean_max':
                v = h['sum'] / h['count']
            else:
                q = {'p50_max': 0.50, 'p95_max': 0.95,
                     'p99_max': 0.99}[kind]
                v = telemetry.hist_quantile(h, q)
                if v is None:
                    return None
            return (v, v > self.threshold)
        # rate kinds: counter delta / wall delta between two checks
        if (prev is None or not dt or dt <= 0.0
                or self.metric not in snap['counters']
                or self.metric not in prev.get('counters', {})):
            return None
        delta = snap['counters'][self.metric] - \
            prev['counters'][self.metric]
        if delta < self.min_count:
            return None
        rate = delta / dt
        if kind == 'rate_min':
            return (rate, rate < self.threshold)
        return (rate, rate > self.threshold)


def parse_rules(spec):
    """Rule list from inline JSON, `@path`, a *.json path, or an
    already-materialized list of dicts/SLORules."""
    if not spec:
        return []
    if isinstance(spec, str):
        spec = spec.strip()
        if spec.startswith('@'):
            with open(spec[1:]) as f:
                spec = json.load(f)
        elif spec.endswith('.json') and not spec.startswith('['):
            with open(spec) as f:
                spec = json.load(f)
        else:
            spec = json.loads(spec)
    if isinstance(spec, dict):
        spec = [spec]
    out = []
    for r in spec:
        out.append(r if isinstance(r, SLORule)
                   else SLORule.from_dict(r))
    return out


class SLOWatchdog(object):
    """Periodic evaluator over a rule set. check_now() is also the
    test/serving-drain entry point — it is safe without start()."""

    def __init__(self, rules, period=None):
        self.rules = list(rules)
        self.period = float(period if period is not None
                            else flags.get_flag('slo_check_secs', 5.0))
        self._prev_snap = None
        self._prev_ts = None
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    def check_now(self):
        """Evaluate every rule against a fresh snapshot; emit a
        slo.breach trace event per failing rule. Returns the breach
        list: [{'rule','metric','kind','value','threshold'}, ...]."""
        with self._lock:
            snap = telemetry.snapshot()
            now = time.time()
            prev, dt = self._prev_snap, None
            if self._prev_ts is not None:
                dt = now - self._prev_ts
            self._prev_snap, self._prev_ts = snap, now
            breaches = []
            for rule in self.rules:
                res = rule.evaluate(snap, prev=prev, dt=dt)
                if res is None:
                    continue
                value, breached = res
                if not breached:
                    continue
                breach = {'rule': rule.name, 'metric': rule.metric,
                          'kind': rule.kind, 'value': value,
                          'threshold': rule.threshold}
                breaches.append(breach)
                trace.event('slo.breach', **breach)
                _breaches.inc()
            _breaching.set(len(breaches))
            return breaches

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(timeout=self.period):
            try:
                self.check_now()
            except Exception:
                pass    # the watchdog must never take the host down

    def stop(self, final_check=True):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if final_check:
            try:
                self.check_now()
            except Exception:
                pass


def watchdog_from_flags():
    """SLOWatchdog built from FLAGS_slo_rules / FLAGS_slo_check_secs,
    or None when no rules are configured (the universal default)."""
    rules = parse_rules(flags.get_flag('slo_rules', ''))
    if not rules:
        return None
    return SLOWatchdog(rules)


_global = None
_global_lock = threading.Lock()


def maybe_start_global():
    """Idempotent process-wide watchdog from flags (training path —
    obs.perf arms this on the first instrumented step)."""
    global _global
    with _global_lock:
        if _global is not None:
            return _global
        wd = watchdog_from_flags()
        if wd is None:
            return None
        _global = wd.start()
        return _global


def stop_global():
    global _global
    with _global_lock:
        wd, _global = _global, None
    if wd is not None:
        wd.stop()
