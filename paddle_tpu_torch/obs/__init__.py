"""Observability (counterpart of paddle_tpu/obs/):

- `obs.telemetry`: process-wide Counters / Gauges / Histograms with a
  near-free disabled path, `snapshot()`, and periodic JSONL export.
- `obs.trace`: spans, fault and SLO-breach events in one per-process
  JSONL event log.
- `obs.report`: merges the per-role logs into one chrome://tracing
  timeline (clock offsets from RPC span midpoints) plus a metrics
  rollup, with device lanes from a fluid.profiler trace
  (`write_report(xplane_dir=, hlo_dir=)`).
- `obs.perf`: capture (the card's compile) telemetry
  (xla.compile spans, xla.compile_latency, xla.jit_cache.{hit,miss}),
  per-step perf.step_latency / perf.mfu / perf.achieved_tflops, and the
  hbm.* device-memory gauges; wired into Executor/ParallelExecutor.
- `obs.slo`: declarative threshold rules over the registry, evaluated by
  a watchdog that emits slo.breach events (the serving engine owns one;
  training arms one from perf.step_end).

Everything is off unless `FLAGS_obs_dir` is set (or enable() is called).
"""
from . import telemetry, trace, report, perf, slo

__all__ = ['telemetry', 'trace', 'report', 'perf', 'slo']
