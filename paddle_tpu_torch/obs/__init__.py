"""Observability (counterpart of paddle_tpu/obs/, telemetry only):

- `obs.telemetry`: process-wide Counters / Gauges / Histograms with a
  near-free disabled path, `snapshot()`, and periodic JSONL export
  when `FLAGS_obs_dir` is set.

The JAX package's trace spans, cluster report, device perf observatory
and SLO watchdog are not ported (ROADMAP.md).
"""
from . import telemetry

__all__ = ['telemetry']
