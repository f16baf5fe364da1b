"""Device-side performance observatory: capture telemetry, live MFU and
device-memory watermarks (counterpart of paddle_tpu/obs/perf.py; the
series names are the JAX package's, `xla.*` included, so SLO rules and
rollups carry over unchanged).

The Executor reports into it at two points:

- compile time (`record_compile` / `jit_cache_miss` / `jit_cache_hit`).
  On the card "compile" means "capture": a device segment's first run
  with a signature of its run-local inputs is the eager warm-up (a
  miss), its second run captures it as a CUDA graph; `compile_span`
  wraps both, and `record_compile` observes `xla.compile_latency` once,
  at the capture, with the two runs' time. On the CPU, where nothing is
  captured, the warm-up is the compile. Every later run of the segment
  is a hit. The segment's work model (FLOPs) is counted during its
  warm-up (`segment_cost`) and summed onto the owning PreparedProgram's
  `cost_flops`, so step attribution below has a work model to divide by.
- step time (`step_begin` / `step_end`) around each `Executor.run`: its
  wall latency lands in `perf.step_latency`; with the FLOP count it
  gives `perf.achieved_tflops` and `perf.mfu`. A `return_numpy=True`
  fetch has already synchronised through its host copy; otherwise
  step_end synchronises on the fetched tensors' streams first (disable
  with `FLAGS_perf_sync_steps=0` to time an asynchronous window
  instead).

The FLOP count: XLA's cost analysis has no PyTorch twin, so the warm-up
runs under torch.utils.flop_counter.FlopCounterMode (matmuls and
convolutions, forward and grads). The mode does not see the hand-written
kernels, so the flash_attention op and its grads are priced by the
attention work model (kernels/flash_attention.py `priced`), and the
twopass arm's second q·kᵀ sweep is drained from `take_extra_flops`, as
the JAX package prices its Pallas calls (`pallas_extra_flops`). The mode
is active during the warm-up only, never while a graph captures.

Every hook is a no-op while telemetry is disabled (one module-global
boolean), so the executor pays nothing by default; counting FLOPs is the
one cost of turning it on (the warm-up runs its ops through Python
dispatch).

MFU needs a peak-FLOPs denominator: the card's dense bf16 peak, looked
up by torch.cuda.get_device_name (`_PEAK_BF16`), or
`FLAGS_perf_peak_tflops` (the only way to get a nonzero MFU on the CPU
or on a card not in the table).

Device-memory gauges (`hbm.bytes_in_use`, `hbm.peak_bytes`,
`hbm.bytes_limit`, `hbm.scope_bytes`, `hbm.watermark_bytes`) are
refreshed on every step_end from memory.hbm_snapshot(): the caching
allocator's allocated bytes on the card, the scope footprint on the CPU.
`hbm.watermark_bytes` is a process-local high-water mark that survives
allocator-level peak resets.
"""
from __future__ import annotations

import time

import torch

from . import telemetry, trace
from .. import flags

__all__ = ['enabled', 'step_begin', 'step_end', 'jit_cache_hit',
           'jit_cache_miss', 'record_compile', 'segment_cost',
           'kernel_extra_flops', 'device_peak_flops', 'update_hbm',
           'compile_span']

# --- instruments (registered at import; zero until enabled) ---------
_compile_latency = telemetry.histogram('xla.compile_latency')
_jit_hits = telemetry.counter('xla.jit_cache.hit')
_jit_misses = telemetry.counter('xla.jit_cache.miss')
_step_latency = telemetry.histogram('perf.step_latency')
_steps = telemetry.counter('perf.steps')
_mfu = telemetry.gauge('perf.mfu')
_achieved_tflops = telemetry.gauge('perf.achieved_tflops')
_hbm_in_use = telemetry.gauge('hbm.bytes_in_use')
_hbm_peak = telemetry.gauge('hbm.peak_bytes')
_hbm_limit = telemetry.gauge('hbm.bytes_limit')
_hbm_scope = telemetry.gauge('hbm.scope_bytes')
_hbm_watermark = telemetry.gauge('hbm.watermark_bytes')

_watermark = 0          # process-local high-water of bytes_in_use
_slo_started = False    # lazy FLAGS_slo_rules watchdog, armed once

# Dense bf16 peak FLOP/s by device-name prefix (longest prefix wins):
# the H100 SXM's 989.4 TFLOP/s, the figure chip_smoke.py's MFU uses.
_PEAK_BF16 = {
    'NVIDIA H100 80GB HBM3': 989.4e12,
}


def enabled():
    return telemetry._enabled


def device_peak_flops(device=None):
    """Peak dense bf16 FLOP/s for MFU attribution: the
    FLAGS_perf_peak_tflops override if set (TFLOP/s; the only way to
    get a nonzero MFU on the CPU), else the card's entry in _PEAK_BF16,
    else 0.0 (the MFU gauge stays unset)."""
    override = float(flags.get_flag('perf_peak_tflops', 0.0))
    if override > 0.0:
        return override * 1e12
    if device is None or torch.device(device).type != 'cuda':
        return 0.0
    kind = torch.cuda.get_device_name(device)
    best, best_len = 0.0, -1
    for prefix, peak in _PEAK_BF16.items():
        if kind.startswith(prefix) and len(prefix) > best_len:
            best, best_len = peak, len(prefix)
    return best


# --- compile-time hooks ---------------------------------------------

def jit_cache_hit():
    _jit_hits.inc()


def jit_cache_miss():
    _jit_misses.inc()


def compile_span(fingerprint, segment, n_ops, **attrs):
    """Trace span around a device segment's warm-up or capture. The
    program fingerprint tag lets a timeline reader join the span to the
    jit_cache series."""
    return trace.span('xla.compile', fingerprint=fingerprint,
                      segment=segment, n_ops=n_ops, **attrs)


def record_compile(latency_s):
    _compile_latency.observe(latency_s)


def kernel_extra_flops():
    """Drain the extra-work notes of the hand-written kernels (the
    twopass forward's second q·kᵀ sweep): work that ran but that the
    2-matmul attention model does not count. Draining is destructive;
    callers that only want to discard stale notes ignore the return."""
    from ..kernels import flash_attention as fa
    return float(fa.take_extra_flops())


def segment_cost(run):
    """Run `run()` (a segment's warm-up) under FlopCounterMode and
    return its FLOPs: the matmuls and convolutions the mode sees,
    forward and grads, plus the flash_attention op and its grads priced
    by the attention work model and the kernels' extra work. (XLA's cost
    analysis also gives the bytes accessed; nothing here counts them.)"""
    from torch.utils.flop_counter import FlopCounterMode
    from ..kernels import flash_attention as fa
    kernel_extra_flops()     # discard notes left by work outside run()
    with fa.priced() as model, FlopCounterMode(display=False) as counter:
        run()
    return (float(counter.get_total_flops()) + model.flops
            + kernel_extra_flops())


# --- step-time hooks ------------------------------------------------

def step_begin():
    """Start-of-run timestamp, or None when telemetry is off (the
    executor passes the None straight back to step_end's guard)."""
    if not telemetry._enabled:
        return None
    return time.perf_counter()


def _synchronize(results):
    """Wait for the streams that produce the fetched CUDA tensors."""
    devices = {r.device for r in results
               if isinstance(r, torch.Tensor) and r.device.type == 'cuda'}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def step_end(t0, prepared=None, device=None, scope=None, sync=None):
    """Close out one Executor.run: observe the step latency, derive
    achieved TFLOP/s and MFU from the prepared program's FLOP count,
    refresh the hbm.* gauges, and (once) arm the FLAGS_slo_rules
    watchdog.

    `sync` is the fetched result list when the caller did NOT request
    numpy (the timer must wait for the card first); None means the host
    fetch already synchronised."""
    if t0 is None or not telemetry._enabled:
        return
    if sync is not None and flags.get_flag('perf_sync_steps', True):
        _synchronize(sync)
    dt = time.perf_counter() - t0
    _step_latency.observe(dt)
    _steps.inc()
    flops = float(getattr(prepared, 'cost_flops', 0.0) or 0.0)
    if dt > 0.0 and flops > 0.0:
        achieved = flops / dt
        _achieved_tflops.set(achieved / 1e12)
        peak = device_peak_flops(device)
        if peak > 0.0:
            _mfu.set(achieved / peak)
    update_hbm(device=device, scope=scope)
    _maybe_start_slo()


def update_hbm(device=None, scope=None):
    """Export memory.hbm_snapshot() as gauges + the process-local
    watermark. Callable standalone, between the steps of a hand-rolled
    loop."""
    global _watermark
    if not telemetry._enabled:
        return
    from .. import memory
    try:
        snap = memory.hbm_snapshot(device=device, scope=scope)
    except Exception:
        return
    _hbm_in_use.set(snap['bytes_in_use'])
    _hbm_peak.set(snap['peak_bytes'])
    _hbm_limit.set(snap['bytes_limit'])
    _hbm_scope.set(snap['scope_bytes'])
    if snap['bytes_in_use'] > _watermark:
        _watermark = snap['bytes_in_use']
    if snap['peak_bytes'] > _watermark:
        _watermark = snap['peak_bytes']
    _hbm_watermark.set(_watermark)


def _maybe_start_slo():
    """The first instrumented step arms the declarative SLO watchdog
    when FLAGS_slo_rules is set: training runs get breach events
    without the serving engine's explicit start()/stop() wiring."""
    global _slo_started
    if _slo_started:
        return
    _slo_started = True
    if not flags.get_flag('slo_rules', ''):
        return
    from . import slo
    slo.maybe_start_global()


def _reset_for_tests():
    """Zero the module-local state telemetry.reset() can't see."""
    global _watermark, _slo_started
    _watermark = 0
    _slo_started = False
