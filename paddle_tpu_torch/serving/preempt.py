"""Preempt-first capacity: SLO-tiered preemption policy + host swap
(counterpart of paddle_tpu/serving/preempt.py, copied: plain Python).

The vLLM-style answer to page-pool exhaustion: when
HBM pages run dry mid-decode or mid-prefill, the engine no longer
sheds the victim stream — it PREEMPTS the lowest-tier longest-idle
stream instead, so overload costs latency for low-tier work, never
availability for anyone. Two resume paths:

  swap       PagePool.save_pages copies the victim's pages to host RAM
             (float32 bytes copy exactly); on resume, restore_pages
             writes them back onto freshly allocated pages and the
             stream continues from its exact position. Host memory is
             bounded by FLAGS_serving_swap_host_mb (HostSwapBudget) —
             past the budget the preemption degrades to re-prefill.
  reprefill  pages are simply dropped; greedy determinism means the
             stream is fully described by (prompt + tokens so far), so
             re-admission re-prefills that sequence and the final
             chunk's output token IS the next stream token (the prefix
             cache makes it nearly free). The re-prefill computes the
             stream's K/V in other chunks than the first pass did, so on
             the card its logits may differ in the last bits: a resumed
             stream equals the unpreempted one, or differs first where
             the two best logits are a near tie.

This module holds the policy pieces the engine composes: victim
selection, the host-RAM budget, and the serving.* preemption
telemetry. The mechanics live where the state lives —
PagePool.save_pages/restore_pages in paging.py,
save_stream/restore_stream on the paged predictors, and the
tier-queue scheduling in engine.py.

Telemetry: serving.preemptions / serving.swapped_pages /
serving.swap_bytes counters, serving.resume_latency histogram
(preempt -> back in a slot, seconds), serving.preempted_streams gauge
(currently swapped/dropped streams waiting to resume).
"""
from __future__ import annotations

import threading

from ..flags import get_flag
from ..obs import telemetry

__all__ = ['HostSwapBudget', 'pick_victim', 'preempt_policy']

preemptions = telemetry.counter('serving.preemptions')
swapped_pages = telemetry.counter('serving.swapped_pages')
swap_bytes = telemetry.counter('serving.swap_bytes')
resume_latency = telemetry.histogram('serving.resume_latency')
preempted_streams = telemetry.gauge('serving.preempted_streams')


def preempt_policy():
    """The validated FLAGS_serving_preempt_policy value."""
    policy = str(get_flag('serving_preempt_policy') or 'swap').lower()
    if policy not in ('swap', 'reprefill', 'off'):
        raise ValueError("FLAGS_serving_preempt_policy must be 'swap', "
                         "'reprefill' or 'off', got %r" % policy)
    return policy


def pick_victim(lanes, below=None):
    """The slot to preempt: lowest tier first, longest idle (oldest
    last-token activity) within a tier. Only READY lanes qualify — a
    mid-prefill lane has its own requeue path and nothing worth
    swapping. `below` restricts candidates to tiers strictly under it
    (a prefilling stream only preempts strictly lower-tier work, so
    equal-tier streams never thrash each other). Returns None when no
    lane qualifies."""
    cands = [(lane.req.priority, lane.last_active, slot)
             for slot, lane in lanes.items()
             if lane.ready and (below is None or lane.req.priority < below)]
    if not cands:
        return None
    return min(cands)[2]


class HostSwapBudget(object):
    """FLAGS_serving_swap_host_mb accounting, shared by every worker of
    one engine (host RAM is a process resource, unlike the per-worker
    page pools). reserve() is all-or-nothing: a swap that does not fit
    degrades to the re-prefill path instead of growing host memory
    unboundedly."""

    def __init__(self, limit_mb=None):
        limit_mb = (get_flag('serving_swap_host_mb')
                    if limit_mb is None else limit_mb)
        self.limit_bytes = int(float(limit_mb) * (1 << 20))
        self._used = 0
        self._mu = threading.Lock()

    @property
    def used_bytes(self):
        return self._used

    def reserve(self, nbytes):
        """Take `nbytes` of budget; False (nothing taken) when it does
        not fit."""
        nbytes = int(nbytes)
        with self._mu:
            if self._used + nbytes > self.limit_bytes:
                return False
            self._used += nbytes
            return True

    def release(self, nbytes):
        with self._mu:
            self._used = max(0, self._used - int(nbytes))
