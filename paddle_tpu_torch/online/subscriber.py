"""ParamSubscriber: the serving side of the online-learning loop
(counterpart of paddle_tpu/online/subscriber.py).

The refresh cycle, per newly published version:

  1. GET_VERSION (manifest=True) against every pserver — learns each
     shard's hosted param blocks, their digests, and the version they
     belong to. Versions are per-shard; `published` is the newest any
     shard reports and `staleness_rounds` measures installed vs that.
  2. GET_VARS fan-out — ONE multi-var frame per pserver over the
     pipelined client (all shards pull concurrently); each shard's
     params are read atomically under the service lock and arrive
     stamped with per-param digests + the version they were read at.
  3. Verify — every pulled value is re-serialized locally and its
     crc32 compared against the shard-stamped digest: end-to-end
     integrity independent of the frame CRC (a corrupt pull is
     detected even if transport framing survived).
  4. Stage — row blocks (`<param>.block<k>`, the DistributeTranspiler
     slicing) reassemble by dim-0 concat of the CPU tensors the wire
     decoded, then stage_weights validates names/shapes and copies
     them to the device OFF the decode path (the one host-to-device
     copy of a refresh; nothing goes through numpy).
  5. Install — ServingEngine.request_swap runs install_weights between
     two decode steps: in-flight steps finish on the old weights, the
     next step reads the new ones.

Any failure (unreachable shard, failed digest, timeout) abandons the
cycle WITHOUT touching the installed weights — the old verified
version keeps serving, and the next poll retries from scratch
(checkpoint/restore.py's quarantine-and-fall-back discipline applied
to live refresh). Subscriber RPC traffic runs in the serving client-id
range (rpc.SERVING_TID_BASE), so its dedup/replay space never collides
with a co-located trainer's.

Telemetry: serving.param_version / serving.staleness_rounds gauges,
online.refresh_latency / online.refresh_bytes hists,
online.refreshes / online.refresh_failures counters, and an
online.refresh span per attempt. An SLO rule like
{"name": "staleness", "metric": "serving.staleness_rounds",
 "kind": "gauge_max", "threshold": 3} pages when refresh stalls.
"""
from __future__ import annotations

import threading
import time

import torch

from ..flags import get_flag
from ..integrity import crc32
from ..obs import telemetry as _tm
from ..obs import trace as _trace

__all__ = ['ParamSubscriber', 'RefreshError']

_installed_version = _tm.gauge('serving.param_version')
_staleness = _tm.gauge('serving.staleness_rounds')
_refresh_latency = _tm.histogram('online.refresh_latency')
_refresh_bytes = _tm.histogram('online.refresh_bytes')
_refreshes = _tm.counter('online.refreshes')
_refresh_failures = _tm.counter('online.refresh_failures')


class RefreshError(RuntimeError):
    """One refresh cycle failed (pull, digest, shape, or timeout) —
    the previously installed version is untouched and still serving."""


def _origin_of(name):
    """pserver block name -> (origin param name, block index).
    Unsplit params carry no suffix and map to block 0 of themselves."""
    if '.block' in name:
        base, idx = name.rsplit('.block', 1)
        if idx.isdigit():
            return base, int(idx)
    return name, 0


def _as_tensor(value):
    """A pulled value as a CPU tensor: the wire decodes tensors; a
    numpy array (an in-process caller's) is wrapped without a copy."""
    if isinstance(value, torch.Tensor):
        return value
    import numpy as np
    return torch.from_numpy(np.ascontiguousarray(value))


class ParamSubscriber(object):
    def __init__(self, endpoints, predictor, engine=None,
                 subscriber_id=0, poll_secs=None, pull_timeout=None):
        """endpoints: the pserver fleet (the transpile's
        pserver_endpoints). predictor: the serving DecodePredictor
        whose parent scope receives installs. engine: the
        ServingEngine whose step boundary gates installs (None: direct
        install — single-threaded/benchmark use). subscriber_id:
        disambiguates multiple subscribers in one process (each gets
        its own serving-range client per endpoint)."""
        self.endpoints = [e.strip() for e in endpoints if e.strip()]
        if not self.endpoints:
            raise ValueError('ParamSubscriber needs at least one '
                             'pserver endpoint')
        self._predictor = predictor
        self._engine = engine
        self._subscriber_id = int(subscriber_id)
        self.poll_secs = float(poll_secs if poll_secs is not None
                               else get_flag('online_poll_secs', 0.5))
        self.pull_timeout = float(
            pull_timeout if pull_timeout is not None
            else get_flag('online_pull_timeout', 30.0))
        self.installed_version = 0
        self.published_version = 0
        self.refreshes = 0
        self.failures = 0
        self.last_error = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._paused = False
        self._thread = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Arm the background poll loop (idempotent)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._poll_loop,
                                        name='param-subscriber',
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def pause(self):
        """Freeze installs (maintenance window): the poll loop keeps
        measuring published versions — so staleness keeps climbing and
        the SLO rule can page — but nothing is pulled or installed."""
        self._paused = True

    def resume(self):
        self._paused = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- introspection -----------------------------------------------------
    def staleness_rounds(self):
        return max(0, self.published_version - self.installed_version)

    def stats(self):
        return {'installed_version': self.installed_version,
                'published_version': self.published_version,
                'staleness_rounds': self.staleness_rounds(),
                'refreshes': self.refreshes,
                'failures': self.failures,
                'last_error': self.last_error}

    # -- refresh machinery -------------------------------------------------
    def _client(self, ep):
        # re-acquired from the pool every cycle: a client that
        # exhausted its retry budget mid-pull evicted itself, and the
        # next cycle must start on a fresh connection, not the corpse
        from ..distributed import rpc
        return rpc.get_serving_client(ep, self._subscriber_id)

    def poll_published(self, with_manifest=False):
        """Ask every shard for its published version (concurrently);
        updates published_version + the staleness gauge. Returns the
        per-endpoint reply metas."""
        futs = [(ep, self._client(ep).get_version_async(with_manifest))
                for ep in self.endpoints]
        deadline = time.monotonic() + self.pull_timeout
        out = {}
        for ep, fut in futs:
            out[ep] = fut.result(max(0.1, deadline - time.monotonic()))
        with self._lock:
            self.published_version = max(
                [int(r.get('version', 0)) for r in out.values()]
                + [self.published_version])
            _staleness.set(self.staleness_rounds())
        return out

    def refresh_once(self):
        """One full refresh cycle; returns the newly installed version.
        Raises RefreshError (installed weights untouched) on any
        failure."""
        t0 = time.monotonic()
        try:
            with _trace.span('online.refresh', kind='serving',
                             endpoints=len(self.endpoints)):
                version = self._refresh()
        except Exception as e:
            with self._lock:
                self.failures += 1
                self.last_error = repr(e)
            _refresh_failures.inc()
            if isinstance(e, RefreshError):
                raise
            raise RefreshError('refresh failed: %r' % e) from e
        with self._lock:
            self.refreshes += 1
            self.installed_version = version
            self.last_error = None
            _installed_version.set(version)
            _staleness.set(self.staleness_rounds())
        _refresh_latency.observe(time.monotonic() - t0)
        return version

    def _refresh(self):
        from ..distributed import wire
        deadline = time.monotonic() + self.pull_timeout
        manifests = self.poll_published(with_manifest=True)

        # fan the shard pulls out over the pipelined clients, one
        # GET_VARS frame per pserver, then collect
        futs = []
        for ep in self.endpoints:
            names = sorted(manifests[ep].get('manifest', {}))
            if not names:
                continue
            futs.append((ep, self._client(ep).get_vars_async(names)))
        if not futs:
            raise RefreshError(
                'no pserver published a param manifest — was the '
                'service built with param_names? (pre-online pservers '
                'cannot feed a subscriber)')
        pulled = {}              # block name -> CPU tensor
        versions = []
        nbytes = 0
        for ep, fut in futs:
            version, entries, values = fut.result(
                max(0.1, deadline - time.monotonic()))
            versions.append(int(version))
            for e, value in zip(entries, values):
                # end-to-end digest check: re-serialize the received
                # value and compare with the crc the shard stamped
                # under the same lock hold as the read
                _, payload = wire._payload_of(value)
                if 'digest' in e and crc32(payload) != int(e['digest']):
                    raise RefreshError(
                        'digest mismatch on %r from %s (version %s): '
                        'corrupt pull — keeping the installed version'
                        % (e.get('name'), ep, version))
                pulled[e['name']] = value
                nbytes += len(payload)

        staged = self._stage(pulled)
        # install is the ONLY step that touches serving state, and it
        # runs at a step boundary: a failure anywhere above left the
        # old weights fully intact
        install = self._predictor.install_weights
        if self._engine is not None:
            self._engine.request_swap(lambda: install(staged))
        else:
            install(staged)
        _refresh_bytes.observe(nbytes)
        # a shard that answered with a newer version than its peers
        # leaves a mixed-version install (the reference's async-update
        # tolerance); report the OLDEST contributing version so
        # staleness never under-counts
        return min(versions)

    def _stage(self, pulled):
        """Reassemble transpiler row blocks into origin params and
        stage them on device. Block k of a split param is rows
        [offset_k, offset_k + rows_k) — dim-0 concat in block order
        (distribute_transpiler._slice_params); gaps mean a shard's
        manifest was incomplete and fail the refresh."""
        served = set(self._predictor.param_names())
        groups = {}
        for name, value in pulled.items():
            base, idx = _origin_of(name)
            groups.setdefault(base, {})[idx] = value
        assembled, skipped = {}, []
        for base, blocks in groups.items():
            if base not in served:
                # pservers may host params the decode program never
                # references (e.g. a distributed lookup table the
                # serving graph replaced) — not an error, just not ours
                skipped.append(base)
                continue
            if set(blocks) != set(range(len(blocks))):
                raise RefreshError(
                    'param %r arrived with non-contiguous blocks %s'
                    % (base, sorted(blocks)))
            if len(blocks) == 1:
                assembled[base] = _as_tensor(blocks[0])
            else:
                assembled[base] = torch.cat(
                    [_as_tensor(blocks[i]) for i in range(len(blocks))],
                    dim=0)
        missing = served - set(assembled)
        if missing:
            raise RefreshError(
                'refresh is missing served params %s (pulled %d, '
                'skipped %s)' % (sorted(missing)[:8], len(assembled),
                                 skipped[:8]))
        return self._predictor.stage_weights(assembled)

    # -- poll loop ---------------------------------------------------------
    def _poll_loop(self):
        while not self._stop.wait(timeout=self.poll_secs):
            try:
                self.poll_published()
                if self._paused:
                    continue
                if self.published_version > self.installed_version:
                    self.refresh_once()
            except Exception:
                # the poll loop must outlive transient cluster trouble
                # (pservers restarting, refresh failures): stats() and
                # the failure counter carry the evidence
                continue
