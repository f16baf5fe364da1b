"""LMServer: the user-facing serving surface (counterpart of
paddle_tpu/serving/api.py).

Construct from a saved-model directory (or an AnalysisPredictor, or a
prepared DecodePredictor), then either block in generate() or go async
with submit()/poll()/result()/cancel(). One ServingEngine runs
underneath. With no place the model loads on CUDAPlace(0); a machine
without a card raises (pass place=CPUPlace()).

    with LMServer(model_dir, slots=8) as srv:
        out = srv.generate([1, 2, 3], max_new_tokens=32, eos_id=2)
        h = srv.submit([4, 5], max_new_tokens=8)
        tokens = srv.result(h)
"""
from __future__ import annotations

from .decode import DecodePredictor
from .engine import ServingEngine

__all__ = ['LMServer']


class LMServer(object):
    def __init__(self, model_dir_or_predictor, place=None, slots=None,
                 prefill_batch=None, workers=1, max_queue=None,
                 paged=False, page_tokens=None, kv_pages=None,
                 prefill_chunk=None, speculative=False, spec_k=None,
                 draft_layers=None, mesh=None):
        """model_dir_or_predictor: a save_inference_model directory, an
        AnalysisPredictor, or an already-prepared DecodePredictor.
        paged=True serves from the page-pool cache (serving/paged.py):
        copy-on-write prefix sharing plus chunked prefill, sized by
        page_tokens / kv_pages / prefill_chunk (each None defaults from
        FLAGS_serving_*). speculative=True (implies paged) serves
        through draft/verify speculation (serving/speculative.py);
        spec_k / draft_layers default from FLAGS_spec_*. mesh (None:
        FLAGS_serve_mesh_shape; '' = one device; 'tp=2') serves over a
        mesh of rank processes (serving/mesh.py); stats() carries its
        mesh_shape and mesh_devices. close() releases the predictors
        this server made (their ranks exit with the last user)."""
        obj = model_dir_or_predictor
        self._owns_decode = not isinstance(obj, DecodePredictor)
        if isinstance(obj, DecodePredictor):
            dec = obj
        else:
            if isinstance(obj, str):
                from ..inference import AnalysisConfig, AnalysisPredictor
                obj = AnalysisPredictor(AnalysisConfig(obj, place=place))
            dec = obj.prepare_decoding(
                slots=slots, prefill_batch=prefill_batch, paged=paged,
                page_tokens=page_tokens, kv_pages=kv_pages,
                prefill_chunk=prefill_chunk, speculative=speculative,
                spec_k=spec_k, draft_layers=draft_layers, mesh=mesh)
        self._decode = dec
        self._engine = ServingEngine(dec, workers=workers,
                                     max_queue=max_queue)
        self._requests = {}
        self._subscriber = None
        self._engine.start()

    # -- online refresh ----------------------------------------------------
    def enable_refresh(self, endpoints, subscriber_id=0, poll_secs=None,
                       pull_timeout=None, start=True, paused=False):
        """Attach a ParamSubscriber (online/): serving tracks the
        pserver fleet's published param versions and installs fresh
        weights at decode step boundaries. Returns the
        subscriber (started unless start=False). paused=True starts the
        poll loop but freezes automatic installs — the fleet-replica
        posture, where only an orchestrator-driven refresh_once() (a
        rolling deploy's SRV_REFRESH) installs, while staleness keeps
        being measured."""
        if self._subscriber is not None:
            return self._subscriber
        from ..online import ParamSubscriber
        self._subscriber = ParamSubscriber(
            endpoints, self._decode, engine=self._engine,
            subscriber_id=subscriber_id, poll_secs=poll_secs,
            pull_timeout=pull_timeout)
        if start:
            self._subscriber.start()
        if paused:
            self._subscriber.pause()
        return self._subscriber

    @property
    def subscriber(self):
        """The attached ParamSubscriber, or None."""
        return self._subscriber

    def refresh_once(self):
        """One orchestrator-driven refresh (pull + verify + install at
        a step boundary); returns the installed version. Raises
        RuntimeError when no refresh machinery is attached, RefreshError
        (old weights untouched) on a failed pull."""
        if self._subscriber is None:
            raise RuntimeError('no refresh attached — call '
                               'enable_refresh(endpoints) first')
        return self._subscriber.refresh_once()

    # -- blocking ----------------------------------------------------------
    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 timeout=None):
        """Greedy-decode and return the generated token ids."""
        return self._engine.generate(prompt, max_new_tokens,
                                     eos_id=eos_id, timeout=timeout)

    # -- async -------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None, priority=0,
               deadline_ms=None):
        """Enqueue; returns an opaque handle for poll()/result().
        priority is the SLO tier (higher = more important, 0 = the
        default lowest tier, the only tier admission ever rejects),
        deadline_ms the optional end-to-end budget (None = no deadline;
        see ServingEngine.submit for the expiry semantics)."""
        req = self._engine.submit(prompt, max_new_tokens, eos_id=eos_id,
                                  priority=priority,
                                  deadline_ms=deadline_ms)
        self._requests[req.id] = req
        return req.id

    def _req(self, handle):
        try:
            return self._requests[handle]
        except KeyError:
            raise KeyError('unknown request handle %r' % (handle,))

    def poll(self, handle):
        """Non-blocking snapshot {'state', 'tokens'(, 'error')}: tokens
        is the stream generated so far."""
        req = self._req(handle)
        out = {'state': req.state, 'tokens': list(req.tokens)}
        if req.error is not None:
            out['error'] = str(req.error)
        return out

    def result(self, handle, timeout=None):
        """Block for the final token stream (see Request.result)."""
        return self._req(handle).result(timeout)

    def cancel(self, handle):
        self._engine.cancel(self._req(handle))

    # -- disaggregated page shipping (serving/disagg.py) -------------------
    @property
    def paged(self):
        """True when serving from the page-pool cache."""
        return bool(getattr(self._decode, 'paged', False))

    def export_prefix(self, prompt):
        """Longest resident full-page chain for `prompt` as host copies
        (see ServingEngine.export_prefix); None when non-paged or cold."""
        return self._engine.export_prefix(prompt)

    def install_prefix(self, prompt, keys, data, skip=0):
        """Install an exported page run (see ServingEngine.
        install_prefix); returns (installed, deduped) page counts."""
        return self._engine.install_prefix(prompt, keys, data, skip=skip)

    def resident_keys(self, prompt):
        """Hex keys of the locally resident leading chain run for
        `prompt`."""
        return self._engine.resident_keys(prompt)

    def prefix_report(self):
        """Drain {'new', 'evicted'} prefix-chain hex keys since the
        last call."""
        return self._engine.prefix_report()

    # -- ops ---------------------------------------------------------------
    @property
    def max_len(self):
        """Context-window bound: prompt + generated tokens per stream."""
        return self._decode.max_len

    def param_digests(self):
        """{param name: crc32 of its wire payload} for every served
        weight — what a rolling deploy's convergence check compares
        against the pserver manifest."""
        return self._decode.param_digests()

    def drain(self, timeout=None):
        return self._engine.drain(timeout)

    def stats(self):
        """Engine stats plus the online-refresh position: param_version
        (installed; None before any refresh machinery is attached) and
        staleness_rounds (rounds behind the newest published version)."""
        out = self._engine.stats()
        if self._subscriber is not None:
            sub = self._subscriber.stats()
            out['param_version'] = sub['installed_version']
            out['staleness_rounds'] = sub['staleness_rounds']
            out['refreshes'] = sub['refreshes']
            out['refresh_failures'] = sub['failures']
        else:
            out['param_version'] = None
            out['staleness_rounds'] = None
        return out

    def close(self, drain=True, timeout=None):
        """drain=True waits for in-flight streams; past `timeout` it
        cancels them instead. True for a clean drain."""
        if self._subscriber is not None:
            self._subscriber.stop()
            self._subscriber = None
        clean = self._engine.stop(drain=drain, timeout=timeout)
        # the engine's clones are this server's; the first predictor too
        # when the server prepared it
        preds = self._engine._predictors
        for p in (preds if self._owns_decode else preds[1:]):
            close = getattr(p, 'close', None)
            if close is not None:
                close()
        return clean

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
