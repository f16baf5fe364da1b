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
                 prefill_batch=None, workers=1, max_queue=None):
        obj = model_dir_or_predictor
        if isinstance(obj, DecodePredictor):
            dec = obj
        else:
            if isinstance(obj, str):
                from ..inference import AnalysisConfig, AnalysisPredictor
                obj = AnalysisPredictor(AnalysisConfig(obj, place=place))
            dec = obj.prepare_decoding(slots=slots,
                                       prefill_batch=prefill_batch)
        self._decode = dec
        self._engine = ServingEngine(dec, workers=workers,
                                     max_queue=max_queue)
        self._requests = {}
        self._engine.start()

    # -- blocking ----------------------------------------------------------
    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 timeout=None):
        """Greedy-decode and return the generated token ids."""
        return self._engine.generate(prompt, max_new_tokens,
                                     eos_id=eos_id, timeout=timeout)

    # -- async -------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_id=None):
        """Enqueue; returns an opaque handle for poll()/result()."""
        req = self._engine.submit(prompt, max_new_tokens, eos_id=eos_id)
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

    # -- ops ---------------------------------------------------------------
    @property
    def max_len(self):
        """Context-window bound: prompt + generated tokens per stream."""
        return self._decode.max_len

    def drain(self, timeout=None):
        return self._engine.drain(timeout)

    def stats(self):
        return self._engine.stats()

    def close(self, drain=True, timeout=None):
        """drain=True waits for in-flight streams; past `timeout` it
        cancels them instead. True for a clean drain."""
        return self._engine.stop(drain=drain, timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
