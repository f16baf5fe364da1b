"""KV-cache incremental decoding + continuous-batching serving
(counterpart of paddle_tpu/serving/, dense ring cache only).

- decode.py  DecodePredictor: a loaded LM transpiled into a prefill +
             decode program pair with per-layer [slots, T, H, dh] K/V
             ring caches in a child Scope, weights shared with the base
             Predictor through the parent Scope.
- engine.py  ServingEngine: continuous batching over the slot pool with
             FIFO admission; worker threads share weights via clone().
- api.py     LMServer: blocking generate() and async submit/poll/result.
"""
from .decode import DecodePredictor
from .engine import ServingEngine, Request
from .api import LMServer

__all__ = ['DecodePredictor', 'ServingEngine', 'Request', 'LMServer']
