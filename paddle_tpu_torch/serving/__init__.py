"""KV-cache incremental decoding, continuous-batching serving, fleet
serving and mesh-sharded serving (counterpart of paddle_tpu/serving/).

- decode.py       DecodePredictor: a loaded LM transpiled into a
                  prefill + decode program pair with per-layer
                  [slots, T, H, dh] K/V ring caches in a child Scope,
                  weights shared with the base Predictor through the
                  parent Scope; stage_weights / install_weights.
- paging.py       Host-side paged-cache bookkeeping: PagePool
                  (refcounted free list over [num_pages, page_tokens,
                  H, dh] pools, typed retryable CacheExhaustedError when
                  dry), PageTable (a stream's logical -> physical map
                  with copy-on-write forks), PrefixCache (content-hash
                  chain over full pages + partial tails).
- paged.py        PagedDecodePredictor: the DecodePredictor contract
                  over the page pool: chunked prefill, the page index as
                  a feed (no new capture per admission), transactional
                  on-demand page allocation, swap out / in.
- speculative.py  SpeculativeDecodePredictor: draft/verify speculation
                  over the paged cache (a layer-cut self-draft or an
                  explicit draft LM proposes up to FLAGS_spec_k tokens a
                  stream, one verify pass scores all k+1 rows a slot).
- preempt.py      Preempt-first capacity policy: victim selection
                  (lowest tier, longest idle) and the host-RAM swap
                  budget (FLAGS_serving_swap_host_mb).
- engine.py       ServingEngine: continuous batching over the slot pool
                  with priority tiers, deadlines, preemption, chunked
                  prefill interleaved with decode, and step-boundary
                  weight swaps; worker threads share weights via
                  clone().
- api.py          LMServer: blocking generate() and async
                  submit/poll/result, dense, paged or speculative;
                  enable_refresh() attaches an online.ParamSubscriber
                  that installs the pservers' published versions at
                  step boundaries, param_digests() proves which.
- replica.py      ReplicaServer: one LMServer on the wire (the SRV_*
                  message types), the process
                  `python -m paddle_tpu_torch.tools.serve_replica` runs.
- disagg.py       Disaggregated prefill/decode: KV pages as wire objects
                  (SRV_PAGES / SRV_PAGE_FETCH); a prefill tier computes
                  pages once per unique prefix and ships them
                  content-addressed to paged decode replicas; every ship
                  failure falls back to local re-prefill.
- fleet.py        FleetRouter: health-checked dispatch over N replicas
                  with session affinity and priority tiers, mid-stream
                  failover (greedy re-prefill from the accumulated
                  prefix), SLO-rule admission control (typed
                  OverloadError), the gray-failure watchdog, hedging,
                  zero-drop rolling weight deploys and the prefill tier;
                  FleetAutoscaler drives replica count.
- mesh.py         Mesh-sharded serving: a predictor's programs run on a
                  group of rank processes (serving_mesh, the
                  controller's RemoteExecutor, the ranks'
                  MeshDecodeExecutor), the K/V state sharded on heads,
                  the weights by their serve specs.
"""
from .decode import DecodePredictor
from .paging import (CacheExhaustedError, PagePool, PageTable,
                     PrefixCache, chain_keys)
from .paged import PagedDecodePredictor
from .speculative import DraftModel, SpeculativeDecodePredictor
from .engine import ServingEngine, Request, DeadlineExceededError
from .preempt import HostSwapBudget
from .api import LMServer
from .replica import ReplicaServer
from .disagg import ShipError
from .fleet import (FleetRouter, FleetAutoscaler, FleetRequest,
                    OverloadError, FleetDeployError)

__all__ = ['DecodePredictor', 'PagedDecodePredictor',
           'DraftModel', 'SpeculativeDecodePredictor',
           'CacheExhaustedError', 'PagePool', 'PageTable', 'PrefixCache',
           'chain_keys', 'ShipError',
           'ServingEngine', 'Request', 'DeadlineExceededError',
           'HostSwapBudget', 'LMServer',
           'ReplicaServer', 'FleetRouter', 'FleetAutoscaler',
           'FleetRequest', 'OverloadError', 'FleetDeployError']
