"""Global flag registry + env bootstrap (counterpart of paddle_tpu/flags.py,
holding only the flags this package reads).

Known flags:
  check_nan_inf          the Executor runs each device segment op by op,
                         eagerly (never captured), and raises
                         OpExecutionError naming the first op whose
                         floating output holds a NaN or an Inf (a debug
                         mode: one host read an op); off by default
  use_flash_attention    route the flash_attention op through the
                         hand-written kernel for CUDA tensors
                         (kernels/flash_attention.py); False selects the
                         plain PyTorch version explicitly
  use_pallas_fused_ops   models.resnet builds each conv + BN as one
                         conv2d_bn op, and its 1x1 path runs the
                         hand-written matmul + BN-statistics kernel K6
                         for CUDA tensors (kernels/conv_bn.py); read when
                         the op runs, so clearing it selects the plain
                         PyTorch version explicitly. Off by default, as
                         in the JAX package
  amp_bf16_param_grads   under AMP, round fp32 parameter grads to bf16
                         where one grad op is their sole producer
                         (registry.register_vjp_grad); off by default
  bf16_momentum          Momentum creates its velocity accumulators in
                         bf16 (optimizer.py); the update math runs in the
                         parameter's dtype and stores back in bf16
                         (ops/optimizer_ops.py); off by default
  ckpt_verify            io.save_vars writes a CHECKPOINT_DIGESTS manifest
                         of the files it wrote, and io.load_vars verifies
                         the files it reads against it before loading
                         (checkpoint/manifest.py); off by default
  serving_slots          KV-cache slot-pool size per DecodePredictor
  serving_prefill_batch  prompts per prefill call
  serving_max_queue      ServingEngine admission queue bound
  serving_idle_wait      seconds an idle serving worker sleeps between
                         queue checks
  serving_page_tokens    paged KV cache: tokens per page (page-pool
                         granularity for alloc/COW/prefix sharing)
  serving_kv_pages       paged KV cache: physical pages in the pool
                         (0 = auto-size to dense-equivalent capacity,
                         slots * ceil(max_len/page_tokens) + 1)
  serving_prefill_chunk  chunked prefill: tokens admitted per engine
                         iteration while a prompt prefills, so long
                         prompts never stall live decode lanes
  serving_preempt_policy paged-cache exhaustion response
                         (serving/preempt.py): 'swap' preempts the
                         lowest-tier longest-idle stream and copies its
                         pages to host RAM (falling back to
                         drop-and-re-prefill when the host budget is
                         dry), 'reprefill' always drops pages and
                         re-prefills from the accumulated tokens on
                         resume, 'off' fails the victim with the typed
                         CacheExhaustedError
  serving_swap_host_mb   host-RAM budget (MiB per engine) for swapped
                         KV pages; a preemption past the budget
                         degrades to the re-prefill path instead of
                         growing host memory unboundedly
  serve_mesh_shape       mesh-sharded serving (serving/mesh.py): the
                         MeshConfig axis spec the decode, prefill and
                         verify programs run over ('tp=2', 'dp=1,tp=4';
                         '' = one device). The K/V state shards its
                         heads axis over tp; an axis that does not
                         divide (heads % tp != 0) falls back to
                         replicated via fit_spec, never an error
  spec_k                 speculative decoding (serving/speculative.py):
                         draft proposals per verify pass (the ceiling:
                         the predictor adapts k between 1 and this from
                         the rolling accept rate)
  spec_draft_layers      self-draft depth: the draft model is the
                         target truncated to its first N transformer
                         blocks (same weights, no extra weight memory);
                         ignored when an explicit draft program is
                         given
  obs_dir                telemetry export directory (obs/telemetry.py):
                         when set, recording is on from import and a
                         snapshot line is appended every
                         obs_flush_secs seconds; '' = off
  obs_flush_secs         telemetry export period in seconds
  obs_role               role name in the telemetry and trace file names
                         ('' = the process id)
  fault_plan             deterministic fault injection for the RPC layer
                         and the Trainer's step boundary
                         (distributed/resilience.py): a JSON FaultPlan,
                         a path to one, or "seed:N" for a generated
                         plan; read once at import
  trainer_step_retries / trainer_max_rollbacks
                         Trainer.train fault handling: re-run a step
                         this many times on a retryable failure, and
                         roll back to the last SUCCESS checkpoint at
                         most this many times on a fatal one
  anomaly_action         Trainer numeric-anomaly guard: 'none' (off,
                         default), 'rollback' (skip the step; after
                         anomaly_skip_steps consecutive anomalies, roll
                         back to the last SUCCESS checkpoint), or
                         'fatal' (raise once the skip budget is spent)
  anomaly_skip_steps     consecutive anomalous steps tolerated (as
                         skipped steps) before the anomaly_action
                         escalation fires
  perf_sync_steps        synchronise on the fetched tensors of an
                         Executor.run with return_numpy=False before
                         stamping perf.step_latency (obs/perf.py)
  perf_peak_tflops       peak dense bf16 TFLOP/s used as the perf.mfu
                         denominator (0 = the card's entry in
                         obs/perf.py's table; must be set for a nonzero
                         MFU on the CPU)
  slo_rules              declarative SLO rule list for obs/slo.py:
                         inline JSON (a list of {name, metric, kind,
                         threshold[, min_count]}) or @/path/rules.json
                         ('' = no watchdog); breaches emit slo.breach
                         trace events and the slo.breaches counter
  slo_check_secs         SLOWatchdog evaluation period in seconds
  rpc_deadline           seconds of trainer silence before a pserver
                         declares it dead and retires it from sync
                         rounds (distributed/param_service.py)
  rpc_max_retries / rpc_retry_backoff / rpc_retry_max_backoff /
  rpc_reconnect_secs     shared RetryPolicy for PSClient/MasterClient
                         transparent reconnect (attempts, initial and
                         max backoff seconds, per-attempt reconnect
                         budget)
  rpc_dedup_window       per-trainer replayed-request dedup window on
                         the ParameterService (entries, not seconds)
  trainer_incarnation    logical restart counter of this trainer
                         process (elastic recovery): pservers fence
                         messages from lower incarnations and rejoin
                         higher ones; the supervisor bumps it per
                         restart
  ps_state_path          pserver durability: atomic snapshot file for
                         params + round/replay state ('' = off);
                         mutations since the snapshot journal to
                         <path>.journal
  ps_snapshot_every      rounds between pserver snapshots
  ps_average_live        average merged gradients over the LIVE
                         trainer set instead of the original
                         num_trainers (see ParameterService._merge)
  ps_check_grad_finite   pserver-side guard (default on): reject a
                         SEND_VAR with NaN/Inf in its float payload
                         with a retryable error BEFORE journaling or
                         applying it -- the client retry resends the
                         value it actually computed
  rpc_read_deadline      socket read deadline (seconds) for PSClient /
                         MasterClient: a peer that accepts but never
                         replies surfaces as RetryableRPCError instead
                         of a silent hang
  rpc_inflight_window    pipelined PSClient: max unacked requests
                         riding one connection (the *_async APIs);
                         1 degrades to stop-and-wait
  rpc_batch_bytes        dense gradients up to this many bytes bound
                         for one endpoint coalesce into a single
                         SEND_VARS frame (0 disables batching)
  rpc_batch_max_bytes /
  rpc_batch_max_vars     flush thresholds for one SEND_VARS frame
                         (total payload bytes / contained vars)
  sup_healthy_secs       Supervisor (distributed/supervisor.py): a role
                         that stayed up this long before dying gets its
                         restart BUDGET (and backoff exponent) reset --
                         a replica that crashes once a day is not a
                         crash loop. Lifetime restart counts (and the
                         incarnation fence they feed) are unaffected
  online_poll_secs       ParamSubscriber (paddle_tpu_torch/online/) version-
                         poll period in seconds -- how often serving
                         asks its pservers for the published param
                         version between refreshes
  online_pull_timeout    seconds one refresh (version poll + shard
                         pulls + verify + stage) may take before it is
                         abandoned; the previously installed verified
                         version keeps serving
  fleet_poll_secs        FleetRouter (serving/fleet.py) stream-pump
                         period: dispatch held requests + SRV_POLL
                         progress of every in-flight stream
  fleet_probe_secs       FleetRouter control period: SRV_HEALTH probe
                         of every replica + admission-rule evaluation +
                         autoscaler tick
  fleet_probe_fails      consecutive failed probes before a quiet
                         replica (no in-flight streams to trip the
                         pump) is declared dead; a failed poll/submit
                         kills it immediately
  fleet_max_hold         FleetRouter hold-queue bound -- submissions
                         past this raise OverloadError regardless of
                         the admission rules
  fleet_shed_consecutive control periods a breached admission rule must
                         persist before the router starts shedding
                         (typed OverloadError on submit)
  fleet_admission_rules  obs/slo.py rule list (same format as
                         slo_rules) evaluated against the router's OWN
                         fleet.* snapshot as the admission-control
                         trigger; '' = the built-in fleet.queue_depth
                         gauge_max rule at fleet_max_hold / 2
  fleet_deploy_timeout   seconds rolling_deploy() may spend per replica
                         on drain + refresh + health-check before the
                         deploy aborts (the replica is un-drained)
  fleet_connect_timeout  cap (seconds) on the TCP connect step of one
                         router->replica call; the effective connect
                         timeout is min(per-call timeout, this) so a
                         short probe call can never spend longer
                         connecting than it was given overall
  fleet_probe_timeout    SRV_HEALTH probe RPC timeout (seconds) on the
                         router's DEDICATED per-replica probe
                         connection -- deliberately far below
                         call_timeout so one stalled replica delays the
                         probe loop by at most this, not 10s
  fleet_progress_timeout_secs  gray-failure watchdog (serving/fleet.py):
                         a dispatched stream with no new token for this
                         long -- or a router->replica RPC in flight this
                         long -- gray-marks the replica and fails its
                         streams over through the re-prefill path
                         (bit-exact by greedy determinism). 0 = off
  fleet_hedge_ms         hedged dispatch: a stream with no first token
                         this many ms after dispatch is duplicated to a
                         second replica; first token wins, the loser is
                         SRV_CANCELled. Greedy determinism makes both
                         streams identical, so hedging can never change
                         output. 0 = off
  fleet_gray_probes      clean (in-time) SRV_HEALTH probes a gray-marked
                         replica must answer consecutively before it
                         rejoins dispatch (the half-open probation
                         length); a slow or failed probe resets the
                         count
  fleet_cache_shed_budget  cross-replica retries a stream that FAILED
                         with CacheExhaustedError gets (the router
                         requeues it onto a cooler replica) before the
                         failure is final -- bounds the livelock when
                         the whole fleet is saturated; counted in
                         fleet.cache_sheds
  fleet_prefill_endpoints  disaggregated serving (serving/disagg.py):
                         comma-separated ReplicaServer endpoints that
                         form the PREFILL tier. When set, the router
                         routes each stream's prefill to this tier and
                         the computed KV pages are shipped over the
                         wire (SRV_PAGES) to the decode replica that
                         owns the stream; '' (default) keeps today's
                         colocated path
  disagg_ship_timeout    seconds one page ship (SRV_PAGE_FETCH prefill
                         + SRV_PAGES transfer + install) may take on
                         the decode replica before it gives up and
                         re-prefills locally (bit-exact by greedy
                         determinism)
  fleet_prefix_affinity  weight of the prefix-affinity term in the
                         router's dispatch score: the fraction of a
                         request's hash-chain prefix already resident
                         on a replica (per the fleet-wide prefix
                         directory) is subtracted from its load score
                         scaled by this, so shared-prefix requests
                         land where the pages live. 0 disables the
                         term
  wire_binary_meta       frame the wire meta header in the compact
                         binary codec (wire version 3) instead of JSON
                         -- negotiated per connection: a sender
                         advertises in its JSON meta, and only
                         upgrades after the peer has proven it speaks
                         v3, so old peers keep working
"""
from __future__ import annotations

import os

__all__ = ['set_flags', 'get_flag', 'get_flags']

_DEFAULTS = {
    'check_nan_inf': False,
    # MeshConfig.from_flags axis spec, e.g. 'dp=2,tp=2' ('' = dp over
    # every rank); per-rank batch_norm statistics on a dp mesh
    'mesh_shape': '',
    'bn_local_stats': False,
    'use_flash_attention': True,
    'use_pallas_fused_ops': False,
    'amp_bf16_param_grads': False,
    'bf16_momentum': False,
    'ckpt_verify': False,
    'serving_slots': 8,
    'serving_prefill_batch': 1,
    'serving_max_queue': 256,
    'serving_idle_wait': 0.05,
    'serving_page_tokens': 16,
    'serving_kv_pages': 0,
    'serving_prefill_chunk': 64,
    'serving_preempt_policy': 'swap',
    'serving_swap_host_mb': 64,
    'serve_mesh_shape': '',
    'spec_k': 4,
    'spec_draft_layers': 1,
    'obs_dir': '',
    'obs_flush_secs': 2.0,
    'obs_role': '',
    'fault_plan': '',
    'trainer_step_retries': 2,
    'trainer_max_rollbacks': 2,
    'anomaly_action': 'none',
    'anomaly_skip_steps': 1,
    'perf_sync_steps': True,
    'perf_peak_tflops': 0.0,
    'slo_rules': '',
    'slo_check_secs': 5.0,
    'rpc_deadline': 180.0,
    'rpc_max_retries': 5,
    'rpc_retry_backoff': 0.05,
    'rpc_retry_max_backoff': 2.0,
    'rpc_reconnect_secs': 3.0,
    'rpc_dedup_window': 512,
    'trainer_incarnation': 0,
    'ps_state_path': '',
    'ps_snapshot_every': 1,
    'ps_check_grad_finite': True,
    'rpc_read_deadline': 120.0,
    'rpc_inflight_window': 32,
    'rpc_batch_bytes': 65536,
    'rpc_batch_max_bytes': 1 << 20,
    'rpc_batch_max_vars': 64,
    'ps_average_live': False,
    'sup_healthy_secs': 300.0,
    # online refresh (online/): subscriber version-poll cadence, and
    # the wall budget one refresh (poll + pull + verify + stage) gets
    # before it is abandoned in favour of the installed version
    'online_poll_secs': 0.5,
    'online_pull_timeout': 30.0,
    'fleet_poll_secs': 0.01,
    'fleet_probe_secs': 0.25,
    'fleet_probe_fails': 2,
    'fleet_max_hold': 512,
    'fleet_shed_consecutive': 2,
    'fleet_admission_rules': '',
    'fleet_deploy_timeout': 120.0,
    'fleet_cache_shed_budget': 5,
    # disaggregated prefill/decode serving (serving/disagg.py): the
    # prefill-tier endpoints ('' = colocated), the per-ship wall budget
    # on the decode side before local re-prefill, and the weight of the
    # prefix-directory affinity term in dispatch scoring (0 = off)
    'fleet_prefill_endpoints': '',
    'disagg_ship_timeout': 15.0,
    'fleet_prefix_affinity': 0.5,
    # gray-failure tolerance (serving/fleet.py): connect-step cap and
    # the dedicated probe-connection timeout (both seconds), the
    # no-progress watchdog horizon (0 = off), the hedged-dispatch
    # trigger in ms (0 = off), and the half-open probation length in
    # clean probes before a gray-marked replica rejoins dispatch
    'fleet_connect_timeout': 2.0,
    'fleet_probe_timeout': 1.0,
    'fleet_progress_timeout_secs': 0.0,
    'fleet_hedge_ms': 0.0,
    'fleet_gray_probes': 3,
    'wire_binary_meta': False,
}

_FLAGS = dict(_DEFAULTS)


def _coerce(name, value):
    default = _DEFAULTS.get(name)
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.lower() in ('1', 'true', 'yes', 'on')
        return bool(value)
    if isinstance(default, float):
        return float(value)
    if isinstance(default, int):
        return int(value)
    return value


def _key(name):
    return name[len('FLAGS_'):] if name.startswith('FLAGS_') else name


def set_flags(flags):
    """set_flags({'FLAGS_use_flash_attention': False}) — with or without
    the FLAGS_ prefix."""
    for name, value in flags.items():
        key = _key(name)
        _FLAGS[key] = _coerce(key, value)


def get_flag(name, default=None):
    return _FLAGS.get(_key(name), default)


def get_flags(names=None):
    if names is None:
        return dict(_FLAGS)
    return {n: get_flag(n) for n in names}


def _bootstrap_from_env():
    """Read the known FLAGS_* env vars once at import."""
    for key, value in os.environ.items():
        if key.startswith('FLAGS_') and _key(key) in _DEFAULTS:
            set_flags({key: value})


_bootstrap_from_env()
