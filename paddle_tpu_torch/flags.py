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
"""
from __future__ import annotations

import os

__all__ = ['set_flags', 'get_flag', 'get_flags']

_DEFAULTS = {
    'check_nan_inf': False,
    'use_flash_attention': True,
    'use_pallas_fused_ops': False,
    'amp_bf16_param_grads': False,
    'bf16_momentum': False,
    'ckpt_verify': False,
    'serving_slots': 8,
    'serving_prefill_batch': 1,
    'serving_max_queue': 256,
    'serving_idle_wait': 0.05,
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
