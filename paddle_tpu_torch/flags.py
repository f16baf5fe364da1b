"""Global flag registry + env bootstrap (counterpart of paddle_tpu/flags.py,
holding only the flags this package reads).

Known flags:
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
    'use_flash_attention': True,
    'use_pallas_fused_ops': False,
    'amp_bf16_param_grads': False,
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
