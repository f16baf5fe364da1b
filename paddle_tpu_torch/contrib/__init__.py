"""Contributed extensions (counterpart of paddle_tpu/contrib/): bf16
mixed precision and the memory-usage estimate."""
from . import mixed_precision  # noqa: F401
from . import memory_usage_calc  # noqa: F401
from .memory_usage_calc import memory_usage  # noqa: F401
