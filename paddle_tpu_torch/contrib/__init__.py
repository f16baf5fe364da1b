"""Contributed extensions (counterpart of paddle_tpu/contrib/): bf16
mixed precision, the memory-usage estimate and the seq2seq decoders."""
from . import mixed_precision  # noqa: F401
from . import memory_usage_calc  # noqa: F401
from . import decoder  # noqa: F401
from .memory_usage_calc import memory_usage  # noqa: F401
