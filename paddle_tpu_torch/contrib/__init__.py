"""Contributed extensions (counterpart of paddle_tpu/contrib/): bf16
mixed precision."""
from . import mixed_precision  # noqa: F401
