"""`fluid.core` for the port (counterpart of paddle_tpu/core.py): the
places, the Scope and the reader's end-of-pass exception that user
scripts touch through `fluid.core`."""
from __future__ import annotations

from .executor import CPUPlace, CUDAPlace, Scope  # noqa: F401
from .reader.pipeline import EOFException  # noqa: F401
