"""`fluid.core` for the port (counterpart of paddle_tpu/core.py): the
places, the Scope, LoDTensor, the reader's end-of-pass exception and
the device queries that user scripts touch through `fluid.core`.

The device queries answer for CUDA, from torch.cuda: the port runs on
NVIDIA cards, so `is_compiled_with_cuda()` is whether this torch build
sees one and `is_compiled_with_tpu()` is always False (the JAX package
answers the other way round)."""
from __future__ import annotations

import torch

from .executor import (CPUPlace, CUDAPlace, TPUPlace, XLAPlace,  # noqa: F401
                       Scope)
from .lod_tensor import LoDTensor  # noqa: F401
from .reader.pipeline import EOFException  # noqa: F401


def is_compiled_with_cuda():
    return torch.cuda.is_available()


def is_compiled_with_tpu():
    return False


def get_cuda_device_count():
    return torch.cuda.device_count()


def get_tpu_device_count():
    return 0


def get_device_count():
    """Devices the port can run on: the cards, or the CPU alone."""
    return torch.cuda.device_count() or 1
