"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py):
only increment (:108) is ported; the rest waits (ROADMAP.md, Queue 1)."""
from __future__ import annotations

__all__ = ['increment']


def increment(x, value=1.0, in_place=True):
    from . import ops as _ops
    return _ops.increment(x, value=value, in_place=in_place)
