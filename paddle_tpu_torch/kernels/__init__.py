"""Hand-written CUDA kernels (sources in ../csrc), each beside its plain
PyTorch version. Importing this package builds and loads nothing.

The wrappers count what they launch in plain attributes
(`<wrapper>.launches`, `matmul_bn_stats_kernel.launches_by_kernel`,
`FlashAttention.plain_cuda_calls`, K4a's extra-work notes), and tell
`note` each count they add. Python does not run when a captured CUDA
graph replays, so the Executor captures a segment inside `recording()`
on its capture stream, which keeps what the wrappers note while that
stream is current, and adds that again at every replay (`count_add`): a
count means the same under replay as in an eager run.
"""
from __future__ import annotations

import contextlib

__all__ = ['note', 'recording', 'count_add']

# (device, stream handle) -> the counts noted on that stream
_recordings = {}


def _current_stream(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def note(key, d=1):
    """Called by a wrapper with each count it adds ({key} as count_add
    takes it): a recording() open on the current stream keeps it."""
    if not _recordings:
        return
    for (device, stream), rec in list(_recordings.items()):
        if _current_stream(device) == stream:
            rec[key] = rec.get(key, 0) + d


@contextlib.contextmanager
def recording(device, stream):
    """The counts the wrappers note inside the block while `stream` (a
    CUDA stream's handle) is the current stream of `device`, as {key:
    number}: the work captured on that stream, whichever thread launches
    it (the autograd engine runs a backward on a thread of its own, on
    its forward's stream). Launches on other streams, such as another
    thread's eager steps, stay out."""
    rec = _recordings[(device, stream)] = {}
    try:
        yield rec
    finally:
        del _recordings[(device, stream)]


def count_add(counts):
    """Add a recording's counts back into the wrappers' counts."""
    if not counts:
        return
    from . import conv_bn, flash_attention as fa
    k6 = conv_bn.matmul_bn_stats_kernel
    with fa._count_lock:
        for key, d in counts.items():
            if key[0] == 'launches':
                getattr(fa, key[1]).launches += d
            elif key[0] == 'plain_cuda_calls':
                fa.FlashAttention.plain_cuda_calls += d
            elif key[0] == 'extra_flops':
                fa._extra_flops += d
    with conv_bn._count_lock:
        for key, d in counts.items():
            if key == ('k6',):
                k6.launches += d
            elif key[0] == 'k6':
                by_kernel = k6.launches_by_kernel
                by_kernel[key[1]] = by_kernel.get(key[1], 0) + d
