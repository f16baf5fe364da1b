"""Probe: is exp2 cheaper than exp on this card?

The port's flash kernels call expf for every visited score
(csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu). If the
card's special-function unit makes 2^x cheaper than e^x, folding log2(e)
into the softmax scale turns each of those calls into exp2f. This probe
times a chain of dependent exp or exp2 steps over an fp32 array in one
kernel (P, csrc/probe_exp2.cu, the Hopper port of tools/probe_exp2.py
`_kernel` :26) and cancels the launch, the loads and the stores by
differencing two chain lengths, as the TPU probe does (4 against 8
steps). At 4 and 8 steps the chain's work is smaller than reading and
writing the array on an H100, so the probe also differences 64 against
128 steps, where the chain dominates; its answer comes from that pair.

    python -m paddle_tpu_torch.tools.probe_exp2

It prints, for each function and chain length, the time per launch
(CUDA events), then ns per element-step and G steps/s, beside the
special-function unit's rate on this card: SMs x 16 ex2 results per
clock per SM (the CUDA C Programming Guide's throughput table for
compute capability 9.0) x the maximum SM clock that nvidia-smi reports.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels import build

__all__ = ['exp_chain_kernel', 'exp_chain_reference', 'measure',
           'sfu_rate', 'FNS', 'REP_PAIRS', 'SHAPE']

FNS = ('exp', 'exp2')
SHAPE = (64, 512, 512)          # tools/probe_exp2.py's BLOCKS, BQ, BK
REP_PAIRS = ((4, 8), (64, 128))
ITERS = 20
SFU_EX2_PER_CLOCK_PER_SM = 16


def exp_chain_kernel(x, reps, fn):
    """Launch P: `reps` times x <- f(-(x·0.5 + 0.25)) elementwise, f =
    expf ('exp') or exp2f ('exp2'). x: contiguous float32 CUDA tensor.
    Returns a new tensor of x's shape. Does not synchronise."""
    if fn not in FNS:
        raise ValueError('exp_chain_kernel: fn %r is not one of %s'
                         % (fn, FNS))
    if x.device.type != 'cuda':
        raise ValueError('exp_chain_kernel: x is on %s, the kernel needs a '
                         'CUDA tensor' % x.device)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError('exp_chain_kernel: x must be a contiguous, '
                         'non-empty float32 tensor')
    if reps < 0:
        raise ValueError('exp_chain_kernel: reps %d < 0' % reps)
    out = torch.empty_like(x)
    launch = build.function('probe_exp2', 'probe_exp2_chain',
                            [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), x.numel(), int(reps),
                     int(fn == 'exp2'), stream)
    if err != 0:
        raise RuntimeError('exp_chain_kernel: kernel launch failed with CUDA '
                           'error %d' % err)
    exp_chain_kernel.launches += 1
    return out


exp_chain_kernel.launches = 0


def exp_chain_reference(x, reps, fn):
    """Plain PyTorch version of P: the same chain, one op at a time, on
    any device."""
    f = {'exp': torch.exp, 'exp2': torch.exp2}[fn]
    for _ in range(reps):
        x = f(-(x * 0.5 + 0.25))
    return x


def probe_input(shape=SHAPE, device='cuda'):
    """The TPU probe's input: uniform [0, 1) from RandomState(0)."""
    x = np.random.RandomState(0).rand(*shape).astype('float32')
    return torch.from_numpy(x).to(device)


def launch_ms(fn_call, iters=ITERS, warmup=2):
    """Mean device time of one fn_call() over `iters`, by CUDA events."""
    for _ in range(warmup):
        fn_call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn_call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sfu_rate(device=0):
    """(ex2 results per second, how it was worked out) for this card:
    SMs x SFU_EX2_PER_CLOCK_PER_SM x the maximum SM clock."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = subprocess.run(
        ['nvidia-smi', '-i', str(device), '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    rate = sms * SFU_EX2_PER_CLOCK_PER_SM * mhz * 1e6
    return rate, ('%d SMs x %d ex2 per clock x %.0f MHz = %.4g per s'
                  % (sms, SFU_EX2_PER_CLOCK_PER_SM, mhz, rate))


def measure(x=None, rep_pairs=REP_PAIRS, iters=ITERS):
    """For each rep pair and f: ms per launch at both chain lengths, then
    ns per element-step and G steps/s of their difference. Returns a
    list of dicts."""
    x = probe_input() if x is None else x
    n = x.numel()
    rows = []
    for short, long_ in rep_pairs:
        for fn in FNS:
            ms = {reps: launch_ms(lambda r=reps: exp_chain_kernel(x, r, fn),
                                  iters)
                  for reps in (short, long_)}
            per_step_ms = (ms[long_] - ms[short]) / (long_ - short)
            rows.append({'fn': fn, 'reps': [short, long_],
                         'ms': [ms[short], ms[long_]],
                         'ns_per_elem': per_step_ms * 1e6 / n,
                         'gsteps_per_s': (n / (per_step_ms * 1e-3) / 1e9
                                          if per_step_ms > 0 else None)})
    return rows


def report(rows, rate):
    """Print the rows beside the special-function unit's rate, and the
    answer of the last rep pair."""
    for r in rows:
        share = ('%.1f%% of the SFU rate' % (100.0 * r['gsteps_per_s'] * 1e9
                                              / rate)
                 if r['gsteps_per_s'] else 'no measurable difference')
        print('%s: %d steps %.4f ms, %d steps %.4f ms -> %.4g ns/elem, %s '
              'Gexp/s (%s)'
              % (r['fn'], r['reps'][0], r['ms'][0], r['reps'][1], r['ms'][1],
                 r['ns_per_elem'],
                 '%.1f' % r['gsteps_per_s'] if r['gsteps_per_s'] else 'n/a',
                 share), flush=True)
    last = {r['fn']: r for r in rows if r['reps'] == rows[-1]['reps']}
    ratio = last['exp']['ns_per_elem'] / last['exp2']['ns_per_elem']
    print('answer (%d against %d steps): one exp step costs %.3f x one exp2 '
          'step on this card, so %s'
          % (last['exp']['reps'][0], last['exp']['reps'][1], ratio,
             'folding log2(e) into the scale and calling exp2f saves time'
             if ratio > 1.05 else 'exp2f saves nothing measurable over expf'),
          flush=True)
    return ratio


def main():
    if not torch.cuda.is_available():
        print('probe_exp2: no CUDA device; nothing run', file=sys.stderr)
        return 2
    rate, how = sfu_rate()
    print('card: %s; SFU rate: %s' % (torch.cuda.get_device_name(0), how),
          flush=True)
    x = probe_input()
    print('input: fp32 %s, %d elements, %d launches per timing'
          % (list(x.shape), x.numel(), ITERS), flush=True)
    rows = measure(x)
    ratio = report(rows, rate)
    print(json.dumps({'probe_exp2': rows, 'sfu_per_s': rate,
                      'exp_over_exp2': ratio}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
