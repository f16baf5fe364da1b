#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path, the LM training step, the
ResNet-50 training step, the long-context LM training step and the
exp/exp2 probe once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final "ok" line):
  (a) build every CUDA kernel of the paths with nvcc (one process per
      source, started together): the flash-attention forwards K1, K4a,
      K4b (bf16 K1 is the tensor-core flash_fwd_wgmma_kernel), the
      backwards K2, K3a, K3b, K5 (bf16 K2 and K5 are one tensor-core
      kernel, flash_bwd_wgmma_kernel; bf16 K3a and K3b the tensor-core
      flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel), the
      matmul + BN-statistics kernel K6 and the probe P; the registers
      and spills of the tensor-core K1, K2/K5, K3a and K3b at d = 64 and
      128 are logged;
  (b) hold K1, K2, K3a and K3b against their plain PyTorch versions on
      the card, at the shapes the paths give them and at ragged edge
      shapes, fp32 and bf16 (K1 by check_fwd_output: lse within the fp32
      atol in both dtypes, bf16 o also within O_RTOL relative to |o| +
      mean |o|; bf16 K2's dq, dk, dv, K3a's dq and K3b's dk, dv also
      within G_RTOL relative to |g| + mean |g|; K3a and K3b launched
      twice give bit-identical outputs), and time kernel, plain version
      and the PyTorch library call (sdpa_yardstick:
      scaled_dot_product_attention on 4-D views under a fused backend
      only; its backward is timed as fwd+bwd minus fwd, timed only);
  (b4) the same for K4a, K4b and K5 at the long-context path's shape
      [16, 8192, 128] causal in bf16 and in fp32 (K4b's o also against
      an fp64 evaluation, logged; K5's dq, dk, dv too, and the plain
      evaluation with P and dS rounded once to bf16) and at phase b's
      ragged shapes, bf16 K4b's o also within O_RTOL of its plain version
      relative to |o| + mean |o| and bf16 K5's gradients within G_RTOL;
      bf16 K1 (the default arm's forward there) at the same shapes by
      check_fwd_output (its o also against fp64, logged); then their
      times, K1 and K4a + K4b against the library forward
      and K5 against the library backward (every "x the library" factor
      is taken on torch.profiler device time, the library's only clock);
  (c) build the flagship LM (bench.py's transformer: vocab 32768, dim
      2048, 16 heads, 12 layers, ffn 8192, max_len 512, flash attention)
      with random weights from a seed, run its startup program on
      CUDAPlace(0), save_inference_model, load it through
      AnalysisConfig/AnalysisPredictor, prepare_decoding(slots=8,
      prefill_batch=1), and answer 8 requests (prompts of 32..480
      tokens, 32 new tokens each) through LMServer.submit/result, with
      every kernel launch counter set to 0 just before and read just
      after: the flash forward must launch at least prefills x layers
      times;
  (d) each request's prefill logits and first token match the port's own
      full-recompute Predictor.run (rtol = atol = 1e-3);
  (e) each engine stream equals its solo DecodePredictor.generate stream;
  (f), (g) prefill and decode-step timing, and their device time;
  (t1) build the flagship training program as bench.py's _bench_lm does
      (py_reader feed, fused LM head with chunk 4096, mean,
      Momentum(0.001, 0.9) under contrib.mixed_precision.decorate), run
      its startup program on CUDAPlace(0), then 2 warm-up and 5 timed
      steps through ParallelExecutor(use_cuda=True); with the counters
      set to 0 before the timed steps, K1 must launch >= 12 x steps
      times, K2 exactly 12 x steps, K3, K4 and K5 never; every loss is
      finite;
  (t2) one step from a saved state with the kernels and the same step
      with FLAGS_use_flash_attention=False (the plain versions): the
      losses and the updates of layer0_qkv, layer11_down and lm_head
      agree within TRAIN_LOSS_TOL / TRAIN_UPDATE_TOL;
  (t3) the same step under PADDLE_FLASH_BWD=split: K3a and K3b launch 12
      times each, K2 never, and loss and updates match t2's kernel step;
      then the split step's wall ms and its device time by kernel kind
      from torch.profiler over 3 steps;
  (t4) step ms, tokens/s, MFU (bench.py's FLOPs per token over the bf16
      dense peak), device-busy share and top device items from
      torch.profiler over 3 steps, and peak device memory.
The LM is freed, then ResNet-50 (bench.py's bench_resnet, NCHW, built
with FLAGS_use_pallas_fused_ops so every conv + BN is one conv2d_bn op):
  (r1) the training step at 224 px, 1000 classes, batch RESNET_BATCH
      (py_reader, train_network(depth=50), Momentum(0.01, 0.9) under
      contrib.mixed_precision.decorate, startup on CUDAPlace(0),
      ParallelExecutor(use_cuda=True)): 2 warm-up and 5 timed steps; K6
      launches exactly 36 x steps, every loss is finite and the BN
      running statistics move;
  (b6) K6 against its plain version on the card at the largest, smallest
      and widest of the step's 1x1 shapes (read from r1's program) and
      at a ragged 300 x 70 x 130, fp32 and bf16; then kernel, plain
      version and the library yardstick (torch.matmul, then the two
      column sums; timed only) at every one of the step's 15 shapes,
      summed over its 36 launches;
  (r2) one step from a saved state with K6, each of its 36 launches also
      held against the plain version on the step's own inputs, and the
      same step with FLAGS_use_pallas_fused_ops cleared at run time (the
      plain version): the losses agree within TRAIN_LOSS_TOL, and the
      updates of the stem conv, a stage-1 1x1 conv and fc within
      TRAIN_UPDATE_TOL or RESNET_SPREAD_FACTOR x the plain step's own
      spread when its column sums are taken in fp64, whichever is larger
      (the bf16 step amplifies any reordering of fp32 sums);
  (r3) one conv_bn against conv2d + batch_norm with shared parameter
      names, fp32, at a stage-1 1x1 shape and a 3x3 shape: Y and the
      loss after 3 SGD steps agree within PAIR_TOL;
  (r4) step ms, images/s, MFU (bench.py's FLOPs per image over the bf16
      dense peak), device-busy share and device time by kernel kind from
      torch.profiler over 3 steps, and peak device memory.
ResNet-50 is freed, then the long-context LM (bench.py's
bench_long_context: vocab 32768, dim 1024, 8 heads, 4 layers, ffn 4096,
max_len 8192, batch 2, fused LM head with chunk 8192, reader lc_reader,
AMP Momentum, ParallelExecutor), under PADDLE_FLASH_FWD=twopass and
PADDLE_FLASH_BWD=onepass (restored after each phase):
  (l1) 2 warm-up and 5 timed steps: K4a, K4b and K5 launch exactly
      4 x steps each, K1, K2, K3a and K3b never; every loss is finite;
  (l2) one step from a saved state under twopass/onepass, under the
      default arms (online/kvmajor) and with FLAGS_use_flash_attention
      =False (plain): losses and the updates of layer0_qkv, layer3_down
      and lm_head agree within TRAIN_LOSS_TOL / TRAIN_UPDATE_TOL; the
      two kernel steps are timed in turns (in bf16 their backwards run
      the same kernel, so they differ in the forward, K1 against K4a +
      K4b), and each arm's device time by kernel kind over 3 steps;
  (l3) step ms, tokens/s, MFU by bench.py's causal count and by the
      executed FLOPs (take_extra_flops added), device-busy share and
      device time by kernel kind over 3 steps, peak device memory.
  (p) the probe P (paddle_tpu_torch/tools/probe_exp2.py) against its
      plain version, then its exp and exp2 rates against the card's
      special-function-unit rate.

It prints the card's name and power limit (nvidia-smi), the kernels
line, the serving and training numbers, its own wall time, and as its
last line {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MODEL = dict(vocab=32768, dim=2048, heads=16, layers=12, ffn=8192,
             max_len=512, flash_attention=True)
SLOTS, PREFILL_BATCH, N_REQUESTS, NEW_TOKENS = 8, 1, 8, 32
SEED = 1234
# the training step of bench.py's bench_transformer (:253-271)
TRAIN_BATCH, HEAD_CHUNK, WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = \
    8, 4096, 2, 5, 3
PARAMS_COMPARED = ('layer0_qkv.w_0', 'layer11_down.w_0', 'lm_head.w_0')

# bench.py's bench_resnet (:128-189): ResNet-50 at 224 px, 1000 classes,
# NCHW (the fused conv2d_bn op is NCHW-only), batch RESNET_BATCH
RESNET = dict(depth=50, image_hw=224, class_dim=1000)
RESNET_BATCH = 256
RESNET_PARAMS_COMPARED = ('conv_bn_0.w_0', 'conv_bn_2.w_0', 'fc_0.w_0')
# r2: the kernel step's update differences may reach this multiple of the
# plain step's own spread when only its column sums change order (fp64)
RESNET_SPREAD_FACTOR = 2.0
K6_SOURCE = ('matmul_bn_stats', 'paddle_tpu/pallas/conv_bn.py:38',
             'paddle_tpu_torch/csrc/conv_bn.cu')
# K6 vs its plain version: |y - y_ref| <= tol * max(1, |y_ref|) (bf16 y
# is the same fp32 value rounded once); each column sum within 1e-4 of
# the column's sum of |y| (Σy) or of y² (Σy²): fp32 sums in another order
K6_SUM_RTOL = 1e-4
# fused conv_bn vs conv2d + batch_norm in fp32 (Y is normalised to O(1))
PAIR_TOL = 1e-4

# bench.py's bench_long_context (:274-295): T=8192, batch 2, fused head
# with chunk 8192, under the two alternative flash arms
LC_MODEL = dict(vocab=32768, dim=1024, heads=8, layers=4, ffn=4096,
                max_len=8192, flash_attention=True)
LC_BATCH, LC_HEAD_CHUNK, LC_READER = 2, 8192, 'lc_reader'
LC_ARMS = ('twopass', 'onepass')      # PADDLE_FLASH_FWD, PADDLE_FLASH_BWD
LC_PARAMS_COMPARED = ('layer0_qkv.w_0', 'layer3_down.w_0', 'lm_head.w_0')

# kernel vs plain version on the card: fp32 math in both; bf16 outputs
# are rounded once (2^-8 relative), and K2's dq and K5's dk, dv are
# summed with atomics. lse is fp32 in every dtype: K4a's is held to the
# fp32 tolerance.
KERNEL_ATOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# bf16 K4b also within a relative bound: max |o - o_ref| / (|o_ref| +
# mean |o_ref|). At [16, 8192, 128] typical |o| (~1.8e-2) lies below the
# bf16 atol, which would pass an o a few per cent off everywhere; o is
# rounded to bf16 once (2^-8 relative at most)
O_RTOL = 2e-2
# bf16 K2 and K5 (one tensor-core kernel) also within a relative bound on
# each gradient: max |g - g_ref| / (|g_ref| + mean |g_ref|) for dq, dk and
# dv. At [16, 8192, 128] mean |g| is ~1e-2 while the first rows and keys
# of a head carry |g| near 1, so the atol alone would pass gradients a
# few per cent off where |g| is small; each gradient is rounded to bf16
# once (2^-8 relative at most). A gradient that is zero in exact
# arithmetic (dq and dk at T = 1, a softmax over one key) comes out of
# the fp32 plain version as rounding noise, so the mean in the
# denominator is floored at the fp32 atol, far below mean |g| at the
# paths' shapes (b4 logs it at [16, 8192, 128])
G_RTOL = 2e-2
G_FLOOR = 1e-4
# P vs its plain version: expf / exp2f against torch.exp / torch.exp2,
# each within a few ulps; the chain x <- f(-(x/2 + 1/4)) shrinks errors
# (|d/dx| < 0.4), and its values lie in (0, 1]
PROBE_ATOL = 1e-6
RECOMPUTE_TOL = 1e-3        # prefill vs full recompute (rtol and atol)
# kernel step vs plain step under bf16 AMP: |loss difference|, and the
# largest update difference over the largest update of each parameter
TRAIN_LOSS_TOL = 1e-2
TRAIN_UPDATE_TOL = 5e-2

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES_PER_S = 3.35e12


class PhaseError(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def phase(name):
    """Run the decorated function as one named phase: any exception is
    reported and turns into a PhaseError."""
    def deco(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            log('== phase %s' % name)
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                raise PhaseError('phase %s failed: %s: %s'
                                 % (name, type(e).__name__, e)) from e
            log('== phase %s ok (%.1f s)' % (name, time.perf_counter() - t0))
            return out
        return run
    return deco


def gpu_name_and_power_limit():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bracketed_ms(fns):
    """Time each of fns {'ms', 'plain_ms', 'library_ms'} twice in the
    order kernel, plain, library, library, plain, kernel, so the pairs
    bracket drift in clocks; each time is the mean of its two runs."""
    runs = {key: [] for key in fns}
    for key in ('ms', 'plain_ms', 'library_ms', 'library_ms', 'plain_ms',
                'ms'):
        if key in fns:
            runs[key].append(cuda_ms(fns[key]))
    return {key: float(np.mean(v)) for key, v in runs.items()}


# -- (a) ---------------------------------------------------------------------

KERNEL_SOURCES = ('flash_attention_fwd', 'flash_attention_bwd', 'conv_bn',
                  'probe_exp2')


@phase('a: build kernels')
def build_kernels():
    from paddle_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build(*KERNEL_SOURCES)
    for name, path in paths.items():
        log('built %s -> %s' % (name, os.path.relpath(path, HERE)))
        for line in build.build_logs.get(name, '').splitlines():
            # each kernel's name, registers and spills, and any warning
            # (a serialised wgmma among them)
            if any(w in line for w in ('Compiling entry', 'registers',
                                       'spill', 'arning')):
                log('  ptxas: %s' % line.strip())
    for source, mark in (('flash_attention_fwd', 'flash_fwd_wgmma_kernel'),
                         ('flash_attention_bwd', 'flash_bwd_wgmma_kernel'),
                         ('flash_attention_bwd', 'flash_bwd_dq_wgmma_kernel'),
                         ('flash_attention_bwd',
                          'flash_bwd_dkv_wgmma_kernel')):
        for entry, regs, stores, loads in ptxas_report(
                build.build_logs.get(source, ''), mark):
            log('ptxas %s: %d registers, %d bytes spill stores, %d bytes '
                'spill loads' % (entry, regs, stores, loads))
    log('build seconds: %.2f' % (time.perf_counter() - t0))


def ptxas_report(log_text, mark):
    """[(kernel, registers, spill store bytes, spill load bytes)] for
    every entry function of nvcc's -Xptxas -v log whose mangled name holds
    `mark`; the kernel is named `mark<template arguments>`."""
    import re
    out, entry, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = None
            if mark in m.group(1):
                args = re.search(re.escape(mark) + r'I(.*?)EE', m.group(1))
                entry = '%s<%s>' % (mark, ', '.join(
                    re.findall(r'Li(\d+)E', (args.group(1) + 'E')
                               if args else '')))
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and entry:
            out.append((entry, int(m.group(1))) + spills)
            entry = None
    return out


# -- (b) ---------------------------------------------------------------------

# (name in the kernels line, TPU body it replaces, source, FLOP per
# visited score per head-dim column, [BH, T, d] matrices read, [BH, T, d]
# matrices written, fp32 [BH, T] rows read or written)
KERNELS = {
    'fwd': ('flash_attention_fwd', 'paddle_tpu/pallas/flash_attention.py:171',
            'paddle_tpu_torch/csrc/flash_attention_fwd.cu', 4, 3, 1, 1),
    'k2': ('flash_attention_bwd_kvmajor',
           'paddle_tpu/pallas/flash_attention.py:512',
           'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 10, 4, 3, 2),
    'k3a': ('flash_attention_bwd_dq',
            'paddle_tpu/pallas/flash_attention.py:339',
            'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 6, 4, 1, 2),
    'k3b': ('flash_attention_bwd_dkv',
            'paddle_tpu/pallas/flash_attention.py:385',
            'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 8, 4, 2, 2),
    'k4a': ('flash_attention_fwd_stats',
            'paddle_tpu/pallas/flash_attention.py:229',
            'paddle_tpu_torch/csrc/flash_attention_fwd.cu', 2, 2, 0, 1),
    'k4b': ('flash_attention_fwd_acc',
            'paddle_tpu/pallas/flash_attention.py:276',
            'paddle_tpu_torch/csrc/flash_attention_fwd.cu', 4, 3, 1, 1),
    'k5': ('flash_attention_bwd_onepass',
           'paddle_tpu/pallas/flash_attention.py:436',
           'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 10, 4, 3, 2),
}
PROBE_SOURCE = ('probe_exp2_chain', 'tools/probe_exp2.py:26',
                'paddle_tpu_torch/csrc/probe_exp2.cu')


def flash_bound_ms(kind, BH, T, d, causal, dtype):
    """Least time for the work of one call: the visited scores
    (causal: T(T+1)/2 per head) x FLOP per score at the peak of the
    call's type (fp32 CUDA cores, bf16 tensor cores), against every
    input read once and every output written once (KERNELS: the
    [BH, T, d] matrices in the call's dtype, the rows lse and delta in
    fp32)."""
    flop_per_col, n_in, n_out, n_rows = KERNELS[kind][3:]
    es = 4 if dtype == 'float32' else 2
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = float(flop_per_col) * BH * pairs * d
    nbytes = es * (n_in + n_out) * BH * T * d + 4 * n_rows * BH * T
    peak = PEAK_FP32_FLOPS if dtype == 'float32' else PEAK_BF16_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def sdpa_yardstick(q, k, v, causal):
    """The library yardstick of the flash kernels, timed only: returns
    (call, backend), where call() runs scaled_dot_product_attention on
    4-D views [1, BH, T, d] of q, k, v ([BH, T, d], or [B, H, T, d] as
    they are) under the one fused backend that takes them: flash
    attention first, else memory-efficient attention. PyTorch's fused
    backends refuse 3-D inputs, so without the views every call took the
    unfused math path. Raises if no fused backend takes the inputs: the
    math path is never timed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (t if t.dim() == 4 else t.unsqueeze(0) for t in (q, k, v))
    errors = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=causal)
        try:
            with warnings.catch_warnings():
                # a refusing backend warns its reasons before it raises
                warnings.simplefilter('ignore', UserWarning)
                call()
        except RuntimeError as e:
            errors.append('%s: %s' % (backend.name, str(e).splitlines()[0]))
            continue
        return call, backend.name
    raise RuntimeError('no fused scaled_dot_product_attention backend takes '
                       '%s %s: %s' % (tuple(q4.shape), q4.dtype,
                                      '; '.join(errors)))


# edge shapes of every flash kernel check: (BH, T, d, causal)
RAGGED_SHAPES = ((3, 200, 64, False), (2, 130, 128, True), (4, 64, 64, True),
                 (1, 1, 128, False), (2, 1, 64, True))


def _inputs(rng, BH, T, d, dtype, device):
    """q, k, v, dO from a seeded numpy stream, in the working dtype."""
    import torch
    mk = lambda s: torch.from_numpy(  # noqa: E731
        (rng.randn(BH, T, d) * s).astype('float32')).to(device).to(
            getattr(torch, dtype))
    return mk(0.5), mk(0.5), mk(1.0), mk(1.0)


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _check_shape(fa, rng, dev, BH, T, d, causal, dtype):
    """Run K1, K2, K3a and K3b once at one shape and hold each against
    its plain version (K1 by check_fwd_output; the gradients of K2, K3a
    and K3b by check_grads: G_RTOL in bf16), and launch K3a and K3b a
    second time on the same inputs: the split arm is the deterministic
    one, so both launches must give the same bits. Returns {kind:
    max_abs_err}."""
    import torch
    q, k, v, do = _inputs(rng, BH, T, d, dtype, dev)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
    o_err, o_rel, lse_err, fwd_ok = check_fwd_output(o, lse, o_ref, lse_ref,
                                                     dtype)
    errs = {'fwd': max(o_err, lse_err)}
    finite = bool(torch.isfinite(o).all())
    # the backward kernels get the plain forward's o and lse, so each is
    # held to the plain backward on identical inputs
    delta = fa.bwd_delta(o_ref, do)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, o_ref, lse_ref,
                                                  do, causal, scale)
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    got = {'k2': fa.flash_attention_bwd_kvmajor(*args),
           'k3a': (fa.flash_attention_bwd_dq(*args),),
           'k3b': fa.flash_attention_bwd_dkv(*args)}
    again = {'k3a': (fa.flash_attention_bwd_dq(*args),),
             'k3b': fa.flash_attention_bwd_dkv(*args)}
    torch.cuda.synchronize()
    want = {'k2': (dq, dk, dv), 'k3a': (dq,), 'k3b': (dk, dv)}
    rels, oks = {}, {'fwd': fwd_ok}
    for kind, out in got.items():
        errs[kind], rels[kind], oks[kind] = check_grads(out, want[kind], dtype)
        finite = finite and all(bool(torch.isfinite(t).all()) for t in out)
    same = {kind: all(torch.equal(a, b) for a, b in zip(got[kind], out))
            for kind, out in again.items()}
    bad = [kind for kind in errs if not oks[kind]]
    varied = [kind for kind, s in same.items() if not s]
    log('[%d, %d, %d] causal=%s %s: max_abs_err %s (atol %g); %s o %.3e, '
        'lse %.3e (atol %g), o relative %.3e; relative %s (bounds %s); '
        'second launch bit-identical: %s %s'
        % (BH, T, d, causal, dtype,
           ', '.join('%s %.3e' % (KERNELS[kd][0], e)
                     for kd, e in errs.items()),
           KERNEL_ATOL[dtype], KERNELS['fwd'][0], o_err, lse_err,
           KERNEL_ATOL['float32'], o_rel,
           '; '.join('%s %s %s' % (KERNELS[kd][0], _GRAD_NAMES[kd],
                                   ', '.join('%.3e' % r for r in rs))
                     for kd, rs in rels.items()),
           '%g / %g' % (O_RTOL, G_RTOL) if dtype == 'bfloat16' else 'none',
           ', '.join('%s %s' % (KERNELS[kd][0], 'yes' if s else 'NO')
                     for kd, s in same.items()),
           'ok' if not bad and not varied and finite else 'MISMATCH'))
    faults = (['%s disagree with their plain versions'
               % [KERNELS[kd][0] for kd in bad]] if bad else []) + \
        (['%s give other bits on a second launch'
          % [KERNELS[kd][0] for kd in varied]] if varied else []) + \
        ([] if finite else ['a result is not finite'])
    if faults:
        raise AssertionError('%s at [%d, %d, %d] %s'
                             % ('; '.join(faults), BH, T, d, dtype))
    return errs


# the gradients each backward kind returns, in the order it returns them
_GRAD_NAMES = {'k2': 'dq, dk, dv', 'k3a': 'dq', 'k3b': 'dk, dv'}


def _row(kind, dtype, shape, causal, err, times, bound):
    name, replaces, source = KERNELS[kind][:3]
    if kind == 'fwd' and dtype == 'bfloat16':
        name = 'flash_attention_fwd_bf16'
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': err,
            'ms': times['ms'], 'plain_ms': times['plain_ms'],
            'bound_ms': bound[0], 'bound_by': bound[1],
            'library_ms': times.get('library_ms'),
            'device_ms': times.get('device_ms'),
            'shape': list(shape), 'dtype': dtype, 'causal': causal}


def _over_library(device_ms, library_ms):
    """' (N.NNx the library)' from two torch.profiler device times, the
    one clock both are read on; '' where either is missing."""
    if device_ms is None or library_ms is None:
        return ''
    return ' (%.2fx the library by device time)' % (device_ms / library_ms)


def _fmt_ms(x):
    return 'n/a' if x is None else '%.4f' % x


def _log_rows(rows):
    for r in rows:
        log('%s %s %s: kernel %.4f ms (device time %s ms), plain %.4f ms, '
            'library %s ms, bound %.4f ms (%s)%s'
            % (r['name'], r['dtype'], r['shape'], r['ms'],
               _fmt_ms(r.get('device_ms')), r['plain_ms'],
               _fmt_ms(r['library_ms']),
               r['bound_ms'], r['bound_by'],
               _over_library(r.get('device_ms'), r['library_ms'])))


def _device_ms(fn, iters=10):
    """Device time of one fn() from torch.profiler: the sum of its
    kernels' time over `iters` calls, per call (None if the profiler saw
    no device events in two windows: it has once returned an empty
    window for a kernel that the next window traced). Unlike CUDA events
    around the calls, it leaves out the time the card waits for the
    host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages()
                 if getattr(e, 'device_type', None) == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    return None


def _library_ms(fn):
    """Device time of one library call fn() by torch.profiler, the only
    clock the yardstick is read on: at small shapes the card runs the
    library's calls faster than the host issues them, so CUDA events
    around the calls would time the host. Raises if the profiler sees no
    device time."""
    ms = _device_ms(fn)
    if ms is None:
        raise RuntimeError('torch.profiler saw no device time in the '
                           'library call')
    return ms


def _library_fwd_bwd(q, k, v, do, causal, label):
    """The yardstick's forward, and its backward as fwd+bwd minus fwd,
    both by _library_ms. Returns (fwd ms, bwd ms)."""
    import torch
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fwd, backend = sdpa_yardstick(qg, kg, vg, causal)
    do4 = do.reshape(fwd().shape)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), do4)

    fwd_ms, both_ms = _library_ms(fwd), _library_ms(fwd_bwd)
    log('library (scaled_dot_product_attention, backend %s, %s %s causal=%s):'
        ' device time fwd %.4f ms, bwd %.4f ms (fwd+bwd minus fwd)'
        % (backend, label, list(q.shape), causal, fwd_ms, both_ms - fwd_ms))
    return fwd_ms, both_ms - fwd_ms


def _timed(fns):
    """bracketed_ms of fns, plus the kernel's device time by
    torch.profiler ('device_ms', None if not measured)."""
    times = bracketed_ms(fns)
    times['device_ms'] = _device_ms(fns['ms'])
    return times


@phase('b: kernels vs plain versions')
def check_kernels(cfg):
    """Correctness at the paths' shapes and at ragged ones, then times at
    the paths' shapes. Returns the kernels line's rows."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(SEED)
    dev = torch.device('cuda', 0)
    d = cfg.dim // cfg.heads
    T = cfg.max_len
    serve_bh = PREFILL_BATCH * cfg.heads      # the prefill's attention
    train_bh = TRAIN_BATCH * cfg.heads        # the training step's
    path_errs = {}
    shapes = [(serve_bh, T, d, True, 'float32'),
              (train_bh, T, d, True, 'bfloat16'),
              (train_bh, T, d, True, 'float32')]
    shapes += [s + (dtype,) for dtype in ('float32', 'bfloat16')
               for s in RAGGED_SHAPES]
    for BH, t, dd, causal, dtype in shapes:
        errs = _check_shape(fa, rng, dev, BH, t, dd, causal, dtype)
        if (BH, t, dd) == (serve_bh, T, d) and dtype == 'float32':
            path_errs[('fwd', 'float32')] = errs['fwd']
        if (BH, t, dd) == (train_bh, T, d) and dtype == 'bfloat16':
            for kind, e in errs.items():
                path_errs[(kind, 'bfloat16')] = e

    rows = []
    scale = d ** -0.5
    # K1 fp32 at the serving shape, as in the first slice
    q, k, v, _ = _inputs(rng, serve_bh, T, d, 'float32', dev)
    library, backend = sdpa_yardstick(q, k, v, True)
    times = _timed({
        'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
        'plain_ms': lambda: fa.flash_attention_reference(q, k, v, True,
                                                         scale)})
    times['library_ms'] = _library_ms(library)
    log('library (scaled_dot_product_attention, backend %s, float32 %s '
        'causal=True): device time fwd %.4f ms'
        % (backend, [serve_bh, T, d], times['library_ms']))
    rows.append(_row('fwd', 'float32', (serve_bh, T, d), True,
                     path_errs[('fwd', 'float32')], times,
                     flash_bound_ms('fwd', serve_bh, T, d, True,
                                    'float32')))

    # the training step's kernels: bf16 [BH, T, d] causal
    q, k, v, do = _inputs(rng, train_bh, T, d, 'bfloat16', dev)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    lib_fwd_ms, lib_bwd_ms = _library_fwd_bwd(q, k, v, do, True, 'bf16')
    plain_bwd = lambda: fa.flash_attention_bwd_reference(  # noqa: E731
        q, k, v, o, lse, do, True, scale)
    fns = {
        'fwd': {'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
                'plain_ms': lambda: fa.flash_attention_reference(
                    q, k, v, True, scale)},
        'k2': {'ms': lambda: fa.flash_attention_bwd_kvmajor(*args),
               'plain_ms': plain_bwd},
        'k3a': {'ms': lambda: fa.flash_attention_bwd_dq(*args),
                'plain_ms': plain_bwd},
        'k3b': {'ms': lambda: fa.flash_attention_bwd_dkv(*args),
                'plain_ms': plain_bwd},
    }
    for kind, f in fns.items():
        times = _timed(f)
        times['library_ms'] = lib_fwd_ms if kind == 'fwd' else lib_bwd_ms
        rows.append(_row(kind, 'bfloat16', (train_bh, T, d), True,
                         path_errs[(kind, 'bfloat16')], times,
                         flash_bound_ms(kind, train_bh, T, d, True,
                                        'bfloat16')))
    _log_rows(rows)
    return rows


def _acc_fp64_err(q, k, v, lse, causal, scale, outs):
    """Max |x - o64| for each x in outs, where o64 = exp(s - lse)·v is
    evaluated in fp64 (no all-masked rows): another order of sums and
    another rounding than any fp32 evaluation."""
    import torch
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, float('-inf'))
    s.sub_(lse.double()[..., None]).exp_()
    o64 = torch.matmul(s, v.double())
    del s
    return [(x.double() - o64).abs().max().item() for x in outs]


def _acc_one_bf16_p(q, k, v, lse, causal, scale):
    """K4b's function with P = exp(s - lse) rounded once to v's dtype
    before P·v, as the TPU kernel rounds it (no all-masked rows)."""
    import torch
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, float('-inf'))
    p = s.sub_(lse[..., None]).exp_().to(v.dtype)
    del s
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def rel_err(x, ref, floor=0.0):
    """max |x - ref| / (|ref| + max(mean |ref|, floor)), elementwise in
    fp32: K4b's o (no floor) and the backward's gradients (G_RTOL's
    comment says why their floor)."""
    x, ref = x.float(), ref.float()
    mag = ref.abs()
    return ((x - ref).abs() /
            (mag + max(mag.mean().item(), floor))).max().item()


def check_acc_output(o, o_ref, dtype):
    """K4b's o against its plain version: (max_abs_err, rel_err, ok);
    ok needs the atol of the dtype and, in bf16, O_RTOL."""
    err, rel = _max_err((o,), (o_ref,)), rel_err(o, o_ref)
    ok = err <= KERNEL_ATOL[dtype] and (dtype != 'bfloat16' or rel <= O_RTOL)
    return err, rel, ok


def check_fwd_output(o, lse, o_ref, lse_ref, dtype):
    """K1's (o, lse) against its plain version: (o max_abs_err, o rel_err,
    lse max_abs_err, ok); ok needs o as check_acc_output holds K4b's (the
    atol of the dtype and, in bf16, O_RTOL) and lse within the fp32 atol
    in both dtypes, as K4a's lse is held."""
    o_err, o_rel, o_ok = check_acc_output(o, o_ref, dtype)
    lse_err = _max_err((lse,), (lse_ref,))
    return o_err, o_rel, lse_err, o_ok and lse_err <= KERNEL_ATOL['float32']


def check_grads(got, want, dtype):
    """(dq, dk, dv) against their plain versions: (max_abs_err, relative
    error of each by rel_err with G_FLOOR, ok); ok needs the atol of the
    dtype and, in bf16, G_RTOL on each gradient."""
    err = _max_err(got, want)
    rels = [rel_err(g, w, G_FLOOR) for g, w in zip(got, want)]
    ok = err <= KERNEL_ATOL[dtype] and (dtype != 'bfloat16' or
                                        max(rels) <= G_RTOL)
    return err, rels, ok


def _bwd_fp64(q, k, v, o, lse, do, causal, scale, heads=2):
    """The backward's (dq, dk, dv) evaluated in fp64 from the same
    inputs (o and lse as given), `heads` heads at a time; and the same
    function in fp32 with P and dS rounded once to bf16 before their
    products, as the TPU kernels round them (:409, :412). No all-masked
    rows."""
    import torch
    BH, T, _ = q.shape
    keep = (torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    g64 = [torch.empty(q.shape, dtype=torch.float64, device=q.device)
           for _ in range(3)]
    g16 = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
           for _ in range(3)]
    for b0 in range(0, BH, heads):
        sl = slice(b0, b0 + heads)
        for out, dt in ((g64, torch.float64), (g16, torch.float32)):
            qs, kf, vf, dof = (x[sl].to(dt) for x in (q, k, v, do))
            qs = qs * scale
            s = torch.matmul(qs, kf.transpose(-1, -2))
            if causal:
                s.masked_fill_(~keep, float('-inf'))
            p = s.sub_(lse[sl].to(dt)[..., None]).exp_()
            delta = (dof * o[sl].to(dt)).sum(-1)
            ds = torch.matmul(dof, vf.transpose(-1, -2))
            ds.sub_(delta[..., None]).mul_(p)
            if dt == torch.float32:
                p, ds = p.bfloat16().float(), ds.bfloat16().float()
            out[2][sl] = torch.matmul(p.transpose(-1, -2), dof)
            out[1][sl] = torch.matmul(ds.transpose(-1, -2), qs)
            out[0][sl] = torch.matmul(ds, kf) * scale
            del s, p, ds
    return g64, g16


def _log_bwd_fp64(q, k, v, o, lse, do, causal, scale, got, want, label):
    """Log the kernel's and the plain version's (dq, dk, dv) against an
    fp64 evaluation, and how far one bf16 rounding of P and dS puts the
    gradients from the plain version, relative (G_RTOL's measure)."""
    import torch
    g64, g16 = _bwd_fp64(q, k, v, o, lse, do, causal, scale)
    for who, grads in (('flash_attention_bwd_onepass', got),
                       ('its plain version', want)):
        log('%s: %s vs fp64 max_abs_err dq, dk, dv %s; relative %s'
            % (label, who,
               ', '.join('%.3e' % (g.double() - r).abs().max().item()
                         for g, r in zip(grads, g64)),
               ', '.join('%.3e' % rel_err(g, r, G_FLOOR)
                         for g, r in zip(grads, g64))))
    log('%s: mean |g| of the fp64 dq, dk, dv %s (G_FLOOR %g)'
        % (label, ', '.join('%.3e' % r.abs().mean().item() for r in g64),
           G_FLOOR))
    if q.dtype == torch.bfloat16:
        log('%s: with P and dS rounded once to bf16 (the TPU kernels\' '
            'rounding; the kernel carries both as bf16 hi + lo) the plain '
            'evaluation lies %s from its plain version, relative (bound '
            '%g)' % (label, ', '.join('%.3e' % rel_err(g, w, G_FLOOR)
                                      for g, w in zip(g16, want)), G_RTOL))
    del g64, g16
    torch.cuda.empty_cache()


def _check_long_shape(fa, rng, dev, BH, T, d, causal, dtype, fp64=False):
    """Run K4a, K4b and K5 once at one shape and hold each against its
    plain version on the same inputs (K4b gets the plain lse, K5 the
    plain forward's o and lse); in bf16 also K1, the default arm's
    forward, by check_fwd_output. Returns {kind: max_abs_err}. K4b's o is
    also held to O_RTOL and K5's gradients to G_RTOL in bf16. fp64=True
    also logs K4b's, K1's, K5's and their plain versions' distance from
    an fp64 evaluation. The plain intermediates are freed before
    returning."""
    import torch
    q, k, v, do = _inputs(rng, BH, T, d, dtype, dev)
    scale = d ** -0.5
    lse_ref = fa.flash_attention_stats_reference(q, k, causal, scale)
    lse = fa.flash_attention_fwd_stats(q, k, causal, scale)
    o = fa.flash_attention_fwd_acc(q, k, v, lse_ref, causal, scale)
    torch.cuda.synchronize()
    o_ref = fa.flash_attention_acc_reference(q, k, v, lse_ref, causal, scale)
    o_err, o_rel, o_ok = check_acc_output(o, o_ref, dtype)
    errs = {'k4a': _max_err((lse,), (lse_ref,)), 'k4b': o_err}
    fwd_ok, k1_outs = True, ()
    if dtype == 'bfloat16':
        o1, lse1 = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o1_ref, lse1_ref = fa.flash_attention_reference(q, k, v, causal,
                                                        scale)
        o1_err, o1_rel, lse1_err, fwd_ok = check_fwd_output(
            o1, lse1, o1_ref, lse1_ref, dtype)
        errs['fwd'] = max(o1_err, lse1_err)
        k1_outs = (o1, o1_ref)
        log('[%d, %d, %d] causal=%s %s: flash_attention_fwd o %.3e, lse '
            '%.3e (atol o %g, lse %g), o relative %.3e (bound %g) %s'
            % (BH, T, d, causal, dtype, o1_err, lse1_err, KERNEL_ATOL[dtype],
               KERNEL_ATOL['float32'], o1_rel, O_RTOL,
               'ok' if fwd_ok else 'MISMATCH'))
    if fp64:
        e64 = _acc_fp64_err(q, k, v, lse_ref, causal, scale,
                            (o, o_ref) + k1_outs)
        log('[%d, %d, %d] causal=%s %s: vs fp64 max_abs_err '
            'flash_attention_fwd_acc %.3e, its plain version %.3e%s; mean '
            '|o| %.3e' % (BH, T, d, causal, dtype, e64[0], e64[1],
                          ', flash_attention_fwd %.3e, its plain version '
                          '%.3e' % tuple(e64[2:]) if k1_outs else '',
                          o_ref.float().abs().mean().item()))
    if fp64 and dtype == 'bfloat16':
        log('[%d, %d, %d] causal=%s %s: with P rounded once to bf16 (the '
            'TPU kernel\'s rounding; the kernel carries P as bf16 hi + lo) '
            'the plain evaluation lies %.3e from its plain version, '
            'relative (bound %g)'
            % (BH, T, d, causal, dtype,
               rel_err(_acc_one_bf16_p(q, k, v, lse_ref, causal, scale),
                         o_ref), O_RTOL))
    got = fa.flash_attention_bwd_onepass(q, k, v, do, lse_ref,
                                         fa.bwd_delta(o_ref, do), causal,
                                         scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                            causal, scale)
    errs['k5'], g_rels, g_ok = check_grads(got, want, dtype)
    if fp64:
        _log_bwd_fp64(q, k, v, o_ref, lse_ref, do, causal, scale, got, want,
                      '[%d, %d, %d] causal=%s %s' % (BH, T, d, causal, dtype))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (lse, o) + got + k1_outs[:1])
    tols = {'k4a': KERNEL_ATOL['float32'], 'k4b': KERNEL_ATOL[dtype],
            'k5': KERNEL_ATOL[dtype]}
    oks = {'k4a': errs['k4a'] <= tols['k4a'], 'k4b': o_ok, 'k5': g_ok,
           'fwd': fwd_ok}
    bad = [kind for kind in errs if not oks[kind]]
    log('[%d, %d, %d] causal=%s %s: max_abs_err %s (atol lse %g, o and '
        'grads %g); flash_attention_fwd_acc relative %.3e, '
        'flash_attention_bwd_onepass dq, dk, dv relative %s (bounds %s) %s'
        % (BH, T, d, causal, dtype,
           ', '.join('%s %.3e' % (KERNELS[kd][0], e)
                     for kd, e in errs.items()),
           tols['k4a'], tols['k5'], o_rel,
           ', '.join('%.3e' % r for r in g_rels),
           '%g / %g' % (O_RTOL, G_RTOL) if dtype == 'bfloat16' else 'none',
           'ok' if not bad and finite else 'MISMATCH'))
    del q, k, v, do, lse, o, got, want, lse_ref, o_ref, k1_outs
    torch.cuda.empty_cache()
    if bad or not finite:
        raise AssertionError('%s disagree with their plain versions at '
                             '[%d, %d, %d] %s (finite: %s)'
                             % ([KERNELS[kd][0] for kd in bad], BH, T, d,
                                dtype, finite))
    return errs


@phase('b4: K4a, K4b, K5 and bf16 K1 vs plain versions at the '
       'long-context shape')
def check_long_kernels(cfg):
    """Correctness at the long-context path's shape (bf16 causal, and
    fp32, where KERNEL_ATOL is ~1% of typical values: |o| ~1e-2 over up
    to 8192 keys of a near-uniform softmax; bf16 K4b's and K1's o also
    within O_RTOL) and at phase b's ragged shapes, fp32 and bf16; then
    times at the path's shape (K1 bf16 too: the default arm's forward).
    Returns the kernels line's rows."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(SEED + 6)
    dev = torch.device('cuda', 0)
    d, T = cfg.dim // cfg.heads, cfg.max_len
    bh = LC_BATCH * cfg.heads
    path_errs = _check_long_shape(fa, rng, dev, bh, T, d, True, 'bfloat16',
                                  fp64=True)
    _check_long_shape(fa, rng, dev, bh, T, d, True, 'float32', fp64=True)
    for dtype in ('float32', 'bfloat16'):
        for shape in RAGGED_SHAPES:
            _check_long_shape(fa, rng, dev, *shape, dtype)

    scale = d ** -0.5
    q, k, v, do = _inputs(rng, bh, T, d, 'bfloat16', dev)
    lse = fa.flash_attention_fwd_stats(q, k, True, scale)
    o = fa.flash_attention_fwd_acc(q, k, v, lse, True, scale)
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    lib_fwd_ms, lib_bwd_ms = _library_fwd_bwd(q, k, v, do, True, 'bf16')
    pair = _timed({
        'ms': lambda: fa.flash_attention_fwd_acc(
            q, k, v, fa.flash_attention_fwd_stats(q, k, True, scale), True,
            scale),
        'plain_ms': lambda: fa.flash_attention_acc_reference(
            q, k, v, fa.flash_attention_stats_reference(q, k, True, scale),
            True, scale)})
    log('K4a + K4b (the twopass forward) at %s bf16 causal: kernels %.4f '
        'ms (device time %s ms), plain %.4f ms, library forward %.4f ms%s'
        % ([bh, T, d], pair['ms'], _fmt_ms(pair['device_ms']),
           pair['plain_ms'], lib_fwd_ms,
           _over_library(pair['device_ms'], lib_fwd_ms)))
    fns = {
        'fwd': {'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
                'plain_ms': lambda: fa.flash_attention_reference(
                    q, k, v, True, scale)},
        'k4a': {'ms': lambda: fa.flash_attention_fwd_stats(q, k, True,
                                                           scale),
                'plain_ms': lambda: fa.flash_attention_stats_reference(
                    q, k, True, scale)},
        'k4b': {'ms': lambda: fa.flash_attention_fwd_acc(q, k, v, lse, True,
                                                         scale),
                'plain_ms': lambda: fa.flash_attention_acc_reference(
                    q, k, v, lse, True, scale)},
        'k5': {'ms': lambda: fa.flash_attention_bwd_onepass(*args),
               'plain_ms': lambda: fa.flash_attention_bwd_reference(
                   q, k, v, o, lse, do, True, scale)},
    }
    rows = []
    for kind, f in fns.items():
        times = _timed(f)
        # one PyTorch call computes K1's function (the library forward)
        # and K5's (the library backward); none computes K4a's or K4b's
        # alone (the pair's line is above)
        times['library_ms'] = {'fwd': lib_fwd_ms, 'k5': lib_bwd_ms}.get(kind)
        rows.append(_row(kind, 'bfloat16', (bh, T, d), True, path_errs[kind],
                         times, flash_bound_ms(kind, bh, T, d, True,
                                               'bfloat16')))
    _log_rows(rows)
    fa.take_extra_flops()     # the timing launches are not a step's work
    del q, k, v, do, lse, o, delta, args
    torch.cuda.empty_cache()
    return rows


# -- (c) ---------------------------------------------------------------------

def prompts_for(vocab, max_len):
    rng = np.random.RandomState(SEED + 1)
    lens = np.linspace(32, min(480, max_len - NEW_TOKENS),
                       N_REQUESTS).astype(int)
    return [rng.randint(1, vocab, size=int(n)).tolist() for n in lens]


@phase('c1: build, initialise and save the model')
def build_and_save(cfg, place, model_dir):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[1, cfg.max_len, 1],
                                 dtype='int64', append_batch_size=False)
        logits = transformer.language_model_logits(toks, cfg)
    n_params = sum(int(np.prod(v.shape)) for v in prog.list_vars()
                   if v.persistable)
    log('model: vocab %d, dim %d, heads %d, layers %d, ffn %d, max_len %d, '
        'flash %s: %d parameters (%.2f GB fp32), no depth cut'
        % (cfg.vocab, cfg.dim, cfg.heads, cfg.layers, cfg.ffn, cfg.max_len,
           cfg.flash_attention, n_params, n_params * 4 / 1e9))
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ['tokens'], [logits], exe,
                                      main_program=prog)
    return n_params


@phase('c2: load through AnalysisPredictor and prepare decoding')
def load_and_prepare(model_dir, place):
    import paddle_tpu_torch as fluid
    pred = fluid.inference.AnalysisPredictor(
        fluid.inference.AnalysisConfig(model_dir, place=place))
    dec = pred.prepare_decoding(slots=SLOTS, prefill_batch=PREFILL_BATCH)
    return pred, dec


@phase('c3: serve requests through LMServer')
def serve(dec, prompts, counters, sync):
    import paddle_tpu_torch as fluid
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with fluid.serving.LMServer(dec) as srv:
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts]
        streams = [srv.result(h, timeout=600) for h in handles]
        sync()
        wall = time.perf_counter() - t0
        stats = srv.stats()
    launches = {name: c.launches for name, c in counters.items()}
    if stats['prefills'] != len(prompts) or stats['completed'] != \
            len(prompts):
        raise AssertionError('engine stats %r' % (stats,))
    for p, s in zip(prompts, streams):
        if len(s) != NEW_TOKENS:
            raise AssertionError('a stream of %d tokens, want %d'
                                 % (len(s), NEW_TOKENS))
    need = stats['prefills'] * dec._pair.spec.layers
    log('main path: %d requests, %d prefills, %d decode steps, %.3f s, '
        '%.1f generated tokens/s; launches %s (flash needs >= %d)'
        % (len(prompts), stats['prefills'], stats['decode_steps'], wall,
           len(prompts) * NEW_TOKENS / wall, json.dumps(launches), need))
    if launches['flash_attention_fwd'] < need:
        raise AssertionError('flash_attention_fwd launched %d times on the '
                             'main path, want >= %d'
                             % (launches['flash_attention_fwd'], need))
    return streams, launches, wall, stats


# -- (d), (e) ----------------------------------------------------------------

def _padded(prompt, T):
    toks = np.zeros((1, T, 1), np.int64)
    toks[0, :len(prompt), 0] = prompt
    return toks


@phase('d: prefill and first token vs full recompute')
def check_recompute(pred, dec, prompts, streams):
    worst = 0.0
    for p, s in zip(prompts, streams):
        full = pred.run([_padded(p, dec.max_len)])[0][0, len(p) - 1]
        ids, logits = dec.prefill([p], [0], return_logits=True)
        if not np.isfinite(logits).all() or logits[0].shape != full.shape:
            raise AssertionError('prefill logits %s not finite or not of '
                                 'shape %s' % (logits[0].shape, full.shape))
        np.testing.assert_allclose(logits[0], full, rtol=RECOMPUTE_TOL,
                                   atol=RECOMPUTE_TOL)
        worst = max(worst, float(np.abs(logits[0] - full).max()))
        # the first token is the recompute's argmax, up to a near tie
        # within the stated tolerance
        if s[0] != int(np.argmax(full)) and \
                full[s[0]] < full.max() - RECOMPUTE_TOL:
            raise AssertionError('first token %d, recompute argmax %d'
                                 % (s[0], int(np.argmax(full))))
        if int(ids[0]) != s[0]:
            raise AssertionError('prefill token %d, engine first token %d'
                                 % (int(ids[0]), s[0]))
    log('prefill vs full recompute: max_abs_diff %.3e over %d requests'
        % (worst, len(prompts)))


@phase('e: engine streams vs solo generate')
def check_solo(dec, prompts, streams):
    dec.reset()
    for i, (p, s) in enumerate(zip(prompts, streams)):
        solo = dec.generate(p, NEW_TOKENS, slot=0)
        if solo != s:
            raise AssertionError('request %d: engine stream differs from '
                                 'solo generate' % i)
    log('engine streams equal solo generate for %d requests' % len(prompts))


@phase('f: prefill and decode-step timing')
def time_path(dec, prompts, sync):
    p = prompts[-1]
    dec.prefill([p], [0])
    sync()
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        dec.prefill([p], [0])
    sync()
    prefill_ms = (time.perf_counter() - t0) / n * 1e3
    toks = np.ones((dec.slots,), np.int64)
    poss = np.full((dec.slots,), len(p), np.int32)
    dec.decode_step(toks, poss)
    sync()
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        dec.decode_step(toks, poss)
    sync()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    log('prefill (%d-token prompt, padded to %d): %.3f ms; decode step '
        '(%d slots): %.3f ms; %.1f tokens/s at full slots'
        % (len(p), dec.max_len, prefill_ms, dec.slots, step_ms,
           dec.slots / step_ms * 1e3))
    return prefill_ms, step_ms


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


@phase('g: device time inside the prefill and the decode step')
def profile_path(dec, prompts, times_ms, sync):
    """torch.profiler over a few calls of each: device time per call,
    its share of the unprofiled wall time (phase f), and the kernels
    that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p = prompts[-1]
    toks = np.ones((dec.slots,), np.int64)
    poss = np.full((dec.slots,), len(p), np.int32)
    calls = {'prefill': lambda: dec.prefill([p], [0]),
             'decode_step': lambda: dec.decode_step(toks, poss)}
    n = 5
    for name, fn in calls.items():
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            sync()
        # kernels only: an aten op's device time repeats its kernels'
        events = [e for e in prof.key_averages()
                  if getattr(e, 'device_type', None) == DeviceType.CUDA
                  and _device_us(e) > 0]
        device_ms = sum(_device_us(e) for e in events) / n / 1e3
        if device_ms == 0:
            log('%s: device time not measured (the profiler saw no device '
                'events)' % name)
            continue
        top = sorted(events, key=_device_us, reverse=True)[:6]
        log('%s: device busy %.3f ms of %.3f ms wall (%.1f%%); top: %s'
            % (name, device_ms, times_ms[name],
               100.0 * device_ms / times_ms[name],
               '; '.join('%s %.3f ms' % (e.key[:48], _device_us(e) / n / 1e3)
                         for e in top)))


# -- (t1)-(t4): the training step --------------------------------------------

def train_flops_per_token(cfg, causal=False):
    """bench.py's _transformer_train_flops_per_token (:93-100): 2 FLOP
    per MAC over qkv+proj, ffn, attention and the head, x3 for forward +
    backward. Attention counts T per token, or the useful T/2 when
    causal (bench.py's long-context series)."""
    d, f, t, v, n = cfg.dim, cfg.ffn, cfg.max_len, cfg.vocab, cfg.layers
    per_layer = 4 * d * d + 2 * d * f
    attn = (t if causal else 2 * t) * d
    return 3 * 2 * (n * (per_layer + attn) + d * v)


class Trainer(object):
    """An LM training step built as bench.py's _bench_lm builds it
    (:198-235): py_reader `reader_name` fed `batch` sequences a step,
    trunk, fused LM head with `head_chunk`, mean, Momentum(0.001, 0.9)
    under AMP; its state on the card."""

    def __init__(self, cfg, place, batch, head_chunk, reader_name):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import transformer as tfm
        self.fluid, self.cfg, self.batch = fluid, cfg, batch
        self.main, startup = fluid.Program(), fluid.Program()
        self.main.random_seed = startup.random_seed = SEED
        with fluid.unique_name.guard(), \
                fluid.program_guard(self.main, startup):
            self.reader = fluid.layers.py_reader(
                capacity=4,
                shapes=[(-1, cfg.max_len, 1), (-1, cfg.max_len, 1)],
                dtypes=['int64', 'int64'], name=reader_name,
                use_double_buffer=True)
            tokens, labels = fluid.layers.read_file(self.reader)
            trunk = tfm.language_model_trunk(tokens, cfg)
            cost = fluid.layers.fused_softmax_cross_entropy(
                trunk, labels, cfg.vocab, chunk=head_chunk, name='lm_head')
            self.avg_cost = fluid.layers.mean(cost)
            opt = fluid.optimizer.Momentum(learning_rate=0.001,
                                           momentum=0.9)
            opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(self.avg_cost)
        self.scope = fluid.Scope()
        fluid.Executor(place).run(startup, scope=self.scope)
        self.pe = fluid.ParallelExecutor(
            use_cuda=True, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)
        self.persistables = [v.name for v in self.main.list_vars()
                             if v.persistable and
                             self.scope.find_var(v.name) is not None]

    def feed(self, provider):
        if self.reader._started:
            self.reader.reset()
        self.reader.decorate_tensor_provider(provider)
        self.reader.start()

    def step(self):
        return float(self.pe.run(fetch_list=[self.avg_cost.name])[0])

    def snapshot(self):
        return {n: self.scope.find_var(n).clone() for n in self.persistables}

    def restore(self, saved):
        for n, t in saved.items():
            self.scope.find_var(n).copy_(t)


def bench_provider(cfg, batch, rng):
    """bench.py's token provider (:228-232)."""
    def provider():
        while True:
            toks = rng.randint(0, cfg.vocab,
                               size=(batch, cfg.max_len, 1)).astype('int64')
            yield [toks, np.roll(toks, -1, axis=1)]
    return provider


@phase('t1: train the flagship LM (AMP Momentum, py_reader, '
       'ParallelExecutor)')
def train_steps(cfg, place, counters, sync):
    import torch
    t0 = time.perf_counter()
    tr = Trainer(cfg, place, TRAIN_BATCH, HEAD_CHUNK, 'tfm_reader')
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    ops = tr.main.global_block().ops
    log('training program: %d ops of %d types, %d parameters (%.2f GB '
        'fp32), batch %d x %d tokens, no depth cut; built and initialised '
        'in %.1f s' % (len(ops), len(set(o.type for o in ops)), n_params,
                       n_params * 4 / 1e9, tr.batch, cfg.max_len,
                       time.perf_counter() - t0))
    tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(0)))
    losses = [tr.step() for _ in range(WARMUP_STEPS)]
    sync()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step; launches %s; peak '
        'device memory %.2f GB' % (TIMED_STEPS, wall, step_ms,
                                   json.dumps(launches), peak_gb))
    if not all(np.isfinite(losses)):
        raise AssertionError('a training loss is not finite: %r' % losses)
    need = cfg.layers * TIMED_STEPS
    if launches['flash_attention_fwd'] < need:
        raise AssertionError('K1 launched %d times in %d steps, want >= %d'
                             % (launches['flash_attention_fwd'],
                                TIMED_STEPS, need))
    if launches['flash_attention_bwd_kvmajor'] != need:
        raise AssertionError('K2 launched %d times in %d steps, want %d'
                             % (launches['flash_attention_bwd_kvmajor'],
                                TIMED_STEPS, need))
    others = [KERNELS[kd][0] for kd in ('k3a', 'k3b', 'k4a', 'k4b', 'k5')]
    if any(launches[n] for n in others):
        raise AssertionError('K3, K4 or K5 launched on the default arms: %r'
                             % launches)
    return tr, losses, step_ms, launches, peak_gb


def _one_step(tr, saved, batch, params=PARAMS_COMPARED):
    """Restore the saved state, run one step on `batch`, and return the
    loss and the updates of `params`."""
    tr.restore(saved)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    loss = tr.step()
    updates = {n: (tr.scope.find_var(n) - saved[n]).float()
               for n in params}
    return loss, updates


def _update_diffs(a, b, params):
    """Per parameter: max |update difference| over max |update| of b."""
    return {n: ((a[1][n] - b[1][n]).abs().max() /
                b[1][n].abs().max().clamp_min(1e-30)).item()
            for n in params}


def _compare(what, a, b, params=PARAMS_COMPARED):
    """|loss difference| and, per parameter, max |update difference| over
    max |update|; raises beyond TRAIN_LOSS_TOL / TRAIN_UPDATE_TOL."""
    loss_diff = abs(a[0] - b[0])
    rel = _update_diffs(a, b, params)
    log('%s: loss %.6f vs %.6f (|diff| %.3e, tol %g); update max '
        'diff / max update: %s (tol %g)'
        % (what, a[0], b[0], loss_diff, TRAIN_LOSS_TOL,
           ', '.join('%s %.3e' % kv for kv in rel.items()),
           TRAIN_UPDATE_TOL))
    if not (np.isfinite(a[0]) and loss_diff <= TRAIN_LOSS_TOL
            and all(r <= TRAIN_UPDATE_TOL for r in rel.values())):
        raise AssertionError('%s disagree beyond the stated tolerance'
                             % what)
    return loss_diff, rel


@phase('t2: kernel step vs plain-version step from one saved state')
def check_plain_step(tr, counters):
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 2)
    toks = rng.randint(0, tr.cfg.vocab, size=(tr.batch, tr.cfg.max_len,
                                              1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    kernel = _one_step(tr, saved, batch)
    fluid.set_flags({'FLAGS_use_flash_attention': False})
    try:
        for c in counters.values():
            c.launches = 0
        plain = _one_step(tr, saved, batch)
        if any(c.launches for c in counters.values()):
            raise AssertionError('a kernel launched in the plain step: %r'
                                 % {n: c.launches
                                    for n, c in counters.items()})
    finally:
        fluid.set_flags({'FLAGS_use_flash_attention': True})
    diffs = _compare('kernel step vs plain step', kernel, plain)
    return saved, batch, kernel, diffs


@phase('t3: one step under the split backward arm (K3a + K3b)')
def check_split_step(tr, saved, batch, kernel, counters, sync):
    """One step from the saved state under PADDLE_FLASH_BWD=split, held
    to the kvmajor kernel step; then the split step's wall ms over
    TIMED_STEPS steps and its device time by kernel kind over
    PROFILE_STEPS. Returns (launches, differences, wall ms, device
    ms)."""
    with flash_arms(None, 'split'):
        for c in counters.values():
            c.launches = 0
        split = _one_step(tr, saved, batch)
        launches = {n: c.launches for n, c in counters.items()}
    log('split-arm step launches: %s' % json.dumps(launches))
    L = tr.cfg.layers
    if launches['flash_attention_bwd_dq'] != L or \
            launches['flash_attention_bwd_dkv'] != L or \
            launches['flash_attention_bwd_kvmajor']:
        raise AssertionError('split arm: want K3a and K3b %d times each and '
                             'K2 never, got %r' % (L, launches))
    diffs = _compare('split-arm step vs kvmajor step', split, kernel)
    with flash_arms(None, 'split'):
        tr.feed(bench_provider(tr.cfg, tr.batch, np.random.RandomState(3)))
        tr.step()
        sync()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            tr.step()
        sync()
        step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        device_ms, _ = _profile_steps(tr, step_ms, sync, 'split-arm step')
        tr.reader.reset()
    tr.restore(saved)
    return launches, diffs, step_ms, device_ms


@phase('t4: step time, tokens/s, MFU, device time')
def profile_train(tr, step_ms, sync):
    cfg = tr.cfg
    tokens = tr.batch * cfg.max_len
    fl = train_flops_per_token(cfg)
    tok_s = tokens / step_ms * 1e3
    mfu = tok_s * fl / PEAK_BF16_FLOPS
    log('train step: %.3f ms, %.1f tokens/s, %.1f TFLOP/s at %.3f GFLOP '
        'per token (%.2f TFLOP per step), MFU %.4f of the %.1f TFLOP/s '
        'bf16 dense peak' % (step_ms, tok_s, tok_s * fl / 1e12, fl / 1e9,
                             fl * tokens / 1e12, mfu,
                             PEAK_BF16_FLOPS / 1e12))
    tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(1)))
    tr.step()
    sync()
    device_ms, busy = _profile_steps(tr, step_ms, sync, 'train step')
    tr.reader.reset()
    return tok_s, mfu, device_ms, busy


def _profile_steps(tr, step_ms, sync, label):
    """torch.profiler over PROFILE_STEPS steps: device time per step, its
    share of the unprofiled step, the top kernels and the time by kernel
    kind. Returns (device ms, busy share or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            tr.step()
        sync()
        prof_wall_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) == DeviceType.CUDA
              and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / PROFILE_STEPS / 1e3
    if device_ms == 0:
        log('%s: device time not measured (the profiler saw no device '
            'events)' % label)
        return device_ms, None
    busy = device_ms / step_ms
    top = sorted(events, key=_device_us, reverse=True)[:10]
    log('%s: device busy %.3f ms of %.3f ms unprofiled wall (%.1f%%; %.3f '
        'ms wall under the profiler); top: %s'
        % (label, device_ms, step_ms, 100.0 * busy, prof_wall_ms,
           '; '.join('%s %.3f ms' % (e.key[:60],
                                     _device_us(e) / PROFILE_STEPS / 1e3)
                     for e in top)))
    by_kind = {}
    for e in events:
        kind = _kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            _device_us(e) / PROFILE_STEPS / 1e3
    log('%s device time by kind: %s'
        % (label, ', '.join('%s %.3f ms' % kv for kv in
                            sorted(by_kind.items(), key=lambda kv: -kv[1]))))
    return device_ms, busy


def _kernel_kind(name):
    """Coarse class of a device kernel by its name."""
    low = name.lower()
    if 'flash_bwd_wgmma_kernel' in low:
        return 'K2/K5 bf16 (flash_bwd_wgmma_kernel)'
    if 'flash_bwd_dq_wgmma_kernel' in low:
        return 'K3a bf16 (flash_bwd_dq_wgmma_kernel)'
    if 'flash_bwd_dkv_wgmma_kernel' in low:
        return 'K3b bf16 (flash_bwd_dkv_wgmma_kernel)'
    if 'flash_fwd_wgmma_kernel' in low:
        return 'K1 bf16 (flash_fwd_wgmma_kernel)'
    if 'flash_bwd_q_kernel' in low and 'true>' in low:
        return 'K5 (flash_bwd_q_kernel<..., true>)'
    for kind, marks in (('K4a (flash_fwd_stats_kernel)', ('flash_fwd_stats',)),
                        ('K4b (flash_fwd_acc_kernel)', ('flash_fwd_acc',)),
                        ('flash kernels (K1/K2/K3)', ('flash_',)),
                        ('K6 (matmul + BN statistics)',
                         ('matmul_bn_stats', 'column_sums')),
                        ('convolutions (cuDNN)',
                         ('cudnn', 'fprop', 'dgrad', 'wgrad', 'implicit',
                          'convolution', 'conv2d')),
                        ('GEMMs (cuBLAS)', ('gemm', 'nvjet', 'cutlass')),
                        ('reductions', ('reduce',)),
                        ('copies', ('memcpy', 'memset', 'copy')),
                        ('elementwise', ('elementwise', 'index', 'scatter',
                                         'gather'))):
        if any(m in low for m in marks):
            return kind
    return 'other'


# -- (b6), (r1)-(r4): ResNet-50 through the fused conv + BN op ----------------

def resnet50_train_flops_per_image(image_hw, class_dim):
    """bench.py's _resnet50_train_flops_per_image (:62-90): 2 FLOP per
    MAC over the convs and fc, x3 for forward + backward."""
    flops = 0

    def conv(hw_in, cin, cout, k, stride):
        hw_out = hw_in // stride
        return hw_out, 2 * (hw_out ** 2) * cout * cin * k * k

    hw, f = conv(image_hw, 3, 64, 7, 2)
    flops += f
    hw //= 2
    cin = 64
    for ch, count, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2),
                              (512, 3, 2)]:
        for i in range(count):
            s = stride if i == 0 else 1
            hw2, f1 = conv(hw, cin, ch, 1, s)
            _, f2 = conv(hw2, ch, ch, 3, 1)
            _, f3 = conv(hw2, ch, ch * 4, 1, 1)
            flops += f1 + f2 + f3
            if i == 0:
                _, fp = conv(hw, cin, ch * 4, 1, s)
                flops += fp
            hw = hw2
            cin = ch * 4
    flops += 2 * cin * class_dim
    return 3 * flops


class ResNetTrainer(Trainer):
    """bench.py's bench_resnet program (:136-158), NCHW, built with
    FLAGS_use_pallas_fused_ops set, with its state on the card."""

    def __init__(self, place, batch):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import resnet
        self.fluid, self.batch = fluid, batch
        hw = RESNET['image_hw']
        self.main, startup = fluid.Program(), fluid.Program()
        self.main.random_seed = startup.random_seed = SEED
        with fluid.unique_name.guard(), \
                fluid.program_guard(self.main, startup):
            self.reader = fluid.layers.py_reader(
                capacity=4, shapes=[(-1, 3, hw, hw), (-1, 1)],
                dtypes=['float32', 'int64'], name='resnet_reader',
                use_double_buffer=True)
            image, label = fluid.layers.read_file(self.reader)
            _, self.avg_cost, _ = resnet.train_network(
                image, label, class_dim=RESNET['class_dim'],
                depth=RESNET['depth'])
            opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
            opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(self.avg_cost)
        self.scope = fluid.Scope()
        fluid.Executor(place).run(startup, scope=self.scope)
        self.pe = fluid.ParallelExecutor(
            use_cuda=True, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)
        self.persistables = [v.name for v in self.main.list_vars()
                             if v.persistable and
                             self.scope.find_var(v.name) is not None]


def image_batch(rng, batch, device=None):
    """bench.py's batch (:160-164): uniform images and random labels from
    a seeded numpy stream, on `device` when given (bench.py puts them on
    the chip once and feeds the same batch every step)."""
    import torch
    hw, classes = RESNET['image_hw'], RESNET['class_dim']
    img = rng.rand(batch, 3, hw, hw).astype('float32')
    lbl = rng.randint(0, classes, size=(batch, 1)).astype('int64')
    if device is None:
        return [img, lbl]
    return [torch.from_numpy(img).to(device), torch.from_numpy(lbl).to(device)]


def k6_path_shapes(program, batch):
    """{(M, K, N): launches per step} of the 1x1 conv2d_bn ops of the
    program (the ones that run K6), with M = batch x Ho x Wo."""
    shapes = {}
    block = program.global_block()
    for op in block.ops:
        if op.type != 'conv2d_bn':
            continue
        w = block.var_recursive(op.single_input('Filter'))
        if tuple(w.shape[2:]) != (1, 1) or \
                list(op.attr('paddings', [0, 0])) != [0, 0]:
            continue
        y = block.var_recursive(op.single_output('Y'))
        key = (batch * y.shape[2] * y.shape[3], w.shape[1], w.shape[0])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def k6_bound_ms(M, K, N, dtype):
    """Least time for one call, (bytes time, operations time) in ms: x, w
    read once, y and the two fp32 sums written once, against 2·M·K·N
    FLOP at the peak of the call's type. The bound is the larger."""
    es = 4 if dtype == 'float32' else 2
    nbytes = es * (M * K + K * N + M * N) + 2 * 4 * N
    peak = PEAK_FP32_FLOPS if dtype == 'float32' else PEAK_BF16_FLOPS
    return nbytes / PEAK_BYTES_PER_S * 1e3, 2.0 * M * K * N / peak * 1e3


def _k6_inputs(gen, M, K, N, dtype, dev):
    import torch
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) * (2.0 / K) ** 0.5
    dt = getattr(torch, dtype)
    return x.to(dt), w.to(dt)


def _k6_check(k6, gen, dev, M, K, N, dtype):
    """Run K6 once and hold it against its plain version; returns the
    max abs error of y."""
    import torch
    x, w = _k6_inputs(gen, M, K, N, dtype, dev)
    y, s, q = k6.matmul_bn_stats_kernel(x, w)
    torch.cuda.synchronize()
    yr, sr, qr = k6.matmul_bn_stats_reference(x, w)
    abs_sum = torch.matmul(x.float(), w.float()).abs().sum(0)
    tol = KERNEL_ATOL[dtype]
    dy = (y.float() - yr.float()).abs()
    ok_y = bool((dy <= tol * yr.float().abs().clamp_min(1.0)).all())
    err_s = ((s - sr).abs() / abs_sum.clamp_min(1e-30)).max().item()
    err_q = ((q - qr).abs() / qr.clamp_min(1e-30)).max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in (y, s, q))
    ok = ok_y and err_s <= K6_SUM_RTOL and err_q <= K6_SUM_RTOL and finite
    err = dy.max().item()
    log('K6 [%d, %d, %d] %s: y max_abs_err %.3e (tol %g x max(1, |y|)), '
        'colsum err %.3e of sum|y|, colsumsq err %.3e of sum y^2 (tol %g) %s'
        % (M, K, N, dtype, err, tol, err_s, err_q, K6_SUM_RTOL,
           'ok' if ok else 'MISMATCH'))
    if not ok:
        raise AssertionError('K6 disagrees with its plain version at '
                             '[%d, %d, %d] %s (finite: %s)'
                             % (M, K, N, dtype, finite))
    return err


@phase('b6: K6 (matmul + BN statistics) vs its plain version')
def check_k6(path_shapes):
    """Correctness at the largest, smallest and widest path shapes and a
    ragged one, fp32 and bf16; then times of kernel, plain version and
    yardstick at every path shape in bf16, summed over one step's
    launches. Returns the kernels line's row."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    nbytes = lambda s: s[0] * s[1] + s[1] * s[2] + s[0] * s[2]  # noqa: E731
    picks = [max(path_shapes, key=nbytes), min(path_shapes, key=nbytes),
             max(path_shapes, key=lambda s: (s[2], s[1]))]
    path_err = 0.0
    for shape in picks + [(300, 70, 130)]:
        for dtype in ('float32', 'bfloat16'):
            err = _k6_check(k6, gen, dev, *shape, dtype)
            if shape in picks and dtype == 'bfloat16':
                path_err = max(path_err, err)
    torch.cuda.empty_cache()

    totals = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
              'bound_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
    for (M, K, N), count in sorted(path_shapes.items()):
        x, w = _k6_inputs(gen, M, K, N, 'bfloat16', dev)

        def library():
            yf = torch.matmul(x, w).float()
            return yf.sum(0), (yf * yf).sum(0)

        times = bracketed_ms({
            'ms': lambda: k6.matmul_bn_stats_kernel(x, w),
            'plain_ms': lambda: k6.matmul_bn_stats_reference(x, w),
            'library_ms': library})
        t_bytes, t_ops = k6_bound_ms(M, K, N, 'bfloat16')
        log('K6 [%d, %d, %d] bf16 x %d per step: kernel %.4f ms, plain '
            '%.4f ms, library %.4f ms, bound %.4f ms (%s)'
            % (M, K, N, count, times['ms'], times['plain_ms'],
               times['library_ms'], max(t_bytes, t_ops),
               'bytes' if t_bytes >= t_ops else 'operations'))
        for key in ('ms', 'plain_ms', 'library_ms'):
            totals[key] += count * times[key]
        totals['bound_ms'] += count * max(t_bytes, t_ops)
        totals['bytes_ms'] += count * t_bytes
        totals['ops_ms'] += count * t_ops
        del x, w
    torch.cuda.empty_cache()
    n_launch = sum(path_shapes.values())
    log('K6 per step (%d launches over %d shapes, bf16): kernel %.4f ms, '
        'plain %.4f ms, library %.4f ms, bound %.4f ms (the sum of each '
        'launch\'s bound; bytes alone %.4f ms, operations alone %.4f ms)'
        % (n_launch, len(path_shapes), totals['ms'], totals['plain_ms'],
           totals['library_ms'], totals['bound_ms'], totals['bytes_ms'],
           totals['ops_ms']))
    name, replaces, source = K6_SOURCE
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': path_err,
            'ms': totals['ms'], 'plain_ms': totals['plain_ms'],
            'bound_ms': totals['bound_ms'],
            'bound_by': ('bytes' if totals['bytes_ms'] >= totals['ops_ms']
                         else 'operations'),
            'library_ms': totals['library_ms'],
            'shape': 'one step: %d launches over the %d 1x1 shapes at batch '
                     '%d' % (n_launch, len(path_shapes), RESNET_BATCH),
            'dtype': 'bfloat16'}


@phase('r1: train ResNet-50 through the fused conv + BN op (AMP Momentum, '
       'py_reader, ParallelExecutor)')
def resnet_steps(place, sync):
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    t0 = time.perf_counter()
    tr = ResNetTrainer(place, RESNET_BATCH)
    ops = tr.main.global_block().ops
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    path_shapes = k6_path_shapes(tr.main, RESNET_BATCH)
    per_step = sum(path_shapes.values())
    log('ResNet-50 program: %d ops of %d types (%d conv2d_bn, %d of them '
        '1x1 on K6), %d parameters, batch %d x 3 x %d x %d, %d classes, no '
        'depth cut; built and initialised in %.1f s'
        % (len(ops), len(set(o.type for o in ops)),
           sum(o.type == 'conv2d_bn' for o in ops), per_step, n_params,
           RESNET_BATCH, RESNET['image_hw'], RESNET['image_hw'],
           RESNET['class_dim'], time.perf_counter() - t0))
    stats = [n for n in tr.persistables if n.endswith(('.mean', '.variance'))]
    stats0 = {n: tr.scope.find_var(n).clone() for n in stats}
    batch = image_batch(np.random.RandomState(0), RESNET_BATCH,
                        torch.device('cuda', 0))

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    losses = [tr.step() for _ in range(WARMUP_STEPS)]
    sync()
    torch.cuda.reset_peak_memory_stats()
    k6.matmul_bn_stats_kernel.launches = 0
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = k6.matmul_bn_stats_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    moved = sum(not torch.equal(tr.scope.find_var(n), stats0[n])
                for n in stats)
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f images/s; K6 '
        'launches %d (want %d x %d); peak device memory %.2f GB; BN running '
        'statistics moved: %d of %d'
        % (TIMED_STEPS, wall, step_ms, RESNET_BATCH / step_ms * 1e3,
           launches, per_step, TIMED_STEPS, peak_gb, moved, len(stats)))
    if not all(np.isfinite(losses)):
        raise AssertionError('a ResNet loss is not finite: %r' % losses)
    if per_step != 36 or launches != per_step * TIMED_STEPS:
        raise AssertionError('K6 launched %d times in %d steps, want 36 x %d'
                             ' (the program has %d 1x1 conv2d_bn ops)'
                             % (launches, TIMED_STEPS, TIMED_STEPS, per_step))
    if moved != len(stats) or not stats:
        raise AssertionError('BN running statistics moved for %d of %d vars'
                             % (moved, len(stats)))
    return tr, path_shapes, losses, step_ms, launches, peak_gb


def _reordered_reference(x, w):
    """The plain version with its column sums taken in fp64: the same
    math in another order of summation, timed and used only as the
    yardstick of r2."""
    import torch
    y = torch.matmul(x.float(), w.float())
    yd = y.double()
    return y.to(x.dtype), yd.sum(0).float(), (yd * yd).sum(0).float()


@phase('r2: K6 step vs plain-version step from one saved state')
def check_resnet_plain_step(tr):
    """One step with K6, every launch also held against the plain version
    on its own inputs; the same step with FLAGS_use_pallas_fused_ops
    cleared (the plain version); and the same step with the plain
    version's column sums in fp64. The bf16 AMP step amplifies any change
    in the order of the fp32 sums (it rounds every activation to bf16
    after each op), so the updates of the kernel step are held to the
    plain step within TRAIN_UPDATE_TOL or within RESNET_SPREAD_FACTOR
    times the plain step's own spread under the fp64 sums, whichever is
    larger."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import conv_bn as k6
    batch = image_batch(np.random.RandomState(SEED + 2), RESNET_BATCH)
    saved = tr.snapshot()
    kernel_fn, plain_fn = k6.matmul_bn_stats_kernel, \
        k6.matmul_bn_stats_reference
    worst = {'y': 0.0, 'colsum': 0.0, 'colsumsq': 0.0, 'flips': 0.0}

    def checked_kernel(x, w):
        y, s, q = kernel_fn(x, w)
        yr, sr, qr = plain_fn(x, w)
        abs_sum = torch.matmul(x.float(), w.float()).abs().sum(0)
        dy = (y.float() - yr.float()).abs()
        worst['y'] = max(worst['y'], (dy / yr.float().abs().clamp_min(
            1.0)).max().item())
        worst['colsum'] = max(worst['colsum'], ((s - sr).abs() /
                                                abs_sum.clamp_min(1e-30))
                              .max().item())
        worst['colsumsq'] = max(worst['colsumsq'], ((q - qr).abs() /
                                                    qr.clamp_min(1e-30))
                                .max().item())
        worst['flips'] = max(worst['flips'], (y != yr).float().mean().item())
        return y, s, q

    # the kernel counts its launches on the module's name, which is
    # checked_kernel while it stands in
    checked_kernel.launches = 0
    k6.matmul_bn_stats_kernel = checked_kernel
    try:
        kernel = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED)
    finally:
        k6.matmul_bn_stats_kernel = kernel_fn
    log('K6 on the step\'s own 36 inputs vs its plain version: y max diff / '
        'max(1, |y|) %.3e (tol %g), bf16 y that differ %.2e of the '
        'elements, colsum %.3e of sum|y|, colsumsq %.3e of sum y^2 (tol %g)'
        % (worst['y'], KERNEL_ATOL['bfloat16'], worst['flips'],
           worst['colsum'], worst['colsumsq'], K6_SUM_RTOL))
    if checked_kernel.launches != 36:
        raise AssertionError('K6 launched %d times in the kernel step, want '
                             '36' % checked_kernel.launches)
    if not (worst['y'] <= KERNEL_ATOL['bfloat16'] and
            worst['colsum'] <= K6_SUM_RTOL and
            worst['colsumsq'] <= K6_SUM_RTOL):
        raise AssertionError('K6 disagrees with its plain version on the '
                             'step\'s inputs: %r' % worst)
    fluid.set_flags({'FLAGS_use_pallas_fused_ops': False})
    try:
        kernel_fn.launches = 0
        plain = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED)
        k6.matmul_bn_stats_reference = _reordered_reference
        reordered = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED)
        if kernel_fn.launches:
            raise AssertionError('K6 launched %d times in the plain steps'
                                 % kernel_fn.launches)
    finally:
        k6.matmul_bn_stats_reference = plain_fn
        fluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
    tr.restore(saved)
    spread = _update_diffs(reordered, plain, RESNET_PARAMS_COMPARED)
    got = _update_diffs(kernel, plain, RESNET_PARAMS_COMPARED)
    loss_diff = abs(kernel[0] - plain[0])
    log('K6 step vs plain step: loss %.6f vs %.6f (|diff| %.3e, tol %g; '
        'fp64-sum plain step %.6f, |diff| %.3e); update max diff / max '
        'update: %s; the plain step\'s spread under fp64 sums: %s (tol: '
        'the larger of %g and %g x that spread)'
        % (kernel[0], plain[0], loss_diff, TRAIN_LOSS_TOL, reordered[0],
           abs(reordered[0] - plain[0]),
           ', '.join('%s %.3e' % kv for kv in got.items()),
           ', '.join('%s %.3e' % kv for kv in spread.items()),
           TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR))
    bad = [n for n in RESNET_PARAMS_COMPARED
           if not got[n] <= max(TRAIN_UPDATE_TOL,
                                RESNET_SPREAD_FACTOR * spread[n])]
    if not np.isfinite(kernel[0]) or loss_diff > TRAIN_LOSS_TOL or bad:
        raise AssertionError('K6 step vs plain step disagree beyond the '
                             'stated tolerance (%s)' % bad)
    return loss_diff, got, spread, worst


def _pair_program(fluid, fused, channels, filters, fs, pad):
    """test_pallas_fused.py's pair at a ResNet shape: conv_bn, or conv2d
    + batch_norm, with shared parameter names, then mean and SGD(0.1)."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[channels, 56, 56],
                              dtype='float32')
        if fused:
            y = fluid.layers.conv_bn(
                x, num_filters=filters, filter_size=fs, padding=pad,
                act='relu', param_attr=fluid.ParamAttr(name='cw'),
                bn_param_attr=fluid.ParamAttr(name='bs'),
                bn_bias_attr=fluid.ParamAttr(name='bb'))
        else:
            c = fluid.layers.conv2d(
                x, num_filters=filters, filter_size=fs, padding=pad,
                bias_attr=False, param_attr=fluid.ParamAttr(name='cw'))
            y = fluid.layers.batch_norm(
                c, act='relu', param_attr=fluid.ParamAttr(name='bs'),
                bias_attr=fluid.ParamAttr(name='bb'))
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, y, loss


@phase('r3: fused conv_bn vs conv2d + batch_norm on the card')
def check_fused_pair(place):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import conv_bn as k6
    xv = np.random.RandomState(SEED + 4).rand(8, 64, 56, 56).astype(
        'float32')
    worst = {}
    for label, filters, fs, pad in (('1x1 64->256', 256, 1, 0),
                                    ('3x3 64->64', 64, 3, 1)):
        results, init = {}, None
        for fused in (False, True):
            prog, startup, y, loss = _pair_program(fluid, fused, 64,
                                                   filters, fs, pad)
            scope = fluid.Scope()
            exe = fluid.Executor(place)
            exe.run(startup, scope=scope)
            if init is None:
                init = scope.find_var('cw').clone()
            else:
                scope.find_var('cw').copy_(init)
            k6.matmul_bn_stats_kernel.launches = 0
            vals = [exe.run(prog, feed={'x': xv}, fetch_list=[y, loss],
                            scope=scope) for _ in range(3)]
            if fused and fs == 1 and k6.matmul_bn_stats_kernel.launches != 3:
                raise AssertionError('the fused 1x1 pair launched K6 %d '
                                     'times in 3 steps, want 3'
                                     % k6.matmul_bn_stats_kernel.launches)
            results[fused] = vals
        dy = max(float(np.max(np.abs(a[0] - b[0]) /
                              np.maximum(np.abs(b[0]), 1.0)))
                 for a, b in zip(results[True], results[False]))
        dl = max(abs(float(a[1]) - float(b[1])) /
                 max(abs(float(b[1])), 1.0)
                 for a, b in zip(results[True], results[False]))
        worst[label] = (dy, dl)
        log('fused vs unfused %s, [8, 64, 56, 56] fp32, 3 SGD steps: Y max '
            'diff / max(1, |Y|) %.3e, loss %.3e (tol %g)'
            % (label, dy, dl, PAIR_TOL))
        if not (dy <= PAIR_TOL and dl <= PAIR_TOL):
            raise AssertionError('fused and unfused %s disagree' % label)
    return worst


@phase('r4: ResNet-50 step time, images/s, MFU, device time')
def profile_resnet(tr, step_ms, sync):
    import torch
    fl = resnet50_train_flops_per_image(RESNET['image_hw'],
                                        RESNET['class_dim'])
    img_s = RESNET_BATCH / step_ms * 1e3
    mfu = img_s * fl / PEAK_BF16_FLOPS
    log('ResNet-50 step: %.3f ms, %.1f images/s, %.1f TFLOP/s at %.3f GFLOP '
        'per image, MFU %.4f of the %.1f TFLOP/s bf16 dense peak'
        % (step_ms, img_s, img_s * fl / 1e12, fl / 1e9, mfu,
           PEAK_BF16_FLOPS / 1e12))
    batch = image_batch(np.random.RandomState(1), RESNET_BATCH,
                        torch.device('cuda', 0))

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    tr.step()
    sync()
    device_ms, busy = _profile_steps(tr, step_ms, sync, 'ResNet-50 step')
    tr.reader.reset()
    return img_s, mfu, device_ms, busy


# -- (l1)-(l3): the long-context LM under twopass / onepass ------------------

@contextlib.contextmanager
def flash_arms(fwd, bwd):
    """PADDLE_FLASH_FWD / PADDLE_FLASH_BWD set to fwd / bwd (None: unset)
    for the body, and restored after it."""
    names = ('PADDLE_FLASH_FWD', 'PADDLE_FLASH_BWD')
    prev = {n: os.environ.get(n) for n in names}
    try:
        for n, value in zip(names, (fwd, bwd)):
            if value is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = value
        yield
    finally:
        for n, value in prev.items():
            if value is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = value


@phase('l1: train the long-context LM under twopass / onepass (K4a, K4b, '
       'K5)')
def lc_steps(cfg, place, counters, sync):
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    tr = Trainer(cfg, place, LC_BATCH, LC_HEAD_CHUNK, LC_READER)
    ops = tr.main.global_block().ops
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    log('long-context program: vocab %d, dim %d, heads %d, layers %d, ffn '
        '%d, max_len %d; %d ops of %d types, %d parameters, batch %d x %d '
        'tokens, fused head chunk %d, no depth cut; built and initialised '
        'in %.1f s'
        % (cfg.vocab, cfg.dim, cfg.heads, cfg.layers, cfg.ffn, cfg.max_len,
           len(ops), len(set(o.type for o in ops)), n_params, tr.batch,
           cfg.max_len, LC_HEAD_CHUNK, time.perf_counter() - t0))
    with flash_arms(*LC_ARMS):
        tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(0)))
        losses = [tr.step() for _ in range(WARMUP_STEPS)]
        sync()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        fa.take_extra_flops()
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(TIMED_STEPS)]
        sync()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        extra_per_step = fa.take_extra_flops() / TIMED_STEPS
        tr.reader.reset()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step; launches %s; peak '
        'device memory %.2f GB; extra FLOP noted by K4a %.4g per step'
        % (TIMED_STEPS, wall, step_ms, json.dumps(launches), peak_gb,
           extra_per_step))
    if not all(np.isfinite(losses)):
        raise AssertionError('a long-context loss is not finite: %r'
                             % losses)
    need = cfg.layers * TIMED_STEPS
    wrong = {n: c for n, c in launches.items()
             if c != (need if n in [KERNELS[kd][0] for kd in
                                    ('k4a', 'k4b', 'k5')] else 0)}
    if wrong:
        raise AssertionError('want K4a, K4b and K5 exactly %d times in %d '
                             'steps and K1, K2, K3a, K3b never; got %r'
                             % (need, TIMED_STEPS, wrong))
    return tr, losses, step_ms, launches, peak_gb, extra_per_step


def _timed_step(tr, saved, batch, sync):
    """Wall ms of one step from the saved state (feed started first)."""
    tr.restore(saved)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    sync()
    t0 = time.perf_counter()
    tr.step()
    sync()
    return (time.perf_counter() - t0) * 1e3


@phase('l2: twopass/onepass step vs default-arm step vs plain step')
def check_lc_arms(tr, counters, sync):
    """One step from a saved state under each of twopass/onepass,
    online/kvmajor and the plain versions, with their launch counts. In
    bf16 the onepass and kvmajor backwards launch the same tensor-core
    kernel (flash_bwd_wgmma_kernel) through their own wrappers, so the
    two kernel steps differ in the forward only: K4a + K4b against K1.
    Returns the losses' and updates' differences, each arm's mean wall
    ms of one step, the launches and each arm's device ms per step."""
    import paddle_tpu_torch as fluid
    cfg = tr.cfg
    rng = np.random.RandomState(SEED + 5)
    toks = rng.randint(0, cfg.vocab, size=(tr.batch, cfg.max_len,
                                           1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    results, launches = {}, {}
    for label, arms, flash in (('twopass/onepass', LC_ARMS, True),
                               ('online/kvmajor', (None, None), True),
                               ('plain', (None, None), False)):
        with flash_arms(*arms):
            fluid.set_flags({'FLAGS_use_flash_attention': flash})
            try:
                for c in counters.values():
                    c.launches = 0
                results[label] = _one_step(tr, saved, batch,
                                           LC_PARAMS_COMPARED)
                launches[label] = {n: c.launches
                                   for n, c in counters.items()}
            finally:
                fluid.set_flags({'FLAGS_use_flash_attention': True})
        log('%s step launches: %s' % (label, json.dumps(launches[label])))
    L = cfg.layers
    want = {'twopass/onepass': ('k4a', 'k4b', 'k5'),
            'online/kvmajor': ('fwd', 'k2'), 'plain': ()}
    for label, kinds in want.items():
        names = [KERNELS[kd][0] for kd in kinds]
        bad = {n: c for n, c in launches[label].items()
               if c != (L if n in names else 0)}
        if bad:
            raise AssertionError('%s step: want %s %d times each and no '
                                 'other flash kernel; got %r'
                                 % (label, names, L, bad))
    diffs = {
        'plain': _compare('twopass/onepass step vs plain step',
                          results['twopass/onepass'], results['plain'],
                          LC_PARAMS_COMPARED),
        'default': _compare('twopass/onepass step vs online/kvmajor step',
                            results['twopass/onepass'],
                            results['online/kvmajor'], LC_PARAMS_COMPARED)}
    # the two kernel arms' steps in turns: A, B, B, A
    times = {'twopass/onepass': [], 'online/kvmajor': []}
    for label in ('twopass/onepass', 'online/kvmajor', 'online/kvmajor',
                  'twopass/onepass'):
        with flash_arms(*(LC_ARMS if label == 'twopass/onepass'
                          else (None, None))):
            times[label].append(_timed_step(tr, saved, batch, sync))
    tr.reader.reset()
    tr.restore(saved)
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    log('one step from the saved state, in turns A B B A: twopass/onepass '
        '%s ms, online/kvmajor %s ms (means %.3f / %.3f ms)'
        % (', '.join('%.3f' % t for t in times['twopass/onepass']),
           ', '.join('%.3f' % t for t in times['online/kvmajor']),
           step_ms['twopass/onepass'], step_ms['online/kvmajor']))
    # the arms' device time per step, which the host's noise in the wall
    # times above does not reach
    device_ms = {}
    for label, arms in (('twopass/onepass', LC_ARMS),
                        ('online/kvmajor', (None, None))):
        with flash_arms(*arms):
            tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(2)))
            tr.step()
            sync()
            device_ms[label], _ = _profile_steps(
                tr, step_ms[label], sync, 'long-context %s step' % label)
            tr.reader.reset()
    tr.restore(saved)
    return diffs, step_ms, launches, device_ms


@phase('l3: long-context step time, tokens/s, MFU, device time')
def profile_lc(tr, step_ms, extra_per_step, sync):
    cfg = tr.cfg
    tokens = tr.batch * cfg.max_len
    fl = train_flops_per_token(cfg, causal=True)
    tok_s = tokens / step_ms * 1e3
    mfu = tok_s * fl / PEAK_BF16_FLOPS
    executed = fl * tokens + extra_per_step
    mfu_exec = executed / (step_ms / 1e3) / PEAK_BF16_FLOPS
    log('long-context step: %.3f ms, %.1f tokens/s, MFU %.4f at bench.py\'s '
        'causal %.4f GFLOP per token (%.3f TFLOP per step); by the executed '
        'FLOPs (+ %.4g noted by K4a per step: %.3f TFLOP) MFU %.4f, of the '
        '%.1f TFLOP/s bf16 dense peak'
        % (step_ms, tok_s, mfu, fl / 1e9, fl * tokens / 1e12,
           extra_per_step, executed / 1e12, mfu_exec,
           PEAK_BF16_FLOPS / 1e12))
    with flash_arms(*LC_ARMS):
        tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(1)))
        tr.step()
        sync()
        device_ms, busy = _profile_steps(tr, step_ms, sync,
                                         'long-context step')
        tr.reader.reset()
    return tok_s, mfu, mfu_exec, device_ms, busy


# -- (p): the exp / exp2 probe ------------------------------------------------

@phase('p: the exp/exp2 probe P vs its plain version, and its rates')
def check_probe():
    import torch
    from paddle_tpu_torch.tools import probe_exp2 as probe
    x = probe.probe_input()
    ragged = probe.probe_input((3, 7, 111))
    errs = {}
    for inp in (x, ragged):
        for fn in probe.FNS:
            for reps in (4, 8):
                got = probe.exp_chain_kernel(inp, reps, fn)
                torch.cuda.synchronize()
                want = probe.exp_chain_reference(inp, reps, fn)
                errs[(tuple(inp.shape), fn, reps)] = _max_err((got,), (want,))
    worst = max(errs.values())
    log('P vs its plain version: max_abs_err %s (atol %g) %s'
        % (', '.join('%s %s x%d %.3e' % (list(sh), fn, r, e)
                     for (sh, fn, r), e in errs.items()), PROBE_ATOL,
           'ok' if worst <= PROBE_ATOL else 'MISMATCH'))
    if not worst <= PROBE_ATOL:
        raise AssertionError('P disagrees with its plain version')
    # the probe's own run is P's main path
    rate, how = probe.sfu_rate()
    log('special-function-unit rate: %s' % how)
    probe.exp_chain_kernel.launches = 0
    rows = probe.measure(x)
    launches = probe.exp_chain_kernel.launches
    ratio = probe.report(rows, rate)
    reps, fn, n = 8, 'exp2', x.numel()
    times = bracketed_ms({
        'ms': lambda: probe.exp_chain_kernel(x, reps, fn),
        'plain_ms': lambda: probe.exp_chain_reference(x, reps, fn)})
    # x read once and out written once; per element and step one exp2 on
    # the special-function unit and a multiply and an add in fp32
    t_bytes = 2 * 4 * n / PEAK_BYTES_PER_S * 1e3
    t_ops = max(reps * n / rate, 2 * reps * n / PEAK_FP32_FLOPS) * 1e3
    name, replaces, source = PROBE_SOURCE
    row = {'name': name, 'route': 'cuda', 'source': source,
           'replaces': replaces, 'launches': launches,
           'max_abs_err': errs[(tuple(x.shape), fn, reps)],
           'ms': times['ms'], 'plain_ms': times['plain_ms'],
           'bound_ms': max(t_bytes, t_ops),
           'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
           'library_ms': None, 'shape': list(x.shape), 'dtype': 'float32',
           'fn': fn, 'reps': reps}
    _log_rows([row])
    return row, rows, ratio


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false); nothing run', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'paddle_tpu_torch')):
        print('chip_smoke: paddle_tpu_torch/ is not beside this script; run '
              'it from a checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerConfig
    counters = {KERNELS[kind][0]: getattr(fa, KERNELS[kind][0])
                for kind in KERNELS}

    card = gpu_name_and_power_limit()
    log('card: %s' % card)
    log('python %s, torch %s, cuda %s' % (sys.version.split()[0],
                                        torch.__version__, torch.version.cuda))
    cfg = TransformerConfig(**MODEL)
    lc_cfg = TransformerConfig(**LC_MODEL)
    place = fluid.CUDAPlace(0)
    sync = torch.cuda.synchronize
    try:
        build_kernels()
        rows = check_kernels(cfg)
        long_rows = check_long_kernels(lc_cfg)
        prompts = prompts_for(cfg.vocab, cfg.max_len)
        build_root = os.path.join(HERE, 'build')
        os.makedirs(build_root, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_root) as model_dir:
            build_and_save(cfg, place, model_dir)
            torch.cuda.empty_cache()
            pred, dec = load_and_prepare(model_dir, place)
        torch.cuda.reset_peak_memory_stats()
        streams, launches, wall, stats = serve(dec, prompts, counters, sync)
        check_recompute(pred, dec, prompts, streams)
        check_solo(dec, prompts, streams)
        prefill_ms, step_ms = time_path(dec, prompts, sync)
        profile_path(dec, prompts, {'prefill': prefill_ms,
                                    'decode_step': step_ms}, sync)
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del pred, dec
        torch.cuda.empty_cache()

        tr, losses, train_ms, train_launches, train_peak_gb = train_steps(
            cfg, place, counters, sync)
        saved, batch, kernel_step, plain_diffs = check_plain_step(
            tr, counters)
        split_launches, split_diffs, split_ms, split_device_ms = \
            check_split_step(tr, saved, batch, kernel_step, counters, sync)
        del saved
        tok_s, mfu, device_ms, busy = profile_train(tr, train_ms, sync)
        # the LM is freed before the ResNet phases
        del tr
        torch.cuda.empty_cache()

        fluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
        torch.cuda.reset_peak_memory_stats()
        (rtr, path_shapes, r_losses, r_step_ms, r_launches,
         r_peak_gb) = resnet_steps(place, sync)
        k6_row = check_k6(path_shapes)
        r_plain_diffs = check_resnet_plain_step(rtr)
        pair_diffs = check_fused_pair(place)
        img_s, r_mfu, r_device_ms, r_busy = profile_resnet(rtr, r_step_ms,
                                                           sync)
        del rtr
        torch.cuda.empty_cache()

        (ltr, l_losses, l_step_ms, l_launches, l_peak_gb,
         l_extra) = lc_steps(lc_cfg, place, counters, sync)
        l_diffs, l_arm_ms, l_arm_launches, l_arm_dev = check_lc_arms(
            ltr, counters, sync)
        l_tok_s, l_mfu, l_mfu_exec, l_device_ms, l_busy = profile_lc(
            ltr, l_step_ms, l_extra, sync)
        del ltr
        torch.cuda.empty_cache()

        probe_row, probe_rows, exp_over_exp2 = check_probe()
    except PhaseError as e:
        print('chip_smoke: %s' % e, file=sys.stderr)
        import traceback
        traceback.print_exception(e.__cause__, file=sys.stderr)
        return 1
    # launches on each kernel's own main path: K1 fp32 in serving, K1
    # bf16 and K2 in the timed training steps, K3a/K3b in the split step,
    # K4a/K4b/K5 in the timed long-context steps, K1 bf16 at T = 8192 in
    # l2's default-arm step
    path_launches = {'flash_attention_fwd': launches['flash_attention_fwd'],
                     'flash_attention_fwd_bf16':
                         train_launches['flash_attention_fwd'],
                     'flash_attention_bwd_kvmajor':
                         train_launches['flash_attention_bwd_kvmajor'],
                     'flash_attention_bwd_dq':
                         split_launches['flash_attention_bwd_dq'],
                     'flash_attention_bwd_dkv':
                         split_launches['flash_attention_bwd_dkv']}
    long_launches = {'flash_attention_fwd_bf16':
                     l_arm_launches['online/kvmajor']['flash_attention_fwd']}
    for kind in ('k4a', 'k4b', 'k5'):
        long_launches[KERNELS[kind][0]] = l_launches[KERNELS[kind][0]]
    for r in rows:
        r['launches'] = path_launches[r['name']]
    for r in long_rows:
        r['launches'] = long_launches[r['name']]
    rows += long_rows
    k6_row['launches'] = r_launches
    rows += [k6_row, probe_row]
    log('serving: %.3f s for %d requests x %d tokens, prefill %.3f ms, '
        'decode step %.3f ms, peak device memory %.2f GB'
        % (wall, N_REQUESTS, NEW_TOKENS, prefill_ms, step_ms, serve_peak_gb))
    log('training: step %.3f ms, %.1f tokens/s, MFU %.4f, device busy %s, '
        'peak device memory %.2f GB, loss after %d steps %.6f; kernel vs '
        'plain step loss |diff| %.3e, split vs kvmajor %.3e; split-arm step '
        '%.3f ms, device %s ms (kvmajor %s ms)'
        % (train_ms, tok_s, mfu,
           'not measured' if busy is None else '%.1f%%' % (100 * busy),
           train_peak_gb, len(losses), losses[-1], plain_diffs[0],
           split_diffs[0], split_ms, _fmt_ms(split_device_ms or None),
           _fmt_ms(device_ms or None)))
    log('ResNet-50 training (batch %d, 224 px, AMP Momentum): step %.3f ms, '
        '%.1f images/s, MFU %.4f, device busy %s, peak device memory %.2f '
        'GB, loss after %d steps %.6f, K6 launches %d; K6 vs plain step loss '
        '|diff| %.3e; fused vs unfused Y %s'
        % (RESNET_BATCH, r_step_ms, img_s, r_mfu,
           'not measured' if r_busy is None else '%.1f%%' % (100 * r_busy),
           r_peak_gb, len(r_losses), r_losses[-1], r_launches,
           r_plain_diffs[0],
           ', '.join('%s %.3e' % (k, v[0]) for k, v in pair_diffs.items())))
    log('long-context training (T %d, batch %d, twopass/onepass): step %.3f '
        'ms, %.1f tokens/s, MFU %.4f (causal count), %.4f (executed), '
        'device busy %s, peak device memory %.2f GB, loss after %d steps '
        '%.6f; loss |diff| vs plain %.3e, vs online/kvmajor %.3e; one step '
        'twopass/onepass %.3f ms, online/kvmajor %.3f ms; device ms per '
        'step twopass/onepass %.3f, online/kvmajor %.3f'
        % (lc_cfg.max_len, LC_BATCH, l_step_ms, l_tok_s, l_mfu, l_mfu_exec,
           'not measured' if l_busy is None else '%.1f%%' % (100 * l_busy),
           l_peak_gb, len(l_losses), l_losses[-1], l_diffs['plain'][0],
           l_diffs['default'][0], l_arm_ms['twopass/onepass'],
           l_arm_ms['online/kvmajor'], l_arm_dev['twopass/onepass'],
           l_arm_dev['online/kvmajor']))
    log('probe: one exp step costs %.3f x one exp2 step' % exp_over_exp2)
    log('chip_smoke wall time: %.1f s' % (time.perf_counter() - t_start))
    log(json.dumps({'kernels': rows}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
