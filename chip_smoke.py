#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path, the LM training step (under
Momentum and under the Transformer recipe's Adam, and with every block a
rematerialization scope), the ResNet-50 training step, the long-context
LM training step and the exp/exp2 probe once on one CUDA card.

    python3 chip_smoke.py

Every program runs through the Executor's default path on the card: a
prepared program's device segments run eagerly once, are captured as
CUDA graphs on the second run and replayed from then on (the kernel
wrappers' launch counts are added again at each replay, so every count
below counts replays). The first step of t1, a1, r1 and l1 runs under
no_host_sync (torch.cuda.set_sync_debug_mode('error')): a device op
that synchronises with the host fails the run. r2 runs its steps op by
op, since its stand-in kernel must run where Python runs.

Phases, each of which fails the run (non-zero exit, no final "ok" line):
  (a) build every CUDA kernel of the paths with nvcc (one process per
      source, started together): the flash-attention forwards K1, K4a,
      K4b (bf16 K1 is the tensor-core flash_fwd_wgmma_kernel), the
      backwards K2, K3a, K3b, K5 (bf16 K2 and K5 are one tensor-core
      kernel, flash_bwd_wgmma_kernel; bf16 K3a and K3b the tensor-core
      flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel), the
      matmul + BN-statistics kernel K6 (bf16: the tensor-core
      matmul_bn_stats_wgmma_kernel; fp32 and ragged bf16: the generic
      matmul_bn_stats_kernel) and the probe P; the registers and spills
      of fp32 K1 (flash_fwd_f32_kernel), of the tensor-core K1, K2/K5,
      K3a and K3b at d = 64 and 128 and of bf16 K6 at BN = 64 and 128
      are logged;
  (b) hold K1, K2, K3a and K3b against their plain PyTorch versions on
      the card, at the shapes the paths give them and at ragged edge
      shapes, fp32 and bf16 (K1 by check_fwd_output: lse within the fp32
      atol in both dtypes, bf16 o also within O_RTOL relative to |o| +
      mean |o|; bf16 K2's dq, dk, dv, K3a's dq and K3b's dk, dv also
      within G_RTOL relative to |g| + mean |g|; K1, K3a and K3b launched
      twice give bit-identical outputs; fp32 K1's o and lse at the
      serving shape and its plain version's are also held against an
      fp64 evaluation, logged), and time kernel, plain version
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
  (h) the flash_attention op on CUDA tensors at shapes the kernels do
      not take (UNTAKEN_FLASH: head dim 16 and 32 in fp32 and bf16, 64 in
      fp16, causal): each output has the plain version's bits, the
      plain-on-card counter (FlashAttention.plain_cuda_calls) counts the
      call and no kernel launches. Phases c3, t1, t3, l1 and a1 require
      that counter to stay 0 over their timed work; t2, l2 and a2 run the
      plain versions on purpose and reset it after;
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
  (f), (g) prefill and decode-step timing, and their device time (fp32
      K1's device ms and launches per prefill beside the top kernels);
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
The LM is freed, then the same LM with TransformerConfig's own use_tp /
use_sp (the one-device parallel layers and annotations) trains under
the Transformer recipe: Adam(noam_decay(2048, 4000), beta1 0.9, beta2
0.98, epsilon 1e-9) with GradientClipByGlobalNorm(1.0) set by
set_gradient_clip, under contrib.mixed_precision.decorate:
  (a1) 2 warm-up and 5 timed steps through ParallelExecutor: K1 >= 12 x
      steps and K2 exactly 12 x steps launches, K3-K5 never, no plain
      call, every loss finite; the rate and the step counter fetched in
      every step, every beta power read after the warm-up steps and the
      last one; step ms, tokens/s, MFU, device busy share (one
      torch.profiler step) and peak memory;
  (a2) those records: the rate within SCHEDULE_RTOL of noam_decay, the
      counter s in the s-th step, every beta power beta^(s+1); then one
      step from a saved state with the kernels and one plain step: loss
      within TRAIN_LOSS_TOL and each ADAM_PARAMS_COMPARED weight's step
      gradient (from its first moment) within TRAIN_UPDATE_TOL of the
      largest; the updates are logged;
  (a3) the eleven optimizer updates (sgd, momentum and the nine of this
      slice) at OPT_SHAPES on the card against the same emitter on CPU
      copies, within OPT_TOL of max(1, |ref|);
  (a4) every op type registered after A4_EARLIER_OPS, forward and grads,
      on the card against CPU copies (rtol OP_RTOL, atol OP_ATOL; integer
      and bool outputs exact; the script fails if such an op type has no
      case and no entry in A4_HELD_ELSEWHERE); dropout (is_test bits,
      kept entries and share over DROPOUT_N elements, grad dOut·Mask)
      and truncated_gaussian_random's draw.
The Adam LM is freed, then ResNet-50 (bench.py's bench_resnet, NCHW,
built with FLAGS_use_pallas_fused_ops so every conv + BN is one
conv2d_bn op):
  (r1) the training step at 224 px, 1000 classes, batch RESNET_BATCH
      (py_reader, train_network(depth=50), Momentum(0.01, 0.9) under
      contrib.mixed_precision.decorate, startup on CUDAPlace(0),
      ParallelExecutor(use_cuda=True)): 2 warm-up and 5 timed steps; K6
      launches exactly 36 x steps, every one the tensor-core kernel
      (the per-kernel counts), every loss is finite and the BN running
      statistics move;
  (b6) K6 against its plain version on the card (k6_check_shapes): in
      bf16 on the tensor-core kernel at the largest, smallest and widest
      of the step's 1x1 shapes (read from r1's program), a path shape
      for every tile width the plan uses and one with K = 64, and at the
      smallest with one row more; on the generic kernel at the three
      picks in fp32 and at a ragged 300 x 70 x 130 in both dtypes. Each
      is launched twice: the second launch gives the same bits, and the
      per-kernel counts show which kernel ran (a path shape on any other
      kernel fails). Then kernel, plain version, the library yardstick
      (torch.matmul, then the two column sums) and the product alone
      (torch.matmul; both timed only) at every one of the step's 15
      shapes by CUDA events, and kernel and product alone by
      torch.profiler device time, summed over its 36 launches;
  (r2) one step from a saved state with K6, each of its 36 launches (all
      on the tensor-core kernel) also held against the plain version on
      the step's own inputs, and the
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
r1's executor is closed (two batch-256 graph pools do not fit on the
card) and ResNet-50 freed; then ResNet-50 as bench.py builds it for an
accelerator, under N1_FLAGS (FLAGS_use_pallas_fused_ops off, as bench.py
leaves it, and FLAGS_amp_bf16_param_grads on, as its main() sets it):
  (n1) train_network(nhwc=True) at 224 px, 1000 classes, batch
      RESNET_BATCH, AMP Momentum(0.01, 0.9), ParallelExecutor: the
      program has 53 conv2d and 53 batch_norm ops at NHWC, no conv2d_bn
      and one transpose (the NCHW feed's, at the stem); 2 warm-up steps
      (the first under no_host_sync) and 5 timed captured steps: K6
      never launches, every loss is finite, every BN running statistic
      moves, one segment is captured, reserved memory stays under
      RESNET_PEAK_GB;
  (n3) its step ms, images/s, MFU, busy share and device time by kernel
      kind (every copy kernel by name), beside r4's;
  (n2) one NHWC step and one step of the same program built NCHW
      (without the fused flag: the same parameter names) from one saved
      state and batch, op by op: losses within TRAIN_LOSS_TOL, the
      updates of NHWC_PARAMS_COMPARED by r2's rule (TRAIN_UPDATE_TOL or
      RESNET_SPREAD_FACTOR x the NCHW step's own spread when its batch
      statistics are summed in fp64);
  (i2) n1's program at batch NAN_CHECK_BATCH: a step under
      FLAGS_check_nan_inf runs op by op (the capture count does not
      move) to a captured step's loss within NAN_CHECK_TOL, and a batch
      with one NaN pixel raises OpExecutionError naming the first op that
      reads the image (nothing else is caught);
then
  (s1) the space-to-depth stem: the retiled 4x4 conv through the port
      (models.resnet.space_to_depth and conv2d) with s2d_filter's
      weights equals the 7x7/2 conv within S2D_TOL in fp32, and
      train_network(space_to_depth=True), NCHW with the fused flag, at
      batch RESNET_BATCH: 2 + 3 steps, finite losses, K6 36 launches a
      step, step ms logged;
  (i1) bench_inference's ResNet-50 leg: resnet_imagenet(is_test=True,
      nhwc=True) at batch INFER_BATCH, 224 px, fp32, its BN affine and
      running statistics drawn from the seed (inference_model), saved
      with save_inference_model and loaded by AnalysisPredictor: with
      ir_optim 53 -> 0 batch_norm ops and 53 more elementwise_add, the
      output within INFER_TOL of an ir_optim=False predictor's, a clone
      the same bits; p50 and p99 ms a call from a host feed, and device
      images/s from a device-resident feed, N/2N differenced as
      bench.py's serving_throughput does.
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
The captured path itself:
  (x1) after t4 (the Momentum step, under PADDLE_FLASH_BWD=split), after
      a2 (the Adam step), after r4 (ResNet-50) and after l3 (the
      long-context step, twopass/onepass): WARMUP_STEPS + X_TIMED_STEPS
      steps op by op (use_program_cache=False) and the same steps
      through a new ParallelExecutor (eager, captured, replayed) from one
      saved state on the same batches: every loss within TRAIN_LOSS_TOL,
      the updates within TRAIN_UPDATE_TOL (t2's measure; a2's
      gradient-weighted one for Adam; r2's rule for ResNet-50), the
      capture count equal to the program's device segments and
      unchanged over the timed steps; whether the bits are equal, and
      each way's ms per step, peak memory and (one more step under
      torch.profiler) device ms and busy share, are logged;
  (x2) after g: the prefill and decode programs' first runs under
      no_host_sync; after two generations on a new decode predictor its
      jit_cache_stats read 2 prepared programs, 2 captured segments and
      2 misses (the JAX package's tests/test_serving.py:197-200); the
      engine run op by op gives c3's streams exactly; its prefill and
      decode step by the host clock beside f's, and their device time;
  (x3) after x1 (Momentum), on a new ParallelExecutor: a replayed step
      under PADDLE_FLASH_BWD=kvmajor launches K2 12 times and K3 never,
      one under split K3a and K3b 12 times each and K2 never: two
      prepared programs; a weight replaced with Scope.set_var after the
      capture: the next replayed step's loss is the eager step's with
      the new weight; a fetch returned with return_numpy=False is the
      same after the next run;
  (x4) before a1: the flagship LM (AMP Momentum, batch TRAIN_BATCH)
      with TransformerConfig(remat=None, 'nothing', 'dots') from the
      same weights and batches, captured: K1 12 launches a step without
      remat and 24 with it, K2 12; losses within TRAIN_LOSS_TOL and the
      updates within TRAIN_UPDATE_TOL of remat=None's; each policy's
      step ms and peak device memory (logged, with whether 'nothing' <
      'dots' < None holds).

It prints the card's name and power limit (nvidia-smi), the kernels
line, the serving and training numbers (an Adam line among them), its
own wall time, and as its last line {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MODEL = dict(vocab=32768, dim=2048, heads=16, layers=12, ffn=8192,
             max_len=512, flash_attention=True, use_tp=False, use_sp=False)
SLOTS, PREFILL_BATCH, N_REQUESTS, NEW_TOKENS = 8, 1, 8, 32
SEED = 1234
# the training step of bench.py's bench_transformer (:253-271)
TRAIN_BATCH, HEAD_CHUNK, WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = \
    8, 4096, 2, 5, 3
PARAMS_COMPARED = ('layer0_qkv.w_0', 'layer11_down.w_0', 'lm_head.w_0')

# a1-a4: the same LM with TransformerConfig's own use_tp / use_sp (True:
# the one-device tensor- and sequence-parallel layers and annotations),
# trained with the Transformer recipe Fluid users ran: Adam over
# noam_decay(d_model, 4000), beta2 0.98, epsilon 1e-9, global-norm clip 1
ADAM_MODEL = {k: v for k, v in MODEL.items() if k not in ('use_tp', 'use_sp')}
ADAM = dict(warmup_steps=4000, beta1=0.9, beta2=0.98, epsilon=1e-9,
            clip_norm=1.0)
# PARAMS_COMPARED's three weights under the parallel layers' names (there
# 'layer0_qkv.w_0' is the qkv bias, whose key third has no gradient)
ADAM_PARAMS_COMPARED = ('layer0_qkv_0.w', 'layer11_down_0.w', 'lm_head.w_0')
# the rate, the step counter and the beta powers against their closed
# forms, relative
SCHEDULE_RTOL = 1e-6
# a3: the eleven optimizer updates on the card against the same emitter
# on CPU copies, |out - ref| <= OPT_TOL * max(1, |ref|)
OPT_SHAPES = ((2048, 8192), (1,), (1000, 37))
OPT_TOL = 1e-5
# a4: the op types of the training core on the card against the same
# emitters on CPU copies (fp32); integer and bool outputs exact
OP_RTOL, OP_ATOL = 1e-5, 1e-6
DROPOUT_P, DROPOUT_N = 0.3, 1 << 20
# h: shapes the flash kernels do not take ([B, H, T, d], dtype), routed
# to the plain version on the card
UNTAKEN_FLASH = (((2, 4, 128, 16), 'float32'), ((2, 4, 128, 16), 'bfloat16'),
                 ((2, 4, 128, 32), 'float32'), ((2, 4, 128, 32), 'bfloat16'),
                 ((2, 4, 128, 64), 'float16'))

# bench.py's bench_resnet (:128-189): ResNet-50 at 224 px, 1000 classes,
# NCHW (the fused conv2d_bn op is NCHW-only), batch RESNET_BATCH
RESNET = dict(depth=50, image_hw=224, class_dim=1000)
RESNET_BATCH = 256
RESNET_PARAMS_COMPARED = ('conv_bn_0.w_0', 'conv_bn_2.w_0', 'fc_0.w_0')
# r2: the kernel step's update differences may reach this multiple of the
# plain step's own spread when only its column sums change order (fp64)
RESNET_SPREAD_FACTOR = 2.0
# the ResNet step's peak device memory, captured graphs' pools included,
# stays under this on the 80 GB card (PERF.md section 2)
RESNET_PEAK_GB = 70.0
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


BRACKET_ORDER = ('ms', 'plain_ms', 'library_ms', 'matmul_ms')


def bracketed_ms(fns):
    """Time each of fns {'ms', 'plain_ms', 'library_ms', 'matmul_ms'}
    twice in the order kernel, plain, library, product alone, then back
    (product alone, library, plain, kernel), so the pairs bracket drift
    in clocks; each time is the mean of its two runs."""
    runs = {key: [] for key in fns}
    for key in BRACKET_ORDER + BRACKET_ORDER[::-1]:
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
    for source, mark in (('flash_attention_fwd', 'flash_fwd_f32_kernel'),
                         ('flash_attention_fwd', 'flash_fwd_wgmma_kernel'),
                         ('flash_attention_bwd', 'flash_bwd_wgmma_kernel'),
                         ('flash_attention_bwd', 'flash_bwd_dq_wgmma_kernel'),
                         ('flash_attention_bwd',
                          'flash_bwd_dkv_wgmma_kernel'),
                         ('conv_bn', 'matmul_bn_stats_wgmma_kernel')):
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


def _check_shape(fa, rng, dev, BH, T, d, causal, dtype, fp64=False):
    """Run K1, K2, K3a and K3b once at one shape and hold each against
    its plain version (K1 by check_fwd_output; the gradients of K2, K3a
    and K3b by check_grads: G_RTOL in bf16), and launch K1, K3a and K3b
    a second time on the same inputs: K1 sums each row's keys in one
    order (engine streams must equal solo streams, phase e) and the split
    arm is the deterministic one, so both launches must give the same
    bits. fp64=True also logs K1's and its plain version's distance from
    an fp64 evaluation. Returns {kind: max_abs_err}."""
    import torch
    q, k, v, do = _inputs(rng, BH, T, d, dtype, dev)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
    o_err, o_rel, lse_err, fwd_ok = check_fwd_output(o, lse, o_ref, lse_ref,
                                                     dtype)
    errs = {'fwd': max(o_err, lse_err)}
    if fp64:
        _log_fwd_fp64(q, k, v, causal, scale, (o, lse), (o_ref, lse_ref),
                      '[%d, %d, %d] causal=%s %s' % (BH, T, d, causal,
                                                     dtype))
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
    same = {'fwd': torch.equal(o, o2) and torch.equal(lse, lse2)}
    same.update((kind, all(torch.equal(a, b)
                           for a, b in zip(got[kind], out)))
                for kind, out in again.items())
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


def _log_fwd_fp64(q, k, v, causal, scale, got, plain, label):
    """Log K1's (o, lse) and its plain version's distance from K1's
    function evaluated in fp64 from the same inputs: shows the fp32
    contract (exact fp32 products, no TF32) rather than assuming it."""
    import torch
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, float('-inf'))
    lse64 = torch.logsumexp(s, dim=-1)
    o64 = torch.matmul(s.sub_(lse64[..., None]).exp_(), v.double())
    del s
    errs = [(x.double() - want).abs().max().item()
            for pair in (got, plain) for x, want in zip(pair, (o64, lse64))]
    log('%s: vs fp64 max_abs_err flash_attention_fwd o %.3e, lse %.3e; its '
        'plain version o %.3e, lse %.3e' % ((label,) + tuple(errs)))
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


# torch.profiler windows taken before a device time is given up as not
# measured: the profiler has returned an empty window for a kernel that
# a later window traced, twice in a row once
DEVICE_MS_WINDOWS = 3


def _device_ms(fn, iters=10):
    """Device time of one fn() from torch.profiler: the sum of its
    kernels' time over `iters` calls, per call (None if the profiler saw
    no device events in DEVICE_MS_WINDOWS windows).
    Unlike CUDA events around the calls, it leaves out the time the card
    waits for the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_WINDOWS):
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
        serving = (BH, t, dd, dtype) == (serve_bh, T, d, 'float32')
        errs = _check_shape(fa, rng, dev, BH, t, dd, causal, dtype,
                            fp64=serving)
        if serving:
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
    from paddle_tpu_torch.kernels import flash_attention as fa
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    with fluid.serving.LMServer(dec) as srv:
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts]
        streams = [srv.result(h, timeout=600) for h in handles]
        sync()
        wall = time.perf_counter() - t0
        stats = srv.stats()
    launches = {name: c.launches for name, c in counters.items()}
    require_no_plain(fa, 'c3')
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


def _time_path(dec, prompts, sync):
    """(prefill ms, decode-step ms) of `dec` by the host clock."""
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


time_path = phase('f: prefill and decode-step timing')(_time_path)


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile_path(dec, prompts, times_ms, sync, label=''):
    """torch.profiler over a few calls of each: device time per call,
    its share of the unprofiled wall time (phase f), and the kernels
    that take most of it. Returns {call: device ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p = prompts[-1]
    toks = np.ones((dec.slots,), np.int64)
    poss = np.full((dec.slots,), len(p), np.int32)
    calls = {'prefill': lambda: dec.prefill([p], [0]),
             'decode_step': lambda: dec.decode_step(toks, poss)}
    n = 5
    out = {}
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
            log('%s%s: device time not measured (the profiler saw no device '
                'events)' % (label, name))
            continue
        out[name] = device_ms
        top = sorted(events, key=_device_us, reverse=True)[:6]
        k1 = [e for e in events if _kernel_kind(e.key).startswith('K1 fp32')]
        log('%s%s: device busy %.3f ms of %.3f ms wall (%.1f%%); K1 fp32 '
            '(flash_fwd_f32_kernel) %.4f ms in %d launches per call; top: %s'
            % (label, name, device_ms, times_ms[name],
               100.0 * device_ms / times_ms[name],
               sum(_device_us(e) for e in k1) / n / 1e3,
               sum(e.count for e in k1) // n,
               '; '.join('%s %.3f ms' % (e.key[:48], _device_us(e) / n / 1e3)
                         for e in top)))
    return out


profile_path = phase('g: device time inside the prefill and the decode '
                     'step')(_profile_path)


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
    under AMP; its state on the card. With adam=True the optimizer is
    the Transformer recipe (ADAM): Adam over noam_decay with the
    global-norm clip set by set_gradient_clip, under AMP; self.lr is
    then the schedule's rate, a var of the program."""

    def __init__(self, cfg, place, batch, head_chunk, reader_name,
                 adam=False):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import transformer as tfm
        self.fluid, self.cfg, self.batch = fluid, cfg, batch
        self.lr = None
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
            if adam:
                fluid.clip.set_gradient_clip(
                    fluid.clip.GradientClipByGlobalNorm(ADAM['clip_norm']))
                self.lr = fluid.layers.noam_decay(
                    d_model=cfg.dim, warmup_steps=ADAM['warmup_steps'])
                opt = fluid.optimizer.Adam(
                    learning_rate=self.lr, beta1=ADAM['beta1'],
                    beta2=ADAM['beta2'], epsilon=ADAM['epsilon'])
            else:
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

    def step(self, sync_checked=False):
        """One step through the ParallelExecutor. sync_checked: under
        no_host_sync, so an op that synchronises with the host raises
        (run it as the prepared program's first, eager run)."""
        if not sync_checked:
            return float(self.pe.run(fetch_list=[self.avg_cost.name])[0])
        with no_host_sync():
            out = self.pe.run(fetch_list=[self.avg_cost.name],
                              return_numpy=False)
        return float(out[0])

    def drop_graphs(self):
        """Close self.pe: its captured graphs, and the memory pool they
        hold, go back to the card (the next step prepares anew)."""
        self.pe.close()
        free_device_memory()

    def fresh_executor(self):
        """A new ParallelExecutor in place of self.pe, which is closed
        first: its jit_cache_stats() count from 0."""
        self.drop_graphs()
        self.pe = self.fluid.ParallelExecutor(
            use_cuda=True, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)

    def batch_of(self, rng):
        toks = rng.randint(0, self.cfg.vocab, size=(
            self.batch, self.cfg.max_len, 1)).astype('int64')
        return [toks, np.roll(toks, -1, axis=1)]

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
    from paddle_tpu_torch.kernels import flash_attention as fa
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
    # the peak covers the eager warm-up, the capture and the replays
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=True)]
    losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
    sync()
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    require_no_plain(fa, 't1')
    peak_gb = peak_memory_gb()
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
    check_replay_launches('t1', tr.step, sync)
    return tr, losses, step_ms, launches, peak_gb


def _one_step(tr, saved, batch, params=PARAMS_COMPARED, eager=None):
    """Restore the saved state, run one step on `batch`, and return the
    loss and the updates of `params`. eager: an Executor that runs the
    step op by op (use_program_cache=False) in place of the
    ParallelExecutor's captured path."""
    tr.restore(saved)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    if eager is None:
        loss = tr.step()
    else:
        loss = float(eager.run(tr.main, fetch_list=[tr.avg_cost.name],
                               scope=tr.scope, use_program_cache=False)[0])
    updates = {n: (tr.scope.find_var(n) - saved[n]).float()
               for n in params}
    return loss, updates


def _update_diffs(a, b, params):
    """Per parameter: max |update difference| over max |update| of b."""
    return {n: ((a[1][n] - b[1][n]).abs().max() /
                b[1][n].abs().max().clamp_min(1e-30)).item()
            for n in params}


def _first_order_diffs(a, b, grads, params):
    """Per parameter: sum |g|·|update difference| over sum |g|·|update of
    b|, g from `grads`: how far the first-order change of the loss, g·u,
    that a's update u buys strays from b's, element by element. 1 for an
    update of 0, 2 for b's reversed; an element whose gradient is near 0,
    which Adam may step either way, weighs next to nothing."""
    out = {}
    for n in params:
        w = grads[n].abs()
        out[n] = ((w * (a[n] - b[n]).abs()).sum() /
                  (w * b[n].abs()).sum().clamp_min(1e-30)).item()
    return out


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
    from paddle_tpu_torch.kernels import flash_attention as fa
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
        fa.FlashAttention.plain_cuda_calls = 0
    diffs = _compare('kernel step vs plain step', kernel, plain)
    return saved, batch, kernel, diffs


@phase('t3: one step under the split backward arm (K3a + K3b)')
def check_split_step(tr, saved, batch, kernel, counters, sync):
    """One step from the saved state under PADDLE_FLASH_BWD=split, held
    to the kvmajor kernel step; then the split step's wall ms over
    TIMED_STEPS steps and its device time by kernel kind over
    PROFILE_STEPS. Returns (launches, differences, wall ms, device
    ms)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    fa.FlashAttention.plain_cuda_calls = 0
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
    require_no_plain(fa, 't3')
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


def _profile_steps(tr, step_ms, sync, label, steps=PROFILE_STEPS,
                   step=None, by_kind_out=None):
    """torch.profiler over `steps` steps (tr.step, or `step`): device
    time per step, its share of the unprofiled step, the top kernels,
    the time by kernel kind (written into `by_kind_out` when given) and
    every copy kernel by name. Returns (device ms, busy share or
    None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = step or tr.step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        prof_wall_ms = (time.perf_counter() - t0) / steps * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) == DeviceType.CUDA
              and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / steps / 1e3
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
                                     _device_us(e) / steps / 1e3)
                     for e in top)))
    by_kind = {}
    for e in events:
        kind = _kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            _device_us(e) / steps / 1e3
    log('%s device time by kind: %s'
        % (label, ', '.join('%s %.3f ms' % kv for kv in
                            sorted(by_kind.items(), key=lambda kv: -kv[1]))))
    copies = sorted((e for e in events if _kernel_kind(e.key) == 'copies'),
                    key=_device_us, reverse=True)
    log('%s copies by name: %s'
        % (label, '; '.join('%s %.3f ms (%d calls)'
                            % (e.key[:80], _device_us(e) / steps / 1e3,
                               e.count // steps) for e in copies) or 'none'))
    if by_kind_out is not None:
        by_kind_out.update(by_kind)
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
    if 'flash_fwd_f32_kernel' in low:
        return 'K1 fp32 (flash_fwd_f32_kernel)'
    if 'matmul_bn_stats_wgmma_kernel' in low:
        return 'K6 (matmul + BN statistics)'
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


# torch.profiler's name of each kernel a wrapper launches once a call ->
# its group in LAUNCH_GROUPS; the fp32 backward kernels are told apart
# by their last template argument (csrc/flash_attention_bwd.cu)
LAUNCH_SYMBOLS = {
    'flash_fwd_wgmma_kernel': 'K1', 'flash_fwd_f32_kernel': 'K1',
    'flash_fwd_stats_wgmma_kernel': 'K4a', 'flash_fwd_stats_kernel': 'K4a',
    'flash_fwd_acc_wgmma_kernel': 'K4b', 'flash_fwd_acc_kernel': 'K4b',
    'flash_bwd_wgmma_kernel': 'K2/K5', ('flash_bwd_kv_kernel', 'true'):
    'K2/K5', ('flash_bwd_q_kernel', 'true'): 'K2/K5',
    'flash_bwd_dq_wgmma_kernel': 'K3a', ('flash_bwd_q_kernel', 'false'):
    'K3a', 'flash_bwd_dkv_wgmma_kernel': 'K3b',
    ('flash_bwd_kv_kernel', 'false'): 'K3b',
    'matmul_bn_stats_wgmma_kernel': 'K6', 'matmul_bn_stats_kernel': 'K6'}
# group -> the wrappers whose launch counts it answers to
LAUNCH_GROUPS = {'K1': ('flash_attention_fwd',),
                 'K4a': ('flash_attention_fwd_stats',),
                 'K4b': ('flash_attention_fwd_acc',),
                 'K2/K5': ('flash_attention_bwd_kvmajor',
                           'flash_attention_bwd_onepass'),
                 'K3a': ('flash_attention_bwd_dq',),
                 'K3b': ('flash_attention_bwd_dkv',),
                 'K6': ('matmul_bn_stats_kernel',)}


def launch_group(name):
    """The LAUNCH_GROUPS group of a profiled kernel's name, or None."""
    m = re.search(r'(\w+_kernel)(?:<([^()]*)>)?', name)
    if m is None:
        return None
    args = (m.group(2) or '').split(',')
    return LAUNCH_SYMBOLS.get(m.group(1)) or \
        LAUNCH_SYMBOLS.get((m.group(1), args[-1].strip()))


def wrapper_counts():
    """{wrapper name: launches} of every wrapper in LAUNCH_GROUPS."""
    from paddle_tpu_torch.kernels import conv_bn, flash_attention as fa
    counts = {n: getattr(fa, n).launches for names in LAUNCH_GROUPS.values()
              for n in names if n != 'matmul_bn_stats_kernel'}
    counts['matmul_bn_stats_kernel'] = conv_bn.matmul_bn_stats_kernel.launches
    return counts


def launch_mismatch(seen, before, after):
    """{group: (profiled launches, counted launches)} where the two
    differ: `seen` {group: kernels the profiler saw}, the counts
    wrapper_counts() read before and after the profiled calls."""
    counted = {g: sum(after[n] - before[n] for n in names)
               for g, names in LAUNCH_GROUPS.items()}
    return {g: (seen.get(g, 0), counted[g]) for g in LAUNCH_GROUPS
            if seen.get(g, 0) != counted[g]}


def check_replay_launches(label, step, sync):
    """One step() under torch.profiler (on a captured program: a replay,
    whose counts are what its capture recorded): for every kernel group,
    the kernels the profiler saw launch equal what the wrappers' counts
    gained. Fails on a mismatch, or where no profiler window of
    DEVICE_MS_WINDOWS shows a device event. Returns {group: launches}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(DEVICE_MS_WINDOWS):
        before = wrapper_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            sync()
        after = wrapper_counts()
        seen = {}
        events = [e for e in prof.key_averages()
                  if getattr(e, 'device_type', None) == DeviceType.CUDA]
        for e in events:
            group = launch_group(e.key)
            if group:
                seen[group] = seen.get(group, 0) + e.count
        if not events:
            continue
        wrong = launch_mismatch(seen, before, after)
        log('%s: one replayed step under the profiler: kernel launches %s, '
            'the same as the wrappers\' counts: %s'
            % (label, json.dumps(seen), not wrong))
        if wrong:
            raise AssertionError('%s: the profiler saw other launches than '
                                 'the wrappers counted, {group: (profiled, '
                                 'counted)}: %r' % (label, wrong))
        return seen
    raise AssertionError('%s: the profiler saw no device events in %d '
                         'windows: the launch counts were not checked'
                         % (label, DEVICE_MS_WINDOWS))


# -- (h): shapes the flash kernels do not take --------------------------------

def require_no_plain(fa, label):
    """Fail where a timed path ran the plain flash version on the card: the
    route (fa.kernel_takes) must never hide the kernels where they should
    launch."""
    n = fa.FlashAttention.plain_cuda_calls
    if n:
        raise AssertionError('%s: %d flash_attention calls ran the plain '
                             'version on the card, want 0' % (label, n))


def _flash_op_program(fluid, shape, dtype):
    """One flash_attention op (causal, default scale) on fed q, k, v."""
    prog = fluid.Program()
    block = prog.global_block()
    ins = {slot: [block.create_var(name=slot.lower(), shape=shape,
                                   dtype=dtype, is_data=True)]
           for slot in ('Q', 'K', 'V')}
    block.append_op(type='flash_attention', inputs=ins,
                    outputs={'Out': [block.create_var(name='out')]},
                    attrs={'causal': True, 'sm_scale': None})
    return prog


@phase('h: the flash_attention op at shapes the kernels do not take')
def check_untaken_flash(place, counters):
    """Each UNTAKEN_FLASH case through the op on CUDA tensors: the output
    has the plain version's bits, the plain-on-card counter counts the
    call, and no kernel launches."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    exe = fluid.Executor(place)
    rng = np.random.RandomState(SEED + 7)
    for shape, dtype in UNTAKEN_FLASH:
        feed = {n: torch.from_numpy((rng.randn(*shape) * 0.5).astype(
            'float32')).to(exe.device).to(getattr(torch, dtype))
            for n in ('q', 'k', 'v')}
        for c in counters.values():
            c.launches = 0
        fa.FlashAttention.plain_cuda_calls = 0
        out, = exe.run(_flash_op_program(fluid, shape, dtype), feed=feed,
                       fetch_list=['out'], scope=fluid.Scope(),
                       return_numpy=False)
        torch.cuda.synchronize()
        plain = fa.FlashAttention.plain_cuda_calls
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        B, H, T, d = shape
        want, _ = fa.flash_attention_reference(
            *(feed[n].reshape(B * H, T, d) for n in ('q', 'k', 'v')), True,
            d ** -0.5)
        same = out.device.type == 'cuda' and out.dtype == want.dtype and \
            torch.equal(out.reshape(want.shape), want)
        log('flash_attention op %s %s on the card: plain calls %d, kernel '
            'launches %s, bits equal to the plain version: %s'
            % (list(shape), dtype, plain, launches or 'none', same))
        if plain != 1 or launches or not same:
            raise AssertionError('%s %s: want one plain call, no kernel '
                                 'launch and the plain version\'s bits'
                                 % (list(shape), dtype))
    fa.FlashAttention.plain_cuda_calls = 0


# -- (a1)-(a4): the training core ----------------------------------------------

def noam_rate(step, d_model):
    """noam_decay's rate in the step-th step (the counter reads step)."""
    return d_model ** -0.5 * min(step ** -0.5,
                                 step * ADAM['warmup_steps'] ** -1.5)


def _beta_pows(tr):
    """Every Adam beta power of the step, read in one copy per kind:
    {'beta1': array, 'beta2': array}."""
    import torch
    out = {}
    for key in ('beta1', 'beta2'):
        names = [n for n in tr.persistables if '_%s_pow_acc_' % key in n]
        out[key] = torch.cat([tr.scope.find_var(n).reshape(-1).float()
                              for n in names]).cpu().numpy()
    return out


def check_adam_records(records, d_model):
    """In each record of step s: the rate noam_rate(s), the step counter
    s, and every beta power read after the step beta^(s + 1), within
    SCHEDULE_RTOL. Raises on the first that is not; returns the worst
    relative errors of the rate and of the beta powers."""
    worst = {'lr': 0.0, 'beta': 0.0}
    for r in records:
        s = r['step']
        if r['counter'] != s:
            raise AssertionError('step %d: the step counter reads %d'
                                 % (s, r['counter']))
        err = abs(r['lr'] / noam_rate(s, d_model) - 1.0)
        worst['lr'] = max(worst['lr'], err)
        if err > SCHEDULE_RTOL:
            raise AssertionError('step %d: the rate is %.9g, noam_decay '
                                 'gives %.9g' % (s, r['lr'],
                                                 noam_rate(s, d_model)))
        for key in ('beta1', 'beta2'):
            if r.get(key) is None:
                continue
            want = ADAM[key] ** (s + 1)
            err = float(np.abs(np.asarray(r[key], 'float64') / want
                               - 1.0).max())
            worst['beta'] = max(worst['beta'], err)
            if err > SCHEDULE_RTOL:
                raise AssertionError('step %d: a %s power is %.3e off '
                                     '%s^%d' % (s, key, err, key, s + 1))
    return worst


@phase('a1: train the flagship LM under AMP Adam + noam_decay + global-norm '
       'clip (py_reader, ParallelExecutor)')
def adam_steps(cfg, place, counters, sync):
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    tr = Trainer(cfg, place, TRAIN_BATCH, HEAD_CHUNK, 'adam_reader',
                 adam=True)
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    ops = tr.main.global_block().ops
    counts = {}
    for o in ops:
        counts[o.type] = counts.get(o.type, 0) + 1
    log('Adam training program: %d ops of %d types, %d parameters (%.2f GB '
        'fp32), use_tp %s, use_sp %s, batch %d x %d tokens, no depth cut; '
        'built and initialised in %.1f s; op types: %s'
        % (len(ops), len(counts), n_params, n_params * 4 / 1e9, cfg.use_tp,
           cfg.use_sp, tr.batch, cfg.max_len, time.perf_counter() - t0,
           json.dumps(dict(sorted(counts.items())))))
    tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(0)))
    records, losses = [], []

    def step(s):
        fetches = [tr.avg_cost.name, tr.lr.name, '@STEP_COUNTER@']
        if s == 1:
            with no_host_sync():
                out = tr.pe.run(fetch_list=fetches, return_numpy=False)
            loss, lr, counter = (t.cpu().numpy() for t in out)
        else:
            loss, lr, counter = tr.pe.run(fetch_list=fetches)
        losses.append(float(loss))
        records.append(dict(step=s, lr=float(np.asarray(lr).reshape(-1)[0]),
                            counter=int(np.asarray(counter).reshape(-1)[0])))

    # the peak covers the eager warm-up, the capture and the replays
    torch.cuda.reset_peak_memory_stats()
    for s in range(1, WARMUP_STEPS + 1):
        step(s)
        records[-1].update(_beta_pows(tr))
    sync()
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    for s in range(WARMUP_STEPS + 1, WARMUP_STEPS + TIMED_STEPS + 1):
        step(s)
    sync()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    require_no_plain(fa, 'a1')
    records[-1].update(_beta_pows(tr))
    peak_gb = peak_memory_gb()
    step_ms = wall / TIMED_STEPS * 1e3
    tokens = tr.batch * cfg.max_len
    fl = train_flops_per_token(cfg)
    tok_s = tokens / step_ms * 1e3
    mfu = tok_s * fl / PEAK_BF16_FLOPS
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('rates: %s' % ', '.join('%.6e' % r['lr'] for r in records))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f tokens/s, MFU '
        '%.4f at %.3f GFLOP per token; launches %s; peak device memory %.2f '
        'GB' % (TIMED_STEPS, wall, step_ms, tok_s, mfu, fl / 1e9,
                json.dumps(launches), peak_gb))
    if not all(np.isfinite(losses)):
        raise AssertionError('an Adam training loss is not finite: %r'
                             % losses)
    need = cfg.layers * TIMED_STEPS
    if launches['flash_attention_fwd'] < need or \
            launches['flash_attention_bwd_kvmajor'] != need:
        raise AssertionError('want K1 >= %d and K2 exactly %d launches in %d '
                             'steps, got %r' % (need, need, TIMED_STEPS,
                                                launches))
    others = [KERNELS[kd][0] for kd in ('k3a', 'k3b', 'k4a', 'k4b', 'k5')]
    if any(launches[n] for n in others):
        raise AssertionError('K3, K4 or K5 launched in the Adam step: %r'
                             % launches)
    device_ms, busy = _profile_steps(tr, step_ms, sync, 'Adam step',
                                     steps=1)
    tr.reader.reset()
    return dict(tr=tr, losses=losses, step_ms=step_ms, launches=launches,
                peak_gb=peak_gb, records=records, tok_s=tok_s, mfu=mfu,
                device_ms=device_ms, busy=busy, n_ops=len(ops))


def _adam_step(tr, saved, batch):
    """_one_step for the Adam LM: (loss, {param: (1 - beta1)·g}) and the
    updates of ADAM_PARAMS_COMPARED, where g is the step's clipped
    gradient, read from the Adam op's first moment: m1 - beta1·m1_saved."""
    loss, updates = _one_step(tr, saved, batch, ADAM_PARAMS_COMPARED)
    grads = {}
    for p in ADAM_PARAMS_COMPARED:
        m1, = [n for n in tr.persistables if n.startswith(p + '_moment1_')]
        grads[p] = (tr.scope.find_var(m1) -
                    ADAM['beta1'] * saved[m1]).float()
    return (loss, grads), updates


@phase('a2: Adam kernel step vs plain step; the rate, the counter and the '
       'beta powers over a1\'s steps')
def check_adam_step(tr, records, counters):
    """The records of a1 (check_adam_records), then one step from a saved
    state with the kernels and with FLAGS_use_flash_attention=False, held
    to t2's bounds: the losses within TRAIN_LOSS_TOL, and each compared
    weight's step gradient, as the Adam op took it into its first moment,
    within TRAIN_UPDATE_TOL of the largest. Each compared weight's update
    is held within TRAIN_UPDATE_TOL too, weighted by the plain step's
    gradient (_first_order_diffs): Adam's step is about lr·sign(m)
    element by element, so an element whose gradient lies within the two
    steps' bf16 rounding of zero steps the other way, and the largest
    update is no scale for that difference."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    worst = check_adam_records(records, tr.cfg.dim)
    log('over %d steps: the rate within %.2e of noam_decay, every beta power '
        'within %.2e of beta^(s+1) (%d accumulators), the counter s in the '
        's-th step (tol %g)' % (len(records), worst['lr'], worst['beta'],
                                2 * len(records[-1]['beta1']),
                                SCHEDULE_RTOL))
    rng = np.random.RandomState(SEED + 8)
    toks = rng.randint(0, tr.cfg.vocab, size=(tr.batch, tr.cfg.max_len,
                                              1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    for c in counters.values():
        c.launches = 0
    kernel, kernel_upd = _adam_step(tr, saved, batch)
    L = tr.cfg.layers
    if counters['flash_attention_fwd'].launches < L or \
            counters['flash_attention_bwd_kvmajor'].launches != L:
        raise AssertionError('the kernel step launched %r'
                             % {n: c.launches for n, c in counters.items()})
    fluid.set_flags({'FLAGS_use_flash_attention': False})
    try:
        for c in counters.values():
            c.launches = 0
        plain, plain_upd = _adam_step(tr, saved, batch)
        if any(c.launches for c in counters.values()):
            raise AssertionError('a kernel launched in the plain step: %r'
                                 % {n: c.launches
                                    for n, c in counters.items()})
    finally:
        fluid.set_flags({'FLAGS_use_flash_attention': True})
        fa.FlashAttention.plain_cuda_calls = 0
    tr.reader.reset()
    tr.restore(saved)
    diffs = _compare('Adam kernel step vs plain step, step gradients',
                     kernel, plain, ADAM_PARAMS_COMPARED)
    upd = _first_order_diffs(kernel_upd, plain_upd, plain[1],
                             ADAM_PARAMS_COMPARED)
    log('Adam kernel step vs plain step, updates: sum |g|·|diff| / sum '
        '|g|·|update| %s (tol %g)'
        % (', '.join('%s %.3e' % kv for kv in upd.items()),
           TRAIN_UPDATE_TOL))
    if not all(r <= TRAIN_UPDATE_TOL for r in upd.values()):
        raise AssertionError('Adam kernel step vs plain step: updates '
                             'disagree beyond the stated tolerance')
    return worst, diffs, upd


def optimizer_cases(rng, shape):
    """The eleven update ops at `shape`, inputs from rng: [(op type,
    inputs, attrs, output slots)]. Accumulators that a root or a division
    reads are positive, except Ftrl's squared one, which is 0 at every
    other element, as it starts, with a gradient of 0 at every third."""
    def f():
        return rng.randn(*shape).astype('float32')

    def pos():
        return (rng.rand(*shape) + 0.1).astype('float32')

    def one(v):
        return np.array([v], 'float32')

    def fresh(a, step):
        # Ftrl's accumulators start at 0 and a gradient may be exactly 0
        a.flat[::step] = 0.0
        return a
    cases = [
        ('sgd', {}, {}, ['ParamOut']),
        ('momentum', {'Velocity': f()}, {'mu': 0.9, 'use_nesterov': True},
         ['ParamOut', 'VelocityOut']),
        ('adam', {'Moment1': f(), 'Moment2': pos(),
                  'Beta1Pow': one(0.9 ** 3), 'Beta2Pow': one(0.98 ** 3)},
         {'beta1': 0.9, 'beta2': 0.98, 'epsilon': 1e-9, 'lazy_mode': False},
         ['ParamOut', 'Moment1Out', 'Moment2Out', 'Beta1PowOut',
          'Beta2PowOut']),
        ('adagrad', {'Moment': pos()}, {'epsilon': 1e-6},
         ['ParamOut', 'MomentOut']),
        ('decayed_adagrad', {'Moment': pos()},
         {'decay': 0.95, 'epsilon': 1e-6}, ['ParamOut', 'MomentOut']),
        ('adamax', {'Moment': f(), 'InfNorm': pos(),
                    'Beta1Pow': one(0.9 ** 2)},
         {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8},
         ['ParamOut', 'MomentOut', 'InfNormOut']),
        ('adadelta', {'AvgSquaredGrad': pos(), 'AvgSquaredUpdate': pos()},
         {'rho': 0.95, 'epsilon': 1e-6},
         ['ParamOut', 'AvgSquaredGradOut', 'AvgSquaredUpdateOut']),
        ('rmsprop', {'MeanSquare': pos(), 'Moment': f()},
         {'decay': 0.9, 'epsilon': 1e-6, 'momentum': 0.5},
         ['ParamOut', 'MeanSquareOut', 'MomentOut']),
        ('ftrl', {'SquaredAccumulator': fresh(pos(), 2),
                  'LinearAccumulator': f(), 'Grad': fresh(f(), 3)},
         {'l1': 0.1, 'l2': 0.2, 'lr_power': -0.5},
         ['ParamOut', 'SquaredAccumOut', 'LinearAccumOut']),
        ('proximal_gd', {}, {'l1': 0.1, 'l2': 0.2}, ['ParamOut']),
        ('proximal_adagrad', {'Moment': pos()}, {'l1': 0.1, 'l2': 0.2},
         ['ParamOut', 'MomentOut']),
    ]
    return [(t, dict({'Param': f(), 'Grad': f(),
                      'LearningRate': one(0.01)}, **accs), attrs, outs)
            for t, accs, attrs, outs in cases]


def run_update(fluid, place, op_type, inputs, attrs, outs):
    """One update op on `place`, fed copies of `inputs`; its outputs as
    CPU tensors."""
    prog = fluid.Program()
    block = prog.global_block()
    ins = {s: [block.create_var(name='in_' + s.lower(), shape=a.shape,
                                dtype='float32', is_data=True)]
           for s, a in inputs.items()}
    out_vars = {s: [block.create_var(name='out_' + s.lower())] for s in outs}
    block.append_op(type=op_type, inputs=ins, outputs=out_vars, attrs=attrs)
    got = fluid.Executor(place).run(
        prog, feed={'in_' + s.lower(): a.copy() for s, a in inputs.items()},
        fetch_list=['out_' + s.lower() for s in outs], scope=fluid.Scope(),
        return_numpy=False)
    return [g.detach().cpu() for g in got]


def check_update(label, got, want):
    """Every output within OPT_TOL of max(1, |ref|), finite and of the
    reference's shape; raises otherwise. Returns the worst error."""
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, 'float64')
        w = np.asarray(w, 'float64')
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError('%s: an output of shape %s (want %s) or '
                                 'not finite' % (label, g.shape, w.shape))
        worst = max(worst, float((np.abs(g - w) /
                                  np.maximum(1.0, np.abs(w))).max()))
    if len(got) != len(want) or worst > OPT_TOL:
        raise AssertionError('%s: an update is %.3e off the CPU one (tol '
                             '%g)' % (label, worst, OPT_TOL))
    return worst


@phase('a3: the eleven optimizer updates on the card vs on CPU copies')
def check_optimizer_ops(place):
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 9)
    worst = {}
    for shape in OPT_SHAPES:
        for op_type, inputs, attrs, outs in optimizer_cases(rng, shape):
            label = '%s %s' % (op_type, list(shape))
            got = run_update(fluid, place, op_type, inputs, attrs, outs)
            want = run_update(fluid, fluid.CPUPlace(), op_type, inputs,
                              attrs, outs)
            worst[op_type] = max(worst.get(op_type, 0.0),
                                 check_update(label, got, want))
    log('optimizer updates on the card vs CPU copies at %s, max error of '
        'max(1, |ref|): %s (tol %g)'
        % (', '.join(str(list(s)) for s in OPT_SHAPES),
           ', '.join('%s %.2e' % kv for kv in worst.items()), OPT_TOL))
    return worst


# op types registered before the training core (phases b to t hold them)
A4_EARLIER_OPS = (
    'abs', 'accuracy', 'argmax', 'assign', 'batch_norm', 'causal_mask',
    'clip', 'clip_by_norm', 'conv2d', 'conv2d_bn', 'cross_entropy',
    'decode_mask', 'depthwise_conv2d', 'elementwise_add', 'elementwise_div',
    'elementwise_max', 'elementwise_mul', 'fill_constant', 'fill_zeros_like',
    'flash_attention', 'fused_softmax_cross_entropy', 'gather_time',
    'gaussian_random', 'gelu', 'kv_cache_append', 'kv_cache_write',
    'layer_norm', 'load', 'load_combine', 'lookup_table', 'matmul', 'mean',
    'momentum', 'mul', 'pool2d', 'position_embedding',
    'position_embedding_at', 'read', 'relu', 'reshape2',
    'reshape_grad_helper', 'save', 'save_combine', 'scale', 'sgd',
    'sharding_constraint', 'slice', 'softmax', 'sqrt', 'square_error_cost',
    'squared_l2_norm', 'sum', 'top_k', 'transpose2', 'uniform_random')
# op types of the training core that a4's table leaves to other checks
A4_HELD_ELSEWHERE = {
    'dropout': 'a4\'s own checks: is_test bits, kept entries, kept share, '
               'grad = dOut·Mask',
    'truncated_gaussian_random': 'a4\'s own check of the draw: the card\'s '
                                 'stream is not the CPU\'s',
    'remat_block': 'x4: the flagship LM with each block a remat scope, '
                   'against remat=None',
}
for _t in ('adam', 'adagrad', 'decayed_adagrad', 'adamax', 'adadelta',
           'rmsprop', 'ftrl', 'proximal_gd', 'proximal_adagrad'):
    A4_HELD_ELSEWHERE[_t] = 'a3'

_UNARY_CASES = {
    'sigmoid': {}, 'logsigmoid': {}, 'tanh': {}, 'tanh_shrink': {},
    'exp': {}, 'square': {}, 'ceil': {}, 'floor': {}, 'round': {},
    'sin': {}, 'cos': {}, 'softplus': {}, 'softsign': {}, 'relu6': {},
    'softshrink': {'lambda': 0.5}, 'leaky_relu': {'alpha': 0.1},
    'elu': {'alpha': 1.0}, 'hard_sigmoid': {}, 'brelu': {'t_max': 2.0},
    'swish': {'beta': 1.5}, 'stanh': {}, 'thresholded_relu': {},
    'hard_shrink': {'threshold': 0.5}}
_POSITIVE_UNARY_CASES = {'log': {}, 'rsqrt': {}, 'reciprocal': {},
                         'pow': {'factor': 2.5}}


def training_op_cases(rng):
    """a4's table, inputs from rng: [(name, op type, {slot: array or
    [(var name, array)]}, attrs, {slot: [var names]} or None for {'Out':
    ['out']}, [input var names whose grads are held])]. An array input of
    slot S is the var in_<s>."""
    def f(*s):
        return rng.randn(*s).astype('float32')

    def pos(*s):
        return (rng.rand(*s) * 0.8 + 0.3).astype('float32')
    x, y = f(4, 6), f(4, 6)
    cases = []

    def add(op, inputs=None, attrs=None, outputs=None, check=('in_x',),
            name=None):
        cases.append((name or op, op, inputs or {}, attrs or {}, outputs,
                      list(check)))
    for op, attrs in _UNARY_CASES.items():
        add(op, {'X': 3 * f(4, 6)}, attrs)
    for op, attrs in _POSITIVE_UNARY_CASES.items():
        add(op, {'X': pos(4, 6)}, attrs)
    add('logit', {'X': np.clip(pos(4, 6), 0.2, 0.8)})
    add('elementwise_sub', {'X': f(2, 3, 4), 'Y': f(3)}, {'axis': 1},
        check=('in_x', 'in_y'))
    add('elementwise_min', {'X': x, 'Y': y}, check=('in_x', 'in_y'))
    add('elementwise_pow', {'X': pos(4, 6), 'Y': pos(4, 6) + 1.0},
        check=('in_x', 'in_y'))
    add('elementwise_mod', {'X': pos(4, 6) * 3, 'Y': pos(4, 6) + 1.0})
    add('elementwise_floordiv', {'X': pos(4, 6) * 3, 'Y': pos(4, 6) + 0.5})
    for red in ('sum', 'mean', 'max', 'min', 'prod'):
        add('reduce_' + red, {'X': pos(3, 4, 5) if red == 'prod'
                              else f(3, 4, 5)},
            {'dim': [1], 'keep_dim': red == 'sum', 'reduce_all': False})
    for op in ('less_than', 'less_equal', 'greater_than', 'greater_equal',
               'equal', 'not_equal'):
        add(op, {'X': x, 'Y': np.where(rng.rand(4, 6) < 0.3, x, y)},
            check=())
    b1, b2 = rng.rand(4, 6) < 0.5, rng.rand(4, 6) < 0.5
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        add(op, {'X': b1, 'Y': b2}, check=())
    add('logical_not', {'X': b1}, check=())
    xinf = x.copy()
    xinf[2, 3] = np.inf
    add('isfinite', {'X': [('fin_a', x), ('fin_b', xinf)]}, check=())
    add('argsort', {'X': f(5, 7)}, {'axis': -1},
        {'Out': ['as_out'], 'Indices': ['as_idx']}, check=())
    add('cumsum', {'X': x}, {'axis': 1, 'exclusive': True, 'reverse': True})
    add('where', {'Cond': x > 0, 'X': x, 'Y': y}, check=('in_x', 'in_y'))
    add('increment', {'X': np.array([4.5], 'float32')}, {'step': 1.0},
        check=())
    add('cast', {'X': 3 * x}, {'in_dtype': 'float32', 'out_dtype': 'int64'},
        check=())
    add('concat', {'X': [('cc_a', x), ('cc_b', y)]}, {'axis': 1},
        check=('cc_a', 'cc_b'))
    add('split', {'X': f(5, 4)}, {'sections': [2, 3], 'axis': 0},
        {'Out': ['sp_a', 'sp_b']})
    add('stack', {'X': [('st_a', x), ('st_b', y)]}, {'axis': 1},
        {'Y': ['stack_y']}, check=('st_a', 'st_b'))
    add('expand', {'X': f(2, 3)}, {'expand_times': [2, 3]})
    add('gather', {'X': x, 'Index': np.array([3, 0, 2], 'int64')})
    add('scatter', {'X': x, 'Ids': np.array([2, 0], 'int64'),
                    'Updates': f(2, 6)}, {'overwrite': True},
        check=('in_x', 'in_updates'))
    add('one_hot', {'X': np.array([[1], [0], [4]], 'int64')}, {'depth': 5},
        check=())
    add('pad', {'X': f(2, 3, 4)}, {'paddings': [0, 1, 2, 0, 1, 1],
                                   'pad_value': -1.5})
    add('shape', {'Input': f(2, 3, 4)}, check=())
    add('reshape', {'X': x}, {'shape': [3, -1]})
    add('transpose', {'X': f(2, 3, 4)}, {'axis': [2, 0, 1]})
    add('squeeze', {'X': f(4, 1, 6)}, {'axes': [1]})
    add('unsqueeze', {'X': x}, {'axes': [1]})
    add('squeeze2', {'X': f(4, 1, 6)}, {'axes': [1]},
        {'Out': ['out'], 'XShape': ['xshape']})
    add('unsqueeze2', {'X': x}, {'axes': [0]},
        {'Out': ['out'], 'XShape': ['xshape']})
    add('range', attrs={'start': 2, 'end': 11, 'step': 3, 'dtype': 'int64'},
        check=())
    add('reverse', {'X': x}, {'axis': [0, 1]})
    add('label_smooth', {'X': pos(4, 6)}, {'epsilon': 0.1})
    add('assign_value', attrs={'shape': [2, 3], 'dtype': 'float32',
                               'values': [0.5, -1.0, 2.0, 3.5, 0.0, 1.25]},
        check=())
    add('softmax_with_cross_entropy',
        {'Logits': 2 * f(4, 7),
         'Label': np.array([[0], [6], [-100], [3]], 'int64')},
        {'soft_label': False, 'ignore_index': -100},
        {'Softmax': ['swce_sm'], 'Loss': ['swce_loss']}, check=('in_logits',))
    add('sigmoid_cross_entropy_with_logits',
        {'X': 3 * f(4, 3), 'Label': (rng.rand(4, 3) < 0.5).astype('float32')},
        {'ignore_index': -100})
    return cases


def uncovered_op_types(cases):
    """Op types of the port registered after A4_EARLIER_OPS that neither
    the table nor A4_HELD_ELSEWHERE holds."""
    from paddle_tpu_torch import registry
    new = {t for t in registry._REGISTRY if not t.endswith('_grad')} - \
        set(A4_EARLIER_OPS)
    return sorted(new - {c[1] for c in cases} - set(A4_HELD_ELSEWHERE))


def run_op_case(fluid, place, case):
    """One case's op on `place`, fed copies: {var name: numpy array} of
    its outputs and of the held inputs' grads against a fixed cotangent
    on its Loss, Out or Y outputs."""
    import torch
    _, op_type, inputs, attrs, outputs, check = case
    prog = fluid.Program()
    block = prog.global_block()
    feed, ins = {}, {}
    for slot, val in inputs.items():
        named = val if isinstance(val, list) else \
            [('in_' + slot.lower(), val)]
        ins[slot] = []
        for name, arr in named:
            ins[slot].append(block.create_var(
                name=name, shape=arr.shape, dtype=arr.dtype.name,
                is_data=True, stop_gradient=name not in check))
            feed[name] = arr.copy()
    outputs = outputs or {'Out': ['out']}
    outs = {slot: [block.create_var(name=n) for n in names]
            for slot, names in outputs.items()}
    fetch = [n for names in outputs.values() for n in names]
    with fluid.program_guard(prog, fluid.Program()):
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs=dict(attrs))
        if check:
            targets = outs.get('Loss') or outs.get('Out') or outs['Y']
            cots = []
            for i, t in enumerate(targets):
                cot = block.create_var(name='cot_%d' % i, shape=t.shape,
                                       dtype='float32', is_data=True,
                                       stop_gradient=True)
                feed[cot.name] = np.asarray(np.random.RandomState(
                    i + 1).randn(*t.shape), 'float32')
                cots.append(cot)
            grads = fluid.backward.calc_gradient(
                targets, [block.var(n) for n in check],
                target_gradients=cots)
            fetch += [g.name for g in grads]
    got = fluid.Executor(place).run(prog, feed=feed, fetch_list=fetch,
                                    scope=fluid.Scope(), return_numpy=False)
    return {n: (g.detach().float() if g.dtype == torch.bfloat16 else
                g.detach()).cpu().numpy() for n, g in zip(fetch, got)}


def check_op_outputs(label, got, want):
    """fp32 within OP_ATOL + OP_RTOL·|ref|; integer and bool outputs
    exact; the same names and shapes. Raises; returns the worst fp32
    error over (OP_ATOL + OP_RTOL·|ref|)."""
    if sorted(got) != sorted(want):
        raise AssertionError('%s: outputs %s, want %s'
                             % (label, sorted(got), sorted(want)))
    worst = 0.0
    for n, w in want.items():
        g = got[n]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError('%s: %s is %s %s, want %s %s'
                                 % (label, n, g.dtype, g.shape, w.dtype,
                                    w.shape))
        if w.dtype.kind in 'biu':
            if not np.array_equal(g, w):
                raise AssertionError('%s: %s differs' % (label, n))
            continue
        both_inf = np.isinf(w) & (g == w)
        err = np.where(both_inf, 0.0, np.abs(g.astype('float64') - w) /
                       (OP_ATOL + OP_RTOL * np.abs(w)))
        worst = max(worst, float(err.max()) if err.size else 0.0)
        if not (err <= 1.0).all():
            raise AssertionError('%s: %s is %.3g x the tolerance off'
                                 % (label, n, float(np.nanmax(err))))
    return worst


def _dropout_program(fluid, shape, impl, is_test):
    """dropout (seed 0: the executor's generator) of a fed x, its grad
    against a fed cotangent."""
    prog = fluid.Program()
    block = prog.global_block()
    with fluid.program_guard(prog, fluid.Program()):
        x = block.create_var(name='x', shape=shape, dtype='float32',
                             is_data=True, stop_gradient=False)
        out, mask = block.create_var(name='out'), block.create_var(
            name='mask', stop_gradient=True)
        block.append_op(type='dropout', inputs={'X': [x]},
                        outputs={'Out': [out], 'Mask': [mask]},
                        attrs={'dropout_prob': DROPOUT_P, 'is_test': is_test,
                               'seed': 0, 'dropout_implementation': impl})
        cot = block.create_var(name='cot', shape=shape, dtype='float32',
                               is_data=True, stop_gradient=True)
        grad, = fluid.backward.calc_gradient([out], [x],
                                             target_gradients=[cot])
    prog.random_seed = SEED
    return prog, grad.name


def check_dropout(place):
    """is_test: the card's outputs are the CPU's bits. Training, over
    DROPOUT_N elements: dropped entries 0, kept ones x (downgrade_in_infer)
    or x / (1 - p) (upscale_in_train; within 1e-6 relative, as the mask's
    1 / (1 - p)), the kept share within 0.01 of 1 - p, and the grad
    exactly dOut·Mask. Returns the kept shares."""
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 11)
    shares = {}
    for impl in ('downgrade_in_infer', 'upscale_in_train'):
        x = (rng.randn(4, 6) + 3).astype('float32')
        res = []
        for p in (place, fluid.CPUPlace()):
            prog, gname = _dropout_program(fluid, x.shape, impl, True)
            res.append(fluid.Executor(p).run(
                prog, feed={'x': x.copy(), 'cot': np.ones_like(x)},
                fetch_list=['out', 'mask'], scope=fluid.Scope()))
        for g, w in zip(*res):
            if not np.array_equal(g, w):
                raise AssertionError('dropout %s is_test: the card\'s '
                                     'output is not the CPU\'s' % impl)
        x = (rng.randn(DROPOUT_N // 1024, 1024) + 3).astype('float32')
        dout = rng.randn(*x.shape).astype('float32')
        prog, gname = _dropout_program(fluid, x.shape, impl, False)
        out, mask, dx = fluid.Executor(place).run(
            prog, feed={'x': x.copy(), 'cot': dout},
            fetch_list=['out', 'mask', gname], scope=fluid.Scope())
        keep = mask > 0
        kept = x / np.float32(1.0 - DROPOUT_P) \
            if impl == 'upscale_in_train' else x
        scale = 1.0 / (1.0 - DROPOUT_P) if impl == 'upscale_in_train' \
            else 1.0
        share = float(keep.mean())
        shares[impl] = share
        # x / (1 - p) on the card may be x times the rounded reciprocal:
        # within a few ulps
        if not (np.allclose(out[keep], kept[keep], rtol=1e-6, atol=0)
                and not out[~keep].any()
                and np.allclose(mask[keep], scale, rtol=1e-6, atol=0)
                and abs(share - (1.0 - DROPOUT_P)) <= 0.01
                and np.array_equal(dx, dout * mask)):
            raise AssertionError('dropout %s on the card: kept share %.4f, '
                                 'or an entry, the mask or the grad wrong'
                                 % (impl, share))
    return shares


def check_truncated_normal(place):
    """The card's truncated_gaussian_random draw: within mean +- 2 std,
    its mean and std (0.8796 of std at a 2-sigma cut) within 0.01."""
    import paddle_tpu_torch as fluid
    prog = fluid.Program()
    prog.random_seed = SEED
    block = prog.global_block()
    block.append_op(type='truncated_gaussian_random',
                    outputs={'Out': [block.create_var(name='w')]},
                    attrs={'shape': [1024, 1024], 'mean': 0.0, 'std': 1.0,
                           'dtype': 'float32'})
    w, = fluid.Executor(place).run(prog, fetch_list=['w'],
                                   scope=fluid.Scope())
    if not (np.abs(w).max() <= 2.0 and abs(w.mean()) < 0.01
            and abs(w.std() - 0.8796) < 0.01):
        raise AssertionError('truncated_gaussian_random: |w| max %.4f, mean '
                             '%.4f, std %.4f' % (np.abs(w).max(), w.mean(),
                                                 w.std()))
    return float(w.mean()), float(w.std())


@phase('a4: the training core\'s op types on the card vs on CPU copies, '
       'forward and grads')
def check_training_ops(place):
    import paddle_tpu_torch as fluid
    cases = training_op_cases(np.random.RandomState(SEED + 10))
    missing = uncovered_op_types(cases)
    if missing:
        raise AssertionError('op types of the training core with no case '
                             'and no other check: %s' % missing)
    worst = {}
    for case in cases:
        got = run_op_case(fluid, place, case)
        want = run_op_case(fluid, fluid.CPUPlace(), case)
        worst[case[0]] = check_op_outputs(case[0], got, want)
    shares = check_dropout(place)
    mean_std = check_truncated_normal(place)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log('%d op cases on the card vs CPU copies (%d op types), worst error '
        'over the tolerance (rtol %g, atol %g): %s; dropout kept shares %s '
        '(1 - p = %.2f); truncated normal mean %.4f, std %.4f'
        % (len(cases), len({c[1] for c in cases}), OP_RTOL, OP_ATOL,
           ', '.join('%s %.3f' % kv for kv in top), json.dumps(shares),
           1.0 - DROPOUT_P, mean_std[0], mean_std[1]))
    return max(worst.values())


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


def resnet_program(nhwc=False, space_to_depth=False,
                   reader_name='resnet_reader'):
    """bench.py's bench_resnet program (:136-158), built under the flags
    set now: py_reader, train_network(depth=50, nhwc=, space_to_depth=),
    Momentum(0.01, 0.9) under contrib.mixed_precision.decorate. Returns
    (main, startup, reader, image, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    hw = RESNET['image_hw']
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, 3, hw, hw), (-1, 1)],
            dtypes=['float32', 'int64'], name=reader_name,
            use_double_buffer=True)
        image, label = fluid.layers.read_file(reader)
        _, avg_cost, _ = resnet.train_network(
            image, label, class_dim=RESNET['class_dim'],
            depth=RESNET['depth'], nhwc=nhwc, space_to_depth=space_to_depth)
        opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg_cost)
    return main, startup, reader, image, avg_cost


class ResNetTrainer(Trainer):
    """resnet_program's step with its state on the card: NCHW with
    FLAGS_use_pallas_fused_ops set (r1), NHWC as bench.py builds it for
    an accelerator (n1), or NCHW with the space-to-depth stem (s1)."""

    def __init__(self, place, batch, nhwc=False, space_to_depth=False,
                 reader_name='resnet_reader'):
        import paddle_tpu_torch as fluid
        self.fluid, self.batch = fluid, batch
        (self.main, startup, self.reader, self.image,
         self.avg_cost) = resnet_program(nhwc, space_to_depth, reader_name)
        self.scope = fluid.Scope()
        fluid.Executor(place).run(startup, scope=self.scope)
        self.pe = fluid.ParallelExecutor(
            use_cuda=True, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)
        self.persistables = [v.name for v in self.main.list_vars()
                             if v.persistable and
                             self.scope.find_var(v.name) is not None]

    def batch_of(self, rng):
        return image_batch(rng, self.batch)


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


def _k6_check(k6, gen, dev, M, K, N, dtype, want):
    """Launch K6 twice on the same inputs and hold it against its plain
    version: y within KERNEL_ATOL of max(1, |y|), the sums within
    K6_SUM_RTOL, the second launch the same bits, and both launches by
    the kernel `want` (from the per-kernel counts). Returns the max abs
    error of y."""
    import torch
    x, w = _k6_inputs(gen, M, K, N, dtype, dev)
    counts = k6.matmul_bn_stats_kernel.launches_by_kernel
    before = dict(counts)
    y, s, q = k6.matmul_bn_stats_kernel(x, w)
    y2, s2, q2 = k6.matmul_bn_stats_kernel(x, w)
    torch.cuda.synchronize()
    ran = {k: n - before.get(k, 0) for k, n in counts.items()
           if n != before.get(k, 0)}
    same = all(torch.equal(a, b) for a, b in ((y, y2), (s, s2), (q, q2)))
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
    log('K6 [%d, %d, %d] %s on %s: y max_abs_err %.3e (tol %g x max(1, '
        '|y|)), colsum err %.3e of sum|y|, colsumsq err %.3e of sum y^2 (tol '
        '%g), second launch bit-identical %s %s'
        % (M, K, N, dtype, ', '.join('%s x %d' % kv for kv in ran.items())
           or 'no kernel', err, tol, err_s, err_q, K6_SUM_RTOL,
           'yes' if same else 'NO', 'ok' if ok and same else 'MISMATCH'))
    if ran != {want: 2}:
        raise AssertionError('K6 at [%d, %d, %d] %s ran %s, want %s twice'
                             % (M, K, N, dtype, ran, want))
    if not same:
        raise AssertionError('K6 at [%d, %d, %d] %s: a second launch on the '
                             'same inputs gave other bits' % (M, K, N, dtype))
    if not ok:
        raise AssertionError('K6 disagrees with its plain version at '
                             '[%d, %d, %d] %s (finite: %s)'
                             % (M, K, N, dtype, finite))
    return err


def k6_check_shapes(k6, path_shapes, sms):
    """[(shape, dtype, kernel that must run, on the path)] of phase b6:
    the largest, smallest and widest path shapes, a path shape for every
    tile width the plan uses and one with K = 64 (a single k slice) in
    bf16, all on the tensor-core kernel; the smallest path shape with
    one row more (M not a multiple of the tile), the routing's pick; the
    three picks in fp32 and the ragged 300 x 70 x 130 in both dtypes, on
    the generic kernel."""
    nbytes = lambda s: s[0] * s[1] + s[1] * s[2] + s[0] * s[2]  # noqa: E731
    shapes = sorted(path_shapes)
    picks = [max(shapes, key=nbytes), min(shapes, key=nbytes),
             max(shapes, key=lambda s: (s[2], s[1]))]
    by_bn = {}
    for s in shapes:
        by_bn.setdefault(k6._plan(*s, sms).bn, s)
    k64 = [s for s in shapes if s[1] == 64][:1]
    path = []
    for s in picks + [by_bn[bn] for bn in sorted(by_bn)] + k64:
        if s not in path:
            path.append(s)
    M, K, N = picks[1]
    out = [(s, 'bfloat16', k6.WGMMA_KERNEL, True) for s in path]
    out.append(((M + 1, K, N), 'bfloat16',
                k6._route(M + 1, K, N, _torch_dtype('bfloat16')), False))
    out += [(s, 'float32', k6.GENERIC_KERNEL, False) for s in picks]
    out += [((300, 70, 130), dt, k6.GENERIC_KERNEL, False)
            for dt in ('float32', 'bfloat16')]
    return out


def _torch_dtype(name):
    import torch
    return getattr(torch, name)


def check_k6_outputs(k6, gen, dev, path_shapes, sms):
    """Every shape of k6_check_shapes through _k6_check; returns the max
    abs error of y over the bf16 path shapes."""
    path_err = 0.0
    for shape, dtype, want, on_path in k6_check_shapes(k6, path_shapes, sms):
        err = _k6_check(k6, gen, dev, *shape, dtype, want)
        if on_path:
            path_err = max(path_err, err)
    return path_err


@phase('b6: K6 (matmul + BN statistics) vs its plain version')
def check_k6(path_shapes):
    """Correctness and bit-identical second launches at the shapes of
    k6_check_shapes; then times of kernel, plain version, yardstick and
    the product alone at every path shape in bf16, summed over one
    step's launches. Returns the kernels line's row."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path_err = check_k6_outputs(k6, gen, dev, path_shapes, sms)
    torch.cuda.empty_cache()

    totals = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
              'matmul_ms': 0.0, 'device_ms': 0.0, 'matmul_device_ms': 0.0,
              'bound_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
    for (M, K, N), count in sorted(path_shapes.items()):
        x, w = _k6_inputs(gen, M, K, N, 'bfloat16', dev)

        def library():
            yf = torch.matmul(x, w).float()
            return yf.sum(0), (yf * yf).sum(0)

        times = bracketed_ms({
            'ms': lambda: k6.matmul_bn_stats_kernel(x, w),
            'plain_ms': lambda: k6.matmul_bn_stats_reference(x, w),
            'library_ms': library,
            'matmul_ms': lambda: torch.matmul(x, w)})
        # device time alone (the events above also hold any time the
        # card waits for the host between calls)
        for key, fn in (('device_ms', lambda: k6.matmul_bn_stats_kernel(x, w)),
                        ('matmul_device_ms', lambda: torch.matmul(x, w))):
            times[key] = _device_ms(fn)
            if times[key] is None:
                raise RuntimeError('torch.profiler saw no device time in K6 '
                                   'or the product at [%d, %d, %d]'
                                   % (M, K, N))
        t_bytes, t_ops = k6_bound_ms(M, K, N, 'bfloat16')
        plan = k6._plan(M, K, N, sms)
        log('K6 [%d, %d, %d] bf16 x %d per step: kernel %.4f ms, plain '
            '%.4f ms, library %.4f ms, product alone %.4f ms, bound %.4f ms '
            '(%s); device: kernel %.4f ms (%.2f TB/s, %.1f TFLOP/s), '
            'product alone %.4f ms; plan BN %d, %d tiles on %d CTAs, %d '
            'stages, w %s'
            % (M, K, N, count, times['ms'], times['plain_ms'],
               times['library_ms'], times['matmul_ms'], max(t_bytes, t_ops),
               'bytes' if t_bytes >= t_ops else 'operations',
               times['device_ms'],
               t_bytes * PEAK_BYTES_PER_S / 1e12 / times['device_ms'],
               2.0 * M * K * N / times['device_ms'] / 1e9,
               times['matmul_device_ms'], plan.bn, plan.tiles, plan.grid,
               plan.stages, 'resident' if plan.resident else 'streamed'))
        for key in ('ms', 'plain_ms', 'library_ms', 'matmul_ms', 'device_ms',
                    'matmul_device_ms'):
            totals[key] += count * times[key]
        totals['bound_ms'] += count * max(t_bytes, t_ops)
        totals['bytes_ms'] += count * t_bytes
        totals['ops_ms'] += count * t_ops
        del x, w
    torch.cuda.empty_cache()
    n_launch = sum(path_shapes.values())
    log('K6 per step (%d launches over %d shapes, bf16): kernel %.4f ms, '
        'plain %.4f ms, library %.4f ms, product alone %.4f ms, bound %.4f '
        'ms (the sum of each launch\'s bound; bytes alone %.4f ms, '
        'operations alone %.4f ms); device: kernel %.4f ms, product alone '
        '%.4f ms'
        % (n_launch, len(path_shapes), totals['ms'], totals['plain_ms'],
           totals['library_ms'], totals['matmul_ms'], totals['bound_ms'],
           totals['bytes_ms'], totals['ops_ms'], totals['device_ms'],
           totals['matmul_device_ms']))
    name, replaces, source = K6_SOURCE
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': path_err,
            'ms': totals['ms'], 'plain_ms': totals['plain_ms'],
            'bound_ms': totals['bound_ms'],
            'bound_by': ('bytes' if totals['bytes_ms'] >= totals['ops_ms']
                         else 'operations'),
            'library_ms': totals['library_ms'],
            'matmul_ms': totals['matmul_ms'],
            'device_ms': totals['device_ms'],
            'matmul_device_ms': totals['matmul_device_ms'],
            'kernel': k6.WGMMA_KERNEL,
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
    # the peak covers the eager warm-up, the capture and the replays
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=True)]
    losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
    sync()
    k6.reset_launches()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = k6.matmul_bn_stats_kernel.launches
    by_kernel = dict(k6.matmul_bn_stats_kernel.launches_by_kernel)
    peak_gb = peak_memory_gb()
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    moved = sum(not torch.equal(tr.scope.find_var(n), stats0[n])
                for n in stats)
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f images/s; K6 '
        'launches %d (want %d x %d; by kernel: %s); peak device memory %.2f '
        'GB; BN running statistics moved: %d of %d'
        % (TIMED_STEPS, wall, step_ms, RESNET_BATCH / step_ms * 1e3,
           launches, per_step, TIMED_STEPS,
           ', '.join('%s %d' % kv for kv in by_kernel.items()), peak_gb,
           moved, len(stats)))
    if not all(np.isfinite(losses)):
        raise AssertionError('a ResNet loss is not finite: %r' % losses)
    if per_step != 36 or launches != per_step * TIMED_STEPS:
        raise AssertionError('K6 launched %d times in %d steps, want 36 x %d'
                             ' (the program has %d 1x1 conv2d_bn ops)'
                             % (launches, TIMED_STEPS, TIMED_STEPS, per_step))
    if by_kernel.get(k6.WGMMA_KERNEL) != launches:
        raise AssertionError('K6 launched %s in the timed steps: every '
                             'launch must be %s' % (by_kernel,
                                                    k6.WGMMA_KERNEL))
    if moved != len(stats) or not stats:
        raise AssertionError('BN running statistics moved for %d of %d vars'
                             % (moved, len(stats)))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('peak reserved device memory %.2f GB over the '
                             '%g GB the batch of %d is held to'
                             % (reserved_gb, RESNET_PEAK_GB, RESNET_BATCH))
    check_replay_launches('r1', tr.step, sync)
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
    # the captured step's pool and an eager step do not fit together
    tr.drop_graphs()
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
    checked_kernel.launches_by_kernel = {}
    k6.matmul_bn_stats_kernel = checked_kernel
    # op by op: a captured graph replays without calling the stand-in
    eager = fluid.Executor(fluid.CUDAPlace(0))
    try:
        kernel = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED, eager)
    finally:
        k6.matmul_bn_stats_kernel = kernel_fn
    log('K6 on the step\'s own 36 inputs vs its plain version: y max diff / '
        'max(1, |y|) %.3e (tol %g), bf16 y that differ %.2e of the '
        'elements, colsum %.3e of sum|y|, colsumsq %.3e of sum y^2 (tol %g)'
        % (worst['y'], KERNEL_ATOL['bfloat16'], worst['flips'],
           worst['colsum'], worst['colsumsq'], K6_SUM_RTOL))
    if checked_kernel.launches_by_kernel != {k6.WGMMA_KERNEL: 36}:
        raise AssertionError('K6 launched %s in the kernel step, want %s x 36'
                             % (checked_kernel.launches_by_kernel,
                                k6.WGMMA_KERNEL))
    if not (worst['y'] <= KERNEL_ATOL['bfloat16'] and
            worst['colsum'] <= K6_SUM_RTOL and
            worst['colsumsq'] <= K6_SUM_RTOL):
        raise AssertionError('K6 disagrees with its plain version on the '
                             'step\'s inputs: %r' % worst)
    fluid.set_flags({'FLAGS_use_pallas_fused_ops': False})
    try:
        kernel_fn.launches = 0
        plain = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED, eager)
        k6.matmul_bn_stats_reference = _reordered_reference
        reordered = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED,
                              eager)
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


def _profile_resnet(tr, step_ms, sync, label):
    """images/s and MFU of a ResNet-50 step of step_ms (bench.py's FLOPs
    per image over the bf16 dense peak), then a fresh batch, two steps
    and PROFILE_STEPS profiled. Returns (images/s, MFU, device ms, busy
    share, {kernel kind: device ms})."""
    import torch
    fl = resnet50_train_flops_per_image(RESNET['image_hw'],
                                        RESNET['class_dim'])
    img_s = RESNET_BATCH / step_ms * 1e3
    mfu = img_s * fl / PEAK_BF16_FLOPS
    log('%s: %.3f ms, %.1f images/s, %.1f TFLOP/s at %.3f GFLOP per image, '
        'MFU %.4f of the %.1f TFLOP/s bf16 dense peak'
        % (label, step_ms, img_s, img_s * fl / 1e12, fl / 1e9, mfu,
           PEAK_BF16_FLOPS / 1e12))
    batch = image_batch(np.random.RandomState(1), RESNET_BATCH,
                        torch.device('cuda', 0))

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    tr.step()       # after a new executor: the warm-up, then the capture
    tr.step()
    sync()
    by_kind = {}
    device_ms, busy = _profile_steps(tr, step_ms, sync, label,
                                     by_kind_out=by_kind)
    tr.reader.reset()
    return img_s, mfu, device_ms, busy, by_kind


@phase('r4: ResNet-50 step time, images/s, MFU, device time')
def profile_resnet(tr, step_ms, sync):
    return _profile_resnet(tr, step_ms, sync, 'ResNet-50 step')


# -- (n1)-(n3), (i2): bench.py's accelerator ResNet-50 (NHWC) ---------------

# bench.py builds ResNet-50 NHWC on an accelerator (bench_resnet :148),
# with FLAGS_use_pallas_fused_ops at its default and bf16 parameter
# grads (main :524-527); set for n1-n3 and i2, restored after
N1_FLAGS = {'FLAGS_use_pallas_fused_ops': False,
            'FLAGS_amp_bf16_param_grads': True}
# the stem conv, a stage-1 1x1 conv and fc of the unfused program
NHWC_PARAMS_COMPARED = ('conv2d_0.w_0', 'conv2d_2.w_0', 'fc_0.w_0')
RESNET_CONV_BN = 53          # conv + BN pairs of ResNet-50
NAN_CHECK_BATCH = 32
NAN_CHECK_TOL = 1e-5         # the flagged step's loss vs the captured one
S2D_TOL = 1e-5               # tests/test_resnet_s2d.py's bound
S2D_BATCH = 8
S2D_TIMED_STEPS = 3
INFER_BATCH = 16             # bench_inference's ResNet leg (:377-410)
INFER_ITERS = 20
INFER_TOL = 2e-4             # tests/test_parity_modules.py:252


@contextlib.contextmanager
def flags_set(flags):
    """set_flags(flags) for the body, the earlier values restored after."""
    import paddle_tpu_torch as fluid
    prev = fluid.get_flags(list(flags))
    fluid.set_flags(flags)
    try:
        yield
    finally:
        fluid.set_flags(prev)


def check_nhwc_program(program):
    """bench.py's accelerator ResNet-50: RESNET_CONV_BN conv2d and
    batch_norm ops, all NHWC, no conv2d_bn, one transpose (the stem's, of
    the NCHW feed). Returns the op count."""
    ops = program.global_block().ops
    convs = [op for op in ops if op.type == 'conv2d']
    bns = [op for op in ops if op.type == 'batch_norm']
    fused = sum(op.type == 'conv2d_bn' for op in ops)
    transposes = sum(op.type == 'transpose2' for op in ops)
    log('NHWC program: %d ops, %d conv2d (%d NHWC), %d batch_norm (%d NHWC), '
        '%d conv2d_bn, %d transpose2'
        % (len(ops), len(convs),
           sum(op.attr('data_format') == 'NHWC' for op in convs), len(bns),
           sum(op.attr('data_layout') == 'NHWC' for op in bns), fused,
           transposes))
    if not (len(convs) == len(bns) == RESNET_CONV_BN and fused == 0 and
            transposes == 1 and
            all(op.attr('data_format') == 'NHWC' for op in convs) and
            all(op.attr('data_layout') == 'NHWC' for op in bns)):
        raise AssertionError('the NHWC program is not bench.py\'s: want %d '
                             'NHWC conv2d and batch_norm ops, no conv2d_bn '
                             'and one transpose' % RESNET_CONV_BN)
    return len(ops)


@phase('n1: bench.py\'s accelerator ResNet-50 (NHWC, conv2d + batch_norm, '
       'bf16 parameter grads)')
def nhwc_steps(place, sync):
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    t0 = time.perf_counter()
    tr = ResNetTrainer(place, RESNET_BATCH, nhwc=True)
    n_ops = check_nhwc_program(tr.main)
    log('built and initialised in %.1f s' % (time.perf_counter() - t0))
    stats = [n for n in tr.persistables if n.endswith(('.mean', '.variance'))]
    stats0 = {n: tr.scope.find_var(n).clone() for n in stats}
    batch = image_batch(np.random.RandomState(0), RESNET_BATCH,
                        place.device)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=True)]
    losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
    sync()
    k6.reset_launches()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = k6.matmul_bn_stats_kernel.launches
    peak_gb = peak_memory_gb()
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    moved = sum(not torch.equal(tr.scope.find_var(n), stats0[n])
                for n in stats)
    segments = device_segments(tr.main)
    captured = tr.pe.jit_cache_stats()['compiled_segments']
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f images/s; K6 '
        'launches %d; BN running statistics moved: %d of %d; captured '
        'segments %d (the program has %d); peak device memory %.2f GB '
        'allocated, %.2f GB reserved'
        % (TIMED_STEPS, wall, step_ms, RESNET_BATCH / step_ms * 1e3,
           launches, moved, len(stats), captured, segments, peak_gb,
           reserved_gb))
    if not all(np.isfinite(losses)):
        raise AssertionError('an NHWC loss is not finite: %r' % losses)
    if launches:
        raise AssertionError('K6 launched %d times on the NHWC path' %
                             launches)
    if moved != len(stats) or len(stats) != 2 * RESNET_CONV_BN:
        raise AssertionError('BN running statistics moved for %d of %d vars'
                             % (moved, len(stats)))
    if captured != segments or segments != 1:
        raise AssertionError('%d segments captured, the program has %d: '
                             'want one' % (captured, segments))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('peak reserved device memory %.2f GB over the '
                             '%g GB the batch of %d is held to'
                             % (reserved_gb, RESNET_PEAK_GB, RESNET_BATCH))
    return tr, dict(losses=losses, step_ms=step_ms, peak_gb=peak_gb,
                    reserved_gb=reserved_gb, n_ops=n_ops)


@phase('n3: the NHWC step\'s time, images/s, MFU, device time')
def profile_nhwc(tr, step_ms, sync):
    return _profile_resnet(tr, step_ms, sync, 'NHWC ResNet-50 step')


def _bn_batch_stats_fp64(x, axes):
    """batch_norm's batch statistics with the sums taken in fp64: the
    same math in another order of summation (n2's yardstick)."""
    import torch
    xd = x.double()
    m = 1
    for i in axes:
        m *= x.shape[i]
    mean = torch.sum(xd, dim=axes) / m
    var = torch.clamp(torch.sum(xd * xd, dim=axes) / m - mean * mean,
                      min=0.0)
    return mean.float(), var.float()


@phase('n2: the NHWC step vs the NCHW step from one saved state')
def check_nhwc_vs_nchw(tr, place):
    """One step of n1's program from its saved state, and one step of the
    same program built NCHW (without the fused flag, so the same
    parameter names) from the same state and batch, both op by op: the
    losses within TRAIN_LOSS_TOL, the updates of NHWC_PARAMS_COMPARED by
    t2's measure within TRAIN_UPDATE_TOL or RESNET_SPREAD_FACTOR x the
    NCHW step's own spread when its batch statistics are summed in fp64,
    whichever is larger (r2's rule: the bf16 step amplifies any
    reordering of fp32 sums)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    batch = image_batch(np.random.RandomState(SEED + 5), RESNET_BATCH)
    saved = tr.snapshot()
    # the captured step's pool and an eager step do not fit together
    tr.drop_graphs()
    # a reader of its own: the read op finds its reader by name
    nchw = ResNetTrainer(place, RESNET_BATCH, reader_name='resnet_nchw')
    if sorted(nchw.persistables) != sorted(tr.persistables):
        raise AssertionError('the NCHW and NHWC programs name their '
                             'persistables differently')
    eager = fluid.Executor(place)
    params = NHWC_PARAMS_COMPARED
    nhwc = _one_step(tr, saved, batch, params, eager)
    plain = _one_step(nchw, saved, batch, params, eager)
    stats_fn = nn_ops._bn_batch_stats
    nn_ops._bn_batch_stats = _bn_batch_stats_fp64
    try:
        reordered = _one_step(nchw, saved, batch, params, eager)
    finally:
        nn_ops._bn_batch_stats = stats_fn
    tr.restore(saved)
    nchw.drop_graphs()
    spread = _update_diffs(reordered, plain, params)
    got = _update_diffs(nhwc, plain, params)
    loss_diff = abs(nhwc[0] - plain[0])
    bound = {n: max(TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR * spread[n])
             for n in params}
    log('NHWC step vs NCHW step: loss %.6f vs %.6f (|diff| %.3e, tol %g; '
        'fp64-sum NCHW step %.6f, |diff| %.3e); update max diff / max '
        'update: %s; the NCHW step\'s spread under fp64 sums: %s (tol: the '
        'larger of %g and %g x that spread)'
        % (nhwc[0], plain[0], loss_diff, TRAIN_LOSS_TOL, reordered[0],
           abs(reordered[0] - plain[0]),
           ', '.join('%s %.3e' % kv for kv in got.items()),
           ', '.join('%s %.3e' % kv for kv in spread.items()),
           TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR))
    bad = [n for n in params if not got[n] <= bound[n]]
    if not np.isfinite(nhwc[0]) or loss_diff > TRAIN_LOSS_TOL or bad:
        raise AssertionError('the NHWC and NCHW steps disagree beyond the '
                             'stated tolerance (%s)' % bad)
    return dict(loss_diff=loss_diff, updates=got, spread=spread)


def first_reader_of(program, name):
    """(index, op) of the first op of the program's global block that
    reads `name`."""
    for i, op in enumerate(program.global_block().ops):
        if name in op.input_arg_names():
            return i, op
    raise AssertionError('no op reads %r' % name)


def check_nan_error(program, image, run_bad):
    """run_bad() must raise OpExecutionError for a NaN in `image`, naming
    the first op that reads it; any other outcome fails (nothing else is
    caught). Returns the message."""
    from paddle_tpu_torch.executor import OpExecutionError
    pos, op = first_reader_of(program, image)
    try:
        run_bad()
    except OpExecutionError as e:
        msg = str(e)
    else:
        raise AssertionError('FLAGS_check_nan_inf: a NaN in %r raised no '
                             'OpExecutionError' % image)
    want = 'op #%d %r' % (pos, op.type)
    log('a NaN pixel under FLAGS_check_nan_inf: %s' % msg.splitlines()[0])
    if 'NaN/Inf detected in output' not in msg or want not in msg:
        raise AssertionError('FLAGS_check_nan_inf named another op than '
                             '%s, the first reader of %r: %s'
                             % (want, image, msg))
    return msg


@phase('i2: FLAGS_check_nan_inf on the card (n1\'s program at batch %d)'
       % NAN_CHECK_BATCH)
def check_nan_inf_mode(tr, sync):
    """From one saved state: a captured step (warm-up, then the capture
    and its replay) and a step under FLAGS_check_nan_inf, which runs op
    by op (the capture count does not move) to the captured step's loss
    within NAN_CHECK_TOL; then a batch with one NaN pixel must raise
    OpExecutionError naming the first op that reads the image."""
    rng = np.random.RandomState(SEED + 7)
    batch = image_batch(rng, NAN_CHECK_BATCH)
    saved = tr.snapshot()
    tr.fresh_executor()
    _one_step(tr, saved, batch, ())
    captured = _one_step(tr, saved, batch, ())[0]
    before = tr.pe.jit_cache_stats()['compiled_segments']
    with flags_set({'FLAGS_check_nan_inf': True}):
        t0 = time.perf_counter()
        checked = _one_step(tr, saved, batch, ())[0]
        sync()
        checked_ms = (time.perf_counter() - t0) * 1e3
        after = tr.pe.jit_cache_stats()['compiled_segments']
        bad = [batch[0].copy(), batch[1]]
        hw = RESNET['image_hw']
        bad[0][NAN_CHECK_BATCH // 2, 1, hw // 2, hw // 3] = float('nan')
        try:
            msg = check_nan_error(tr.main, tr.image.name,
                                  lambda: _one_step(tr, saved, bad, ()))
        finally:
            tr.reader.reset()
    tr.restore(saved)
    tr.drop_graphs()
    diff = abs(checked - captured)
    log('batch %d: captured step loss %.6f, checked step (op by op, every '
        'output scanned) %.6f, |diff| %.3e (tol %g), %.1f ms; captured '
        'segments %d before the checked step, %d after'
        % (NAN_CHECK_BATCH, captured, checked, diff, NAN_CHECK_TOL,
           checked_ms, before, after))
    if after != before or before < 1:
        raise AssertionError('the checked step was captured (%d -> %d)'
                             % (before, after))
    if not np.isfinite(checked) or diff > NAN_CHECK_TOL:
        raise AssertionError('the checked step\'s loss is not the captured '
                             'step\'s')
    return dict(loss_diff=diff, checked_ms=checked_ms, message=msg)


# -- (s1): the space-to-depth stem ----------------------------------------------

def s2d_filter(w):
    """[O, C, 7, 7] -> [O, 4C, 4, 4]: the space-to-depth stem's filter,
    w'[o, c*4+di*2+dj, m, n] = w[o, c, 2m+di-1, 2n+dj-1], zero outside
    the 7x7 support."""
    import torch
    O, C = w.shape[:2]
    w4 = w.new_zeros((O, C * 4, 4, 4))
    chans = torch.arange(C, device=w.device) * 4
    for di in range(2):
        for dj in range(2):
            for m in range(4):
                for n in range(4):
                    u, v = 2 * m + di - 1, 2 * n + dj - 1
                    if 0 <= u < 7 and 0 <= v < 7:
                        w4[:, chans + di * 2 + dj, m, n] = w[:, :, u, v]
    return w4


def s2d_stem_conv(x, w4):
    """The retiled stem through the port on x's device: models.resnet's
    space_to_depth (reshape, transpose, reshape, pad) and a 4x4 conv2d
    with filter w4, fp32."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    _, C, H, W = x.shape
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        xv = fluid.layers.data(name='x', shape=[C, H, W], dtype='float32')
        out = fluid.layers.conv2d(
            resnet.space_to_depth(xv), num_filters=w4.shape[0],
            filter_size=4, bias_attr=False,
            param_attr=fluid.ParamAttr(name='stem4.w'))
    place = fluid.CPUPlace() if x.device.type == 'cpu' \
        else fluid.CUDAPlace(x.device.index or 0)
    scope = fluid.Scope()
    scope.set_var('stem4.w', w4)
    return fluid.Executor(place).run(prog, feed={'x': x}, fetch_list=[out],
                                     scope=scope, return_numpy=False)[0]


@phase('s1: the space-to-depth stem (exactness; ResNet-50 with it, NCHW, '
       'K6)')
def s2d_steps(place, sync):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import conv_bn as k6
    dev = place.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hw = RESNET['image_hw']
    x = torch.rand((S2D_BATCH, 3, hw, hw), generator=gen, device=dev)
    w = torch.randn((64, 3, 7, 7), generator=gen, device=dev) * 0.1
    want = F.conv2d(x, w, stride=2, padding=3)
    got = s2d_stem_conv(x, s2d_filter(w))
    err = (got - want).abs().max().item()
    log('the retiled 4x4 stem vs the 7x7/2 conv, [%d, 3, %d, %d] fp32: max '
        '|diff| %.3e (tol %g, relative to max |y| %.3f)'
        % (S2D_BATCH, hw, hw, err, S2D_TOL, want.abs().max().item()))
    if tuple(got.shape) != tuple(want.shape) or \
            not err <= S2D_TOL * max(1.0, want.abs().max().item()):
        raise AssertionError('the space-to-depth stem is not the 7x7 stem')
    # r1's configuration: NCHW, every conv + BN one conv2d_bn, whose 1x1
    # path runs K6 (the flag is read when the program is built and when
    # the op runs)
    with flags_set({'FLAGS_use_pallas_fused_ops': True}):
        tr = ResNetTrainer(place, RESNET_BATCH, space_to_depth=True)
        path_shapes = k6_path_shapes(tr.main, RESNET_BATCH)
        per_step = sum(path_shapes.values())
        ops = [op.type for op in tr.main.global_block().ops]
        batch = image_batch(np.random.RandomState(0), RESNET_BATCH, dev)

        def provider():
            while True:
                yield batch
        tr.feed(provider)
        losses = [tr.step() for _ in range(WARMUP_STEPS)]
        sync()
        k6.reset_launches()
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(S2D_TIMED_STEPS)]
        sync()
        step_ms = (time.perf_counter() - t0) / S2D_TIMED_STEPS * 1e3
    launches = k6.matmul_bn_stats_kernel.launches
    log('s2d program: %d conv2d_bn, %d pad; losses: %s; %d timed steps, '
        '%.3f ms per step, %.1f images/s; K6 launches %d (want %d x %d)'
        % (ops.count('conv2d_bn'), ops.count('pad'),
           ', '.join('%.6f' % v for v in losses), S2D_TIMED_STEPS, step_ms,
           RESNET_BATCH / step_ms * 1e3, launches, per_step,
           S2D_TIMED_STEPS))
    tr.drop_graphs()
    if not all(np.isfinite(losses)):
        raise AssertionError('an s2d loss is not finite: %r' % losses)
    if ops.count('pad') != 1 or per_step != 36 or \
            launches != per_step * S2D_TIMED_STEPS:
        raise AssertionError('K6 launched %d times in %d s2d steps, want 36 '
                             'a step' % (launches, S2D_TIMED_STEPS))
    return dict(stem_err=err, losses=losses, step_ms=step_ms,
                launches=launches)


# -- (i1): bench_inference's ResNet-50 leg ----------------------------------------

def inference_model(model_dir, place, batch, hw, classes, depth, seed):
    """bench_inference's ResNet program (resnet_imagenet(is_test=True,
    nhwc=True)), initialised on `place`, saved with save_inference_model
    into model_dir. So that the fold is not the identity, each batch
    norm's affine is drawn from `seed`, and its running statistics are
    the batch statistics it sees in one training-mode forward over a
    batch drawn from `seed` (as training would leave them: the
    activations stay normalised, and the softmax is not saturated).
    Returns the input name."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet

    def build(is_test):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            image = fluid.layers.data(name='image', shape=[3, hw, hw],
                                      dtype='float32')
            pred = resnet.resnet_imagenet(image, class_dim=classes,
                                          depth=depth, is_test=is_test,
                                          nhwc=True)
        return main, startup, pred
    main, startup, pred = build(True)
    calib = build(False)[0]
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    bns = [op for op in main.global_block().ops if op.type == 'batch_norm']
    for op in bns:
        c = main.global_block().var(op.single_input('Scale')).shape[0]
        fluid.io.load_numpy_params(scope, {
            op.single_input('Scale'): (1.0 + 0.1 * rng.randn(c)).astype(
                'float32'),
            op.single_input('Bias'): (0.1 * rng.randn(c)).astype('float32')},
            place, program=main)
    # the same network in training mode (the same names): each batch
    # norm's SavedMean / SavedVariance
    saved = [op.single_output(s) for op in calib.global_block().ops
             if op.type == 'batch_norm'
             for s in ('SavedMean', 'SavedVariance')]
    stats = exe.run(calib, feed={'image': rng.rand(batch, 3, hw, hw)
                                 .astype('float32')},
                    fetch_list=saved, scope=scope, use_program_cache=False)
    for op, mean, var in zip(bns, stats[0::2], stats[1::2]):
        fluid.io.load_numpy_params(scope, {op.single_input('Mean'): mean,
                                           op.single_input('Variance'): var},
                                   place, program=main)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ['image'], [pred], exe,
                                      main_program=main)
    return 'image'


def op_counts(predictor):
    types = [op.type for op in predictor._program.global_block().ops]
    return {t: types.count(t) for t in ('batch_norm', 'elementwise_add',
                                        'conv2d')}


def check_fold(folded, plain, img, runs=3):
    """The folded predictor against the ir_optim=False one on `img`:
    batch_norm ops gone, each replaced by one elementwise_add, outputs
    within INFER_TOL; a clone of the folded one gives its bits. Each
    predictor runs `runs` times (on the card: warm-up, capture, replay)
    and its last output is compared. Returns (max |diff|, op counts)."""
    cf, cp = op_counts(folded), op_counts(plain)
    outs = {}
    clone = folded.clone()
    for name, p in (('folded', folded), ('plain', plain), ('clone', clone)):
        for _ in range(runs):
            outs[name] = p.run([img])[0]
    err = float(np.abs(outs['folded'] - outs['plain']).max())
    same = bool(np.array_equal(outs['clone'], outs['folded']))
    log('ir_optim: batch_norm %d -> %d, elementwise_add %d -> %d, conv2d %d '
        '-> %d; folded vs unfolded output max |diff| %.3e (tol %g; outputs '
        'in [%.3e, %.3e]); the clone gives the same bits: %s'
        % (cp['batch_norm'], cf['batch_norm'], cp['elementwise_add'],
           cf['elementwise_add'], cp['conv2d'], cf['conv2d'], err,
           INFER_TOL, outs['plain'].min(), outs['plain'].max(), same))
    if not (cf['batch_norm'] == 0 and cp['batch_norm'] > 0 and
            cf['elementwise_add'] == cp['elementwise_add'] +
            cp['batch_norm'] and cf['conv2d'] == cp['conv2d']):
        raise AssertionError('the fold did not replace every batch_norm by '
                             'one elementwise_add: %r vs %r' % (cf, cp))
    if not np.isfinite(outs['folded']).all() or err > INFER_TOL or not same:
        raise AssertionError('the folded predictor disagrees with the '
                             'unfolded one or with its clone')
    return err, cf, cp


def _latency_ms(fn, iters):
    """bench.py's _latency_stats: p50, p99 and mean ms of fn()."""
    lats = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        lats.append(time.perf_counter() - t0)
    lats.sort()
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    return p50 * 1e3, p99 * 1e3, sum(lats) / len(lats) * 1e3


def serving_throughput(predictor, feed, batch, iters, sync):
    """bench.py's serving_throughput (:313-342): predictor.run(feed,
    return_numpy=False) on a device-resident feed, synchronised once,
    N/2N differenced; N doubles until the differenced work is more than
    half the shorter run. Returns (images/s, ms per batch) or (None,
    None)."""
    def _loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            predictor.run(feed, return_numpy=False)
        sync()
        return time.perf_counter() - t0
    _loop(3)
    for _ in range(4):
        w1, w2 = _loop(iters), _loop(2 * iters)
        d = w2 - w1
        if d > 0.5 * w1:
            return batch * iters / d, d / iters * 1e3
        iters *= 2
    return None, None


@phase('i1: bench_inference\'s ResNet-50 leg (batch %d, 224 px, NHWC) '
       'through AnalysisPredictor\'s batch-norm fold' % INFER_BATCH)
def inference_leg(place, sync):
    import torch
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
    hw = RESNET['image_hw']
    build_root = os.path.join(HERE, 'build')
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as model_dir:
        name = inference_model(model_dir, place, INFER_BATCH, hw,
                               RESNET['class_dim'], RESNET['depth'], SEED)
        folded = AnalysisPredictor(AnalysisConfig(model_dir, place=place))
        plain = AnalysisPredictor(AnalysisConfig(model_dir, place=place)
                                  .switch_ir_optim(False))
    img = np.random.RandomState(SEED + 9).rand(
        INFER_BATCH, 3, hw, hw).astype('float32')
    err, cf, cp = check_fold(folded, plain, img)
    del plain
    p50, p99, mean = _latency_ms(lambda: folded.run([img]), INFER_ITERS)
    feed = {name: torch.from_numpy(img).to(place.device)}
    thr, ms = serving_throughput(folded, feed, INFER_BATCH, INFER_ITERS,
                                 sync)
    log('ResNet-50 inference, batch %d, fp32, folded: host feed p50 %.3f ms, '
        'p99 %.3f ms, mean %.3f ms (%.1f images/s); device-resident feed '
        '%s images/s (%s ms a batch, N/2N differenced)'
        % (INFER_BATCH, p50, p99, mean, INFER_BATCH / mean * 1e3,
           'not measured' if thr is None else '%.1f' % thr,
           'not measured' if ms is None else '%.3f' % ms))
    if thr is None:
        raise AssertionError('the device throughput was not measured: the '
                             'differenced work never dominated')
    return dict(err=err, p50=p50, p99=p99, images_s=thr, batch_ms=ms,
                folded=cf, plain=cp)


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
        # the peak covers the eager warm-up, the capture and the replays
        torch.cuda.reset_peak_memory_stats()
        losses = [tr.step(sync_checked=True)]
        losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
        sync()
        for c in counters.values():
            c.launches = 0
        fa.FlashAttention.plain_cuda_calls = 0
        fa.take_extra_flops()
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(TIMED_STEPS)]
        sync()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        require_no_plain(fa, 'l1')
        extra_per_step = fa.take_extra_flops() / TIMED_STEPS
        check_replay_launches('l1', tr.step, sync)
        fa.take_extra_flops()  # the checked step's notes
        tr.reader.reset()
    peak_gb = peak_memory_gb()
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
    from paddle_tpu_torch.kernels import flash_attention as fa
    cfg = tr.cfg
    rng = np.random.RandomState(SEED + 5)
    toks = rng.randint(0, cfg.vocab, size=(tr.batch, cfg.max_len,
                                           1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    # the three steps below run eagerly (each its prepared program's
    # first run), with no captured pool held
    tr.drop_graphs()
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
                fa.FlashAttention.plain_cuda_calls = 0
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
    # each kernel arm's capture, then its replayed steps in turns: A, B,
    # B, A
    for arms in (LC_ARMS, (None, None)):
        with flash_arms(*arms):
            _timed_step(tr, saved, batch, sync)
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


# -- (x1)-(x4): the Executor's captured path ----------------------------------

# x1 and x4: WARMUP_STEPS steps (the eager warm-up, then the capture) and
# then X_TIMED_STEPS replays
X_TIMED_STEPS = 3
# x4: the policies, and K1's launches per block and step under each
REMAT_POLICIES = (None, 'nothing', 'dots')
# x4's dropout check: the width of its input and the bound on dL/dw
# against the forward's masked batch mean (fp32 sums in two orders)
REMAT_DROPOUT_WIDTH = 1024
REMAT_DROPOUT_RTOL = 1e-5
# x4's seeded dropout: the op's own seed attr
DROPOUT_OP_SEED = 7
# x5: the reader's second, smaller batch on ResNet-50's captured executor
RESNET_SECOND_BATCH = 64


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode('error') for the body: any op that
    synchronises with the host raises. A device op must not: it would
    fail inside a CUDA graph capture."""
    import torch
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def device_segments(program):
    """The number of device segments the Executor splits the program's
    global block into."""
    from paddle_tpu_torch.executor import PreparedProgram, _DeviceSegment
    return sum(isinstance(s, _DeviceSegment)
               for s in PreparedProgram(program, 0, [], []).steps)


def _x_run(tr, saved, batches, step, sync, names, label, stats=None):
    """From the saved state, feed `batches` in turn and run WARMUP_STEPS +
    X_TIMED_STEPS steps of step(), then one more under torch.profiler.
    Returns the losses of the first ones, {name: value after them}, the
    timed ms per step, the peak device memory, the profiled step's
    device ms and busy share and, with `stats` (an executor's
    jit_cache_stats), compiled_segments after the warm-up steps and at
    the end of the timed ones."""
    import itertools
    import torch
    tr.restore(saved)
    tr.feed(lambda: itertools.cycle(batches))
    sync()
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(WARMUP_STEPS)]
    sync()
    mid = stats()['compiled_segments'] if stats else None
    t0 = time.perf_counter()
    losses += [step() for _ in range(X_TIMED_STEPS)]
    sync()
    ms = (time.perf_counter() - t0) / X_TIMED_STEPS * 1e3
    end = stats()['compiled_segments'] if stats else None
    peak_gb = peak_memory_gb()
    device_ms, busy = _profile_steps(tr, ms, sync, label, steps=1,
                                     step=step)
    tr.reader.reset()
    state = {n: tr.scope.find_var(n).clone() for n in names}
    return dict(losses=losses, state=state, ms=ms, compiled=(mid, end),
                peak_gb=peak_gb, device_ms=device_ms, busy=busy)


def _fmt_busy(busy):
    return 'not measured' if busy is None else '%.1f%%' % (100 * busy)


def check_x1(label, eager, captured, saved, params, n_segments, form,
             grads=None, eager2=None):
    """Hold the captured run to the eager one: every loss within
    TRAIN_LOSS_TOL, each parameter's update (value after the steps minus
    saved) within TRAIN_UPDATE_TOL by t2's measure ('max'), by a2's
    gradient-weighted measure ('weighted', grads {param: g}) or by r2's
    rule ('spread': within the larger of TRAIN_UPDATE_TOL and
    RESNET_SPREAD_FACTOR x a second eager run's own spread); the
    capture count equal to the program's device segments after the
    warm-up steps and unchanged over the timed ones. Returns (worst loss
    difference, {param: update measure}, bits equal)."""
    loss_diff = max(abs(a - b) for a, b in zip(captured['losses'],
                                               eager['losses']))

    def updates(run):
        return {n: (run['state'][n] - saved[n]).float() for n in params}
    ue, uc = updates(eager), updates(captured)
    if form == 'weighted':
        got = _first_order_diffs(uc, ue, grads, params)
        bound = {n: TRAIN_UPDATE_TOL for n in params}
    else:
        got = _update_diffs((0, uc), (0, ue), params)
        bound = {n: TRAIN_UPDATE_TOL for n in params}
        if form == 'spread':
            spread = _update_diffs((0, updates(eager2)), (0, ue), params)
            bound = {n: max(TRAIN_UPDATE_TOL,
                            RESNET_SPREAD_FACTOR * spread[n])
                     for n in params}
    bits = (captured['losses'] == eager['losses'] and
            all(bool((captured['state'][n] == eager['state'][n]).all())
                for n in eager['state']))
    log('%s captured vs eager: loss max |diff| %.3e (tol %g); updates: %s '
        '(%s); the same bits: %s; captured segments %s after the warm-up '
        'and the timed steps (the program has %d)'
        % (label, loss_diff, TRAIN_LOSS_TOL,
           ', '.join('%s %.3e (tol %.3e)' % (n, got[n], bound[n])
                     for n in params),
           {'max': 'max diff / max update', 'weighted':
            'sum |g|·|diff| / sum |g|·|update|',
            'spread': 'max diff / max update'}[form], bits,
           captured['compiled'], n_segments))
    if not all(np.isfinite(captured['losses'])) or \
            loss_diff > TRAIN_LOSS_TOL or \
            any(got[n] > bound[n] for n in params):
        raise AssertionError('%s: the captured steps disagree with the eager '
                             'steps beyond the stated tolerance' % label)
    if captured['compiled'] != (n_segments, n_segments):
        raise AssertionError('%s: %r segments captured after the warm-up and '
                             'the timed steps, want %d both times'
                             % (label, captured['compiled'], n_segments))
    return loss_diff, got, bits


@phase('x1: captured steps vs eager steps from one saved state')
def check_captured_steps(tr, label, params, form, place, sync):
    """WARMUP_STEPS + X_TIMED_STEPS steps of `tr`'s program through a new
    ParallelExecutor (eager, captured, then replayed) and the same steps
    op by op (use_program_cache=False), from one saved state on the same
    batches: check_x1. Returns the comparison and both runs' ms per
    timed step and busy shares."""
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 11)
    batches = [tr.batch_of(rng) for _ in range(WARMUP_STEPS +
                                               X_TIMED_STEPS)]
    saved = tr.snapshot()
    names = list(params)
    m1 = {}
    if form == 'weighted':
        for p in params:
            m1[p], = [n for n in tr.persistables
                      if n.startswith(p + '_moment1_')]
        names += list(m1.values())
    tr.fresh_executor()
    captured = _x_run(tr, saved, batches, tr.step, sync, names,
                      '%s captured' % label, tr.pe.jit_cache_stats)
    # the captured run first, then its pool dropped: a ResNet-50 pool
    # and an eager step do not fit together, and a pool captured after
    # eager runs sits beside the blocks they leave pinned, near the
    # card's size
    tr.drop_graphs()
    eager_exe = fluid.Executor(place)

    def eager_step():
        return float(eager_exe.run(tr.main, fetch_list=[tr.avg_cost.name],
                                   scope=tr.scope,
                                   use_program_cache=False)[0])
    eager = _x_run(tr, saved, batches, eager_step, sync, names,
                   '%s op by op' % label)
    eager2 = (_x_run(tr, saved, batches, eager_step, sync, names,
                     '%s op by op, again' % label)
              if form == 'spread' else None)
    tr.restore(saved)
    grads = ({p: eager['state'][m1[p]].float() for p in params}
             if form == 'weighted' else None)
    out = check_x1(label, eager, captured, saved, params,
                   device_segments(tr.main), form, grads, eager2)
    log('%s: op by op %.3f ms a step (%d timed steps), device %s ms, busy '
        '%s, peak %.2f GB; captured %.3f ms, device %s ms, busy %s, peak '
        '%.2f GB' % (label, eager['ms'], X_TIMED_STEPS,
                     _fmt_ms(eager['device_ms'] or None),
                     _fmt_busy(eager['busy']), eager['peak_gb'],
                     captured['ms'], _fmt_ms(captured['device_ms'] or None),
                     _fmt_busy(captured['busy']), captured['peak_gb']))
    return dict(loss_diff=out[0], updates=out[1], bits=out[2],
                eager_ms=eager['ms'], captured_ms=captured['ms'],
                eager_busy=eager['busy'], captured_busy=captured['busy'])


def check_decode_stats(stats):
    """After a generation loop on a new decode predictor: the JAX
    package's own numbers (tests/test_serving.py:197-200)."""
    want = {'prepared_programs': 2, 'compiled_segments': 2,
            'segment_misses': 2}
    got = {k: stats[k] for k in want}
    if got != want or stats['segment_hits'] < 1:
        raise AssertionError('decode predictor stats %r, want %r and '
                             'segment_hits >= 1' % (stats, want))


@phase('x2: the serving path captured vs eager; the decode predictor\'s '
       'stats')
def check_serving_capture(dec, prompts, streams, sync, captured_ms):
    """The prefill and decode programs' first (eager) runs under
    no_host_sync, on feeds already on the card; a generation loop's
    jit_cache_stats (check_decode_stats); the engine's streams with
    every op run eagerly equal c3's captured streams exactly; the eager
    prefill and decode step by the host clock beside f's captured ones."""
    import functools
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import Executor
    fresh = dec.clone()
    dev = fresh.device
    tokens, pos, slots = fresh._pad_prompts([prompts[0]], [0])
    feeds = [({'prefill_tokens': torch.from_numpy(tokens).to(dev),
               'prefill_pos': torch.from_numpy(pos).to(dev),
               'prefill_slots': torch.from_numpy(slots).to(dev)},
              fresh._pair.prefill_program, fresh._pair.prefill_fetches),
             ({'decode_tokens': torch.ones((fresh.slots, 1, 1),
                                           dtype=torch.int64, device=dev),
               'decode_step_idx': torch.full((fresh.slots,), len(prompts[0]),
                                             dtype=torch.int32, device=dev)},
              fresh._pair.decode_program, fresh._pair.decode_fetches)]
    sync()
    with no_host_sync():
        for feed, program, fetches in feeds:
            fresh._exe.run(program, feed=feed, fetch_list=fetches,
                           scope=fresh._scope, return_numpy=False)
    del fresh
    gen = dec.clone()
    for p in prompts[:2]:
        gen.generate(p, 8)
    stats = gen.jit_cache_stats()
    log('decode predictor after two generations: %s' % json.dumps(stats))
    check_decode_stats(stats)
    del gen
    eager = dec.clone()
    eager._exe.run = functools.partial(Executor.run, eager._exe,
                                       use_program_cache=False)
    with fluid.serving.LMServer(eager) as srv:
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts]
        eager_streams = [srv.result(h, timeout=600) for h in handles]
    differ = [i for i, (a, b) in enumerate(zip(streams, eager_streams))
              if a != b]
    log('engine streams captured vs eager: %d of %d equal'
        % (len(prompts) - len(differ), len(prompts)))
    if differ:
        raise AssertionError('requests %s: the captured engine\'s stream '
                             'differs from the eager engine\'s' % differ)
    prefill_ms, step_ms = _time_path(eager, prompts, sync)
    _profile_path(eager, prompts, {'prefill': prefill_ms,
                                   'decode_step': step_ms}, sync,
                  'op by op ')
    log('op by op: prefill %.3f ms, decode step %.3f ms; captured (f): '
        'prefill %.3f ms, decode step %.3f ms'
        % (prefill_ms, step_ms, captured_ms['prefill'],
           captured_ms['decode_step']))
    return dict(stats=stats, eager_prefill_ms=prefill_ms,
                eager_step_ms=step_ms)


def check_arm_launches(kvmajor, split, layers):
    """One step each: K2 `layers` times under kvmajor and never under
    split, K3a and K3b `layers` times each under split and never under
    kvmajor."""
    k2, k3a, k3b = (KERNELS[k][0] for k in ('k2', 'k3a', 'k3b'))
    want_kv = {k2: layers, k3a: 0, k3b: 0}
    want_split = {k2: 0, k3a: layers, k3b: layers}
    if {k: kvmajor[k] for k in want_kv} != want_kv or \
            {k: split[k] for k in want_split} != want_split:
        raise AssertionError('arm launches kvmajor %r, split %r; want %r and '
                             '%r' % (kvmajor, split, want_kv, want_split))


def check_replaced_weight(captured, eager, before):
    """The loss of the captured step after Scope.set_var replaced a
    weight is the eager step's with the new weight (within
    TRAIN_LOSS_TOL) and nearer to it than to the step with the old
    weight: the graph read the new one."""
    if not abs(captured - eager) <= TRAIN_LOSS_TOL or \
            not abs(captured - eager) < abs(captured - before):
        raise AssertionError('after Scope.set_var: captured loss %.6f, eager '
                             'with the new weight %.6f, with the old %.6f'
                             % (captured, eager, before))


@phase('x3: the cache key (the flash arms), a weight replaced after the '
       'capture, a fetch kept')
def check_cache_key(tr, counters, place, sync):
    """On a new ParallelExecutor over the flagship LM's program: a step
    under PADDLE_FLASH_BWD=kvmajor and then under split, each the third
    run of its prepared program (replayed): K2 in the first, K3a + K3b in
    the second, two prepared programs (check_arm_launches). Then a
    weight replaced with Scope.set_var after the capture: the next
    (replayed) step equals an eager step with the new weight
    (check_replaced_weight). Then a fetch returned with
    return_numpy=False is the same after the next run."""
    import torch
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 12)
    batch = tr.batch_of(rng)
    saved = tr.snapshot()
    pe = fluid.ParallelExecutor(use_cuda=True, loss_name=tr.avg_cost.name,
                                main_program=tr.main, scope=tr.scope)
    loss_name = tr.avg_cost.name

    def replayed_step(fetches=(loss_name,), return_numpy=True):
        out = None
        for _ in range(3):         # warm-up, capture, replay
            tr.restore(saved)
            for c in counters.values():
                c.launches = 0
            out = pe.run(fetch_list=list(fetches),
                         return_numpy=return_numpy)
        return out

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    launches = {}
    for arm in ('kvmajor', 'split'):
        with flash_arms(None, arm):
            replayed_step()
            launches[arm] = {n: c.launches for n, c in counters.items()}
    log('one replayed step under kvmajor: %s; under split: %s; prepared '
        'programs %d' % (json.dumps(launches['kvmajor']),
                         json.dumps(launches['split']),
                         pe.jit_cache_stats()['prepared_programs']))
    check_arm_launches(launches['kvmajor'], launches['split'],
                       tr.cfg.layers)
    if pe.jit_cache_stats()['prepared_programs'] != 2:
        raise AssertionError('want a prepared program for each arm, got %r'
                             % pe.jit_cache_stats())
    name = PARAMS_COMPARED[0]
    with flash_arms(None, 'split'):
        before = float(replayed_step()[0])
        new_w = saved[name] * 0.5
        tr.restore(saved)
        tr.scope.set_var(name, new_w.clone())
        captured = float(pe.run(fetch_list=[loss_name])[0])
        tr.restore(saved)
        tr.scope.set_var(name, new_w.clone())
        eager = float(fluid.Executor(place).run(
            tr.main, fetch_list=[loss_name], scope=tr.scope,
            use_program_cache=False)[0])
    log('after Scope.set_var(%r, w / 2): captured step loss %.6f, eager '
        'step %.6f, the step with the old weight %.6f'
        % (name, captured, eager, before))
    check_replaced_weight(captured, eager, before)
    tr.scope.set_var(name, saved[name].clone())
    out = replayed_step((loss_name, name), return_numpy=False)
    kept = [t.clone() for t in out]
    pe.run(fetch_list=[loss_name, name], return_numpy=False)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(out, kept)):
        raise AssertionError('a fetch returned with return_numpy=False '
                             'changed in the next run')
    log('fetches returned with return_numpy=False (the loss and %s) are '
        'unchanged by the next run' % name)
    tr.reader.reset()
    tr.restore(saved)
    return launches


def check_remat(runs, layers):
    """x4's bounds: under each policy K1 launches layers (None) or 2 x
    layers (a remat scope runs its forward again in the backward) per
    step and K2 layers; 'nothing' and 'dots' hold every loss within
    TRAIN_LOSS_TOL and each compared update within TRAIN_UPDATE_TOL (t2's
    measure) of remat=None's."""
    k1, k2 = KERNELS['fwd'][0], KERNELS['k2'][0]
    base = runs[None]
    for policy, run in runs.items():
        want = layers * (1 if policy is None else 2)
        if run['per_step'][k1] != want or run['per_step'][k2] != layers:
            raise AssertionError('remat=%r: K1 %r and K2 %r launches per '
                                 'step, want %d and %d'
                                 % (policy, run['per_step'][k1],
                                    run['per_step'][k2], want, layers))
        if policy is None:
            continue
        loss_diff = max(abs(a - b) for a, b in zip(run['losses'],
                                                   base['losses']))
        upd = _update_diffs((0, run['updates']), (0, base['updates']),
                            PARAMS_COMPARED)
        run['loss_diff'], run['update_diffs'] = loss_diff, upd
        if not all(np.isfinite(run['losses'])) or \
                loss_diff > TRAIN_LOSS_TOL or \
                any(v > TRAIN_UPDATE_TOL for v in upd.values()):
            raise AssertionError('remat=%r vs None: loss |diff| %.3e, '
                                 'updates %r beyond the stated tolerance'
                                 % (policy, loss_diff, upd))


def remat_dropout_program(fluid):
    """test_recompute.py:52's program: a dropout and a 1-output fc in
    one remat scope, SGD(0): (the program, its startup, the dropout's
    output h, the fc's weight grad name)."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[REMAT_DROPOUT_WIDTH],
                              dtype='float32')

        def body(xv):
            h = fluid.layers.dropout(xv, dropout_prob=0.5)
            return [h, fluid.layers.fc(input=h, size=1, name='w',
                                       bias_attr=False)]
        h, y = fluid.layers.recompute(body, x)
        fluid.optimizer.SGD(0.0).minimize(fluid.layers.mean(y))
    return prog, startup, h, 'w.w_0@GRAD'


def check_remat_dropout(fluid, place, runs=4):
    """remat_dropout_program run `runs` times through one executor (on
    the card: the warm-up, the capture, then replays): in every run dL/dw,
    which the recompute computes, is the batch mean of h, which the
    forward drew (the same mask in both, within REMAT_DROPOUT_RTOL), and
    the mask is new in every run. Returns the masks' kept shares."""
    prog, startup, h, grad = remat_dropout_program(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(SEED).rand(
        64, REMAT_DROPOUT_WIDTH).astype('float32') + 0.5
    shares, masks = [], []
    for _ in range(runs):
        hv, g = exe.run(prog, feed={'x': xv}, fetch_list=[h, grad],
                        scope=scope)
        np.testing.assert_allclose(g.ravel(), hv.mean(0),
                                   rtol=REMAT_DROPOUT_RTOL)
        masks.append(hv != 0)
        shares.append(float(masks[-1].mean()))
    if not all(0.4 < k < 0.6 for k in shares) or \
            any((a == b).all() for a, b in zip(masks, masks[1:])):
        raise AssertionError('dropout in the remat scope: kept shares %r, '
                             'or a mask repeated between runs' % shares)
    return shares, exe.jit_cache_stats()


def check_seeded_dropout(fluid, place, runs=4):
    """A dropout with its own seed attr (DROPOUT_OP_SEED) run `runs`
    times through one executor (on the card: the warm-up, the capture,
    then replays) and once op by op: the seed promises the same mask
    every time. Returns the kept share and the executor's stats."""
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        x = fluid.layers.data(name='x', shape=[REMAT_DROPOUT_WIDTH],
                              dtype='float32')
        h = fluid.layers.dropout(x, dropout_prob=0.5, seed=DROPOUT_OP_SEED)
    feed = {'x': np.ones((64, REMAT_DROPOUT_WIDTH), 'float32')}
    exe = fluid.Executor(place)
    masks = [exe.run(prog, feed=feed, fetch_list=[h])[0] != 0
             for _ in range(runs)]
    masks.append(fluid.Executor(place).run(
        prog, feed=feed, fetch_list=[h], use_program_cache=False)[0] != 0)
    share = float(masks[0].mean())
    if not 0.4 < share < 0.6 or \
            any(not np.array_equal(m, masks[0]) for m in masks[1:]):
        raise AssertionError('a dropout with seed %d: kept share %.4f, or '
                             'not the same mask in each of %d runs and op '
                             'by op' % (DROPOUT_OP_SEED, share, runs))
    return share, exe.jit_cache_stats()


@phase('x4: the flagship LM with remat None, nothing and dots (captured)')
def remat_steps(place, counters, sync):
    """The flagship LM (AMP Momentum, batch TRAIN_BATCH, py_reader) built
    with TransformerConfig(remat=policy) for each of REMAT_POLICIES, from
    the same initial weights and batches: WARMUP_STEPS + X_TIMED_STEPS
    steps each through ParallelExecutor (captured), the launches per
    timed step, the timed ms per step and the peak device memory of all
    of its steps; check_remat. Each trainer is freed before the next."""
    import gc
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import TransformerConfig
    shares, stats = check_remat_dropout(fluid, place)
    log('dropout in a remat scope, 4 runs (eager, captured, replayed): the '
        'recompute\'s grad is the forward\'s masked batch mean in every '
        'run (rtol %g), kept shares %s, executor stats %s'
        % (REMAT_DROPOUT_RTOL, ', '.join('%.4f' % k for k in shares),
           json.dumps(stats)))
    if stats['compiled_segments'] != 1:
        raise AssertionError('the dropout program was not captured: %r'
                             % stats)
    share, stats = check_seeded_dropout(fluid, place)
    log('dropout with seed %d, 4 runs (eager, captured, replayed) and op '
        'by op: the same mask each time, kept share %.4f, executor stats %s'
        % (DROPOUT_OP_SEED, share, json.dumps(stats)))
    if stats['compiled_segments'] != 1:
        raise AssertionError('the seeded dropout program was not captured: '
                             '%r' % stats)
    rng = np.random.RandomState(SEED + 13)
    runs, init, batches = {}, None, None
    for policy in REMAT_POLICIES:
        tr = Trainer(TransformerConfig(remat=policy, **MODEL), place,
                     TRAIN_BATCH, HEAD_CHUNK, 'remat_reader')
        params = [v.name for v in tr.main.list_vars()
                  if getattr(v, 'trainable', False) and v.persistable]
        if init is None:
            init = {n: tr.scope.find_var(n).clone() for n in params}
            batches = [tr.batch_of(rng) for _ in range(WARMUP_STEPS +
                                                       X_TIMED_STEPS)]
        for n in params:
            tr.scope.find_var(n).copy_(init[n])
        saved = {n: init[n] for n in PARAMS_COMPARED}
        tr.feed(lambda: iter(batches))
        gc.collect()
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        losses = [tr.step() for _ in range(WARMUP_STEPS)]
        sync()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(X_TIMED_STEPS)]
        sync()
        ms = (time.perf_counter() - t0) / X_TIMED_STEPS * 1e3
        peak_gb = peak_memory_gb()
        per_step = {n: c.launches / X_TIMED_STEPS
                    for n, c in counters.items()}
        updates = {n: (tr.scope.find_var(n) - saved[n]).float()
                   for n in PARAMS_COMPARED}
        n_remat = sum(op.type == 'remat_block'
                      for op in tr.main.global_block().ops)
        log('remat=%r: %d remat scopes, %d ops; losses %s; %.3f ms a step, '
            'peak device memory %.2f GB; launches per step %s'
            % (policy, n_remat, len(tr.main.global_block().ops),
               ', '.join('%.6f' % x for x in losses), ms, peak_gb,
               json.dumps(per_step)))
        runs[policy] = dict(losses=losses, ms=ms, peak_gb=peak_gb,
                            per_step=per_step, updates=updates)
        tr.reader.reset()
        del tr, saved
        gc.collect()
        torch.cuda.empty_cache()
    check_remat(runs, MODEL['layers'])
    for policy in REMAT_POLICIES[1:]:
        log('remat=%r vs None: loss max |diff| %.3e (tol %g), updates %s '
            '(tol %g)' % (policy, runs[policy]['loss_diff'], TRAIN_LOSS_TOL,
                          ', '.join('%s %.3e' % kv for kv in
                                    runs[policy]['update_diffs'].items()),
                          TRAIN_UPDATE_TOL))
    peaks = [runs[p]['peak_gb'] for p in REMAT_POLICIES]
    log('peak device memory None %.2f, nothing %.2f, dots %.2f GB: %s'
        % (peaks[0], peaks[1], peaks[2],
           'nothing < dots < None, as expected'
           if peaks[1] < peaks[2] < peaks[0] else
           'NOT in the expected order nothing < dots < None'))
    return runs


def check_second_shape_runs(runs, params, n_segments, stats0, stats,
                            reserved_gb):
    """x5's bounds over its runs ({label: (loss, {param: update})}): the
    second batch's replay ('small replayed') and its capture run
    ('small captured') within TRAIN_LOSS_TOL and TRAIN_UPDATE_TOL (t2's
    measure) of its op-by-op step, the first batch's replay after that
    capture ('big again') of its replay before it ('big'); one prepared
    program, n_segments more captures, and the reserved peak within
    RESNET_PEAK_GB. Returns {pair: (loss |diff|, worst update measure,
    same bits)}."""
    out = {}
    for a, b in (('small replayed', 'small op by op'),
                 ('small captured', 'small op by op'),
                 ('big again', 'big')):
        loss_diff = abs(runs[a][0] - runs[b][0])
        upd = _update_diffs(runs[a], runs[b], params)
        bits = runs[a][0] == runs[b][0] and all(
            bool((runs[a][1][n] == runs[b][1][n]).all()) for n in params)
        out['%s vs %s' % (a, b)] = (loss_diff, max(upd.values()), bits)
        if not np.isfinite(runs[a][0]) or loss_diff > TRAIN_LOSS_TOL or \
                any(v > TRAIN_UPDATE_TOL for v in upd.values()):
            raise AssertionError('x5: %s vs %s: loss |diff| %.3e, updates '
                                 '%r beyond the stated tolerance'
                                 % (a, b, loss_diff, upd))
    if stats['prepared_programs'] != stats0['prepared_programs'] or \
            stats['compiled_segments'] != \
            stats0['compiled_segments'] + n_segments:
        raise AssertionError('x5: stats %r after %r: want the same prepared '
                             'programs and %d more captured segments'
                             % (stats, stats0, n_segments))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('x5: peak reserved device memory %.2f GB over '
                             '%g GB' % (reserved_gb, RESNET_PEAK_GB))
    return out


@phase('x5: a second batch size of ResNet-50 on the captured executor')
def check_second_shape(tr, place, sync):
    """tr's executor holds r1's step at RESNET_BATCH, captured. Each from
    one saved state, through that executor and its reader: the step at
    RESNET_BATCH (a replay); RESNET_SECOND_BATCH three times (its
    warm-up, its capture in the executor's one pool beside the first
    graph, a replay); the smaller step op by op; RESNET_BATCH's replay
    again. check_second_shape_runs holds them."""
    import itertools
    import torch
    import paddle_tpu_torch as fluid
    params = RESNET_PARAMS_COMPARED
    rng = np.random.RandomState(SEED + 17)
    dev = torch.device('cuda', 0)
    big = image_batch(rng, RESNET_BATCH, dev)
    small = image_batch(rng, RESNET_SECOND_BATCH, dev)
    saved = tr.snapshot()
    eager_exe = fluid.Executor(place)

    def op_by_op():
        return float(eager_exe.run(tr.main, fetch_list=[tr.avg_cost.name],
                                   scope=tr.scope,
                                   use_program_cache=False)[0])

    def from_saved(batch, step=tr.step):
        tr.restore(saved)
        tr.feed(lambda: itertools.repeat(batch))
        loss = step()
        sync()
        tr.reader.reset()
        return loss, {n: (tr.scope.find_var(n) - saved[n]).float()
                      for n in params}
    stats0 = tr.pe.jit_cache_stats()
    torch.cuda.reset_peak_memory_stats()
    runs = {'big': from_saved(big)}
    from_saved(small)
    runs['small captured'] = from_saved(small)
    runs['small replayed'] = from_saved(small)
    runs['small op by op'] = from_saved(small, op_by_op)
    runs['big again'] = from_saved(big)
    tr.restore(saved)
    stats = tr.pe.jit_cache_stats()
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    log('batch %d then %d on one executor: losses %s; stats %s after %s; '
        'peak device memory reserved %.2f GB'
        % (RESNET_BATCH, RESNET_SECOND_BATCH,
           ', '.join('%s %.6f' % (k, v[0]) for k, v in runs.items()),
           json.dumps(stats), json.dumps(stats0), reserved_gb))
    out = check_second_shape_runs(runs, params, device_segments(tr.main),
                                  stats0, stats, reserved_gb)
    log('x5: %s' % '; '.join('%s: loss |diff| %.3e, updates within %.3e, '
                             'the same bits %s' % ((k,) + v)
                             for k, v in out.items()))
    return out


def peak_memory_gb():
    """Peak allocated device memory since the last reset, in GB (a
    captured graph's pool counts while its tensors are alive in the
    capture; torch.cuda.max_memory_reserved() is logged beside it)."""
    import torch
    log('peak device memory allocated %.2f GB, reserved %.2f GB'
        % (torch.cuda.max_memory_allocated() / 1e9,
           torch.cuda.max_memory_reserved() / 1e9))
    return torch.cuda.max_memory_allocated() / 1e9


def free_device_memory():
    """Collect what the freed trainers left (their executors' captured
    graphs and pools) and return the cached blocks to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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
    adam_cfg = TransformerConfig(**ADAM_MODEL)
    lc_cfg = TransformerConfig(**LC_MODEL)
    place = fluid.CUDAPlace(0)
    sync = torch.cuda.synchronize
    try:
        build_kernels()
        rows = check_kernels(cfg)
        long_rows = check_long_kernels(lc_cfg)
        check_untaken_flash(place, counters)
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
        x2 = check_serving_capture(dec, prompts, streams, sync,
                                   {'prefill': prefill_ms,
                                    'decode_step': step_ms})
        del pred, dec
        free_device_memory()

        tr, losses, train_ms, train_launches, train_peak_gb = train_steps(
            cfg, place, counters, sync)
        saved, batch, kernel_step, plain_diffs = check_plain_step(
            tr, counters)
        split_launches, split_diffs, split_ms, split_device_ms = \
            check_split_step(tr, saved, batch, kernel_step, counters, sync)
        del saved
        tok_s, mfu, device_ms, busy = profile_train(tr, train_ms, sync)
        with flash_arms(None, 'split'):
            x1 = {'Momentum': check_captured_steps(
                tr, 'the Momentum step (split arm)', PARAMS_COMPARED, 'max',
                place, sync)}
        x3 = check_cache_key(tr, counters, place, sync)
        # the LM is freed before the remat LMs, those before the Adam LM,
        # and that one before ResNet
        del tr
        free_device_memory()
        x4 = remat_steps(place, counters, sync)

        adam = adam_steps(adam_cfg, place, counters, sync)
        atr = adam.pop('tr')
        adam_worst, adam_diffs, adam_upd = check_adam_step(
            atr, adam['records'], counters)
        x1['Adam'] = check_captured_steps(
            atr, 'the Adam step', ADAM_PARAMS_COMPARED, 'weighted', place,
            sync)
        del atr
        free_device_memory()
        opt_worst = check_optimizer_ops(place)
        op_worst = check_training_ops(place)

        fluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
        torch.cuda.reset_peak_memory_stats()
        (rtr, path_shapes, r_losses, r_step_ms, r_launches,
         r_peak_gb) = resnet_steps(place, sync)
        k6_row = check_k6(path_shapes)
        x5 = check_second_shape(rtr, place, sync)
        r_plain_diffs = check_resnet_plain_step(rtr)
        pair_diffs = check_fused_pair(place)
        img_s, r_mfu, r_device_ms, r_busy, r_kinds = profile_resnet(
            rtr, r_step_ms, sync)
        x1['ResNet-50'] = check_captured_steps(
            rtr, 'the ResNet-50 step', RESNET_PARAMS_COMPARED, 'spread',
            place, sync)
        # r1's executor is closed before n1: two batch-256 graph pools do
        # not fit on the card together
        rtr.drop_graphs()
        del rtr
        free_device_memory()

        with flags_set(N1_FLAGS):
            ntr, n1 = nhwc_steps(place, sync)
            n_img_s, n_mfu, n_device_ms, n_busy, n_kinds = profile_nhwc(
                ntr, n1['step_ms'], sync)
            n2 = check_nhwc_vs_nchw(ntr, place)
            i2 = check_nan_inf_mode(ntr, sync)
        del ntr
        free_device_memory()
        s1 = s2d_steps(place, sync)
        free_device_memory()
        i1 = inference_leg(place, sync)
        free_device_memory()

        (ltr, l_losses, l_step_ms, l_launches, l_peak_gb,
         l_extra) = lc_steps(lc_cfg, place, counters, sync)
        l_diffs, l_arm_ms, l_arm_launches, l_arm_dev = check_lc_arms(
            ltr, counters, sync)
        l_tok_s, l_mfu, l_mfu_exec, l_device_ms, l_busy = profile_lc(
            ltr, l_step_ms, l_extra, sync)
        with flash_arms(*LC_ARMS):
            x1['long-context'] = check_captured_steps(
                ltr, 'the long-context step (twopass/onepass)',
                LC_PARAMS_COMPARED, 'max', place, sync)
        del ltr
        free_device_memory()

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
    log('Adam training (the flagship LM, batch %d, AMP Adam + noam_decay + '
        'global-norm clip, use_tp/use_sp on): step %.3f ms, %.1f tokens/s, '
        'MFU %.4f, device busy %s, peak device memory %.2f GB, %d ops, loss '
        'after %d steps %.6f; K1 %d and K2 %d launches in %d steps; kernel '
        'vs plain step loss |diff| %.3e, updates within %.3e (gradient-'
        'weighted); rate within %.2e of noam_decay, '
        'beta powers within %.2e; optimizer updates on the card within '
        '%.2e of the CPU\'s; training-core ops within %.3f of their '
        'tolerance'
        % (TRAIN_BATCH, adam['step_ms'], adam['tok_s'], adam['mfu'],
           'not measured' if adam['busy'] is None
           else '%.1f%%' % (100 * adam['busy']),
           adam['peak_gb'], adam['n_ops'], len(adam['losses']),
           adam['losses'][-1], adam['launches']['flash_attention_fwd'],
           adam['launches']['flash_attention_bwd_kvmajor'], TIMED_STEPS,
           adam_diffs[0], max(adam_upd.values()), adam_worst['lr'],
           adam_worst['beta'],
           max(opt_worst.values()), op_worst))
    log('ResNet-50 training (batch %d, 224 px, AMP Momentum): step %.3f ms, '
        '%.1f images/s, MFU %.4f, device busy %s, peak device memory %.2f '
        'GB, loss after %d steps %.6f, K6 launches %d; K6 vs plain step loss '
        '|diff| %.3e; fused vs unfused Y %s'
        % (RESNET_BATCH, r_step_ms, img_s, r_mfu,
           'not measured' if r_busy is None else '%.1f%%' % (100 * r_busy),
           r_peak_gb, len(r_losses), r_losses[-1], r_launches,
           r_plain_diffs[0],
           ', '.join('%s %.3e' % (k, v[0]) for k, v in pair_diffs.items())))
    log('ResNet-50 as bench.py builds it for an accelerator (NHWC, conv2d '
        '+ batch_norm, bf16 parameter grads, batch %d): step %.3f ms, %.1f '
        'images/s, MFU %.4f, device %s ms, busy %s, copies %.3f ms and '
        'elementwise %.3f ms a step (NCHW r4: %.3f ms, %.1f images/s, device '
        '%s ms, busy %s, copies %.3f ms, elementwise %.3f ms), peak %.2f GB '
        'allocated / %.2f GB reserved, %d ops; NHWC vs NCHW step loss |diff| '
        '%.3e; check_nan_inf step %.1f ms, loss |diff| %.3e; s2d stem max '
        '|diff| %.3e, s2d step %.3f ms; inference batch %d p50 %.3f ms, p99 '
        '%.3f ms, device %.1f images/s, folded vs unfolded %.3e'
        % (RESNET_BATCH, n1['step_ms'], n_img_s, n_mfu,
           _fmt_ms(n_device_ms or None), _fmt_busy(n_busy),
           n_kinds.get('copies', 0.0), n_kinds.get('elementwise', 0.0),
           r_step_ms, img_s, _fmt_ms(r_device_ms or None), _fmt_busy(r_busy),
           r_kinds.get('copies', 0.0), r_kinds.get('elementwise', 0.0),
           n1['peak_gb'], n1['reserved_gb'], n1['n_ops'], n2['loss_diff'],
           i2['checked_ms'], i2['loss_diff'], s1['stem_err'], s1['step_ms'],
           INFER_BATCH, i1['p50'], i1['p99'], i1['images_s'], i1['err']))
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
    log('captured path: %s; decode predictor stats %s, eager prefill %.3f '
        'ms and decode step %.3f ms; remat peak GB / step ms / K1 per step: '
        '%s; arms %s; ResNet-50 at batch %d then %d on one executor: %s'
        % ('; '.join('%s %.3f ms captured vs %.3f ms op by op, loss |diff| '
                     '%.3e, same bits %s' % (k, v['captured_ms'],
                                             v['eager_ms'], v['loss_diff'],
                                             v['bits'])
                     for k, v in x1.items()),
           json.dumps(x2['stats']), x2['eager_prefill_ms'],
           x2['eager_step_ms'],
           ', '.join('%s %.2f / %.3f / %g' % (p, r['peak_gb'], r['ms'],
                                               r['per_step'][
                                                   KERNELS['fwd'][0]])
                     for p, r in x4.items()),
           json.dumps(x3), RESNET_BATCH, RESNET_SECOND_BATCH,
           '; '.join('%s same bits %s' % (k, v[2]) for k, v in x5.items())))
    log('chip_smoke wall time: %.1f s' % (time.perf_counter() - t_start))
    log(json.dumps({'kernels': rows}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
