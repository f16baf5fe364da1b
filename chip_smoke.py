#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no final "ok" line):
  (a) build every CUDA kernel of the path with nvcc (one process per
      source, started together);
  (b) hold each kernel against its plain PyTorch version on the card, at
      the shape the serving path gives it and at ragged edge shapes, and
      time kernel, plain version and the PyTorch library call;
  (c) build the flagship LM (bench.py's transformer: vocab 32768, dim
      2048, 16 heads, 12 layers, ffn 8192, max_len 512, flash attention)
      with random weights from a seed, run its startup program on
      CUDAPlace(0), save_inference_model, load it through
      AnalysisConfig/AnalysisPredictor, prepare_decoding(slots=8,
      prefill_batch=1), and answer 8 requests (prompts of 32..480
      tokens, 32 new tokens each) through LMServer.submit/result, with
      every kernel launch counter set to 0 just before and read just
      after: each kernel must have launched on the path (the flash
      forward at least prefills x layers times);
  (d) each request's prefill logits and first token match the port's own
      full-recompute Predictor.run (rtol = atol = 1e-3);
  (e) each engine stream equals its solo DecodePredictor.generate stream.

It prints the card's name and power limit (nvidia-smi), the kernels
line, the serving timings, and as its last line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MODEL = dict(vocab=32768, dim=2048, heads=16, layers=12, ffn=8192,
             max_len=512, flash_attention=True)
SLOTS, PREFILL_BATCH, N_REQUESTS, NEW_TOKENS = 8, 1, 8, 32
SEED = 1234

KERNEL_ATOL = 1e-4          # fp32 kernel vs fp32 plain version
RECOMPUTE_TOL = 1e-3        # prefill vs full recompute (rtol and atol)

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
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


# -- (a) ---------------------------------------------------------------------

@phase('a: build kernels')
def build_kernels():
    from paddle_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build('flash_attention_fwd')
    for name, path in paths.items():
        log('built %s -> %s' % (name, os.path.relpath(path, HERE)))
        for line in build.build_logs.get(name, '').splitlines():
            if 'registers' in line or 'spill' in line:
                log('  ptxas: %s' % line.strip())
    log('build seconds: %.2f' % (time.perf_counter() - t0))


# -- (b) ---------------------------------------------------------------------

def _qkv(rng, BH, T, d, device):
    import torch
    mk = lambda s: torch.from_numpy(  # noqa: E731
        (rng.randn(BH, T, d) * s).astype('float32')).to(device)
    return mk(0.5), mk(0.5), mk(1.0)


def flash_bound_ms(BH, T, d, causal):
    """Least time for the work this call needs: the visited score pairs
    (causal: T(T+1)/2 per row block) x 2 matmuls x 2 FLOP x d at the fp32
    peak, against q, k, v read once and o, lse written once."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4.0 * BH * pairs * d
    nbytes = 4.0 * (4 * BH * T * d + BH * T)
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


@phase('b: kernels vs plain versions')
def check_kernels(cfg):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(SEED)
    dev = torch.device('cuda', 0)
    # the prefill program's attention: [prefill_batch * heads, T, dh]
    BH, T, d = PREFILL_BATCH * cfg.heads, cfg.max_len, cfg.dim // cfg.heads
    shapes = [(BH, T, d, True), (3, 200, 64, False), (2, 130, 128, True),
              (4, 64, 64, True), (1, 1, 128, False)]
    path_err = None
    for bh, t, dd, causal in shapes:
        q, k, v = _qkv(rng, bh, t, dd, dev)
        scale = dd ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
        err = max((o - o_ref).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        ok = bool(torch.isfinite(o).all()) and err <= KERNEL_ATOL
        log('flash_attention_fwd [%d, %d, %d] causal=%s: max_abs_err %.3e '
            '(atol %g) %s' % (bh, t, dd, causal, err, KERNEL_ATOL,
                              'ok' if ok else 'MISMATCH'))
        if not ok:
            raise AssertionError('flash_attention_fwd disagrees with its '
                                 'plain version at [%d, %d, %d]'
                                 % (bh, t, dd))
        if path_err is None:
            path_err = err

    q, k, v = _qkv(rng, BH, T, d, dev)
    scale = d ** -0.5
    # kernel, plain, library, library, plain, kernel: the pairs bracket
    # drift in clocks; each time is the mean of its two runs
    runs = {'ms': [], 'plain_ms': [], 'library_ms': []}
    fns = {'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
           'plain_ms': lambda: fa.flash_attention_reference(q, k, v, True,
                                                            scale),
           'library_ms': lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True)}
    for key in ('ms', 'plain_ms', 'library_ms', 'library_ms', 'plain_ms',
                'ms'):
        runs[key].append(cuda_ms(fns[key]))
    times = {key: float(np.mean(v)) for key, v in runs.items()}
    lib_err = (F.scaled_dot_product_attention(q, k, v, is_causal=True)
               - fa.flash_attention_reference(q, k, v, True, scale)[0]) \
        .abs().max().item()
    bound, bound_by = flash_bound_ms(BH, T, d, True)
    log('flash_attention_fwd [%d, %d, %d] causal: kernel %.4f ms, plain '
        '%.4f ms, library (scaled_dot_product_attention) %.4f ms '
        '(max_abs_err vs plain %.2e), bound %.4f ms (%s)'
        % (BH, T, d, times['ms'], times['plain_ms'], times['library_ms'],
           lib_err, bound, bound_by))
    return {'name': 'flash_attention_fwd', 'route': 'cuda',
            'source': 'paddle_tpu_torch/csrc/flash_attention_fwd.cu',
            'replaces': 'paddle_tpu/pallas/flash_attention.py:171',
            'launches': None, 'max_abs_err': path_err,
            'ms': times['ms'], 'kernel_ms': times['ms'],
            'plain_ms': times['plain_ms'],
            'bound_ms': bound, 'bound_by': bound_by,
            'library_ms': times['library_ms'],
            'shape': [BH, T, d], 'causal': True}


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


def main():
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
    counters = {'flash_attention_fwd': fa.flash_attention_fwd}

    card = gpu_name_and_power_limit()
    log('card: %s' % card)
    log('python %s, torch %s, cuda %s' % (sys.version.split()[0],
                                        torch.__version__, torch.version.cuda))
    cfg = TransformerConfig(**MODEL)
    place = fluid.CUDAPlace(0)
    sync = torch.cuda.synchronize
    try:
        build_kernels()
        kernel = check_kernels(cfg)
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
    except PhaseError as e:
        print('chip_smoke: %s' % e, file=sys.stderr)
        import traceback
        traceback.print_exception(e.__cause__, file=sys.stderr)
        return 1
    kernel['launches'] = launches['flash_attention_fwd']
    log('serving: %.3f s for %d requests x %d tokens, prefill %.3f ms, '
        'decode step %.3f ms, peak device memory %.2f GB'
        % (wall, N_REQUESTS, NEW_TOKENS, prefill_ms, step_ms,
           torch.cuda.max_memory_allocated() / 1e9))
    log(json.dumps({'kernels': [kernel]}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
