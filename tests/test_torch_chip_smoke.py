"""chip_smoke.py's helpers that run without a card: the attention
yardstick, the bounds of the flash kernels, the checks of K1's o and
lse, of K4b's o and of the backward's gradients, the kernel checks of
phases b and b4 run on the plain versions, phase b6's checks of K6 run
on stand-ins built from its plain version (one right, three wrong), the
bracketed timing order, the device-time classes and the ptxas report,
the FLOP count of the LM steps and the arm switch; the checks of phases
h and a1-a4 (the path check refuses one plain call on the card, a2
refuses a rate 1e-4 off, a beta power one step behind and a wrong step
counter, and its update measure forgives sign flips where the gradient
is rounding noise but refuses a step 10% short, a3 refuses one update element 1e-3 off, a4's table covers every
op type of the training core and refuses an output 1e-4 off, its
dropout and truncated-normal checks pass on the CPU); the margin rule of
phases v1-v4 (equal streams, a near tie inside MARGIN_TOL, a divergence
outside it failing the phase), v1-v6 wired into main(), and v1-v5 run
end to end on the CPU at a tiny width; the sequence phases sq1-sq4 (the
Viterbi margin rule, the feed signatures, the parameters compared, the
weights of the update measure, the wiring into main() and an end-to-end
run on the CPU at a tiny width); the control-flow and
machine_translation phases cf1 and mt1-mt3 (their wiring into main(),
beam_margin, the chapter's Program, an end-to-end run on the CPU at a
tiny width); the sparse and detection phases sp1, det1, det2 and a4's
detection ops (their wiring into main(), detection_margin, the rpn
label rule, end-to-end runs on the CPU at a tiny width); the item-6 and
MoE phases (a4's item-6 cases and its published-shape check, random_crop's
draw, moe1 and moe2, sq4's chunk_eval and det2's DetectionMAP: their
wiring into main(), end-to-end runs on the CPU at a tiny width, and each
refusing a wrong result); the profiler and record-file phases pf1 and
rf1 (rf1's shard writer against tools/bench_input_pipeline.py's, byte
for byte, and its read-slot check refusing another image, label or
value; pf1's count, label, share and span checks on a synthetic CUDA
trace, refusing a short window and an unlabeled replay; their wiring
into main()); and the script's refusal to run without a card. The
end-to-end CPU runs of v1-v5, bk1-bk3 with mo1, sq1-sq4 (with sq4's
chunk_eval check), sp1 with det1 and det2, pf1 with rf1, and the mesh
phases mp1, mp2, pp1 and ck1 live in test_torch_chip_smoke_{paged,
book,seq,sparse_det,pf1,mesh}.py."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

import bench
import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.kernels import conv_bn as k6
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.transformer import TransformerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_sdpa_yardstick_takes_a_fused_backend_on_3d_inputs(dtype):
    """PyTorch's fused attention backends refuse [BH, T, d] inputs, so the
    yardstick timed the unfused math path; the repaired helper views them
    as [1, BH, T, d] and runs under one fused backend only (on the CPU
    build, flash attention). Its result is the attention of the inputs
    (bf16: to 2e-2)."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(4, 64, 64).astype('float32'))
               .to(getattr(torch, dtype)) for _ in range(3))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        with pytest.raises(RuntimeError):
            F.scaled_dot_product_attention(q, k, v, is_causal=True)
    call, backend = chip_smoke.sdpa_yardstick(q, k, v, True)
    assert backend == 'FLASH_ATTENTION'
    out = call()
    assert out.shape == (1, 4, 64, 64) and out.dtype == q.dtype
    want, _ = fa.flash_attention_reference(q, k, v, True, 64 ** -0.5)
    tol = 1e-5 if dtype == 'float32' else 2e-2
    np.testing.assert_allclose(out[0].float().numpy(), want.float().numpy(),
                               atol=tol, rtol=tol)


def test_device_time_takes_a_second_window_before_giving_up(monkeypatch):
    """The profiler has returned windows with no device event for kernels
    that a later window traced (up to ten in a row once): a window with
    no device events is taken again, padded longer each time
    (WINDOW_PADS_S, one window each; the first is padded too), and only
    then is the device time not measured (None). On the CPU every window
    is empty: one warm-up call and six windows, each padded on both
    sides."""
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    waits = []
    monkeypatch.setattr(chip_smoke.time, 'sleep', waits.append)
    calls = []
    assert chip_smoke.DEVICE_MS_WINDOWS == 6
    assert chip_smoke.WINDOW_PADS_S[0] > 0 and \
        list(chip_smoke.WINDOW_PADS_S) == sorted(chip_smoke.WINDOW_PADS_S)
    assert chip_smoke._device_ms(lambda: calls.append(1), iters=3) is None
    assert len(calls) == 1 + 3 * chip_smoke.DEVICE_MS_WINDOWS
    assert waits == [p for p in chip_smoke.WINDOW_PADS_S for _ in (0, 1)]


def test_device_time_refuses_a_window_that_lost_a_counted_launch(
        monkeypatch):
    """A window that kept a kernel's small neighbours (a memset) but lost
    the launches its wrapper counted is taken again, padded longer; the
    time is read from the first window that saw every counted launch, and
    is not measured (None) where none did."""
    import contextlib
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    counts = {n: 0 for names in chip_smoke.LAUNCH_GROUPS.values()
              for n in names}

    def fn():
        counts['matmul_bn_stats_kernel'] += 1

    def event(key, n, us):
        return SimpleNamespace(device_type=DeviceType.CUDA, key=key, count=n,
                               self_device_time_total=us)
    memset = event('Memset (Device)', 10, 1.0)
    for windows, want in (([[memset], [memset, event('K6', 10, 500.0)]],
                           0.0501),
                          ([[memset]] * chip_smoke.DEVICE_MS_WINDOWS, None)):
        left, pads = list(windows), []

        @contextlib.contextmanager
        def window(pad):
            pads.append(pad)
            events = left.pop(0)
            yield SimpleNamespace(key_averages=lambda: events)
        monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
        monkeypatch.setattr(chip_smoke, 'device_window', window)
        monkeypatch.setattr(chip_smoke, 'launch_group',
                            lambda key: key if key == 'K6' else None)
        monkeypatch.setattr(chip_smoke, 'wrapper_counts',
                            lambda: dict(counts))
        got = chip_smoke._device_ms(fn, iters=10)
        assert got == pytest.approx(want) if want else got is None
        assert pads == list(chip_smoke.WINDOW_PADS_S[:len(windows)])


def test_library_time_is_device_time_or_raises(monkeypatch):
    """The yardstick is read on torch.profiler's device time only: where
    the profiler sees none, the timing raises and never falls back to
    host-clock times."""
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 64, 64).astype('float32'))
                   for _ in range(4))
    seen = []
    monkeypatch.setattr(chip_smoke, '_device_ms',
                        lambda fn, iters=10: seen.append(fn()))
    with pytest.raises(RuntimeError, match='no device time'):
        chip_smoke._library_fwd_bwd(q, k, v, do, True, 'fp32')
    assert tuple(seen[0].shape) == (1, 2, 64, 64)  # the 4-D forward ran
    assert chip_smoke._over_library(None, 1.0) == ''
    assert chip_smoke._over_library(3.0, 1.5) == \
        ' (2.00x the library by device time)'


@pytest.mark.parametrize('kind,shape,dtype,ms,by', [
    ('k4a', (16, 8192, 128), 'bfloat16', 0.13893, 'operations'),
    ('k4b', (16, 8192, 128), 'bfloat16', 0.27786, 'operations'),
    ('k5', (16, 8192, 128), 'bfloat16', 0.69464, 'operations'),
    ('fwd', (16, 512, 128), 'float32', 0.016057, 'operations'),
    ('fwd', (128, 512, 128), 'bfloat16', 0.020111, 'bytes'),
    ('fwd', (16, 8192, 128), 'bfloat16', 0.27786, 'operations'),
    ('k2', (128, 512, 128), 'bfloat16', 0.035213, 'bytes'),
    ('k3a', (128, 512, 128), 'bfloat16', 0.025197, 'bytes'),
    ('k3b', (128, 512, 128), 'bfloat16', 0.030205, 'bytes'),
])
def test_flash_bounds(kind, shape, dtype, ms, by):
    """K4a does 2 FLOP per visited score per column and writes lse only,
    K4b and K1 4 (K1 at the long-context shape: K4b's bound), K5 10 with
    3 outputs; the earlier kernels' bounds are those PERF.md recorded."""
    got = chip_smoke.flash_bound_ms(kind, *shape, True, dtype)
    assert got[1] == by
    np.testing.assert_allclose(got[0], ms, rtol=1e-4)


@pytest.mark.parametrize('causal', [True, False])
def test_acc_check_refuses_small_rows_five_percent_off(causal):
    """b4's check of bf16 K4b: an o 5% off on its rows of small |o| (the
    second half of a 2048-key causal or full softmax, |o| ~2e-2) lies
    within the bf16 atol of 2e-2 but not within the relative bound; the
    plain version's own o, and one 1% off there, pass."""
    rng = np.random.RandomState(0)
    q, k, v, _ = chip_smoke._inputs(rng, 2, 2048, 64, 'bfloat16', 'cpu')
    lse = fa.flash_attention_stats_reference(q, k, causal, 0.125)
    o_ref = fa.flash_attention_acc_reference(q, k, v, lse, causal, 0.125)
    assert o_ref.float()[:, 1024:].abs().mean() < 2.5e-2

    def off(factor):
        o = o_ref.float().clone()
        o[:, 1024:] *= factor
        return o.to(torch.bfloat16)

    err, rel, ok = chip_smoke.check_acc_output(off(1.05), o_ref, 'bfloat16')
    assert err <= chip_smoke.KERNEL_ATOL['bfloat16'] and not ok
    assert rel > chip_smoke.O_RTOL
    assert chip_smoke.check_acc_output(off(1.01), o_ref, 'bfloat16')[2]
    assert chip_smoke.check_acc_output(o_ref, o_ref, 'bfloat16') == \
        (0.0, 0.0, True)


@pytest.mark.parametrize('causal', [True, False])
def test_fwd_check_refuses_small_rows_five_percent_off(causal):
    """b's and b4's check of K1: a bf16 o 5% off on its rows of small |o|
    (the second half of a 2048-key causal or full softmax, |o| ~2e-2)
    lies within the bf16 atol of 2e-2 but not within O_RTOL; an lse
    1e-3 off is refused in both dtypes (the fp32 atol, as K4a's lse);
    the plain version's own outputs, and an o 1% off there, pass."""
    rng = np.random.RandomState(0)
    q, k, v, _ = chip_smoke._inputs(rng, 2, 2048, 64, 'bfloat16', 'cpu')
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, 0.125)
    assert o_ref.float()[:, 1024:].abs().mean() < 2.5e-2

    def off(factor):
        o = o_ref.float().clone()
        o[:, 1024:] *= factor
        return o.to(torch.bfloat16)

    check = chip_smoke.check_fwd_output
    err, rel, lse_err, ok = check(off(1.05), lse_ref, o_ref, lse_ref,
                                  'bfloat16')
    assert err <= chip_smoke.KERNEL_ATOL['bfloat16'] and not ok
    assert rel > chip_smoke.O_RTOL and lse_err == 0.0
    assert check(off(1.01), lse_ref, o_ref, lse_ref, 'bfloat16')[3]
    assert check(o_ref, lse_ref, o_ref, lse_ref, 'bfloat16') == \
        (0.0, 0.0, 0.0, True)
    for dtype in ('bfloat16', 'float32'):
        err, rel, lse_err, ok = check(o_ref, lse_ref + 1e-3, o_ref, lse_ref,
                                      dtype)
        assert (err, rel) == (0.0, 0.0) and not ok
        np.testing.assert_allclose(lse_err, 1e-3, rtol=1e-2)


def _plain_wrappers(monkeypatch):
    """Every flash wrapper of phases b and b4 replaced by its plain
    version (the backward ones recompute o from the plain forward), and
    torch.cuda.synchronize by a no-op: the checks then run on the CPU."""
    def bwd(q, k, v, do, lse, delta, causal, scale):
        o, _ = fa.flash_attention_reference(q, k, v, causal, scale)
        return fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                                scale)
    for name, fn in (
            ('flash_attention_fwd', fa.flash_attention_reference),
            ('flash_attention_fwd_stats', fa.flash_attention_stats_reference),
            ('flash_attention_fwd_acc', fa.flash_attention_acc_reference),
            ('flash_attention_bwd_kvmajor', bwd),
            ('flash_attention_bwd_onepass', bwd),
            ('flash_attention_bwd_dq', lambda *a: bwd(*a)[0]),
            ('flash_attention_bwd_dkv', lambda *a: bwd(*a)[1:])):
        monkeypatch.setattr(fa, name, fn)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'empty_cache', lambda: None)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kernel_checks_pass_the_plain_versions(monkeypatch, capsys, dtype):
    """Phase b's and b4's checks at a ragged causal shape, run on the CPU
    with the plain versions in place of the kernels: every kind passes
    (K1 with zero error; b4's K5 gets the acc version's o, which lies a
    rounding step from the plain forward's), and b4 holds K1 in bf16
    only (fp32 K1 runs on no path at the long-context T) and logs its
    distance from fp64."""
    _plain_wrappers(monkeypatch)
    rng = np.random.RandomState(1)
    errs = chip_smoke._check_shape(fa, rng, 'cpu', 2, 130, 64, True, dtype)
    assert set(errs) == {'fwd', 'k2', 'k3a', 'k3b'}
    assert max(errs.values()) == 0.0
    errs = chip_smoke._check_long_shape(fa, rng, 'cpu', 2, 130, 64, True,
                                        dtype, fp64=True)
    kinds = {'k4a', 'k4b', 'k5'} | ({'fwd'} if dtype == 'bfloat16' else set())
    assert set(errs) == kinds
    assert errs.get('fwd', 0.0) == errs['k4a'] == errs['k4b'] == 0.0
    out = capsys.readouterr().out
    assert 'MISMATCH' not in out
    assert 'second launch bit-identical: flash_attention_fwd yes, ' \
        'flash_attention_bwd_dq yes, flash_attention_bwd_dkv yes ok' in out
    assert 'flash_attention_bwd_dq dq 0.000e+00; flash_attention_bwd_dkv ' \
        'dk, dv 0.000e+00, 0.000e+00' in out
    bf16 = dtype == 'bfloat16'
    assert (': flash_attention_fwd o ' in out) is bf16
    assert (', flash_attention_fwd ' in out.split('vs fp64')[-1]) is bf16


def test_kernel_checks_refuse_a_wrong_forward(monkeypatch):
    """A K1 whose lse is 1e-3 off fails phase b's check and b4's."""
    _plain_wrappers(monkeypatch)

    def wrong(q, k, v, causal, scale):
        o, lse = fa.flash_attention_reference(q, k, v, causal, scale)
        return o, lse + 1e-3
    monkeypatch.setattr(fa, 'flash_attention_fwd', wrong)
    rng = np.random.RandomState(2)
    for check in (chip_smoke._check_shape, chip_smoke._check_long_shape):
        with pytest.raises(AssertionError, match='flash_attention_fwd'):
            check(fa, rng, 'cpu', 2, 130, 64, True, 'bfloat16')


@pytest.mark.parametrize('kind', ['k3a', 'k3b'])
def test_kernel_checks_refuse_a_split_backward_five_percent_off(
        monkeypatch, kind):
    """Phase b holds bf16 K3a's dq and K3b's dk, dv to G_RTOL as it holds
    K2's: a K3a whose dq, or a K3b whose dk, is 5% off on the rows of
    its second half (|g| below ~8e-2 there, so within the bf16 atol of
    2e-2) is refused, and so is one that disagrees only there."""
    _plain_wrappers(monkeypatch)
    name = chip_smoke.KERNELS[kind][0]
    plain = getattr(fa, name)

    moved = []

    def off(*args):
        out = plain(*args)
        want = out if kind == 'k3a' else out[0]
        g = want.float().clone()
        g[:, g.shape[1] // 2:] *= 1.05
        g = g.to(want.dtype)
        moved.append((g.float() - want.float()).abs().max().item())
        return g if kind == 'k3a' else (g, out[1])
    monkeypatch.setattr(fa, name, off)
    rng = np.random.RandomState(4)
    with pytest.raises(AssertionError, match="'%s'] disagree" % name):
        chip_smoke._check_shape(fa, rng, 'cpu', 2, 2048, 64, True,
                                'bfloat16')
    assert 0 < moved[0] <= chip_smoke.KERNEL_ATOL['bfloat16']


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('kind', ['k3a', 'k3b'])
def test_kernel_checks_refuse_a_split_backward_that_varies(monkeypatch,
                                                           kind, dtype):
    """The split arm exists to be deterministic: phase b launches K3a
    and K3b twice on the same inputs, and a second launch whose output
    differs from the first in one bit fails the phase, in both dtypes."""
    _plain_wrappers(monkeypatch)
    name = chip_smoke.KERNELS[kind][0]
    plain = getattr(fa, name)
    calls = []

    def varies(*args):
        out = plain(*args)
        calls.append(1)
        if len(calls) == 2:
            first = out if kind == 'k3a' else out[-1]
            bits = first.view(torch.int16 if first.dtype == torch.bfloat16
                              else torch.int32)
            bits.view(-1)[7] ^= 1
        return out
    monkeypatch.setattr(fa, name, varies)
    rng = np.random.RandomState(5)
    with pytest.raises(AssertionError, match="'%s'] give other bits on a "
                       "second launch" % name):
        chip_smoke._check_shape(fa, rng, 'cpu', 2, 130, 64, True, dtype)
    assert len(calls) == 2


@pytest.mark.parametrize('which', ['o', 'lse'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_kernel_checks_refuse_a_forward_that_varies(monkeypatch, dtype,
                                                    which):
    """K1 sums each row's keys in one order, and phase e needs that
    (engine streams equal solo streams): phase b launches it twice on
    the same inputs, and a second launch whose o or lse differs from the
    first in one bit fails the phase, in both dtypes."""
    _plain_wrappers(monkeypatch)
    plain = fa.flash_attention_fwd
    calls = []

    def varies(*args):
        o, lse = plain(*args)
        calls.append(1)
        if len(calls) == 2:
            out = o if which == 'o' else lse
            bits = out.view(torch.int16 if out.dtype == torch.bfloat16
                            else torch.int32)
            bits.view(-1)[7] ^= 1
        return o, lse
    monkeypatch.setattr(fa, 'flash_attention_fwd', varies)
    rng = np.random.RandomState(6)
    with pytest.raises(AssertionError, match="'flash_attention_fwd'] give "
                       "other bits on a second launch"):
        chip_smoke._check_shape(fa, rng, 'cpu', 2, 130, 64, True, dtype)
    assert len(calls) == 2


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest), as fp32."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_fwd_check_refuses_a_tf32_forward():
    """fp32 K1's contract is exact fp32 products: an o computed with q,
    k, p and v rounded to TF32 (single-pass tensor-core products) at the
    serving shape [16, 512, 128] causal lies ~1e-3 from the plain
    version, ten times the fp32 atol, and check_fwd_output refuses it;
    the plain version's own outputs pass."""
    rng = np.random.RandomState(chip_smoke.SEED)
    q, k, v, _ = chip_smoke._inputs(rng, 16, 512, 128, 'float32', 'cpu')
    scale = 128 ** -0.5
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, scale)
    s = torch.matmul(_tf32(q), _tf32(k).transpose(-1, -2)) * scale
    keep = torch.ones((512, 512), dtype=torch.bool).tril()
    s = s.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(_tf32(torch.exp(s - lse[..., None])), _tf32(v))
    check = chip_smoke.check_fwd_output
    o_err, _, lse_err, ok = check(o, lse, o_ref, lse_ref, 'float32')
    assert not ok and o_err > 5 * chip_smoke.KERNEL_ATOL['float32']
    assert not check(o, lse_ref, o_ref, lse_ref, 'float32')[3]
    assert check(o_ref, lse_ref, o_ref, lse_ref, 'float32') == \
        (0.0, 0.0, 0.0, True)


def test_kernel_checks_log_the_forward_against_fp64(monkeypatch, capsys):
    """Phase b's fp64=True logs K1's o and lse and its plain version's
    distance from an fp64 evaluation; the plain fp32 version lies within
    a few fp32 roundings of it."""
    _plain_wrappers(monkeypatch)
    rng = np.random.RandomState(7)
    chip_smoke._check_shape(fa, rng, 'cpu', 2, 130, 128, True, 'float32',
                            fp64=True)
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if 'vs fp64' in ln]
    assert len(line) == 1 and line[0].startswith(
        '[2, 130, 128] causal=True float32: vs fp64 max_abs_err '
        'flash_attention_fwd o ')
    errs = [float(x) for x in re.findall(r'\d\.\d{3}e[-+]\d+', line[0])]
    assert len(errs) == 4 and errs[:2] == errs[2:] and max(errs) < 1e-6
    q, k, v, _ = chip_smoke._inputs(np.random.RandomState(7), 2, 130, 128,
                                    'float32', 'cpu')
    got = fa.flash_attention_reference(q, k, v, True, 128 ** -0.5)
    assert chip_smoke._log_fwd_fp64(q, k, v, True, 128 ** -0.5, got, got,
                                    'x') == pytest.approx(errs, rel=1e-2)


@pytest.mark.parametrize('causal', [True, False])
def test_grad_check_refuses_small_rows_five_percent_off(causal):
    """b's and b4's check of bf16 K2 and K5: a dk 5% off on the rows of
    its second half (the last 1024 of 2048 keys: |dk| at most ~6e-2)
    lies within the bf16 atol of 2e-2 but not within G_RTOL; the plain
    version's own gradients, and a dk 1% off there, pass."""
    rng = np.random.RandomState(0)
    q, k, v, do = chip_smoke._inputs(rng, 2, 2048, 64, 'bfloat16', 'cpu')
    o, lse = fa.flash_attention_reference(q, k, v, causal, 0.125)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                            0.125)
    assert want[1].float()[:, 1024:].abs().max() < 6e-2

    def off(factor):
        dk = want[1].float().clone()
        dk[:, 1024:] *= factor
        return want[0], dk.to(torch.bfloat16), want[2]

    err, rels, ok = chip_smoke.check_grads(off(1.05), want, 'bfloat16')
    assert err <= chip_smoke.KERNEL_ATOL['bfloat16'] and not ok
    assert rels[0] == rels[2] == 0.0 and rels[1] > chip_smoke.G_RTOL
    assert chip_smoke.check_grads(off(1.01), want, 'bfloat16')[2]
    assert chip_smoke.check_grads(want, want, 'bfloat16') == \
        (0.0, [0.0, 0.0, 0.0], True)
    # fp32 holds the atol alone
    assert chip_smoke.check_grads(off(1.05), want, 'float32')[2] is \
        (err <= chip_smoke.KERNEL_ATOL['float32'])


def test_grad_check_floors_a_gradient_that_is_zero():
    """At T = 1 a softmax over one key has zero gradient in q and k: the
    fp32 plain version's dq and dk are rounding noise (~5e-8), and the
    kernel's exact zeros pass; a gradient 1e-3 off there does not."""
    rng = np.random.RandomState(3)
    q, k, v, do = chip_smoke._inputs(rng, 1, 1, 128, 'bfloat16', 'cpu')
    o, lse = fa.flash_attention_reference(q, k, v, False, 128 ** -0.5)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, False,
                                            128 ** -0.5)
    assert want[0].float().abs().max() < 1e-6
    zeros = (torch.zeros_like(want[0]), torch.zeros_like(want[1]), want[2])
    err, rels, ok = chip_smoke.check_grads(zeros, want, 'bfloat16')
    assert ok and max(rels) < 1e-2
    wrong = (torch.full_like(want[0], 1e-3), want[1], want[2])
    assert not chip_smoke.check_grads(wrong, want, 'bfloat16')[2]


@pytest.mark.parametrize('name,kind', [
    ('void (anonymous namespace)::tc::flash_bwd_wgmma_kernel<128>('
     '__nv_bfloat16 const*, __nv_bfloat16 const*, float*, int, int, int, '
     'float)', 'K2/K5 bf16 (flash_bwd_wgmma_kernel)'),
    ('void (anonymous namespace)::tc::flash_bwd_wgmma_kernel<64>(...)',
     'K2/K5 bf16 (flash_bwd_wgmma_kernel)'),
    ('_ZN55_GLOBAL__N__0741eedf_22_flash_attention_bwd_cu_2d643e7a2tc22'
     'flash_bwd_wgmma_kernelILi128EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PfP'
     'S2_S8_iiif', 'K2/K5 bf16 (flash_bwd_wgmma_kernel)'),
    ('void (anonymous namespace)::flash_bwd_q_kernel<128, float, true>('
     'float const*, float const*, float*, float*, float*, int, int, '
     'float)', 'K5 (flash_bwd_q_kernel<..., true>)'),
    ('void (anonymous namespace)::flash_bwd_kv_kernel<128, float, true>('
     'float const*)', 'flash kernels (K1/K2/K3)'),
    ('void (anonymous namespace)::tc::flash_fwd_acc_wgmma_kernel<128>()',
     'K4b (flash_fwd_acc_kernel)'),
    ('void (anonymous namespace)::tc::flash_bwd_dq_wgmma_kernel<128>('
     '__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, '
     '__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, '
     'int, int, int, float)', 'K3a bf16 (flash_bwd_dq_wgmma_kernel)'),
    ('void (anonymous namespace)::tc::flash_bwd_dq_wgmma_kernel<64>(...)',
     'K3a bf16 (flash_bwd_dq_wgmma_kernel)'),
    ('_ZN55_GLOBAL__N__32e0028d_22_flash_attention_bwd_cu_2d643e7a2tc25'
     'flash_bwd_dq_wgmma_kernelILi128EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_'
     'PS2_iiif', 'K3a bf16 (flash_bwd_dq_wgmma_kernel)'),
    ('void (anonymous namespace)::tc::flash_bwd_dkv_wgmma_kernel<128>('
     '__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, '
     '__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, '
     '__nv_bfloat16*, int, int, int, float)',
     'K3b bf16 (flash_bwd_dkv_wgmma_kernel)'),
    ('_ZN55_GLOBAL__N__32e0028d_22_flash_attention_bwd_cu_2d643e7a2tc26'
     'flash_bwd_dkv_wgmma_kernelILi64EEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_'
     'PS2_S8_iiif', 'K3b bf16 (flash_bwd_dkv_wgmma_kernel)'),
    ('void (anonymous namespace)::flash_bwd_q_kernel<128, float, false>('
     'float const*)', 'flash kernels (K1/K2/K3)'),
])
def test_kernel_kind_classes_the_backward_kernels(name, kind):
    """t3's, t4's and l3's device-time breakdowns give the tensor-core
    backwards (bf16 K2 and K5; bf16 K3a; bf16 K3b) a line each, by the
    demangled name (as the profiler reports it) or the mangled one (as
    ptxas does), none in another's; fp32 K5 keeps its line, and fp32
    K3a, K3b the CUDA-core flash line."""
    assert chip_smoke._kernel_kind(name) == kind


@pytest.mark.parametrize('name,kind', [
    ('void (anonymous namespace)::tc::flash_fwd_wgmma_kernel<128>('
     '__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, '
     '__nv_bfloat16*, float*, int, int, int, float)',
     'K1 bf16 (flash_fwd_wgmma_kernel)'),
    ('void (anonymous namespace)::tc::flash_fwd_wgmma_kernel<64>(...)',
     'K1 bf16 (flash_fwd_wgmma_kernel)'),
    ('_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_fwd_cu_6928a1a22tc22'
     'flash_fwd_wgmma_kernelILi128EEEvPK13__nv_bfloat16S4_S4_PS2_Pfiiif',
     'K1 bf16 (flash_fwd_wgmma_kernel)'),
    ('void (anonymous namespace)::flash_fwd_kernel<128>(float const*, '
     'float const*, float const*, float*, float*, int, int, float)',
     'flash kernels (K1/K2/K3)'),
    ('void (anonymous namespace)::flash_bwd_q_kernel<128, __nv_bfloat16, '
     'false>(...)', 'flash kernels (K1/K2/K3)'),
    ('void (anonymous namespace)::tc::flash_fwd_stats_wgmma_kernel<128>()',
     'K4a (flash_fwd_stats_kernel)'),
    ('void (anonymous namespace)::flash_fwd_f32_kernel<128>(float const*, '
     'float const*, float const*, float*, float*, int, int, int, int, '
     'float)', 'K1 fp32 (flash_fwd_f32_kernel)'),
    ('_ZN55_GLOBAL__N__9cd0acc9_22_flash_attention_fwd_cu_6928a1a220'
     'flash_fwd_f32_kernelILi64EEEvPKfS2_S2_PfS3_iiiif',
     'K1 fp32 (flash_fwd_f32_kernel)'),
])
def test_kernel_kind_classes_the_forward_kernels(name, kind):
    """t4's and l3's breakdowns give bf16 K1 (the tensor-core forward) a
    line of its own, by its demangled or mangled name; fp32 K1 and K3a,
    K3b keep the CUDA-core flash line, and K4a keeps its own."""
    assert chip_smoke._kernel_kind(name) == kind


@pytest.mark.parametrize('name', [
    'void tc::matmul_bn_stats_wgmma_kernel<128>(CUtensorMap_st, '
    'CUtensorMap_st, CUtensorMap_st, float*, float*, int, int, int, int, '
    'int)',
    '_ZN2tc28matmul_bn_stats_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_'
    'PfS2_iiiii',
    'void (anonymous namespace)::matmul_bn_stats_kernel<__nv_bfloat16>('
    '__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, '
    'float*, int, int, int)',
    'void (anonymous namespace)::column_sums_kernel(float const*, float '
    'const*, float*, float*, int, int)',
])
def test_kernel_kind_classes_the_k6_kernels(name):
    """r4's breakdown keeps every K6 kernel, the tensor-core one (a CUDA
    kernel with tensor maps, no GEMM by name), the generic one and the
    column sums, on K6's line, so the step's K6 time compares across
    PRs."""
    assert chip_smoke._kernel_kind(name) == 'K6 (matmul + BN statistics)'


_K6_PTXAS = """\
ptxas info    : Compiling entry function '_ZN2tc28matmul_bn_stats_wgmma_\
kernelILi64EEEv14CUtensorMap_stS1_S1_PfS2_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc28matmul_bn_stats_wgmma_\
kernelILi64EEEv14CUtensorMap_stS1_S1_PfS2_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN2tc28matmul_bn_stats_wgmma_\
kernelILi128EEEv14CUtensorMap_stS1_S1_PfS2_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc28matmul_bn_stats_wgmma_\
kernelILi128EEEv14CUtensorMap_stS1_S1_PfS2_iiiii
    104 bytes stack frame, 172 bytes spill stores, 168 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 104 bytes cumulative \
stack size
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1614e45a_10_\
conv_bn_cu_59f2cc9722matmul_bn_stats_kernelI13__nv_bfloat16EEvPKT_S4_PS2_\
PfS6_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1614e45a_10_\
conv_bn_cu_59f2cc9722matmul_bn_stats_kernelI13__nv_bfloat16EEvPKT_S4_PS2_\
PfS6_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 66 registers, used 1 barriers, 36864 bytes smem
"""


def test_ptxas_report_reads_the_k6_kernel():
    """Phase a's report of the tensor-core K6 from nvcc's -Xptxas -v
    lines (in the form an sm_90a build prints them): one line per tile
    width with its registers and spills, and none for the generic
    kernel."""
    assert chip_smoke.ptxas_report(_K6_PTXAS,
                                   'matmul_bn_stats_wgmma_kernel') == [
        ('matmul_bn_stats_wgmma_kernel<64>', 168, 0, 0),
        ('matmul_bn_stats_wgmma_kernel<128>', 168, 172, 168)]


def test_bracketed_ms_times_the_product_alone_in_its_turn(monkeypatch):
    """b6 times kernel, plain version, library and the product alone in
    the order k, p, l, m, m, l, p, k, each the mean of its two runs."""
    order = []
    monkeypatch.setattr(chip_smoke, 'cuda_ms',
                        lambda fn: (order.append(fn()), float(len(order)))[1])
    got = chip_smoke.bracketed_ms({k: (lambda k=k: k) for k in (
        'ms', 'plain_ms', 'library_ms', 'matmul_ms')})
    assert order == ['ms', 'plain_ms', 'library_ms', 'matmul_ms',
                     'matmul_ms', 'library_ms', 'plain_ms', 'ms']
    assert got == {'ms': 4.5, 'plain_ms': 4.5, 'library_ms': 4.5,
                   'matmul_ms': 4.5}


# b6 on the CPU at small shapes: every bf16 path shape and the M + 1 one
# are tensor-core shapes; fp32 and the ragged one are generic.
_K6_PATH = {(512, 64, 256): 2, (256, 128, 64): 1, (384, 256, 128): 1}


def _k6_stand_in(monkeypatch, route=None, alter=None):
    """k6.matmul_bn_stats_kernel replaced by its plain version, counting
    each launch under the kernel `route(M, K, N, dtype)` picks (k6._route
    by default); alter(call, y, s, q) may change the outputs of a call
    (0 for the first). torch.cuda.synchronize becomes a no-op."""
    route = route or (lambda M, K, N, dtype: k6._route(M, K, N, dtype))
    calls = []

    def stand_in(x, w):
        (M, K), N = x.shape, w.shape[1]
        kernel = route(M, K, N, x.dtype)
        counts = stand_in.launches_by_kernel
        counts[kernel] = counts.get(kernel, 0) + 1
        y, s, q = k6.matmul_bn_stats_reference(x, w)
        calls.append((M, K, N))
        if alter is not None:
            y, s, q = alter(len(calls) - 1, y, s, q)
        return y, s, q
    stand_in.launches_by_kernel = {}
    monkeypatch.setattr(k6, 'matmul_bn_stats_kernel', stand_in)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    return calls


def _run_b6_checks():
    gen = torch.Generator()
    gen.manual_seed(3)
    return chip_smoke.check_k6_outputs(k6, gen, 'cpu', _K6_PATH, 132)


def test_k6_checks_pass_the_plain_version(monkeypatch, capsys):
    """b6's shapes (the picks, a shape per tile width, K = 64, M + 1 in
    bf16; the picks in fp32; the ragged 300 x 70 x 130 in both), each
    launched twice, pass when the kernel is the plain version, and the
    log names the kernel that ran."""
    calls = _k6_stand_in(monkeypatch)
    assert _run_b6_checks() == 0.0
    shapes = chip_smoke.k6_check_shapes(k6, _K6_PATH, 132)
    assert len(calls) == 2 * len(shapes)
    assert ((257, 128, 64), 'bfloat16', k6.WGMMA_KERNEL, False) in shapes
    assert {s for s, dt, _, on_path in shapes if on_path} == set(_K6_PATH)
    assert ((300, 70, 130), 'bfloat16', k6.GENERIC_KERNEL, False) in shapes
    out = capsys.readouterr().out
    assert 'MISMATCH' not in out
    assert 'bfloat16 on matmul_bn_stats_wgmma_kernel x 2' in out
    assert 'float32 on matmul_bn_stats_kernel x 2' in out


def test_k6_checks_refuse_a_second_launch_one_bit_off(monkeypatch):
    """A K6 whose second launch on the same inputs differs from the first
    in one bit of y fails b6."""
    def flip(call, y, s, q):
        if call % 2:
            y = y.clone()
            bits = y.view(torch.int16) if y.dtype == torch.bfloat16 else \
                y.view(torch.int32)
            bits.view(-1)[7] ^= 1
        return y, s, q
    _k6_stand_in(monkeypatch, alter=flip)
    with pytest.raises(AssertionError, match='second launch'):
        _run_b6_checks()


def test_k6_checks_refuse_y_five_percent_off_in_a_few_rows(monkeypatch):
    """A K6 whose y is 5% off in three rows (its sums right) fails b6."""
    def off(call, y, s, q):
        y = y.clone()
        y[:3] = (y[:3].float() * 1.05).to(y.dtype)
        return y, s, q
    _k6_stand_in(monkeypatch, alter=off)
    with pytest.raises(AssertionError, match='disagrees'):
        _run_b6_checks()


def test_k6_checks_refuse_a_path_shape_on_the_generic_kernel(monkeypatch):
    """A path shape that ran the generic kernel in bf16 fails b6, though
    its outputs are right."""
    _k6_stand_in(monkeypatch,
                 route=lambda M, K, N, dtype: k6.GENERIC_KERNEL)
    with pytest.raises(AssertionError,
                       match='ran .*matmul_bn_stats_kernel.*, want '
                             'matmul_bn_stats_wgmma_kernel'):
        _run_b6_checks()


_FWD_PTXAS = '''\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_\
flash_attention_fwd_cu_6928a1a22tc26flash_fwd_acc_wgmma_kernelILi128EEEvPK13\
__nv_bfloat16S4_S4_PKfPS2_iiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 222 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_\
flash_attention_fwd_cu_6928a1a22tc22flash_fwd_wgmma_kernelILi128EEEvPK13\
__nv_bfloat16S4_S4_PS2_Pfiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 253 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_\
flash_attention_fwd_cu_6928a1a22tc22flash_fwd_wgmma_kernelILi64EEEvPK13\
__nv_bfloat16S4_S4_PS2_Pfiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 205 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_\
flash_attention_fwd_cu_6928a1a220flash_fwd_f32_kernelILi128EEEvPKfS2_S2_PfS3_\
iiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_\
flash_attention_fwd_cu_6928a1a216flash_fwd_kernelILi128EEEvPKfS2_S2_PfS3_iif' \
for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__9cd0acc9_22_\
flash_attention_fwd_cu_6928a1a220flash_fwd_f32_kernelILi64EEEvPKfS2_S2_PfS3_\
iiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
'''


def test_ptxas_report_reads_the_forward_kernel():
    """Phase a's report of bf16 K1 from nvcc's -Xptxas -v lines for the
    forward's source: each instantiation once, K4b's tensor-core kernel
    not mistaken for it."""
    assert chip_smoke.ptxas_report(_FWD_PTXAS, 'flash_fwd_wgmma_kernel') == [
        ('flash_fwd_wgmma_kernel<128>', 253, 0, 0),
        ('flash_fwd_wgmma_kernel<64>', 205, 0, 0)]


@pytest.mark.parametrize('mark,want', [
    ('flash_fwd_f32_kernel', [('flash_fwd_f32_kernel<128>', 128, 0, 0),
                              ('flash_fwd_f32_kernel<64>', 90, 0, 0)]),
    ('flash_fwd_kernel', [('flash_fwd_kernel<128>', 96, 4, 4)]),
])
def test_ptxas_report_reads_the_fp32_forward_kernel(mark, want):
    """Phase a's report of fp32 K1 from nvcc's -Xptxas -v lines for the
    forward's source: each instantiation of flash_fwd_f32_kernel once,
    with its own spills, neither mistaken for a kernel whose name holds
    flash_fwd_kernel nor that one for it."""
    assert chip_smoke.ptxas_report(_FWD_PTXAS, mark) == want


def test_ptxas_report_reads_registers_and_spills():
    log = '''ptxas info    : Compiling entry function '_ZN2tc22flash_bwd_wgmma_kernelILi128EEEvPK13__nv_bfloat16i' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc22flash_bwd_wgmma_kernelILi128EEEvPK13__nv_bfloat16i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN18flash_bwd_q_kernelILi128EfLb1EEEvPKfi' for 'sm_90a'
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tc22flash_bwd_wgmma_kernelILi64EEEvPK13__nv_bfloat16i' for 'sm_90a'
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 212 registers, used 1 barriers
'''
    assert chip_smoke.ptxas_report(log, 'flash_bwd_wgmma_kernel') == [
        ('flash_bwd_wgmma_kernel<128>', 255, 0, 0),
        ('flash_bwd_wgmma_kernel<64>', 212, 12, 8)]
    assert chip_smoke.ptxas_report(log, 'no_such_kernel') == []


_BWD_PTXAS = '''\
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__32e0028d_22_\
flash_attention_bwd_cu_2d643e7a2tc25flash_bwd_dq_wgmma_kernelILi128EEEvPK13\
__nv_bfloat16S4_S4_S4_PKfS6_PS2_iiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 216 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__32e0028d_22_\
flash_attention_bwd_cu_2d643e7a2tc26flash_bwd_dkv_wgmma_kernelILi128EEEvPK13\
__nv_bfloat16S4_S4_S4_PKfS6_PS2_S8_iiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 230 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__32e0028d_22_\
flash_attention_bwd_cu_2d643e7a2tc22flash_bwd_wgmma_kernelILi128EEEvPK13\
__nv_bfloat16S4_S4_S4_PKfS6_PfPS2_S8_iiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__32e0028d_22_\
flash_attention_bwd_cu_2d643e7a2tc25flash_bwd_dq_wgmma_kernelILi64EEEvPK13\
__nv_bfloat16S4_S4_S4_PKfS6_PS2_iiif' for 'sm_90a'
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__32e0028d_22_\
flash_attention_bwd_cu_2d643e7a2tc26flash_bwd_dkv_wgmma_kernelILi64EEEvPK13\
__nv_bfloat16S4_S4_S4_PKfS6_PS2_S8_iiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 190 registers, used 1 barriers
'''


@pytest.mark.parametrize('mark,want', [
    ('flash_bwd_dq_wgmma_kernel', [('flash_bwd_dq_wgmma_kernel<128>', 216,
                                    0, 0),
                                   ('flash_bwd_dq_wgmma_kernel<64>', 168,
                                    12, 8)]),
    ('flash_bwd_dkv_wgmma_kernel', [('flash_bwd_dkv_wgmma_kernel<128>', 230,
                                     0, 0),
                                    ('flash_bwd_dkv_wgmma_kernel<64>', 190,
                                     0, 0)]),
    ('flash_bwd_wgmma_kernel', [('flash_bwd_wgmma_kernel<128>', 255, 0,
                                 0)]),
])
def test_ptxas_report_reads_the_split_backward_kernels(mark, want):
    """Phase a's report of bf16 K3a and K3b from nvcc's -Xptxas -v lines
    for the backward's source: each instantiation once, with its own
    spills; neither is mistaken for the K2/K5 kernel, nor that one for
    them."""
    assert chip_smoke.ptxas_report(_BWD_PTXAS, mark) == want


@pytest.mark.parametrize('model', ['MODEL', 'LC_MODEL'])
@pytest.mark.parametrize('causal', [False, True])
def test_train_flops_per_token_matches_bench(model, causal):
    cfg = TransformerConfig(**getattr(chip_smoke, model))
    assert chip_smoke.train_flops_per_token(cfg, causal) == \
        bench._transformer_train_flops_per_token(cfg, causal=causal)
    if model == 'LC_MODEL' and causal:
        fl = chip_smoke.train_flops_per_token(cfg, True)
        assert round(fl / 1e9, 3) == 0.705
        assert round(fl * 2 * 8192 / 1e12, 1) == 11.5


def test_flash_arms_sets_and_restores_the_environment(monkeypatch):
    monkeypatch.setenv('PADDLE_FLASH_FWD', 'online')
    monkeypatch.delenv('PADDLE_FLASH_BWD', raising=False)
    with chip_smoke.flash_arms(*chip_smoke.LC_ARMS):
        assert (fa.fwd_arm(), fa.bwd_arm()) == ('twopass', 'onepass')
        with chip_smoke.flash_arms(None, None):
            assert (fa.fwd_arm(), fa.bwd_arm()) == ('online', 'kvmajor')
            assert 'PADDLE_FLASH_FWD' not in os.environ
        assert (fa.fwd_arm(), fa.bwd_arm()) == ('twopass', 'onepass')
    assert os.environ['PADDLE_FLASH_FWD'] == 'online'
    assert 'PADDLE_FLASH_BWD' not in os.environ


def test_counters_cover_every_flash_wrapper():
    names = {v[0] for v in chip_smoke.KERNELS.values()}
    assert names == {'flash_attention_fwd', 'flash_attention_fwd_stats',
                     'flash_attention_fwd_acc', 'flash_attention_bwd_kvmajor',
                     'flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
                     'flash_attention_bwd_onepass'}
    for name in names:
        assert getattr(fa, name).launches >= 0
    sources = {v[2] for v in chip_smoke.KERNELS.values()} | \
        {chip_smoke.PROBE_SOURCE[2], chip_smoke.K6_SOURCE[2]}
    assert sources == {'paddle_tpu_torch/csrc/%s.cu' % n
                       for n in chip_smoke.KERNEL_SOURCES}


@pytest.mark.parametrize('alone', [False, True])
def test_refuses_to_run_without_a_card_or_the_package(tmp_path, alone):
    """No CUDA device here: exit code non-zero and no result line; the
    same from a directory that holds chip_smoke.py and nothing else."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    script = os.path.join(ROOT, 'chip_smoke.py')
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / 'chip_smoke.py')
        script, cwd = str(tmp_path / 'chip_smoke.py'), str(tmp_path)
    env = dict(os.environ, PYTHONPATH='')
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=300, cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- phases h and a1-a4: the training core ------------------------------------

def test_path_check_refuses_one_plain_call_on_the_card(monkeypatch):
    monkeypatch.setattr(fa.FlashAttention, 'plain_cuda_calls', 0)
    chip_smoke.require_no_plain(fa, 't1')
    monkeypatch.setattr(fa.FlashAttention, 'plain_cuda_calls', 1)
    with pytest.raises(AssertionError, match='1 flash_attention calls ran '
                                             'the plain version'):
        chip_smoke.require_no_plain(fa, 't1')


def _adam_records(steps=7):
    """What a1 records when the schedule and the accumulators are right:
    the rate in fp32 as the program computes it, the counter, and the
    beta powers after the first two steps and the last one."""
    recs = []
    for s in range(1, steps + 1):
        r = dict(step=s, counter=s,
                 lr=float(np.float32(chip_smoke.noam_rate(s, 2048))))
        if s <= 2 or s == steps:
            for key in ('beta1', 'beta2'):
                r[key] = np.full(300, chip_smoke.ADAM[key] ** (s + 1),
                                 'float32')
        recs.append(r)
    return recs


def test_schedule_check_refuses_a_rate_off_and_a_beta_power_behind():
    """a2 holds a1's records: a rate 1e-4 off noam_decay, a Beta1Pow one
    step behind, or a counter one off fails it."""
    worst = chip_smoke.check_adam_records(_adam_records(), 2048)
    assert worst['lr'] < 1e-7 and worst['beta'] < 1e-7
    recs = _adam_records()
    recs[4]['lr'] *= 1 + 1e-4
    with pytest.raises(AssertionError, match='step 5: the rate'):
        chip_smoke.check_adam_records(recs, 2048)
    recs = _adam_records()
    recs[-1]['beta1'][17] = chip_smoke.ADAM['beta1'] ** 7
    with pytest.raises(AssertionError, match='beta1 power'):
        chip_smoke.check_adam_records(recs, 2048)
    recs = _adam_records()
    recs[3]['counter'] = 3
    with pytest.raises(AssertionError, match='counter reads 3'):
        chip_smoke.check_adam_records(recs, 2048)


def test_update_measure_forgives_flips_at_zero_and_refuses_a_wrong_step():
    """a2's update measure: Adam's lr·sign(g) step flipped where the
    gradient is rounding noise stays far inside TRAIN_UPDATE_TOL; the
    step 10% short, left out or reversed does not."""
    import torch
    rng = np.random.RandomState(2)
    g = torch.from_numpy(rng.randn(4096).astype('float32'))
    g[:40] *= 1e-4                           # within rounding of zero
    step = -1e-3 * torch.sign(g)
    flipped = step.clone()
    flipped[:40] *= -1
    grads = {'w': g}

    def measure(upd):
        return chip_smoke._first_order_diffs({'w': upd}, {'w': step},
                                             grads, ['w'])['w']
    assert measure(step) == 0.0
    assert measure(flipped) < 1e-3
    assert measure(0.9 * step) > chip_smoke.TRAIN_UPDATE_TOL
    assert measure(0 * step) == pytest.approx(1.0)
    assert measure(-step) == pytest.approx(2.0)


def test_noam_rate_is_the_schedule():
    assert chip_smoke.noam_rate(1, 2048) == pytest.approx(
        2048 ** -0.5 * 4000 ** -1.5)
    assert chip_smoke.noam_rate(4000, 2048) == pytest.approx(
        2048 ** -0.5 * 4000 ** -0.5)
    assert chip_smoke.noam_rate(16000, 2048) == pytest.approx(
        2048 ** -0.5 * 16000 ** -0.5)


@pytest.mark.parametrize('op_index', [0, 2, 8])
def test_update_check_refuses_one_element_1e3_off(op_index):
    """a3's check on the CPU against itself passes; one element of
    ParamOut 1e-3 off fails it."""
    import paddle_tpu_torch as tfluid
    rng = np.random.RandomState(0)
    op_type, inputs, attrs, outs = chip_smoke.optimizer_cases(
        rng, (40, 37))[op_index]
    got = chip_smoke.run_update(tfluid, tfluid.CPUPlace(), op_type, inputs,
                                attrs, outs)
    want = chip_smoke.run_update(tfluid, tfluid.CPUPlace(), op_type, inputs,
                                 attrs, outs)
    assert chip_smoke.check_update(op_type, got, want) == 0.0
    got[0] = got[0].clone()
    got[0].view(-1)[5] += 1e-3
    with pytest.raises(AssertionError, match='off the CPU one'):
        chip_smoke.check_update(op_type, got, want)


def test_optimizer_cases_are_the_eleven_updates():
    cases = chip_smoke.optimizer_cases(np.random.RandomState(0), (3,))
    assert [c[0] for c in cases] == [
        'sgd', 'momentum', 'adam', 'adagrad', 'decayed_adagrad', 'adamax',
        'adadelta', 'rmsprop', 'ftrl', 'proximal_gd', 'proximal_adagrad']


def test_training_op_table_covers_every_new_op_type(monkeypatch):
    """a4's table with its named exceptions covers every op type the
    port registers beyond A4_EARLIER_OPS; a case run twice on the CPU
    passes a4's check, and one fp32 output element 1e-4 off fails it.
    The dropout and truncated-normal checks pass on the CPU."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import registry
    cases = chip_smoke.training_op_cases(np.random.RandomState(1))
    assert chip_smoke.uncovered_op_types(cases) == []
    assert set(chip_smoke.A4_EARLIER_OPS) <= set(registry._REGISTRY)
    place = tfluid.CPUPlace()
    for case in cases:
        got = chip_smoke.run_op_case(tfluid, place, case)
        want = chip_smoke.run_op_case(tfluid, place, case)
        assert chip_smoke.check_op_outputs(case[0], got, want) == 0.0
    case = [c for c in cases if c[0] == 'softplus'][0]
    got = chip_smoke.run_op_case(tfluid, place, case)
    want = {n: v.copy() for n, v in got.items()}
    got['out'][1, 2] += 1e-4
    with pytest.raises(AssertionError, match='out is'):
        chip_smoke.check_op_outputs('softplus', got, want)
    monkeypatch.setattr(chip_smoke, 'DROPOUT_N', 1 << 16)
    shares = chip_smoke.check_dropout(place)
    assert all(abs(v - 0.7) < 0.01 for v in shares.values())
    chip_smoke.check_truncated_normal(place)
    chip_smoke.check_batch_size_like(place)


def test_adam_model_is_the_flagship_with_the_parallel_layers():
    """a1's LM is MODEL with TransformerConfig's own use_tp / use_sp (the
    earlier phases keep them off), and a2's parameters are its qkv, down
    and head weights under the parallel layers' names."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.models import transformer
    assert chip_smoke.MODEL['use_tp'] is False
    cfg = TransformerConfig(**chip_smoke.ADAM_MODEL)
    assert cfg.use_tp and cfg.use_sp and cfg.flash_attention
    assert cfg.dim // cfg.heads == 128 and cfg.layers == 12
    small = dict(chip_smoke.ADAM_MODEL, vocab=64, dim=32, heads=2, ffn=64,
                 max_len=16)
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        toks = tfluid.layers.data(name='t', shape=[1, 16, 1], dtype='int64',
                                  append_batch_size=False)
        trunk = transformer.language_model_trunk(
            toks, transformer.TransformerConfig(**small))
        tfluid.layers.fused_softmax_cross_entropy(trunk, toks, 64,
                                                  name='lm_head')
    params = {p.name: p for p in prog.global_block().all_parameters()}
    for name in chip_smoke.ADAM_PARAMS_COMPARED:
        assert len(params[name].shape) == 2, name
    assert params['layer0_qkv.w_0'].shape == (3 * 32,)


# -- x1-x4: the captured path -----------------------------------------------------

def test_captured_path_phases_exist_run_in_order_and_fail_the_run():
    """x1-x5 are phases (a failure is a PhaseError, which main() turns
    into exit 1 with no result line), called by main() in this order:
    x2 after g on the serving predictor; x1 (Momentum) and x3 after t4;
    x4 before a1; x1 (Adam) after a2; x5 after b6 on r1's executor,
    before r2 closes it; x1 (ResNet-50) after r4; x1 (long-context)
    after l3."""
    import inspect
    for fn, name in ((chip_smoke.check_captured_steps, 'x1'),
                     (chip_smoke.check_serving_capture, 'x2'),
                     (chip_smoke.check_cache_key, 'x3'),
                     (chip_smoke.remat_steps, 'x4'),
                     (chip_smoke.check_second_shape, 'x5')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * len(inspect.signature(fn).parameters))
    src = inspect.getsource(chip_smoke.main)
    order = ['profile_path(', 'check_serving_capture(', 'profile_train(',
             "'the Momentum step", 'check_cache_key(', 'remat_steps(',
             'adam_steps(', 'check_adam_step(', "'the Adam step'",
             'check_k6(', 'check_second_shape(', 'check_resnet_plain_step(',
             'profile_resnet(', "'the ResNet-50 step'", 'lc_steps(',
             'profile_lc(', "'the long-context step"]
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    last = src[src.rindex('log(json.dumps({'):]
    assert "'ok': True" in last and "'platform': 'gpu'" in last


def _x_run_of(losses, state, compiled=(1, 1)):
    return dict(losses=list(losses), state=state, ms=1.0, compiled=compiled)


def test_x1_check_holds_the_captured_run_to_the_eager_one():
    r = np.random.RandomState(0)
    saved = {'w': torch.from_numpy(r.randn(8, 8).astype('f4'))}
    after = {'w': saved['w'] + 0.01 * torch.from_numpy(
        r.randn(8, 8).astype('f4'))}
    eager = _x_run_of([2.0, 1.9, 1.8], after)
    same = _x_run_of([2.0, 1.9, 1.8], {'w': after['w'].clone()})
    assert chip_smoke.check_x1('t', eager, same, saved, ['w'], 1,
                               'max')[2] is True
    with pytest.raises(AssertionError, match='disagree'):
        chip_smoke.check_x1('t', eager, _x_run_of([2.0, 1.9, 1.82], after),
                            saved, ['w'], 1, 'max')
    off = {'w': saved['w'] + 1.1 * (after['w'] - saved['w'])}
    with pytest.raises(AssertionError, match='disagree'):
        chip_smoke.check_x1('t', eager, _x_run_of(eager['losses'], off),
                            saved, ['w'], 1, 'max')
    grads = {'w': torch.ones(8, 8)}
    with pytest.raises(AssertionError, match='disagree'):
        chip_smoke.check_x1('t', eager, _x_run_of(eager['losses'], off),
                            saved, ['w'], 1, 'weighted', grads)
    # r2's rule: a second eager run as far off forgives it
    loose = chip_smoke.check_x1('t', eager, _x_run_of(eager['losses'], off),
                                saved, ['w'], 1, 'spread',
                                eager2=_x_run_of(eager['losses'], off))
    assert loose[1]['w'] == pytest.approx(0.1, rel=1e-3)
    with pytest.raises(AssertionError, match='segments captured'):
        chip_smoke.check_x1('t', eager, _x_run_of(eager['losses'], after,
                                                  (1, 2)),
                            saved, ['w'], 1, 'max')


def test_x2_to_x4_checks_refuse_what_they_bound():
    good = {'prepared_programs': 2, 'compiled_segments': 2,
            'segment_misses': 2, 'segment_hits': 40}
    chip_smoke.check_decode_stats(good)
    for key, value in (('compiled_segments', 1), ('prepared_programs', 3),
                       ('segment_misses', 4), ('segment_hits', 0)):
        with pytest.raises(AssertionError):
            chip_smoke.check_decode_stats(dict(good, **{key: value}))
    names = {chip_smoke.KERNELS[k][0]: k for k in chip_smoke.KERNELS}
    zero = {n: 0 for n in names}
    kv = dict(zero, flash_attention_bwd_kvmajor=12)
    split = dict(zero, flash_attention_bwd_dq=12, flash_attention_bwd_dkv=12)
    chip_smoke.check_arm_launches(kv, split, 12)
    with pytest.raises(AssertionError):
        chip_smoke.check_arm_launches(kv, dict(split,
                                               flash_attention_bwd_kvmajor=12),
                                      12)
    chip_smoke.check_replaced_weight(4.5, 4.5, 4.6)
    with pytest.raises(AssertionError):
        chip_smoke.check_replaced_weight(4.6, 4.5, 4.6)   # the old weight
    upd = {n: torch.ones(3) for n in chip_smoke.PARAMS_COMPARED}
    runs = {None: dict(losses=[3.0, 2.9], updates=upd,
                       per_step=dict(zero, flash_attention_fwd=12,
                                     flash_attention_bwd_kvmajor=12))}
    for policy in ('nothing', 'dots'):
        runs[policy] = dict(losses=[3.0, 2.9], updates=upd,
                            per_step=dict(zero, flash_attention_fwd=24,
                                          flash_attention_bwd_kvmajor=12))
    chip_smoke.check_remat(runs, 12)
    runs['dots']['per_step']['flash_attention_fwd'] = 12
    with pytest.raises(AssertionError, match='K1'):
        chip_smoke.check_remat(runs, 12)
    runs['dots']['per_step']['flash_attention_fwd'] = 24
    runs['nothing']['losses'] = [3.0, 2.88]
    with pytest.raises(AssertionError, match='beyond'):
        chip_smoke.check_remat(runs, 12)


def test_remat_dropout_check_passes_on_the_cpu_and_refuses_a_new_mask(
        monkeypatch):
    """x4's dropout check on the CPU (eager): the recompute's mask is the
    forward's in every run; with a recompute generator of its own seed
    whose state is not set from the forward's (another mask), the check
    fails."""
    import torch
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import executor as texecutor
    shares, stats = chip_smoke.check_remat_dropout(tfluid, tfluid.CPUPlace())
    assert len(shares) == 4 and stats['compiled_segments'] == 0
    pair = texecutor.Executor._remat_generators

    class Unset(torch.Generator):
        def set_state(self, state):
            return self

    def other_recompute_generator(self, program, op):
        fwd, _ = pair(self, program, op)
        other = Unset()
        other.manual_seed(99)
        return fwd, other
    monkeypatch.setattr(texecutor.Executor, '_remat_generators',
                        other_recompute_generator)
    with pytest.raises(AssertionError):
        chip_smoke.check_remat_dropout(tfluid, tfluid.CPUPlace())


# -- the launch counts of a replay, held to the profiler --------------------------

def test_launch_groups_name_every_kernel_a_wrapper_launches():
    """Each kernel a wrapper launches once a call, by the name the
    profiler gives it, falls in its wrapper's group; other kernels (K6's
    column sums, PyTorch's own) fall in none."""
    group = chip_smoke.launch_group
    assert group('void tc::flash_fwd_wgmma_kernel<128>(__nv_bfloat16 '
                 'const*, float*, int)') == 'K1'
    assert group('void flash_fwd_f32_kernel<64>(float const*)') == 'K1'
    assert group('void tc::flash_fwd_stats_wgmma_kernel<128>(x)') == 'K4a'
    assert group('void flash_fwd_acc_kernel<64>(float const*)') == 'K4b'
    assert group('void tc::flash_bwd_wgmma_kernel<128>(x)') == 'K2/K5'
    assert group('void flash_bwd_kv_kernel<64, float, true>(x)') == 'K2/K5'
    assert group('void flash_bwd_q_kernel<64, float, true>(x)') == 'K2/K5'
    assert group('void flash_bwd_q_kernel<64, float, false>(x)') == 'K3a'
    assert group('void flash_bwd_kv_kernel<64, float, false>(x)') == 'K3b'
    assert group('void tc::flash_bwd_dq_wgmma_kernel<128>(x)') == 'K3a'
    assert group('void tc::flash_bwd_dkv_wgmma_kernel<128>(x)') == 'K3b'
    assert group('void tc::matmul_bn_stats_wgmma_kernel<128>(CUtensorMap)'
                 ) == 'K6'
    assert group('void matmul_bn_stats_kernel<float>(float const*)') == 'K6'
    assert group('column_sums_kernel(float const*, float const*)') is None
    assert group('void at::native::vectorized_elementwise_kernel<4, '
                 'at::native::FillFunctor<float> >(int)') is None
    assert group('Memcpy DtoD (Device -> Device)') is None
    counts = chip_smoke.wrapper_counts()
    assert set(counts) == {n for names in chip_smoke.LAUNCH_GROUPS.values()
                           for n in names}


def test_replay_launch_check_refuses_a_mismatch_and_no_events(monkeypatch):
    """The counts a replay adds back must be what the profiler saw
    launch; with no device event in any window (the CPU) the check
    fails rather than pass unchecked."""
    before = {n: 0 for names in chip_smoke.LAUNCH_GROUPS.values()
              for n in names}
    after = dict(before, flash_attention_fwd=12,
                 flash_attention_bwd_kvmajor=12)
    assert chip_smoke.launch_mismatch({'K1': 12, 'K2/K5': 12}, before,
                                      after) == {}
    assert chip_smoke.launch_mismatch({'K1': 12}, before, after) == \
        {'K2/K5': (0, 12)}
    assert chip_smoke.launch_mismatch(
        {'K1': 12, 'K2/K5': 12, 'K6': 1}, before, after) == {'K6': (1, 0)}
    calls, waits = [], []
    monkeypatch.setattr(chip_smoke.time, 'sleep', waits.append)
    with pytest.raises(AssertionError, match='no device events'):
        chip_smoke.check_replay_launches('t', lambda: calls.append(1),
                                         lambda: None)
    assert len(calls) == chip_smoke.DEVICE_MS_WINDOWS
    assert waits == [p for p in chip_smoke.WINDOW_PADS_S for _ in (0, 1)]


@pytest.mark.parametrize('windows,want', [
    ([3, 4], 2),                  # a shortfall, then every launch
    ([3] * chip_smoke.DEVICE_MS_WINDOWS, 'all'),  # every window short
    ([5], 1),                     # a launch the wrappers did not count
])
def test_replay_launch_check_retries_a_shortfall_only(monkeypatch, windows,
                                                      want):
    """A window that saw fewer K1 launches than the 4 counted is taken
    again, padded longer, and passes once a window sees all 4; a
    shortfall in every window fails after DEVICE_MS_WINDOWS windows, and
    a launch more than counted fails at once."""
    import contextlib
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    seen_windows = list(windows)
    pads, steps = [], []
    counts = {n: 0 for names in chip_smoke.LAUNCH_GROUPS.values()
              for n in names}

    def step():
        steps.append(1)
        counts['flash_attention_fwd'] += 4

    @contextlib.contextmanager
    def window(pad):
        pads.append(pad)
        n = seen_windows.pop(0)
        yield SimpleNamespace(key_averages=lambda: [SimpleNamespace(
            device_type=DeviceType.CUDA, key='K1', count=n)])
    monkeypatch.setattr(chip_smoke, 'device_window', window)
    monkeypatch.setattr(chip_smoke, 'launch_group', lambda key: key)
    monkeypatch.setattr(chip_smoke, 'wrapper_counts', lambda: dict(counts))
    if want == 2:
        assert chip_smoke.check_replay_launches('t', step, lambda: None) == \
            {'K1': 4}
    else:
        with pytest.raises(AssertionError, match='other launches'):
            chip_smoke.check_replay_launches('t', step, lambda: None)
    n = chip_smoke.DEVICE_MS_WINDOWS if want == 'all' else want
    assert pads == list(chip_smoke.WINDOW_PADS_S[:n]) and len(steps) == n


def test_seeded_dropout_check_passes_on_the_cpu_and_refuses_a_new_mask(
        monkeypatch):
    """x4's seeded dropout on the CPU: the same mask in every run and op
    by op; where the op's seed is not honoured (each run draws anew),
    the check fails."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import executor as texecutor
    share, stats = chip_smoke.check_seeded_dropout(tfluid, tfluid.CPUPlace())
    assert 0.4 < share < 0.6 and stats['compiled_segments'] == 0
    gen = torch.Generator()
    gen.manual_seed(5)
    monkeypatch.setattr(texecutor.EmitContext, 'generator',
                        lambda self, op: gen)
    with pytest.raises(AssertionError, match='same mask'):
        chip_smoke.check_seeded_dropout(tfluid, tfluid.CPUPlace())


def test_x5_check_refuses_what_it_bounds():
    params = ['w']
    upd = {'w': torch.ones(4)}
    runs = {k: (2.0, upd) for k in ('big', 'big again', 'small captured',
                                    'small replayed', 'small op by op')}
    stats0 = {'prepared_programs': 1, 'compiled_segments': 1}
    stats = {'prepared_programs': 1, 'compiled_segments': 2}
    out = chip_smoke.check_second_shape_runs(runs, params, 1, stats0, stats,
                                             50.0)
    assert all(v == (0.0, 0.0, True) for v in out.values())
    for bad in (dict(runs, **{'big again': (2.5, upd)}),
                dict(runs, **{'small replayed': (2.0,
                                                 {'w': 1.1 * upd['w']})})):
        with pytest.raises(AssertionError, match='beyond'):
            chip_smoke.check_second_shape_runs(bad, params, 1, stats0, stats,
                                               50.0)
    with pytest.raises(AssertionError, match='prepared'):
        chip_smoke.check_second_shape_runs(
            runs, params, 1, stats0, dict(stats, prepared_programs=2), 50.0)
    with pytest.raises(AssertionError, match='reserved'):
        chip_smoke.check_second_shape_runs(runs, params, 1, stats0, stats,
                                           chip_smoke.RESNET_PEAK_GB + 1)


# -- n1-n3, s1, i1, i2: bench.py's accelerator ResNet-50 and its serving ------

def test_new_resnet_phases_exist_run_in_order_and_fail_the_run():
    """n1-n3, i2, s1 and i1 are phases (a failure is a PhaseError, which
    main() turns into exit 1 with no result line). main() closes r1's
    executor (drop_graphs: Executor.close()) before n1, runs n1, n3, n2
    and i2 under N1_FLAGS, then s1 and i1, before the long-context LM."""
    import inspect
    for fn, name in ((chip_smoke.nhwc_steps, 'n1'),
                     (chip_smoke.check_nhwc_vs_nchw, 'n2'),
                     (chip_smoke.profile_nhwc, 'n3'),
                     (chip_smoke.s2d_steps, 's1'),
                     (chip_smoke.inference_leg, 'i1'),
                     (chip_smoke.check_nan_inf_mode, 'i2')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * len(inspect.signature(fn).parameters))
    src = inspect.getsource(chip_smoke.main)
    order = ["'the ResNet-50 step'", 'rtr.drop_graphs()', 'del rtr',
             'with flags_set(N1_FLAGS):', 'nhwc_steps(', 'profile_nhwc(',
             'check_nhwc_vs_nchw(', 'check_nan_inf_mode(', 'del ntr',
             's2d_steps(', 'inference_leg(', 'lc_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)


def test_n1_sets_bf16_param_grads_leaves_the_fused_flag_off_and_restores():
    """N1_FLAGS is bench.py's accelerator setting (main :524-527, and the
    fused flag at its default); under it the port builds bench.py's
    NHWC ResNet-50, which check_nhwc_program accepts, and the flags come
    back after the block. r1's fused NCHW program is refused."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import unique_name as tunique_name
    assert chip_smoke.N1_FLAGS == {'FLAGS_use_pallas_fused_ops': False,
                                   'FLAGS_amp_bf16_param_grads': True}
    before = tfluid.get_flags(['use_pallas_fused_ops',
                               'amp_bf16_param_grads'])
    tfluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
    old_gen = tunique_name.switch()
    try:
        with chip_smoke.flags_set(chip_smoke.N1_FLAGS):
            assert tfluid.get_flag('amp_bf16_param_grads') is True
            assert tfluid.get_flag('use_pallas_fused_ops') is False
            main = chip_smoke.resnet_program(nhwc=True)[0]
        assert tfluid.get_flag('use_pallas_fused_ops') is True
        assert tfluid.get_flag('amp_bf16_param_grads') is False
        assert chip_smoke.check_nhwc_program(main) > 500
        fused = chip_smoke.resnet_program()[0]
        with pytest.raises(AssertionError, match='not bench'):
            chip_smoke.check_nhwc_program(fused)
    finally:
        tfluid.set_flags(before)
        tunique_name.switch(old_gen)


def _nan_program():
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import unique_name as tunique_name
    main, startup = tfluid.Program(), tfluid.Program()
    old_gen = tunique_name.switch()
    try:
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data(name='image', shape=[3, 8, 8],
                                   dtype='float32')
            h = tfluid.layers.transpose(x, perm=[0, 2, 3, 1])
            y = tfluid.layers.conv2d(h, 4, 3, padding=1, bias_attr=False,
                                     data_format='NHWC')
            loss = tfluid.layers.mean(y)
    finally:
        tunique_name.switch(old_gen)
    return main, startup, loss


def test_i2_check_names_the_first_reader_and_fails_without_an_error():
    """check_nan_error on the CPU: the port's OpExecutionError names the
    transpose that first reads the image; a run that raises nothing
    fails the phase; any other exception is not caught."""
    import paddle_tpu_torch as tfluid
    main, startup, loss = _nan_program()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    bad = np.ones((2, 3, 8, 8), 'float32')
    bad[1, 2, 3, 4] = np.nan

    def run(x):
        return exe.run(main, feed={'image': x}, fetch_list=[loss],
                       scope=scope)
    with chip_smoke.flags_set({'FLAGS_check_nan_inf': True}):
        msg = chip_smoke.check_nan_error(main, 'image', lambda: run(bad))
        assert "op #0 'transpose2'" in msg
        with pytest.raises(AssertionError, match='raised no'):
            chip_smoke.check_nan_error(main, 'image',
                                       lambda: run(np.ones_like(bad)))

    def other():
        raise ValueError('not the check')
    with pytest.raises(ValueError, match='not the check'):
        chip_smoke.check_nan_error(main, 'image', other)
    # without the flag the NaN flows through and nothing is raised
    assert np.isnan(run(bad)[0]).all()


def test_i1_fold_check_passes_on_the_cpu_and_refuses_a_wrong_fold(
        tmp_path, monkeypatch):
    """i1 at a small size on the CPU: the folded predictor has no
    batch_norm and one more elementwise_add for each, its output within
    INFER_TOL of the unfolded one's, its clone the same bits; a fold that
    forgets the bias fails."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
    from paddle_tpu_torch.transpiler import inference_transpiler as itr
    place = tfluid.CPUPlace()
    name = chip_smoke.inference_model(str(tmp_path), place, 2, 32, 10, 18,
                                      chip_smoke.SEED)
    img = np.random.RandomState(0).rand(2, 3, 32, 32).astype('float32')

    def predictors():
        return (AnalysisPredictor(AnalysisConfig(str(tmp_path), place=place)),
                AnalysisPredictor(AnalysisConfig(str(tmp_path), place=place)
                                  .switch_ir_optim(False)))
    assert name == 'image'
    err, cf, cp = chip_smoke.check_fold(*predictors(), img)
    assert err <= chip_smoke.INFER_TOL and cp['batch_norm'] == 20
    assert cf == dict(cp, batch_norm=0,
                      elementwise_add=cp['elementwise_add'] + 20)
    fold = itr.InferenceTranspiler._fold

    def no_bias(self, block, scope, i, conv_op, bn_op):
        fold(self, block, scope, i, conv_op, bn_op)
        b = conv_op.single_input('Filter') + '.bn_fold_bias'
        scope.set_var(b, scope.find_var(b) * 0)
    monkeypatch.setattr(itr.InferenceTranspiler, '_fold', no_bias)
    with pytest.raises(AssertionError, match='disagrees'):
        chip_smoke.check_fold(*predictors(), img)


def test_s2d_filter_and_the_fp64_statistics_are_exact_yardsticks():
    """s1's filter retiling round-trips every tap of the 7x7 filter, and
    n2's fp64 batch statistics equal batch_norm's own within fp32."""
    from paddle_tpu_torch.ops import nn_ops
    w = torch.randn(4, 3, 7, 7, dtype=torch.float64)
    w4 = chip_smoke.s2d_filter(w)
    assert w4.shape == (4, 12, 4, 4)
    assert torch.count_nonzero(w4) == torch.count_nonzero(w) == 4 * 3 * 49
    assert torch.equal(torch.sort(w4[w4 != 0]).values,
                       torch.sort(w.flatten()).values)
    x = torch.randn(4, 5, 6, 7)
    for axes in ((0, 2, 3), (0, 1, 2)):
        m, v = nn_ops._bn_batch_stats(x, axes)
        m2, v2 = chip_smoke._bn_batch_stats_fp64(x, axes)
        assert m2.dtype == v2.dtype == torch.float32
        np.testing.assert_allclose(m2.numpy(), m.numpy(), atol=1e-6)
        np.testing.assert_allclose(v2.numpy(), v.numpy(), rtol=1e-5)


# -- v1-v6: paged serving, preemption, speculation, weight swap ---------------

def test_margin_rule_passes_equal_streams_and_near_ties_only():
    """Equal streams pass; streams that first differ where the reference
    path's logits for both tokens are within MARGIN_TOL of the best pass
    (index and gap returned); a divergence outside it fails, and inside
    a phase that failure is the phase's."""
    ref, same = [5, 9, 2, 7], [5, 9, 2, 7]
    logits = np.zeros(16)
    logits[2], logits[3] = 4.0, 4.0 - 0.5 * chip_smoke.MARGIN_TOL
    seen = []

    def logits_at(i):
        seen.append(i)
        return logits
    assert chip_smoke.margin_rule(ref, same, logits_at) is None
    assert seen == []
    i, gap = chip_smoke.margin_rule(ref, [5, 9, 3, 1], logits_at)
    assert (i, seen) == (2, [2])
    assert gap == pytest.approx(0.5 * chip_smoke.MARGIN_TOL)
    logits[3] = 4.0 - 2 * chip_smoke.MARGIN_TOL
    with pytest.raises(AssertionError, match='outside the margin rule'):
        chip_smoke.margin_rule(ref, [5, 9, 3, 1], logits_at)
    with pytest.raises(AssertionError, match='streams of 4 and 3'):
        chip_smoke.margin_rule(ref, ref[:3], logits_at)
    held = chip_smoke.phase('v1: a stand-in')(chip_smoke.margin_rule)
    with pytest.raises(chip_smoke.PhaseError, match='phase v1: '):
        held(ref, [5, 9, 3, 1], logits_at)


def test_paged_phases_exist_run_in_order_and_fail_the_run():
    """v1-v6 are phases, called by main() after x2 on the serving
    predictor's weights and before the LM is freed."""
    import inspect
    for fn, name in ((chip_smoke.paged_serving, 'v1'),
                     (chip_smoke.prefix_sharing, 'v2'),
                     (chip_smoke.preemption, 'v3'),
                     (chip_smoke.speculative, 'v4'),
                     (chip_smoke.weight_swap, 'v5'),
                     (chip_smoke.paged_timing, 'v6')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * len(inspect.signature(fn).parameters))
    src = inspect.getsource(chip_smoke.main)
    order = ['check_serving_capture(', 'paged_serving(', 'prefix_sharing(',
             'preemption(', 'speculative(', 'weight_swap(', 'paged_timing(',
             'del pred, dec, pdec', 'train_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)


def test_trainer_and_obs_phases_exist_run_in_order_and_fail_the_run():
    """tr1-tr4 and o1-o2 are phases (a failure is a PhaseError, which
    main() turns into exit 1 with no result line), called by main() in
    this order after x4 and before the Adam LM."""
    import inspect
    for fn, name in ((chip_smoke.trainer_steps, 'tr1'),
                     (chip_smoke.trainer_resume, 'tr2'),
                     (chip_smoke.trainer_faults, 'tr3'),
                     (chip_smoke.trainer_test_and_infer, 'tr4'),
                     (chip_smoke.trainer_telemetry, 'o1'),
                     (chip_smoke.serving_slo, 'o2')):
        n = len([p for p in inspect.signature(fn).parameters.values()
                 if p.default is p.empty])
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * n)
    src = inspect.getsource(chip_smoke.main)
    order = ['remat_steps(', 'trainer_steps(', 'trainer_resume(',
             'trainer_faults(', 'trainer_test_and_infer(',
             'trainer_telemetry(', 'serving_slo(', 'adam_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    # the scratch directories (serving model, checkpoints, obs logs) go
    # however main() ends
    assert 'remove_scratch()' in src[src.index('except PhaseError'):]


def test_the_lm_helper_is_lmrun_and_fluid_trainer_is_the_ports():
    """The step helper of t1-t4, a1, l1 and x1-x4 is LMRun (it was named
    Trainer, which shadowed fluid.Trainer); each phase still builds it
    with the same arguments, and ResNetTrainer still extends it."""
    import inspect
    import paddle_tpu_torch as tfluid
    assert not hasattr(chip_smoke, 'Trainer')
    assert issubclass(chip_smoke.ResNetTrainer, chip_smoke.LMRun)
    assert tfluid.Trainer.__module__ == 'paddle_tpu_torch.trainer'
    src = inspect.getsource(chip_smoke)
    for call in ("LMRun(cfg, place, TRAIN_BATCH, HEAD_CHUNK, 'tfm_reader')",
                 "LMRun(cfg, place, TRAIN_BATCH, HEAD_CHUNK, 'adam_reader',",
                 'LMRun(cfg, place, LC_BATCH, LC_HEAD_CHUNK, LC_READER)',
                 'LMRun(TransformerConfig(remat=policy, **MODEL), place,'):
        assert src.count(call) == 1, call
    # every other Trainer built is the port's
    assert sorted(re.findall(r'(\S*)Trainer\(', src)) == \
        ['ResNet'] * src.count('ResNetTrainer(') + \
        ['fluid.'] * src.count('fluid.Trainer(')
    assert list(inspect.signature(chip_smoke.LMRun).parameters) == \
        ['cfg', 'place', 'batch', 'head_chunk', 'reader_name', 'adam']


def test_trainer_phase_checks_refuse_what_they_bound(monkeypatch):
    """tr2/tr3's same-bits rule refuses one loss one ulp off; tr1/tr2's
    launch check refuses a step one launch short; the disk check fails,
    stating the numbers, where fewer checkpoints fit than asked."""
    import shutil
    losses = {s: np.float32(1.5 + s).item() for s in range(8)}
    chip_smoke.same_bits('ok', dict(losses), losses, range(8))
    off = dict(losses)
    off[6] = float(np.nextafter(np.float32(off[6]), np.float32(9)))
    with pytest.raises(AssertionError, match=r'\(6, '):
        chip_smoke.same_bits('tr2', off, losses, range(4, 8))
    run = {'launches': {0: {'flash_attention_fwd': 12,
                            'flash_attention_bwd_kvmajor': 12,
                            'flash_attention_bwd_dq': 0}}}
    kinds = ('flash_attention_fwd', 'flash_attention_bwd_kvmajor')
    chip_smoke.check_step_launches('tr1', run, 12, kinds)
    run['launches'][1] = dict(run['launches'][0],
                              flash_attention_bwd_kvmajor=11)
    with pytest.raises(AssertionError, match='step 1'):
        chip_smoke.check_step_launches('tr1', run, 12, kinds)

    class Usage(object):
        free = 10 * 10 ** 9
    monkeypatch.setattr(shutil, 'disk_usage', lambda root: Usage())
    chip_smoke.check_disk('/x', 3 * 10 ** 9, 3)
    with pytest.raises(AssertionError, match='10000000000 bytes free'):
        chip_smoke.check_disk('/x', 6 * 10 ** 9, 3)


def test_trainer_phases_run_on_the_cpu_at_a_tiny_width(tmp_path):
    """tr2-tr4 end to end on the CPU at a tiny width (vocab 64, dim 32, 2
    layers, max_len 16), on the plain versions: the killed run resumed
    to the same bits, the flipped byte quarantined, tr3's events and
    bits, the Inferencer within TR4_TOL of the fp32 test program."""
    import paddle_tpu_torch as tfluid
    cfg = TransformerConfig(vocab=64, dim=32, heads=2, layers=2, ffn=64,
                            max_len=16, flash_attention=True, use_tp=False,
                            use_sp=False)
    place = tfluid.CPUPlace()
    counters = {chip_smoke.KERNELS[k][0]: getattr(fa,
                                                  chip_smoke.KERNELS[k][0])
                for k in chip_smoke.KERNELS}
    root, obs_dir = str(tmp_path / 'ck'), str(tmp_path / 'obs')

    def sync():
        pass
    tr2 = chip_smoke.trainer_resume(cfg, place, counters, root, sync)
    assert sorted(tr2['losses']) == list(range(chip_smoke.TR_STEPS))
    assert [s for s, _, _ in tr2['saves']] == [3, 7]
    assert os.path.isdir(os.path.join(root, 'tr2', 'checkpoint_1.corrupt'))
    run, tr3 = chip_smoke.trainer_faults(cfg, place, counters, root, obs_dir,
                                         tr2['losses'], tr2['ms'], sync)
    assert tr3['faults'][0] == ('retry', 1, 1)
    assert [e for e in os.listdir(obs_dir) if e.startswith('events-trainer')]
    tr4 = chip_smoke.trainer_test_and_infer(cfg, run, str(tmp_path), sync,
                                            place=place)
    assert tr4['rel'] <= chip_smoke.TR4_TOL
    assert 'trainer' not in run


# -- bk1-bk3, mo1: the book chapters and the small modules --------------------

def test_book_k6_launches_are_counted_from_the_port_program():
    """bk2's BK2_K6_PER_STEP: the 1x1 conv2d_bn ops of the fused
    resnet_cifar10(depth=32) program that _route sends to a kernel (its
    two projection shortcuts, fp32: the generic kernel)."""
    import paddle_tpu_torch as tfluid
    prev = tfluid.get_flags(['use_pallas_fused_ops'])
    tfluid.set_flags({'use_pallas_fused_ops': True})
    try:
        main = tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, tfluid.Program()):
            chip_smoke.book_image_net(tfluid)
    finally:
        tfluid.set_flags(prev)
    batch = chip_smoke.BOOK['batch']
    assert chip_smoke.book_k6_launches(main, batch) == \
        chip_smoke.BK2_K6_PER_STEP
    shapes = chip_smoke.k6_path_shapes(main, batch)
    assert shapes == {(batch * 16 * 16, 16, 32): 1, (batch * 8 * 8, 32, 64): 1}
    assert {k6._route(*s, torch.float32) for s in shapes} == \
        {k6.GENERIC_KERNEL}
    unfused = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(unfused, tfluid.Program()):
        chip_smoke.book_image_net(tfluid)
    assert chip_smoke.book_params_compared(unfused) == \
        ('conv2d_0.w_0', 'conv2d_22.w_0', 'fc_0.w_0')
    filters = [op.single_input('Filter') for op in main.global_block().ops
               if op.type == 'conv2d_bn']
    assert filters[22] == 'conv_bn_22.w_0'
    assert tuple(main.global_block().var(filters[22]).shape) == (64, 32, 1, 1)


@pytest.mark.parametrize('arr', [
    np.arange(6, dtype='float32').reshape(2, 3) / 3.0,
    np.linspace(-1, 1, 64, dtype='float32').reshape(4, 16),
    np.array([[3, -1, 7]], dtype='int64')], ids=['small', 'summarized', 'int'])
@pytest.mark.parametrize('message', ['', 'the feed'])
def test_expected_print_text_is_the_jax_packages(capfd, arr, message):
    """mo1 holds the port's print ops to expected_print_text on the card;
    here that text against what the JAX package's Print writes."""
    import paddle_tpu as jfluid
    main = jfluid.Program()
    with jfluid.program_guard(main, jfluid.Program()):
        x = jfluid.layers.data(name='x', shape=list(arr.shape[1:]),
                               dtype=arr.dtype.name)
        jfluid.layers.Print(x, message=message or None)
    capfd.readouterr()
    jfluid.Executor(jfluid.CPUPlace()).run(main, feed={'x': arr},
                                           scope=jfluid.Scope())
    err = capfd.readouterr().err
    if arr.dtype == np.int64:   # the JAX package runs with x64 off
        arr = arr.astype('int32')
    assert err == chip_smoke.expected_print_text('x', arr, message)


# -- sq1-sq4: the stacked LSTM and the sequence chapters ----------------------------

def _crf_case(seed, B=3, T=6, N=4):
    r = np.random.RandomState(seed)
    return (r.randn(B, T, N).astype('float32'),
            r.randn(N + 2, N).astype('float32'),
            np.array([6, 1, 4], 'int32'))


def _brute_best(emission, transition, L):
    import itertools
    return max(chip_smoke.path_score(emission, transition, p, L)
               for p in itertools.product(range(emission.shape[1]),
                                          repeat=L))


def test_path_scores_and_the_best_path():
    em, tr, lens = _crf_case(1)
    for b, L in enumerate(lens):
        best = chip_smoke.best_path_score(em[b], tr, L)
        assert abs(best - _brute_best(em[b], tr, L)) < 1e-9
    path = chip_smoke.cpu_viterbi(em, tr, lens)[..., 0]
    assert path.shape == (3, 6) and not path[1, 1:].any()
    for b, L in enumerate(lens):
        assert abs(chip_smoke.path_score(em[b], tr, path[b], L) -
                   chip_smoke.best_path_score(em[b], tr, L)) < 1e-5


def test_viterbi_margin_rule():
    """Equal paths pass; a path that differs from the other but ties the
    best score passes; one that scores 1e-3 below the best fails."""
    em, tr, lens = _crf_case(2)
    want = chip_smoke.cpu_viterbi(em, tr, lens)[..., 0]
    assert chip_smoke.viterbi_margin(em, tr, lens, want, want.copy()) == \
        (3, 0.0)
    # a tie: labels y and z twins (one emission at t = 0, the same
    # transitions), so a path that swaps them at t = 0 scores the same
    tied_em, tied_tr = em.copy(), tr.copy()
    y = int(want[0, 0])
    z = (y + 1) % em.shape[2]
    tied_em[0, 0, z] = tied_em[0, 0, y]
    tied_tr[:, z] = tied_tr[:, y]
    tied_tr[2 + z] = tied_tr[2 + y]
    tied = chip_smoke.cpu_viterbi(tied_em, tied_tr, lens)[..., 0]
    other = tied.copy()
    other[0, 0] = z if tied[0, 0] == y else y
    equal, worst = chip_smoke.viterbi_margin(tied_em, tied_tr, lens, other,
                                             tied)
    assert equal == 2 and worst < 1e-6
    # a worse path: its score short of the best beyond the tolerance
    worse = want.copy()
    worse[0, 2] = (worse[0, 2] + 1) % em.shape[2]
    gap = chip_smoke.best_path_score(em[0], tr, 6) - \
        chip_smoke.path_score(em[0], tr, worse[0], 6)
    assert gap > 1e-3
    with pytest.raises(AssertionError, match='below the best'):
        chip_smoke.viterbi_margin(em, tr, lens, worse, want)


def test_feed_signatures_count_padded_shapes():
    import paddle_tpu_torch as tfluid
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        tfluid.layers.data(name='w', shape=[1], dtype='int64', lod_level=1)
    lod = tfluid.create_lod_tensor
    feeds = [{'w': lod(np.ones((5, 1), 'int64'), [[2, 3]])},
             {'w': lod(np.ones((4, 1), 'int64'), [[1, 3]])},
             {'w': lod(np.ones((4, 1), 'int64'), [[2, 2]])},
             {'w': (np.ones((2, 3, 1), 'int64'), [3, 1])}]
    # padded [2, 3, 1] three times, [2, 2, 1] once
    assert chip_smoke.feed_signatures(main, feeds) == 2


def test_sq_parameters_and_update_weights():
    import torch
    import paddle_tpu_torch as tfluid
    run = chip_smoke.BookRun(tfluid.CPUPlace(), chip_smoke.stacked_lstm_build(
        dict(vocab=50, T=4, batch=2, emb=8, hid=8)), None, 2)
    params = chip_smoke.sq_params(run.main, 'embedding_', 'lstm_',
                                  'lstm_$', 'fc_$')
    assert params[0] == 'embedding_0.w_0' and params[1] == 'lstm_0.w_0'
    assert params[2].startswith('lstm_2.w') and params[3].startswith('fc_3.w')
    accs = chip_smoke._sq_accumulators(run, params, 'adam')
    assert [a.split('_moment1_')[0] for a in accs] == list(params)
    state = {n: torch.full((2,), -3.0) for n in accs}
    state.update({n: torch.full((2,), 1.0) for n in params})
    saved = {n: torch.zeros(2) for n in params}
    g = chip_smoke.sq_grad_weights(run, params, 'adam', dict(state=state),
                                   saved)
    assert all(bool((v == -3.0).all()) for v in g.values())
    g = chip_smoke.sq_grad_weights(run, params, 'sgd', dict(state=state),
                                   saved)
    assert all(bool((v == 1.0).all()) for v in g.values())


def test_sequence_phases_are_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = ['book_chapter_steps(', 'stacked_lstm_steps(',
             'sentiment_steps(', 'recommender_steps(', 'srl_steps(',
             'lc_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    assert chip_smoke.SQ1 == dict(vocab=30000, T=128, batch=64, emb=512,
                                  hid=512)
    for fn, name in ((chip_smoke.stacked_lstm_steps, 'sq1'),
                     (chip_smoke.sentiment_steps, 'sq2'),
                     (chip_smoke.recommender_steps, 'sq3'),
                     (chip_smoke.srl_steps, 'sq4')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(None, None)


def test_control_flow_and_mt_phases_are_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = ['srl_steps(', 'control_flow_steps(', 'mt_steps(', 'mt_decode(',
             'mt_contrib_steps(', 'lc_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    assert chip_smoke.MT['dict_size'] == 30000 and \
        chip_smoke.MT['hidden'] == chip_smoke.MT['word'] == 512 and \
        chip_smoke.MT['batch'] == 64 and chip_smoke.MT['beam'] == 4
    assert chip_smoke.CF1 == dict(batch=64, width=512, trips=(1, 7, 50))
    for fn, name in ((chip_smoke.control_flow_steps, 'cf1'),
                     (chip_smoke.mt_steps, 'mt1'),
                     (chip_smoke.mt_decode, 'mt2'),
                     (chip_smoke.mt_contrib_steps, 'mt3')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * len(inspect.signature(fn).parameters))


def _beam_lattice():
    """A decode of 4 rows, beam 2, 2 steps: (sentences, scores, steps)."""
    ids0 = np.array([[3, 5], [2, 7], [4, 6], [8, 9]])
    ids1 = np.array([[4, 1], [1, 0], [5, 5], [1, 2]])
    par1 = np.array([[0, 1], [0, 1], [1, 0], [0, 0]], 'int32')
    s0 = np.array([[-1.0, -1.5], [-2.0, -2.5], [-0.5, -0.7], [-3.0, -4.0]],
                  'float32')
    s1 = s0 - 1.0
    sent = np.stack([np.stack([ids0[r, par1[r]], ids1[r]], -1)
                     for r in range(4)])
    return sent, s1.copy(), [(ids0, s0, np.zeros((4, 2), 'int32')),
                             (ids1, s1, par1)]


def _copy_lattice(lat):
    sent, scores, steps = lat
    return sent.copy(), scores.copy(), [tuple(v.copy() for v in st)
                                        for st in steps]


def test_beam_margin_passes_equal_beams_and_near_ties_only():
    """beam_margin holds every step's beams and the sentences: equal
    decodes pass; a row whose sentences differ though its steps agree
    (a wrong backtrack or state shuffle) fails even at equal scores; a
    step whose beams differ ends the row only where the scores it took
    lie within the tolerance (a near tie), for at most a quarter of the
    rows; scores beyond the tolerance fail."""
    lat = _beam_lattice()
    assert chip_smoke.beam_margin('x', lat, lat) == (4, 0, 0.0)
    # the sentences of a row swapped between its beams, the scores equal
    swapped = _copy_lattice(lat)
    swapped[0][1] = swapped[0][1][::-1]
    with pytest.raises(AssertionError, match='row 1 takes the same beams'):
        chip_smoke.beam_margin('x', swapped, lat)
    # a backtrack through the wrong parent in one position
    wrong = _copy_lattice(lat)
    wrong[0][2, 0, 0] = 6 if wrong[0][2, 0, 0] != 6 else 4
    with pytest.raises(AssertionError, match='row 2 takes the same beams'):
        chip_smoke.beam_margin('x', wrong, lat)
    # a near tie at step 1 of row 0: the beams differ, the scores within
    tie = _copy_lattice(lat)
    tie[2][1][0][0] = [1, 4]
    tie[2][1][1][0] += 5e-5
    tie[0][0] = tie[0][0][::-1]
    equal, ties, rel = chip_smoke.beam_margin('x', tie, lat)
    assert (equal, ties) == (3, 1) and 0 < rel <= chip_smoke.MT_SCORE_TOL
    # the same beams taken at a score far from the other's
    far_step = _copy_lattice(tie)
    far_step[2][1][1][0, 0] -= 1e-2
    with pytest.raises(AssertionError, match='row 0, step 1'):
        chip_smoke.beam_margin('x', far_step, lat)
    # two rows of four ending at a near tie
    two = _copy_lattice(tie)
    two[2][0][2][3] = [1, 0]
    with pytest.raises(AssertionError, match='2 of 4 rows end at a near tie'):
        chip_smoke.beam_margin('x', two, lat)
    # a sentence's score beyond the tolerance
    far = _copy_lattice(lat)
    far[1][0, 0] -= 1e-3
    with pytest.raises(AssertionError, match='row 0 takes the same beams'):
        chip_smoke.beam_margin('x', far, lat)


def test_mt_program_is_the_chapters():
    """mt1's program at the chapter test's widths is the Program of
    tests/test_torch_book_mt.py (the JAX chapter's, text for text)."""
    import paddle_tpu_torch as tfluid
    import test_torch_book_mt as book
    w = dict(dict_size=book.DICT_SIZE, word=book.WORD_DIM, hidden=book.HID,
             batch=book.BATCH, lr=0.02, max_len=book.TRG_T, beam=4)
    progs = []
    for build in (lambda f: chip_smoke.mt_train_build(w)(f),
                  book.train_program):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            build(tfluid)
        progs.append(main.to_string())
    assert progs[0] == progs[1]


def test_control_flow_and_mt_phases_run_on_the_cpu_at_a_tiny_width():
    """cf1 and mt1-mt3 end to end on the CPU at tiny widths: the loop's
    host reads, the Switch's scope var, the same bits captured and op by
    op (here op by op twice), the card-vs-CPU comparisons (the CPU
    twice), beam 4 at least greedy, beam_margin."""
    import paddle_tpu_torch as tfluid
    place = tfluid.CPUPlace()

    def sync():
        pass
    cf1 = chip_smoke.control_flow_steps(place, sync, dict(batch=4, width=8,
                                                          trips=(1, 3, 6)))
    assert [r['reads'] for r in cf1['loop']['runs']] == [2, 4, 7] * 2
    assert cf1['loop']['err'] == 0.0 and cf1['select']['err'] == 0.0
    # timed both ways (at this width the difference of two runs is noise)
    assert np.isfinite([cf1['loop']['trip_ms'], cf1['loop']['eager_trip_ms']]
                       ).all()
    w = dict(dict_size=50, word=8, hidden=8, batch=4, lr=1e-2, max_len=6,
             beam=3)
    mt1 = chip_smoke.mt_steps(place, sync, w)
    assert mt1['bits'] and mt1['cpu'][0] == 0.0 and mt1['logp'][0] == 0.0
    mt2 = chip_smoke.mt_decode(mt1, place, sync, w)
    assert mt2[1]['equal'] == mt2[3]['equal'] == 4
    assert mt2[1]['ties'] == mt2[3]['ties'] == 0
    mt3 = chip_smoke.mt_contrib_steps(place, sync, w)
    assert mt3['bits'] and mt3['beams'] == (4, 0, 0.0)
    assert mt3['logp'][0] == 0.0


def test_sparse_and_detection_phases_are_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = ['mt_contrib_steps(', 'sparse_steps(', 'ssd_steps(',
             'ssd_decode(', 'lc_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    ssd = chip_smoke.SSD
    assert (ssd['hw'], ssd['classes'], ssd['batch'], ssd['max_boxes']) == \
        (300, 21, 32, 8)
    assert (ssd['base_size'], ssd['min_ratio'], ssd['max_ratio']) == \
        (300, 20, 90)
    assert ssd['aspect_ratios'] == [[2.], [2., 3.], [2., 3.], [2., 3.],
                                    [2.], [2.]]
    assert (ssd['nms_threshold'], ssd['nms_top_k'], ssd['keep_top_k'],
            ssd['score_threshold'], ssd['decode_batch']) == \
        (0.45, 400, 200, 0.01, 8)
    assert chip_smoke.FRCNN['feat'] == (1, 1024, 50, 84)
    for fn, name in ((chip_smoke.sparse_steps, 'sp1'),
                     (chip_smoke.ssd_steps, 'det1'),
                     (chip_smoke.ssd_decode, 'det2')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * (3 if name == 'det2' else 2))


def test_ssd300_maps_and_priors_at_300_px():
    """det1's network at SSD300's settings: six maps of the sizes the
    repo's pool2d gives at 300 px (conv4's 37, fc7's 18, then 9, 5, 3,
    1) and 8096 priors (4, 6, 6, 6, 4, 4 a cell)."""
    import paddle_tpu_torch as tfluid
    main = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(main, tfluid.Program()):
        out = chip_smoke.ssd_build(chip_smoke.SSD)(tfluid)
    assert [tuple(m.shape[2:]) for m in out['maps']] == \
        [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
    assert tuple(out['priors'].shape) == (8096, 4)
    assert out['confs'].shape[-1] == 21


def _dets():
    """Two images of 3 detections each (label, score, box), sorted."""
    d = np.full((4, 3, 6), -1.0)
    for b in range(4):
        for k in range(3):
            d[b, k] = [1 + k, 0.9 - 0.2 * k, 0.1 * k, 0.1, 0.2 + 0.1 * k,
                       0.3]
    return d


def test_detection_margin_passes_equal_rows_and_near_ties_only():
    """detection_margin: equal detections pass; where an image's rows
    first differ at scores within the tolerance (and not equal) it ends
    at a near tie; a different box at an equal score, a score beyond
    the tolerance, and more than a quarter of the images at ties fail."""
    want = _dets()
    assert chip_smoke.detection_margin('x', want, want) == (4, 0, 0.0)
    near = want.copy()
    near[0, 1, 1] += 3e-6                  # the same row, its score close
    assert chip_smoke.detection_margin('x', near, want)[:2] == (4, 0)
    tie = want.copy()
    tie[1, 1] = [2, 0.7 + 5e-6, 0.5, 0.5, 0.6, 0.6]   # another box
    equal, ties, worst = chip_smoke.detection_margin('x', tie, want)
    assert (equal, ties) == (3, 1) and 0 < worst <= chip_smoke.DET_SCORE_TOL
    swapped = want.copy()
    swapped[2, 0, 2:] = swapped[2, 1, 2:]      # a box swapped, score equal
    with pytest.raises(AssertionError, match='image 2, row 0'):
        chip_smoke.detection_margin('x', swapped, want)
    far = want.copy()
    far[3, 2, 1] -= 1e-3
    with pytest.raises(AssertionError, match='image 3, row 2'):
        chip_smoke.detection_margin('x', far, want)
    two = tie.copy()
    two[2, 0] = [1, 0.9 - 4e-6, 0.0, 0.0, 0.1, 0.1]
    with pytest.raises(AssertionError, match='2 of 4 images end at a near'):
        chip_smoke.detection_margin('x', two, want)


def test_rpn_label_rule_refuses_what_it_bounds():
    """rpn_label_properties: a draw of the op passes; a bg label on a
    gt's best anchor, too many fg, and a wrong target fail."""
    import paddle_tpu_torch as tfluid
    anchors = chip_smoke.frcnn_anchors(5, 6, (8.0, 16.0, 32.0), (1.0,), 8.0)
    gts = np.array([[[2, 2, 14, 14], [20, 10, 40, 30]]], 'float32')
    prog = tfluid.Program()
    with tfluid.unique_name.guard(), \
            tfluid.program_guard(prog, tfluid.Program()):
        g = tfluid.layers.data(name='g', shape=[2, 4], dtype='float32')
        labels, tgt = tfluid.layers.rpn_target_assign(
            tfluid.layers.assign(anchors), g, rpn_batch_size_per_im=16,
            rpn_fg_fraction=0.25)
    lab, tg = (np.asarray(v) for v in tfluid.Executor(
        tfluid.CPUPlace()).run(prog, feed={'g': gts},
                               fetch_list=[labels, tgt]))
    fg, n = chip_smoke.rpn_label_properties('x', anchors, gts, lab, tg, 16,
                                            0.25, 0.7, 0.3)
    assert 0 < fg <= 4 and n <= 16
    best = lab.copy()
    best[0, np.flatnonzero(lab[0] == 1)[0]] = 0
    many = lab.copy()
    many[0, :] = 1
    target = tg.copy()
    target[0, 0] += 1.0
    for bad in ((best, tg), (many, tg), (lab, target)):
        with pytest.raises(AssertionError, match='break the rule'):
            chip_smoke.rpn_label_properties('x', anchors, gts, bad[0],
                                            bad[1], 16, 0.25, 0.7, 0.3)


def test_detection_ops_check_passes_on_the_cpu_at_a_small_shape():
    """a4's detection check end to end on the CPU (both sides) at a small
    Faster R-CNN-shaped config."""
    import paddle_tpu_torch as tfluid
    fr = dict(chip_smoke.FRCNN, image=(160.0, 240.0), feat=(1, 16, 10, 15),
              pre_nms=200, post_nms=50, rois=24, align=4, pool=3,
              rpn_batch=32, gts=4, sparse=(200, 8, 40))
    assert chip_smoke.check_detection_ops(tfluid.CPUPlace(), fr) == 0.0


# -- item 6 and the MoE LM: a4's new cases, moe1, moe2, det2's DetectionMAP ----

MOE_TINY = dict(vocab=256, dim=64, heads=2, layers=2, ffn=128, max_len=64,
                flash_attention=True, use_tp=False, use_sp=False,
                moe_experts=4)
MOE2_TINY = dict(S=64, D=32, H=64, E=4, k=1, cf=2.0)
C3D_TINY = dict(chip_smoke.C3D, batch=2, frames=4, hw=8,
                convs=(('conv1a', 3, 4, 4, 8), ('conv2a', 4, 8, 4, 4)),
                pools=(('pool1', 4, 4, 8, [1, 2, 2]),
                       ('pool2', 8, 4, 4, [2, 2, 2])))
SMALL_ITEM6 = dict(c3d=C3D_TINY, seg=dict(batch=2, channels=3, hw=(12, 16)),
                   spp=dict(batch=2, channels=4, hw=13, levels=3),
                   quant=dict(shape=(2, 4, 6, 6), bits=8),
                   auc=dict(batch=64, thresholds=20, batches=3))


def test_moe_and_item6_phases_are_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = ['check_training_ops(', 'moe_steps(', 'moe_op_check(',
             'resnet_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    assert chip_smoke.MOE_MODEL == dict(chip_smoke.MODEL, moe_experts=4,
                                        layers=6)
    assert chip_smoke.MOE_WARMUP + chip_smoke.MOE_TIMED == 10
    assert chip_smoke.MOE2 == dict(S=512, D=2048, H=8192, E=4, k=1, cf=2.0)
    assert chip_smoke.C3D['batch'] == 8 and chip_smoke.SEGNET['hw'] == \
        (360, 480) and chip_smoke.SPPNET['hw'] == 13
    assert chip_smoke.AUC == dict(batch=4096, thresholds=200, batches=3)
    text = open(chip_smoke.__file__).read()

    def body(name):
        start = text.index('def %s(' % name)
        return text[start:text.index('\n\n\n', start)]
    assert 'check_item6_ops(' in body('check_training_ops')
    assert 'srl_chunk_eval(' in body('srl_steps')
    assert 'detection_map_evaluator(' in body('ssd_decode')
    for fn, name, n in ((chip_smoke.moe_steps, 'moe1', 3),
                        (chip_smoke.moe_op_check, 'moe2', 2)):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * n)


def test_a4_covers_item6_and_its_small_cases_pass_on_the_cpu():
    import paddle_tpu_torch as tfluid
    cases = chip_smoke.training_op_cases(np.random.RandomState(1))
    assert chip_smoke.uncovered_op_types(cases) == []
    for case in chip_smoke.item6_op_cases(np.random.RandomState(2)):
        got = chip_smoke.run_op_case(tfluid, tfluid.CPUPlace(), case)
        want = chip_smoke.run_op_case(tfluid, tfluid.CPUPlace(), case)
        assert chip_smoke.check_op_outputs(case[0], got, want) == 0.0


def test_item6_published_shape_check_runs_and_refuses(monkeypatch):
    """check_item6_ops end to end on the CPU (both sides) at small
    shapes; then an output 1e-3 off on one side fails it."""
    import paddle_tpu_torch as tfluid
    worst, ms = chip_smoke.check_item6_ops(tfluid.CPUPlace(), lambda: None,
                                           **SMALL_ITEM6)
    assert worst == 0.0 and 'C3D conv1a at batch 2' in ms
    run = chip_smoke.run_op_case
    calls = []

    def off(fluid, place, case, shapes=None, host=True):
        got = run(fluid, place, case, shapes, host)
        calls.append(case[0])
        if len(calls) == 1:
            got = {n: v * 1.001 if v.dtype.kind == 'f' else v
                   for n, v in got.items()}
        return got
    monkeypatch.setattr(chip_smoke, 'run_op_case', off)
    with pytest.raises(AssertionError, match='tolerance'):
        chip_smoke.check_item6_ops(tfluid.CPUPlace(), lambda: None,
                                   **SMALL_ITEM6)


def test_random_crop_check_refuses_a_fixed_draw(monkeypatch):
    import paddle_tpu_torch as tfluid
    assert chip_smoke.check_random_crop(tfluid.CPUPlace()) >= 10
    monkeypatch.setattr(torch, 'randint',
                        lambda lo, hi, size, **kw: torch.zeros(
                            size, dtype=torch.long, device=kw.get('device')))
    with pytest.raises(AssertionError, match='do not vary'):
        chip_smoke.check_random_crop(tfluid.CPUPlace())


def test_moe_phases_run_on_the_cpu_at_a_tiny_width():
    import paddle_tpu_torch as tfluid
    counters = {chip_smoke.KERNELS[k][0]: getattr(fa, chip_smoke.KERNELS[k][0])
                for k in chip_smoke.KERNELS}
    moe1 = chip_smoke.moe_steps(tfluid.CPUPlace(), counters, lambda: None,
                                MOE_TINY, 2)
    assert moe1['bits'] and len(moe1['losses']) == 10
    assert moe1['losses'][-1] < moe1['losses'][1]
    assert moe1['n_expert'] == 2 * 2 * 4 * 64 * 128 and moe1['flops'] > 0
    moe2 = chip_smoke.moe_op_check(tfluid.CPUPlace(), lambda: None,
                                   MOE2_TINY)
    assert max(moe2['diffs'].values()) == 0.0 and moe2['flips'] == 0
    assert moe2['dense_err'] == 0.0
    assert abs(moe2['flops'][8] - moe2['flops'][4]) < 0.1 * moe2['flops'][4]


def test_moe1_refuses_other_bits(monkeypatch):
    import paddle_tpu_torch as tfluid
    counters = {chip_smoke.KERNELS[k][0]: getattr(fa, chip_smoke.KERNELS[k][0])
                for k in chip_smoke.KERNELS}
    sums = chip_smoke.moe_checksums
    calls = []

    def shifted(scope, names):
        out = sums(scope, names)
        calls.append(1)
        if len(calls) == 2:
            out[names[0]] += 1
        return out
    monkeypatch.setattr(chip_smoke, 'moe_checksums', shifted)
    with pytest.raises(chip_smoke.PhaseError, match='differ from the op by'):
        chip_smoke.moe_steps(tfluid.CPUPlace(), counters, lambda: None,
                             MOE_TINY, 2)


def test_moe2_routing_rule_passes_ties_only():
    w = dict(MOE2_TINY, S=4, E=3)
    g = np.array([[0.5, 0.3, 0.2], [0.2, 0.4, 0.4], [0.6, 0.2, 0.2],
                  [0.1, 0.1, 0.8]], 'float32')
    assert chip_smoke.moe2_routing('t', g, g, w) == (0, 0)
    tie = g.copy()
    tie[1] = [0.2, 0.4 - 3e-7, 0.4 + 3e-7]     # flips inside MOE_TIE
    assert chip_smoke.moe2_routing('t', g, tie, w)[0] == 1
    far = g.copy()
    far[0] = [0.3, 0.5, 0.2]                   # a flip with a wide gap
    with pytest.raises(AssertionError, match='goes to expert'):
        chip_smoke.moe2_routing('t', g, far, w)


def test_det2_detection_map_evaluator_runs_and_refuses(monkeypatch):
    import paddle_tpu_torch as tfluid
    rng = np.random.RandomState(3)
    B, K, G = 4, 12, 3
    gt = np.zeros((B, G, 5), 'float32')
    gt[..., 0] = rng.randint(1, 3, (B, G))
    xy = rng.rand(B, G, 2) * 0.6
    gt[..., 1:3], gt[..., 3:] = xy, xy + 0.2 + 0.1 * rng.rand(B, G, 2)
    dets = np.full((B, K, 6), -1.0, 'float32')
    dets[:, :, 0] = rng.randint(1, 3, (B, K))
    dets[:, :, 1] = np.sort(rng.rand(B, K))[:, ::-1]
    xy = rng.rand(B, K, 2) * 0.7
    dets[:, :, 2:4], dets[:, :, 4:] = xy, xy + 0.2
    w = dict(chip_smoke.SSD_TINY, classes=3)
    card, diff = chip_smoke.detection_map_evaluator(tfluid.CPUPlace(), dets,
                                                    gt, w)
    assert 0.0 < card < 1.0 and diff == 0.0
    evaluate = tfluid.evaluator.DetectionMAP.eval
    calls = []

    def off(self, exe, eval_program=None):
        calls.append(1)
        return evaluate(self, exe) + (1e-3 if len(calls) == 1 else 0.0)
    monkeypatch.setattr(tfluid.evaluator.DetectionMAP, 'eval', off)
    with pytest.raises(AssertionError, match='DetectionMAP'):
        chip_smoke.detection_map_evaluator(tfluid.CPUPlace(), dets, gt, w)


# -- pf1 and rf1: the profiler and the record files ---------------------------

def test_rf1_shards_are_the_bench_tools_byte_for_byte(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    try:
        import bench_input_pipeline
    finally:
        sys.path.pop(0)
    from paddle_tpu_torch import recordio
    shape = (3, 5, 4)
    mine, want = tmp_path / 'port', tmp_path / 'jax'
    mine.mkdir()
    want.mkdir()
    paths, records = chip_smoke.write_image_shards(str(mine), 2, 70, shape,
                                                   64, seed=3)
    jpaths = bench_input_pipeline.write_shards(str(want), 2, 70, shape,
                                               seed=3)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        assert open(p, 'rb').read() == open(q, 'rb').read()
    assert recordio.verify_file(paths[0]) == (2, 70)
    assert len(records) == 140
    img, label = next(recordio.reader(paths[0])())
    import hashlib
    rec = records[hashlib.md5(img.tobytes()).hexdigest()]
    assert np.array_equal(rec[0], img) and rec[1] == int(label[0])


def _decoded_batch(tmp_path, shape=(3, 6, 6), n=24):
    from paddle_tpu_torch.recordio import ParallelImageScanner
    paths, records = chip_smoke.write_image_shards(str(tmp_path), 2, n // 2,
                                                   shape, 4)
    norm = chip_smoke.IMAGENET_NORM
    imgs, labels = [], []
    with ParallelImageScanner(paths, shape, mean=norm['mean'],
                              std=norm['std'], n_threads=2) as sc:
        for i, l in sc:
            imgs.append(i.copy())
            labels.append(l.copy())
    return np.concatenate(imgs), np.concatenate(labels), records, norm


def test_rf1_read_slot_check_holds_the_decode_and_refuses(tmp_path):
    images, labels, records, norm = _decoded_batch(tmp_path)
    assert len(images) == 24
    worst = chip_smoke.check_read_slots(images, labels, records, norm)
    assert worst <= chip_smoke.RF_IMAGE_ATOL
    # the native decode's worst case over every u8 value stays inside the
    # tolerance (x * (1/255) - mean) * (1/std) against (x/255 - mean)/std
    x = np.arange(256, dtype='f4').reshape(1, 1, 256)
    u8 = np.repeat(np.arange(256, dtype='uint8').reshape(1, 1, 256), 3, 0)
    mean = np.asarray(norm['mean'], 'f4').reshape(-1, 1, 1)
    inv = np.float32(1) / np.asarray(norm['std'], 'f4').reshape(-1, 1, 1)
    native = (x * np.float32(1 / 255.0) - mean) * inv
    assert np.abs(native - chip_smoke.normalized(u8, norm)).max() <= \
        chip_smoke.RF_IMAGE_ATOL
    bad = images.copy()
    bad[3, 1, 2, 2] += 1.5 / 255 / norm['std'][1]
    with pytest.raises(AssertionError, match='image 3 is no record'):
        chip_smoke.check_read_slots(bad, labels, records, norm)
    wrong = labels.copy()
    wrong[5] = (wrong[5] + 1) % 1000
    with pytest.raises(AssertionError, match='image 5 has label'):
        chip_smoke.check_read_slots(images, wrong, records, norm)
    off = images.copy()
    off[7] += 2e-6
    with pytest.raises(AssertionError, match='decode'):
        chip_smoke.check_read_slots(off, labels, records, norm)


K1_NAME = 'void tc::flash_fwd_wgmma_kernel<128>(tc::Params)'
K2_NAME = 'void tc::flash_bwd_wgmma_kernel<128>(tc::BwdParams)'
LM_WARM = [('fill_constant.0', 'memset_first_use'), ('mul.3', 'gemm'),
           ('flash_attention.4', K1_NAME), ('mul.5', 'gemm'),
           ('flash_attention_grad.9', K2_NAME), ('mul_grad.10', 'gemm'),
           ('momentum.12', 'axpy')]


def _pf1_trace(tmp_path, replays=2, name='pf1', maps=True):
    from test_torch_profiler import gpu_trace, write_trace
    from paddle_tpu_torch import profiler
    graph = [(None, n) for _, n in LM_WARM[1:]]
    runs = [('lm/1/aa', 'eager', LM_WARM)] + \
        [('lm/1/aa', 'replay', graph)] * replays
    trace_dir = write_trace(tmp_path, gpu_trace(runs, backward_tid=77),
                            name=name)
    op_map = profiler.kernel_op_map(trace_dir) if maps else {}
    return profiler.device_events(trace_dir, op_map)


def _host(steps, read=True):
    names = ['train_step'] * steps + ['device_segment:1(9 ops)'] * steps
    if read:
        names += ['host_op:read'] * steps
    return {'traceEvents': [{'ph': 'X', 'name': n, 'ts': 0.0, 'dur': 1.0}
                            for n in names]}


def test_pf1_count_and_label_checks_on_a_synthetic_trace(tmp_path):
    events = _pf1_trace(tmp_path)
    counted = {'K1': 3, 'K2/K5': 3}
    assert chip_smoke.check_profiled_steps(_host(3), events, counted, 1,
                                           3) == counted
    assert chip_smoke.unlabeled_flash(events) == []
    labels = [e['label'] for e in events if e['phase'] == 'replay']
    assert labels.count('flash_attention.4') == 2
    assert labels.count('flash_attention_grad.9') == 2
    share = chip_smoke.labeled_share(events)
    assert share == 1.0
    # the wrappers counted more than the trace holds: a short window
    with pytest.raises(chip_smoke.ShortWindow, match='profiled, counted'):
        chip_smoke.check_profiled_steps(_host(3), events,
                                        {'K1': 4, 'K2/K5': 3}, 1, 3)
    with pytest.raises(AssertionError, match='host_op:read'):
        chip_smoke.check_profiled_steps(_host(3, read=False), events,
                                        counted, 1, 3)
    with pytest.raises(AssertionError, match='train_step'):
        chip_smoke.check_profiled_steps(_host(2), events, counted, 1, 3)
    # replays read without the segment's map carry raw kernel names
    bare = _pf1_trace(tmp_path, name='bare', maps=False)
    bad = chip_smoke.unlabeled_flash(bare)
    assert sorted(g for g, _, _ in bad) == ['K1', 'K1', 'K2/K5', 'K2/K5']
    assert chip_smoke.labeled_share(bare) == 0.0
    assert chip_smoke.labeled_share([]) is None


def test_pf1_span_check_and_retry():
    spans = [(0.0, 100.0), (200.0, 100.0)]
    assert chip_smoke.outside_spans([(10.0, 5.0), (250.0, 40.0)], spans,
                                    1.0) == 0.0
    assert chip_smoke.outside_spans([(298.0, 2.5)], spans, 1.0) == 0.0
    assert chip_smoke.outside_spans([(150.0, 10.0)], spans, 1.0) == 50.0
    assert chip_smoke.outside_spans([(95.0, 20.0)], spans, 1.0) == 15.0
    assert chip_smoke.is_kernel_slice(K1_NAME)
    assert not chip_smoke.is_kernel_slice('Memcpy HtoD (Pinned -> Device)')
    pads = []

    def attempt(pad):
        pads.append(pad)
        if len(pads) < 3:
            raise chip_smoke.ShortWindow('short')
        return pad
    assert chip_smoke._retrying('x', attempt) == chip_smoke.WINDOW_PADS_S[2]

    def lost(pad):
        raise RuntimeError('torch.profiler saw 3 kernel launches on the '
                           'host and no device activity')
    with pytest.raises(RuntimeError, match='no device activity'):
        chip_smoke._retrying('x', lost)

    def broken(pad):
        raise RuntimeError('something else')
    pads.clear()
    with pytest.raises(RuntimeError, match='something else'):
        chip_smoke._retrying('x', lambda pad: pads.append(pad) or
                             broken(pad))
    assert len(pads) == 1


def test_pf1_and_rf1_are_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = ['profile_train(', 'profile_lm_steps(', 'check_captured_steps(',
             'rtr.drop_graphs()', 'record_file_steps(', 'nhwc_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    assert chip_smoke.RF == dict(files=8, records=128, per_chunk=64,
                                 threads=4, decode_s=2.0, warmup=3, iters=5)
    assert chip_smoke.PF_STEPS == 3
    for fn, name in ((chip_smoke.profile_lm_steps, 'pf1'),
                     (chip_smoke.record_file_steps, 'rf1')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*[None] * 4)
