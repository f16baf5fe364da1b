"""chip_smoke.py's helpers that run without a card: the attention
yardstick, the bounds of the flash kernels, the checks of K1's o and
lse, of K4b's o and of the backward's gradients, the kernel checks of
phases b and b4 run on the plain versions, the device-time classes and
the ptxas report, the FLOP count of the LM steps and the arm switch; and
the script's refusal to run without a card."""
import os
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
    """The profiler has returned an empty window for a kernel that the
    next window traced: a window with no device events is taken again
    once, and only then is the device time not measured (None). On the
    CPU every window is empty: one warm-up call and two windows."""
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    calls = []
    assert chip_smoke._device_ms(lambda: calls.append(1), iters=3) is None
    assert len(calls) == 1 + 2 * 3


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
    assert 'second launch bit-identical: flash_attention_bwd_dq yes, ' \
        'flash_attention_bwd_dkv yes ok' in out
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
])
def test_kernel_kind_classes_the_forward_kernels(name, kind):
    """t4's and l3's breakdowns give bf16 K1 (the tensor-core forward) a
    line of its own, by its demangled or mangled name; fp32 K1 and K3a,
    K3b keep the CUDA-core flash line, and K4a keeps its own."""
    assert chip_smoke._kernel_kind(name) == kind


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
'''


def test_ptxas_report_reads_the_forward_kernel():
    """Phase a's report of bf16 K1 from nvcc's -Xptxas -v lines for the
    forward's source: each instantiation once, K4b's tensor-core kernel
    not mistaken for it."""
    assert chip_smoke.ptxas_report(_FWD_PTXAS, 'flash_fwd_wgmma_kernel') == [
        ('flash_fwd_wgmma_kernel<128>', 253, 0, 0),
        ('flash_fwd_wgmma_kernel<64>', 205, 0, 0)]


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
