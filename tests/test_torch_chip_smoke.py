"""chip_smoke.py's helpers that run without a card: the attention
yardstick, the bounds of the flash kernels, the checks of K4b's o and of
the backward's gradients, the device-time classes and the ptxas report,
the FLOP count of the LM steps and the arm switch; and the script's
refusal to run without a card."""
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
    ('k2', (128, 512, 128), 'bfloat16', 0.035213, 'bytes'),
    ('k3a', (128, 512, 128), 'bfloat16', 0.025197, 'bytes'),
    ('k3b', (128, 512, 128), 'bfloat16', 0.030205, 'bytes'),
])
def test_flash_bounds(kind, shape, dtype, ms, by):
    """K4a does 2 FLOP per visited score per column and writes lse only,
    K4b 4, K5 10 with 3 outputs; the earlier kernels' bounds are those
    PERF.md recorded."""
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
])
def test_kernel_kind_classes_the_backward_kernels(name, kind):
    """t4's and l3's device-time breakdowns give the tensor-core backward
    (bf16 K2 and K5) a line of its own, by its demangled name (as the
    profiler reports it) or its mangled one (as ptxas does); fp32 K5
    keeps its line."""
    assert chip_smoke._kernel_kind(name) == kind


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
