"""chip_smoke.py's helpers that run without a card: the attention
yardstick, the bounds of the flash kernels, the FLOP count of the LM
steps and the arm switch; and the script's refusal to run without a
card."""
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
