"""paddle_tpu_torch flash attention (kernels/flash_attention.py) against
the JAX package's Pallas kernel.

On the CPU the port runs its plain version; here it is held to the TPU
kernel `_fwd` run in Pallas interpret mode, on o and lse, at
atol=rtol=2e-5: both are fp32 and compute the same function with the
sums taken in another order. The CUDA kernel itself is held to the plain
version on the card by chip_smoke.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu.pallas import flash_attention as jax_fa
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.kernels import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The JAX package's fixture (conftest.py) resets only its own
    default programs; reset the port's too."""
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with texecutor.scope_guard(texecutor.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _qkv(seed, BH=2, T=256, d=128):
    rng = np.random.RandomState(seed)
    q = (rng.randn(BH, T, d) * 0.5).astype('float32')
    k = (rng.randn(BH, T, d) * 0.5).astype('float32')
    v = rng.randn(BH, T, d).astype('float32')
    return q, k, v


@pytest.mark.parametrize('causal', [True, False])
def test_reference_matches_pallas_forward(causal):
    q, k, v = _qkv(0 if causal else 1)
    scale = 128 ** -0.5
    o_jax, lse_jax = jax_fa._fwd(q, k, v, causal, scale, interpret=True)
    o, lse = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax)[..., 0],
                               **TOL)


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(a.reshape(1, 2, 256, 128))
               for a in _qkv(2))
    before = fa.flash_attention_fwd.launches
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention_fwd.launches == before
    want, _ = fa.flash_attention_reference(
        q.reshape(2, 256, 128), k.reshape(2, 256, 128),
        v.reshape(2, 256, 128), True, 128 ** -0.5)
    assert out.shape == (1, 2, 256, 128)
    np.testing.assert_array_equal(out.reshape(2, 256, 128).numpy(),
                                  want.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, T=64, d=64))
    before = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match='CUDA tensor'):
        fa.flash_attention_fwd(q, k, v, True, 0.125)
    assert fa.flash_attention_fwd.launches == before


def test_import_builds_nothing_and_needs_no_nvcc():
    code = ('import os, shutil\n'
            'os.environ["PATH"] = ""\n'
            'import paddle_tpu_torch\n'
            'from paddle_tpu_torch.kernels import flash_attention as fa\n'
            'from paddle_tpu_torch.kernels import build\n'
            'assert fa._fn is None and not build._libs\n'
            'assert shutil.which("nvcc") is None\n'
            'print("ok")\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
