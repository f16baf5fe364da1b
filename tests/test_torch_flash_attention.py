"""paddle_tpu_torch flash attention (kernels/flash_attention.py) against
the JAX package's Pallas kernels.

On the CPU the port runs its plain versions; here they are held to the
TPU kernels run in Pallas interpret mode: the forward `_fwd` on o and
lse, the two-pass forward `_fwd_twopass` (K4a, K4b) on lse and o, and
the backward arms `_bwd_kvmajor` (K2), `_bwd_split` (K3) and the
onepass arm of `_bwd` (K5) on dq, dk, dv, at atol=rtol=2e-5 in fp32
(the same function with the sums taken in another order) and
atol=rtol=2e-2 in bf16 (the TPU kernels round the scaled q, P and dS to
bf16 before their products; the plain versions compute in fp32). The
CUDA kernels themselves are held to the plain versions on the card by
chip_smoke.py.
"""
import inspect
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.pallas import flash_attention as jax_fa
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch.kernels import flash_attention as fa

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


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
    lse = torch.zeros(2, 64)
    for wrapper, args in ((fa.flash_attention_fwd, (q, k, v)),
                          (fa.flash_attention_fwd_stats, (q, k)),
                          (fa.flash_attention_fwd_acc, (q, k, v, lse))):
        before = wrapper.launches
        with pytest.raises(ValueError, match='CUDA tensor'):
            wrapper(*args, True, 0.125)
        assert wrapper.launches == before
    assert fa.take_extra_flops() == 0.0


def test_import_builds_nothing_and_needs_no_nvcc():
    code = ('import os, shutil\n'
            'os.environ["PATH"] = ""\n'
            'import paddle_tpu_torch\n'
            'from paddle_tpu_torch.kernels import flash_attention\n'
            'from paddle_tpu_torch.kernels import conv_bn\n'
            'from paddle_tpu_torch.kernels import build\n'
            'assert not build._fns and not build._libs\n'
            'assert shutil.which("nvcc") is None\n'
            'print("ok")\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def _qkvdo(seed, BH=2, T=256, d=128):
    q, k, v = _qkv(seed, BH, T, d)
    do = np.random.RandomState(seed + 100).randn(BH, T, d).astype('float32')
    return q, k, v, do


def _pallas_onepass(jq, jk, jv, o, lse, jdo, causal, scale):
    """The JAX package's onepass arm (K5) through `_bwd` in interpret
    mode, forced by its trace-time hook; the hook, the resolved arm and
    `_bwd`'s jit cache are restored after."""
    prev = jax_fa._FORCE_ARM, jax_fa._RESOLVED_ARM
    jax_fa._FORCE_ARM = 'onepass'
    jax_fa._bwd.clear_cache()
    try:
        out = jax_fa._bwd(jq, jk, jv, o, lse, jdo, causal, scale,
                          interpret=True)
        assert jax_fa._RESOLVED_ARM == 'onepass'
        return out
    finally:
        jax_fa._FORCE_ARM, jax_fa._RESOLVED_ARM = prev
        jax_fa._bwd.clear_cache()
        assert jax_fa._RESOLVED_ARM == prev[1]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('arm', ['kvmajor', 'split', 'onepass'])
def test_plain_backward_matches_pallas_arms(arm, causal, dtype):
    """flash_attention_bwd_reference against the TPU backward arms, on
    the same q, k, v, dO and the TPU forward's o and lse."""
    q, k, v, do = _qkvdo(4 if causal else 5)
    scale = 128 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=dtype) for a in (q, k, v, do))
    o, lse = jax_fa._fwd(jq, jk, jv, causal, scale, interpret=True)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32),
                    axis=-1, keepdims=True)
    bq, bk = jax_fa._block_sizes(256, 128)
    if arm == 'onepass':
        want = _pallas_onepass(jq, jk, jv, o, lse, jdo, causal, scale)
    else:
        run = jax_fa._bwd_kvmajor if arm == 'kvmajor' else \
            jax_fa._bwd_split
        want = run(jq, jk, jv, jdo, lse, delta, causal, scale, True, bq, bk,
                   256 // bq, 256 // bk)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    to = torch.from_numpy(np.array(o, dtype='float32')).to(tdt)
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    got = fa.flash_attention_bwd_reference(tq, tk, tv, to, tlse, tdo,
                                           causal, scale)
    tol = TOL if dtype == 'float32' else BF16_TOL
    for g, w, name in zip(got, want, ('dq', 'dk', 'dv')):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, dtype='float32'),
                                   err_msg=name, **tol)


def test_bf16_reference_matches_pallas_forward():
    q, k, v = _qkv(6)
    scale = 128 ** -0.5
    o_jax, lse_jax = jax_fa._fwd(*(jnp.asarray(a, dtype='bfloat16')
                                   for a in (q, k, v)), True, scale,
                                 interpret=True)
    o, lse = fa.flash_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), True,
        scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_jax, dtype='float32'),
                               **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax)[..., 0],
                               **BF16_TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_autograd_function_matches_plain_autograd(causal):
    """The FlashAttention Function on CPU tensors (plain forward, plain
    backward, delta outside) gives plain autograd's grads through
    flash_attention_reference."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkvdo(7, BH=2, T=96, d=64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*(t.reshape(1, 2, 96, 64) for t in leaves),
                             causal=causal)
    got = torch.autograd.grad(out, leaves, do.reshape(1, 2, 96, 64))
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want_o, _ = fa.flash_attention_reference(*ref, causal, 64 ** -0.5)
    want = torch.autograd.grad(want_o, ref, do)
    np.testing.assert_allclose(out.detach().reshape(2, 96, 64).numpy(),
                               want_o.detach().numpy(), **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)


def test_backward_wrappers_refuse_cpu_tensors():
    q, k, v, do = (torch.from_numpy(a) for a in _qkvdo(8, T=64, d=64))
    lse = torch.zeros(2, 64)
    for wrapper in (fa.flash_attention_bwd_kvmajor, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkv,
                    fa.flash_attention_bwd_onepass):
        before = wrapper.launches
        with pytest.raises(ValueError, match='CUDA tensor'):
            wrapper(q, k, v, do, lse, lse, True, 0.125)
        assert wrapper.launches == before


@pytest.mark.parametrize('arm', ['kvmajor', 'onepass'])
def test_bwd_entry_is_the_tensor_core_kernel_in_bf16(arm):
    """bf16 K2 and K5 launch one C entry point, the tensor-core kernel;
    float32 keeps each arm's CUDA-core kernel. Every entry the wrappers
    name is defined in csrc/flash_attention_bwd.cu, and the CUDA-core
    bf16 entries of K2 and K5 are gone (no fallback to them exists)."""
    assert fa._bwd_entry(arm, torch.bfloat16) == \
        'flash_attention_bwd_wgmma_bf16'
    assert fa._bwd_entry(arm, torch.float32) == \
        'flash_attention_bwd_%s_f32' % arm
    with pytest.raises(ValueError, match='split'):
        fa._bwd_entry('split', torch.bfloat16)
    src = (fa.build.CSRC_DIR / 'flash_attention_bwd.cu').read_text()
    defined = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert {fa._bwd_entry(arm, dt) for dt in fa.SUPPORTED_DTYPES} <= defined
    assert 'flash_attention_bwd_%s_bf16' % arm not in defined
    assert 'flash_bwd_wgmma_kernel<D>' in src


@pytest.mark.parametrize('wrapper,kernel', [
    ('flash_attention_bwd_dq', 'flash_bwd_dq_wgmma_kernel'),
    ('flash_attention_bwd_dkv', 'flash_bwd_dkv_wgmma_kernel')])
def test_split_entries_are_the_tensor_core_kernels_in_bf16(wrapper, kernel):
    """bf16 K3a and K3b launch the tensor-core kernels through the C entry
    points their wrappers name; float32 keeps the CUDA-core kernels, and
    no CUDA-core K3 is instantiated for bf16, so none remains to fall
    back to."""
    assert "'%s_' + _SUFFIX[q.dtype]" % wrapper in \
        inspect.getsource(getattr(fa, wrapper))
    src = (fa.build.CSRC_DIR / 'flash_attention_bwd.cu').read_text()
    bodies = dict(re.findall(r'extern "C" int (\w+)\((.*?)\n}\n', src,
                             re.S))
    bf16, f32 = bodies[wrapper + '_bf16'], bodies[wrapper + '_f32']
    assert 'hopper::launch_1d(\n        tc::%s<D>,' % kernel in bf16
    assert 'tc::' not in f32 and '<float, false>' in f32
    assert '__global__ void __launch_bounds__(kThreads, 1)\n%s(' % kernel \
        in src
    assert not re.search(r'(qmajor|kv)<__nv_bfloat16', src)
    assert not re.search(r'flash_bwd_(q|kv)_kernel<\w+,\s*__nv_bfloat16',
                         src)


def test_fwd_entry_is_the_tensor_core_kernel_in_bf16():
    """bf16 K1 launches the tensor-core kernel through its C entry
    point; float32 launches the CUDA-core kernel flash_fwd_f32_kernel,
    which is instantiated for float32 only, so no bf16 CUDA-core forward
    remains to fall back to, and the old fp32 kernel flash_fwd_kernel is
    gone."""
    src = (fa.build.CSRC_DIR / 'flash_attention_fwd.cu').read_text()
    defined = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert {'flash_attention_fwd_' + fa._SUFFIX[dt]
            for dt in fa.SUPPORTED_DTYPES} <= defined
    assert 'flash_fwd_wgmma_kernel<D>' in src
    assert 'tc::run(tc::flash_fwd_wgmma_kernel<D>' in src
    assert 'flash_fwd_kernel<D, __nv_bfloat16>' not in src
    assert not re.search(r'flash_fwd_kernel<\w+,\s*(__nv_bfloat16|Elem)>',
                         src)
    launchers = re.findall(r'\nint launch_fwd\((.*?)\n}\n', src, re.S)
    f32 = [body for body in launchers if body.startswith('const float* q')]
    assert len(f32) == 1
    assert 'hopper::launch_1d(f32::flash_fwd_f32_kernel<D>' in f32[0]
    assert 'f32::fold_point(blocks)' in f32[0]
    assert not re.search(r'\bflash_fwd_kernel\b', src)
    assert 'atomic' not in src[src.index('namespace f32 {'):
                               src.index('}  // namespace f32')]


@pytest.mark.parametrize('causal', [True, False])
def test_twopass_plain_versions_match_pallas_twopass(causal):
    """K4a's and K4b's plain versions against the TPU's two-pass forward
    `_fwd_twopass` (128 x 128 blocks) in interpret mode: lse against its
    lse, and o from the acc version, fed the TPU's lse, against its o."""
    q, k, v = _qkv(20 if causal else 21)
    scale = 128 ** -0.5
    o_jax, lse_jax = jax_fa._fwd_twopass(
        *(jnp.asarray(a) for a in (q, k, v)), causal, scale, True, 128, 128,
        256 // 128, 256 // 128)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lse = fa.flash_attention_stats_reference(tq, tk, causal, scale)
    assert lse.shape == (2, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax)[..., 0],
                               **TOL)
    o = fa.flash_attention_acc_reference(
        tq, tk, tv, torch.from_numpy(np.array(lse_jax)[..., 0]), causal,
        scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), **TOL)


def test_acc_plain_version_zeroes_the_shift_of_an_all_masked_row():
    """lse <= -5e29 marks an all-masked row: the shift is zeroed, as in
    `_fwd_acc_kernel` :303-307, so o stays finite."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(23, BH=1, T=8, d=64))
    lse = fa.flash_attention_stats_reference(q, k, True, 0.125)
    lse[0, 3] = -1e30
    o = fa.flash_attention_acc_reference(q, k, v, lse, True, 0.125)
    assert torch.isfinite(o).all()
    s = (q[0, 3] * 0.125) @ k[0, :4].T
    np.testing.assert_allclose(o[0, 3].numpy(), (torch.exp(s) @ v[0, :4])
                               .numpy(), **TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_alternative_arms_match_the_default_arms_on_cpu(monkeypatch, causal):
    """PADDLE_FLASH_FWD=twopass and PADDLE_FLASH_BWD=onepass run on CPU
    tensors (the stats and acc plain versions, the plain backward) and
    give the default arms' o and grads."""
    q, k, v, do = (torch.from_numpy(a).reshape(1, 2, 96, 64)
                   for a in _qkvdo(24, BH=2, T=96, d=64))

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=causal)
        return [out] + list(torch.autograd.grad(out, leaves, do))

    want = run()
    monkeypatch.setenv('PADDLE_FLASH_FWD', 'twopass')
    monkeypatch.setenv('PADDLE_FLASH_BWD', 'onepass')
    got = run()
    for g, w, name in zip(got, want, ('o', 'dq', 'dk', 'dv')):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   err_msg=name, **TOL)


def test_twopass_extra_flops_count_the_visited_tiles(monkeypatch):
    """The second q·kᵀ sweep of one twopass forward, as the port's tiles
    execute it (padding included): bf16 in the tensor-core kernels' 128 x
    128 tiles, fp32 in 64 x 64; the JAX package's visited-tile count with
    those bq and bk. The plain versions note nothing."""
    tiles = 64 * 65 // 2
    assert fa.twopass_extra_flops(16, 8192, 128, True) == \
        2.0 * 16 * tiles * 128 * 128 * 128
    assert fa.twopass_extra_flops(16, 8192, 128, True, torch.bfloat16) == \
        fa.twopass_extra_flops(16, 8192, 128, True)
    assert fa.twopass_extra_flops(2, 130, 64, False) == \
        2.0 * 2 * 4 * 128 * 128 * 64
    assert fa.twopass_extra_flops(1, 1, 64, True) == 2.0 * 128 * 128 * 64
    # 300 keys: q tiles 0, 1, 2 visit 1, 2, 3 k tiles
    assert fa.twopass_extra_flops(1, 300, 128, True) == \
        2.0 * 6 * 128 * 128 * 128
    tiles = 128 * 129 // 2
    assert fa.twopass_extra_flops(16, 8192, 128, True, torch.float32) == \
        2.0 * 16 * tiles * 64 * 64 * 128
    assert fa.twopass_extra_flops(2, 130, 64, False, torch.float32) == \
        2.0 * 2 * 9 * 64 * 64 * 64
    assert fa.twopass_extra_flops(1, 1, 64, True, torch.float32) == \
        2.0 * 64 * 64 * 64
    fa.take_extra_flops()
    monkeypatch.setenv('PADDLE_FLASH_FWD', 'twopass')
    q = torch.randn(1, 2, 64, 64)
    fa.flash_attention(q, q, q)
    assert fa.take_extra_flops() == 0.0
