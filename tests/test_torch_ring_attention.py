"""Ring attention across ranks (paddle_tpu_torch/parallel/
ring_attention.py, the ring_attention op and layer,
TransformerConfig(ring_attention=True)), held to the JAX package on
the CPU. The port's ranks are one spawn of 4 gloo ranks
(tests/torch_mesh_worker.py); on the CPU each block runs the kernels'
plain versions (flash_attention_reference,
flash_attention_bwd_reference), as the kernels run on the card.

- tests/test_ring_attention.py::test_ring_matches_full_attention and
  ::test_ring_attention_gradients_match: forward (causal and not) and
  the gradients of sum((o - tgt)^2) on sp=4 against
  ring_attention_global, within 2e-4; both the ring x flash path and
  the plain fold; the blocks each rank computes (r + 1 under causal,
  4 without, in each direction);
- tests/test_ring_flash.py::test_ring_flash_parity_kernel_blocks: the
  ring x flash path at the JAX test's shape (Tl = 128, d = 128) against
  ring_flash_attention_global with the Pallas kernel in interpret mode;
- ::test_ring_attention_op_off_mesh_fallback: the op on one device is
  ordinary attention;
- ::test_sandbox_ctx_propagates_mesh: a sub-block's context keeps the
  parent's mesh;
- ::test_transformer_ring_attention_trains_on_dp_sp_mesh: the ring LM on
  sp=4 and on dp=2 x sp=2 within 1e-4 of the JAX package's run of the
  same Program, the K/V blocks travelling as collective-permutes.
The port keeps lse as [BH, T] (the JAX package's [BH, T, 1]).
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402
from test_torch_mesh import jax_init, jax_losses, _put  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

TOL = 2e-4
STEP_TOL = 1e-4
SP = 4


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _mesh_sp(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(1, n), ('dp', 'sp'))


def _jax_ring(q, k, v, tgt, causal, flash):
    from paddle_tpu.parallel.ring_attention import (
        ring_attention_global, ring_flash_attention_global)
    fn = ring_flash_attention_global if flash else ring_attention_global
    mesh = _mesh_sp(SP)

    def loss(q, k, v):
        o = fn(q, k, v, mesh, causal=causal)
        return jnp.sum((o - tgt) ** 2), o
    with mesh:
        g, o = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
    return [np.asarray(t) for t in (o,) + tuple(g)]


LM_CFG = dict(vocab=64, dim=16, heads=2, layers=2, ffn=32, max_len=16,
              use_tp=False, use_sp=True, ring_attention=True)


@pytest.fixture(scope='module')
def ring_runs(tmp_path_factory):
    rng = np.random.RandomState(1)
    B, H, T, dh = 1, 2, 32, 8
    inputs, oracle = {}, {}
    for s in ('q', 'k', 'v', 'tgt'):
        inputs['ring/' + s] = rng.randn(B, H, T, dh).astype('float32')
    qkvt = [jnp.asarray(inputs['ring/' + s]) for s in ('q', 'k', 'v',
                                                      'tgt')]
    for causal in (True, False):
        oracle[causal] = _jax_ring(*qkvt, causal=causal, flash=False)
    # the ring LM, from the JAX package's weights
    prog, scope, loss, params = jax_init(
        lambda F: W.lm_program(LM_CFG, F))
    _put(inputs, 'lmr', params)
    toks = np.random.RandomState(0).randint(
        0, LM_CFG['vocab'], (8, LM_CFG['max_len'], 1)).astype('int64')
    inputs['lmr/tokens'], inputs['lmr/labels'] = toks, np.roll(toks, -1, 1)
    inputs['lmr/cfg'] = np.array(','.join(
        '%s=%s' % kv for kv in LM_CFG.items()))
    oracle['lm'] = jax_losses(prog, scope, loss, [
        {'tokens': toks, 'labels': inputs['lmr/labels']}] * 3)
    runs = {}
    for mesh in ('sp=4', 'dp=2,sp=2'):
        inputs['lmr/mesh'] = np.array(mesh)
        cases = ['lm_ring'] + (['ring'] if mesh == 'sp=4' else [])
        runs[mesh] = W.spawn(tmp_path_factory.mktemp('ring'), 4, cases,
                             inputs)
    return runs, oracle


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('path', ['flash', 'fold'])
def test_ring_matches_full_attention_and_its_gradients(ring_runs, causal,
                                                       path):
    runs, oracle = ring_runs
    tag = '%s_%s' % ('causal' if causal else 'full', path)
    for rank, r in enumerate(W.results(runs['sp=4'], 'ring')):
        for name, want in zip(('o', 'dq', 'dk', 'dv'), oracle[causal]):
            np.testing.assert_allclose(r['%s/%s' % (tag, name)], want,
                                       rtol=TOL, atol=TOL, err_msg=name)
        n = rank + 1 if causal else SP
        assert list(r['%s/blocks' % tag]) == [n, n]


def test_ring_flash_parity_kernel_blocks():
    """test_ring_flash.py's kernel-block shape (Tl = 128, d = 128): the
    JAX package's ring x flash with the Pallas kernel in interpret mode
    against the port's ring x flash in one process over an sp=1 ring
    per block, folded by the same log-sum-exp merge."""
    import torch
    from paddle_tpu_torch.parallel import ring_attention as tra
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(0)
    B, H, T, d = 1, 1, 512, 128
    q, k, v = (rng.randn(B, H, T, d).astype('float32') * s
               for s in (0.3, 0.3, 1.0))
    jfluid.set_flags({'pallas_interpret': True})
    try:
        from paddle_tpu.parallel.ring_attention import \
            ring_flash_attention_global
        want = np.asarray(ring_flash_attention_global(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _mesh_sp(SP),
            causal=True))
    finally:
        jfluid.set_flags({'pallas_interpret': False})
    # the ring's blocks in one process: rank r's queries against the
    # key blocks 0..r, merged as the ring merges them
    qt, kt, vt = (torch.from_numpy(a).reshape(B * H, T, d) for a in
                  (q, k, v))
    Tl = T // SP
    outs = []
    for r in range(SP):
        qb = qt[:, r * Tl:(r + 1) * Tl]
        o, lse = fa.flash_attention_reference(
            qb, kt[:, r * Tl:(r + 1) * Tl], vt[:, r * Tl:(r + 1) * Tl],
            True, d ** -0.5)
        o = o.float()
        for src in range(r):
            ob, lb = fa.flash_attention_reference(
                qb, kt[:, src * Tl:(src + 1) * Tl],
                vt[:, src * Tl:(src + 1) * Tl], False, d ** -0.5)
            o, lse = tra.merge_partials(o, lse, ob, lb)
        outs.append(o)
    got = torch.cat(outs, 1).reshape(B, H, T, d).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ring_attention_op_off_mesh_fallback():
    """test_ring_attention.py::test_ring_attention_op_off_mesh_fallback:
    one device, the op is ordinary attention (the JAX package's op on
    the same inputs, within 1e-5)."""
    rng = np.random.RandomState(2)
    feeds = {n: rng.randn(1, 2, 8, 4).astype('float32') for n in 'qkv'}
    outs = []
    for F in (jfluid, tfluid):
        prog, startup = F.Program(), F.Program()
        with F.program_guard(prog, startup):
            q, k, v = (F.layers.data(name=n, shape=[2, 8, 4],
                                     dtype='float32') for n in 'qkv')
            out = F.parallel.layers.ring_attention(q, k, v, causal=True)
        exe = F.Executor(F.CPUPlace())
        exe.run(startup)
        outs.append(np.asarray(exe.run(prog, feed=feeds,
                                       fetch_list=[out])[0]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_sandbox_ctx_propagates_mesh():
    """test_ring_attention.py::test_sandbox_ctx_propagates_mesh: a
    sub-block's context (the port's remat re-run) keeps the parent's
    mesh."""
    from paddle_tpu_torch.executor import EmitContext
    from paddle_tpu_torch.parallel.mesh import MeshConfig

    class _Exe(object):
        device = None
        mesh = MeshConfig(sp=4).build()
        _bn_local_stats = None
    prog = tfluid.Program()
    ctx = EmitContext(_Exe(), prog, prog.global_block(), tfluid.Scope(),
                      {})
    assert ctx.mesh is _Exe.mesh
    assert ctx.sub_context(prog.global_block(), {}, None).mesh is ctx.mesh


@pytest.mark.parametrize('mesh', ['sp=4', 'dp=2,sp=2'])
def test_transformer_ring_attention_trains_on_dp_sp_mesh(ring_runs, mesh):
    runs, oracle = ring_runs
    for r in W.results(runs[mesh], 'lm_ring'):
        np.testing.assert_allclose(r['losses'], oracle['lm'],
                                   rtol=STEP_TOL)
        assert r['losses'][-1] < r['losses'][0]
        assert len(r['audit/collective-permute']) > 0
