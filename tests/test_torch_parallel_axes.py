"""Tensor, sequence and expert parallelism across ranks (the port's
parallel/layout.py rules and parallel/moe.py), held to the JAX package on
the CPU: each case's port ranks (tests/torch_mesh_worker.py, one spawn
of 4 gloo ranks) start from the JAX package's initial weights and are
compared with the JAX package running the same Program (whose sharding
annotations change layouts, never values).

- tests/test_parallel_axes.py::test_transformer_tp_sp_matches_serial:
  the tp/sp LM (use_tp, use_sp) on tp=2 x sp=2 and on dp=2 x tp=2,
  three Adam steps within 1e-4, and one step's gradient of every
  parameter within 1e-5 on both meshes and, without tp, on sp=4; each
  tp weight held as its half;
- ::test_column_row_parallel_fc_pair_matches_fc on dp=2 x tp=2: the
  output within 1e-5, the two all-reduces the pair needs (the row
  product's and the global sum's) and no all-gather of a weight;
- ::test_moe_expert_parallel_runs on dp=2 x ep=2: top-1, top-2 (with
  capacity drops: capacity_factor 1) and dense dispatch, three SGD steps
  with the aux loss within 1e-4, the experts [2, 16, 32] a rank, and
  the dispatch an all-to-all.
ZeRO-1 and ZeRO-3 (test_parallel_axes.py's last three) are in
test_torch_mesh.py with the other data-parallel cases.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402
from test_torch_mesh import jax_init, jax_losses, _put  # noqa: E402

STEP_TOL = 1e-4
TOL = 1e-5


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


def _colrow(F):
    prog, startup = F.Program(), F.Program()
    prog.random_seed = startup.random_seed = 3
    with F.program_guard(prog, startup):
        x = F.layers.data(name='x', shape=[8, 16], dtype='float32',
                          append_batch_size=False)
        x3 = F.layers.reshape(x, shape=[2, 4, 16])
        h = F.parallel.layers.column_parallel_fc(x3, 32, act='relu')
        y = F.parallel.layers.row_parallel_fc(h, 16)
        out = F.layers.reduce_sum(y)
    return prog, startup, out


@pytest.fixture(scope='module')
def axes_runs(tmp_path_factory):
    oracle, inputs = {}, {}
    # the tp/sp LM
    cfg = dict(W.LM_SMALL, use_tp=True, use_sp=True)
    prog, scope, loss, params = jax_init(
        lambda F: W.lm_program(cfg, F))
    _put(inputs, 'lm', params)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg['vocab'], (8, cfg['max_len'], 1)).astype(
        'int64')
    inputs['lm/tokens'], inputs['lm/labels'] = toks, np.roll(toks, -1, 1)
    oracle['lm'] = jax_losses(prog, scope, loss, [
        {'tokens': toks, 'labels': inputs['lm/labels']}] * 3)
    oracle['lm_shapes'] = {p.name: tuple(p.shape) for p in
                           prog.global_block().all_parameters()}
    oracle['lm_specs'] = {p.name: getattr(p, 'dist_attr', None) for p in
                          prog.global_block().all_parameters()}
    # the column/row pair
    prog, scope, out, params = jax_init(_colrow)
    _put(inputs, 'colrow', params)
    inputs['colrow/x'] = np.random.RandomState(0).rand(8, 16).astype(
        'float32')
    oracle['colrow'] = float(np.asarray(jfluid.Executor(
        jfluid.CPUPlace()).run(prog, feed={'x': inputs['colrow/x']},
                               fetch_list=[out], scope=scope)[0]))
    # MoE
    inputs['moe/x'] = np.random.RandomState(1).rand(8, 16).astype('f4')
    for tag, k, dispatch in (('moe_top1', 1, 'topk'), ('moe_top2', 2,
                                                       'topk'),
                             ('moe_dense', 1, 'dense')):
        prog, scope, loss, params = jax_init(
            lambda F: W.moe_program(F, k, dispatch))
        _put(inputs, tag, params)
        oracle[tag] = jax_losses(prog, scope, loss,
                                 [{'x': inputs['moe/x']}] * 3)
    # one step's gradients of the LM (the fetch; no optimizer step read):
    # the tp/sp config on two meshes, and use_sp without tp, where the
    # attention's products see sp-sharded queries and keys
    res = {}
    for mesh, kw, cases in (
            ('tp=2,sp=2', {}, ['lm_tp_sp', 'lm_dp_tp', 'colrow', 'moe_top1',
                               'moe_top2', 'moe_dense', 'lm_grads']),
            ('dp=2,tp=2', {}, ['lm_grads']),
            ('sp=4', dict(use_tp=False), ['lm_grads'])):
        gcfg = dict(cfg, **kw)
        prog, scope, loss, params = jax_init(
            lambda F: W.lm_program(gcfg, F))
        _put(inputs, 'lmg', params)
        inputs['lmg/tokens'] = toks
        inputs['lmg/labels'] = inputs['lm/labels']
        inputs['lmg/cfg'] = np.array(','.join('%s=%s' % kv
                                              for kv in gcfg.items()))
        names = [p.name for p in prog.global_block().all_parameters()]
        vals = jfluid.Executor(jfluid.CPUPlace()).run(
            prog, feed={'tokens': toks, 'labels': inputs['lm/labels']},
            fetch_list=[loss.name] + [n + '@GRAD' for n in names],
            scope=scope)
        oracle['lmg', mesh] = {n: np.asarray(v)
                               for n, v in zip(names, vals[1:])}
        inputs['lmg/mesh'] = np.array(mesh)
        res[mesh] = W.spawn(tmp_path_factory.mktemp('axes4'), 4, cases,
                            inputs)
        for k in [k for k in inputs if k.startswith('lmg/p/')]:
            del inputs[k]
    return res, oracle


@pytest.mark.parametrize('mesh', ['tp=2,sp=2', 'dp=2,tp=2', 'sp=4'])
def test_transformer_tp_sp_gradients_match(axes_runs, mesh):
    """One step's gradient of every parameter of the LM, whole, within
    1e-5 of the JAX package's (Adam's steps, being ~lr·sign(g), would
    hide a gradient off by a scale); on sp=4 without tp the attention's
    products take sp-sharded queries against gathered keys."""
    res, oracle = axes_runs
    for r in W.results(res[mesh], 'lm_grads'):
        for name, want in oracle['lmg', mesh].items():
            np.testing.assert_allclose(r['grad/' + name], want, rtol=1e-4,
                                       atol=TOL, err_msg=name)


@pytest.mark.parametrize('name', ['lm_tp_sp', 'lm_dp_tp'])
def test_transformer_tp_sp_matches_serial(axes_runs, name):
    res, oracle = axes_runs
    for r in W.results(res['tp=2,sp=2'], name):
        np.testing.assert_allclose(r['losses'], oracle['lm'],
                                   rtol=STEP_TOL)


def test_tp_weights_are_held_as_their_half(axes_runs):
    """Every weight the JAX package annotates with 'tp' is held as its
    dim's half on each rank of dp=2 x tp=2, the rest whole."""
    res, oracle = axes_runs
    for r in W.results(res['tp=2,sp=2'], 'lm_dp_tp'):
        for name, shape in oracle['lm_shapes'].items():
            spec = oracle['lm_specs'][name] or ()
            want = tuple(s // 2 if (i < len(spec) and spec[i] == 'tp')
                         else s for i, s in enumerate(shape))
            assert tuple(r['shape/' + name]) == want, (name, spec)


def test_column_row_parallel_fc_pair_matches_fc(axes_runs):
    res, oracle = axes_runs
    for r in W.results(res['tp=2,sp=2'], 'colrow'):
        np.testing.assert_allclose(float(r['out']), oracle['colrow'],
                                   rtol=TOL, atol=TOL)
        # the row product's sum over tp and the global sum over dp
        assert len(r['audit/all-reduce']) == 2
        assert 'audit/all-gather' not in r
        assert tuple(r['shape/parallel_fc_0.w']) == (16, 16)
        assert tuple(r['shape/parallel_fc_1.w']) == (16, 16)


@pytest.mark.parametrize('tag', ['moe_top1', 'moe_top2', 'moe_dense'])
def test_moe_expert_parallel_runs(axes_runs, tag):
    res, oracle = axes_runs
    for r in W.results(res['tp=2,sp=2'], tag):
        np.testing.assert_allclose(r['losses'], oracle[tag],
                                   rtol=STEP_TOL)
        assert not np.allclose(r['losses'][0], r['losses'][1])
        experts = [tuple(v) for k, v in r.items()
                   if k.startswith('shape/') and len(v) == 3]
        assert sorted(experts) == [(2, 16, 32), (2, 32, 16)], experts
        if tag != 'moe_dense':
            assert 'audit/all-to-all' in r
