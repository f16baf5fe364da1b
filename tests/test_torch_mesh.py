"""The device mesh, the strategy, the runtime and ParallelExecutor over
ranks (paddle_tpu_torch/parallel/, parallel_executor.py), held to the
JAX package on the CPU.

The JAX side runs in this process on conftest's 8 virtual devices. The
port's ranks are fresh interpreters (tests/torch_mesh_worker.py, never
forked: this process holds JAX) under gloo, with a FileStore rendezvous
in tmp_path; one spawn of 4 ranks and one of 2 run every case of this
file, each from the JAX package's initial weights. Each test names its
JAX oracle:

- mesh.py's MeshConfig, from_spec, from_flags, mesh_scope, fit_spec and
  named_sharding against paddle_tpu/parallel/mesh.py, over the specs of
  the JAX package's tests (no spawn);
- init_parallel_env's env contract (tests/test_dist_multihost.py);
- tests/test_parallel_executor.py: pe vs one device, the uneven batch,
  the strategies;
- tests/test_parallel_axes.py: ZeRO-1, the Reduce knob, ZeRO-3;
- tests/test_bn_local_stats.py's five cases;
- tests/test_dist_multihost.py: two trainers, four-trainer ZeRO-1, ring
  and tp, each trainer feeding its local rows.
fp32 steps within 1e-4 of the JAX package's.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.parallel import mesh as jmesh
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.parallel import mesh as tmesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

import jax  # noqa: E402

STEP_TOL = 1e-4
WORLD = 4


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


# -- the JAX side --------------------------------------------------------------

def jax_init(build, *args):
    """Build a program with the JAX package (fresh names), run its
    startup; returns (prog, scope, loss, {persistable: ndarray})."""
    with junique_name.guard():
        prog, startup, loss = build(jfluid, *args)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    params = {}
    for v in prog.list_vars():
        if v.persistable:
            val = scope.find_var(v.name)
            if val is not None:
                params[v.name] = np.array(val)
    return prog, scope, loss, params


def jax_losses(prog, scope, loss, feeds, devices=None, **kw):
    if devices is None:
        exe = jfluid.Executor(jfluid.CPUPlace())
        return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss],
                                         scope=scope)[0]).reshape(-1)[0])
                for f in feeds]
    pe = jfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                 main_program=prog, scope=scope,
                                 devices=devices, **kw)
    return [float(np.asarray(pe.run(fetch_list=[loss.name], feed=f)[0])
                  .reshape(-1)[0]) for f in feeds]


def _put(inputs, prefix, params):
    for k, v in params.items():
        inputs['%s/p/%s' % (prefix, k)] = v


def _mlp_data(n_steps, bs):
    rng = np.random.RandomState(42)
    w = rng.randn(8, 1).astype('float32')
    out = []
    for _ in range(n_steps):
        xb = rng.randn(bs, 8).astype('float32')
        out.append({'x': xb, 'y': xb @ w})
    return out


def _zero_data(in_dim):
    rng = np.random.RandomState(0)
    xv = rng.rand(16, in_dim).astype('f4')
    return [{'x': xv, 'y': xv.sum(1, keepdims=True).astype('f4')}] * 4


def _dist_batches():
    rng = np.random.RandomState(7)
    out = []
    for _ in range(5):
        xv = rng.rand(32, 8).astype('float32')
        out.append((xv, xv.sum(1, keepdims=True).astype('float32')))
    return out


CASES4 = ['env', 'pe_mlp', 'pe_strategies', 'zero1', 'zero1_replicated',
          'reduce_knob', 'zero3', 'bn_sync', 'bn_local', 'bn_local_nhwc',
          'bn_knob', 'dist_zero1', 'dist_sp', 'dist_tp']


@pytest.fixture(scope='module')
def mesh_runs(tmp_path_factory):
    """Every case of this file: the JAX oracles here, the port's ranks
    in one spawn of 4 and one of 2."""
    oracle, inputs = {}, {}
    # test_parallel_executor.py
    data = _mlp_data(10, 32)
    prog, scope, loss, params = jax_init(W.mlp_program)
    _put(inputs, 'pe_mlp', params)
    inputs['pe_mlp/n'] = np.array(len(data))
    for i, f in enumerate(data):
        inputs['pe_mlp/x%d' % i], inputs['pe_mlp/y%d' % i] = f['x'], f['y']
    oracle['pe_mlp'] = jax_losses(prog, scope, loss, data)
    # test_parallel_axes.py's ZeRO programs (replicated JAX runs)
    for name, z3, dim in (('zero1', False, 16), ('zero3', True, 10)):
        prog, scope, loss, params = jax_init(W.adam_mlp_program, z3, dim)
        _put(inputs, name, params)
        feeds = _zero_data(dim)
        for i, f in enumerate(feeds):
            inputs['%s/x%d' % (name, i)] = f['x']
            inputs['%s/y%d' % (name, i)] = f['y']
        oracle[name] = jax_losses(prog, scope, loss, feeds)
    # test_bn_local_stats.py over the same 4 shards as the port
    rng = np.random.RandomState(0)
    inputs['bn/x'] = rng.rand(16, 3, 8, 8).astype('f4')
    inputs['bn/y'] = rng.randint(0, 10, (16, 1)).astype('int64')
    feed = {'x': inputs['bn/x'], 'y': inputs['bn/y']}
    for nhwc in (False, True):
        tag = 'bn_nhwc' if nhwc else 'bn'
        for local in (False, True):
            jfluid.flags.set_flags({'FLAGS_bn_local_stats': local})
            try:
                prog, scope, loss, params = jax_init(W.bn_program, nhwc)
                if not local:
                    _put(inputs, tag, params)
                oracle['%s_%s' % (tag, local)] = jax_losses(
                    prog, scope, loss, [feed] * 5,
                    devices=jax.devices()[:WORLD])
            finally:
                jfluid.flags.set_flags({'FLAGS_bn_local_stats': False})
    # test_dist_multihost.py: one process of the JAX package
    batches = _dist_batches()
    inputs['dist/steps'] = np.array(len(batches))
    for i, (xv, yv) in enumerate(batches):
        inputs['dist/x%d' % i], inputs['dist/y%d' % i] = xv, yv
    for mode in ('dp', 'sp', 'tp'):
        prog, scope, loss, params = jax_init(W.dist_program, mode)
        _put(inputs, 'dist_%s' % mode, params)
        oracle['dist_' + mode] = jax_losses(
            prog, scope, loss, [{'x': x, 'y': y} for x, y in batches])
    runs = {4: W.spawn(tmp_path_factory.mktemp('mesh4'), 4, CASES4,
                       inputs),
            2: W.spawn(tmp_path_factory.mktemp('mesh2'), 2, ['dist_dp'],
                       inputs)}
    return runs, oracle


def _case(mesh_runs, name, world=4):
    return W.results(mesh_runs[0][world], name)


# -- mesh.py, no spawn ------------------------------------------------------------

SPECS = [(('dp', None), (16, 8)), ((None, 'tp'), (8, 16)),
         (('tp', None), (64, 16)), (('dp', 'tp', None, None), (2, 4, 8, 4)),
         (('dp', 'tp', 'sp', None), (2, 4, 8, 4)), (('dp', 'sp', None),
                                                    (2, 8, 16)),
         (('ep', None, None), (4, 16, 32)), ((('dp', 'tp'), None), (8, 3)),
         (('dp',), (6,)), (('tp', None), (5, 4)), (None, (3, 4))]
MESHES = [dict(dp=2, tp=4), dict(dp=2, tp=2, sp=2), dict(dp=8),
          dict(dp=2, ep=4), dict(tp=4), dict(sp=4), dict(dp=1)]


@pytest.mark.parametrize('sizes', MESHES, ids=lambda d: ','.join(
    '%s=%d' % kv for kv in sorted(d.items())))
def test_mesh_config_builds_the_jax_packages_axes(sizes):
    """paddle_tpu/parallel/mesh.py: MeshConfig.build's axes (order pp,
    dp, ep, sp, tp; size-1 axes dropped) and size; fit_spec and
    named_sharding of every spec against the JAX package's."""
    jcfg = jmesh.MeshConfig(devices=jax.devices(), **sizes)
    tcfg = tmesh.MeshConfig(**sizes)
    assert tcfg.size == jcfg.size
    jm, tm = jcfg.build(), tcfg.build()
    assert tm.axis_names == tuple(jm.axis_names)
    assert [tm.shape[a] for a in tm.axis_names] == list(jm.devices.shape)
    from torch.distributed.tensor import Replicate, Shard
    for spec, shape in SPECS:
        assert tmesh.fit_spec(spec, shape, tm) == \
            jmesh.fit_spec(spec, shape, jm), (spec, shape)
        jps = jmesh.named_sharding(jm, spec).spec
        placements = tmesh.named_sharding(tm, spec)
        assert len(placements) == len(tm.axis_names)
        for ax, pl in zip(tm.axis_names, placements):
            dims = [d for d, e in enumerate(tuple(jps)) if e == ax or
                    (isinstance(e, tuple) and ax in e)]
            if dims and tm.shape[ax] > 1:
                assert pl == Shard(dims[0]), (spec, ax, pl)
            else:
                assert pl == Replicate(), (spec, ax, pl)


def test_mesh_config_from_spec_and_flags():
    for text in ('dp=2,tp=4', ' tp=2 , sp=2', 'ep=4,dp=2'):
        assert tmesh.MeshConfig.from_spec(text).axis_sizes == \
            jmesh.MeshConfig.from_spec(text).axis_sizes
    # '' is pure data parallelism over the given devices
    assert tmesh.MeshConfig.from_spec('', devices=[0, 1, 2]).axis_sizes == \
        jmesh.MeshConfig.from_spec('', devices=[0, 1, 2]).axis_sizes
    with pytest.raises(ValueError, match='axis=size'):
        tmesh.MeshConfig.from_spec('dp2')
    with pytest.raises(ValueError, match='unknown mesh axis'):
        tmesh.MeshConfig(xp=2)
    tfluid.flags.set_flags({'FLAGS_mesh_shape': 'dp=2,tp=2'})
    try:
        assert tmesh.MeshConfig.from_flags().axis_sizes['tp'] == 2
    finally:
        tfluid.flags.set_flags({'FLAGS_mesh_shape': ''})


def test_mesh_scope_restores_the_previous_mesh():
    """paddle_tpu/parallel/mesh.py:mesh_scope: the previous mesh comes
    back even when the body raises."""
    outer = tmesh.set_mesh(tmesh.MeshConfig(dp=2).build())
    try:
        with pytest.raises(RuntimeError):
            with tmesh.mesh_scope(tmesh.MeshConfig(tp=2)) as m:
                assert tmesh.get_mesh() is m and m.axis_names == ('tp',)
                raise RuntimeError('body')
        assert tmesh.get_mesh() is outer
    finally:
        tmesh.set_mesh(None)


def test_strategy_mesh_config_and_world_size():
    from paddle_tpu.parallel import DistributedStrategy as J
    from paddle_tpu_torch.parallel import DistributedStrategy as T
    for kw in (dict(dp=2, tp=2), dict(sp=4), dict(dp=2, ep=2),
               dict(dp=4, sharded_params=True)):
        j, t = J(**kw), T(**kw)
        assert t.world_size == j.world_size
        assert t.sharded_optimizer == j.sharded_optimizer
        assert t.mesh_config().axis_sizes == j.mesh_config().axis_sizes


def test_parallel_exports_match_the_jax_package():
    import paddle_tpu.parallel as jp
    import paddle_tpu_torch.parallel as tp
    assert set(tp.__all__) == set(jp.__all__)
    assert tfluid.parallel.layers.ring_attention is not None


def test_init_parallel_env_needs_endpoints(monkeypatch):
    """dist_worker.py's env contract: several trainers and no endpoint
    raise the JAX package's message."""
    from paddle_tpu_torch.parallel import distributed as D
    for k in ('PADDLE_TRAINER_ENDPOINTS', 'PADDLE_DIST_INIT_METHOD'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match='PADDLE_TRAINER_ENDPOINTS'):
        D.init_parallel_env(trainer_id=0, num_trainers=2)
    assert not D.is_initialized()
    assert D.backend_for(False, 4)[0] == 'gloo'


# -- ranks ----------------------------------------------------------------------------

def test_init_parallel_env_follows_the_env_contract(mesh_runs):
    for r, res in enumerate(_case(mesh_runs, 'env')):
        assert int(res['rank']) == r and int(res['world']) == WORLD
        assert bool(res['up']) and str(res['backend']) == 'gloo'


def test_pe_matches_single_device(mesh_runs):
    """test_parallel_executor.py::test_pe_matches_single_device."""
    for res in _case(mesh_runs, 'pe_mlp'):
        assert int(res['device_count']) == WORLD
        np.testing.assert_allclose(res['losses'],
                                   mesh_runs[1]['pe_mlp'], rtol=STEP_TOL)


def test_pe_uneven_batch_raises(mesh_runs):
    """test_parallel_executor.py::test_pe_uneven_batch_raises: the JAX
    package's message."""
    for res in _case(mesh_runs, 'pe_mlp'):
        assert str(res['uneven']) == \
            'batch size 30 not divisible by dp degree %d' % WORLD


def test_pe_strategies_accepted(mesh_runs):
    for res in _case(mesh_runs, 'pe_strategies'):
        np.testing.assert_allclose(res['losses'],
                                   mesh_runs[1]['pe_mlp'][:3], rtol=STEP_TOL)


@pytest.mark.parametrize('name', ['zero1', 'zero1_replicated',
                                  'reduce_knob'])
def test_zero1_sharded_optimizer_state(mesh_runs, name):
    """test_parallel_axes.py::test_zero1_sharded_optimizer_state and
    ::test_reduce_strategy_knob_drives_zero1: the moments are dp shards
    ([16, 32] -> [4, 32]) and the losses the replicated run's."""
    for res in _case(mesh_runs, name):
        np.testing.assert_allclose(res['losses'], mesh_runs[1]['zero1'],
                                   rtol=STEP_TOL)
        moments = {k: tuple(v) for k, v in res.items()
                   if k.startswith('shape/') and 'moment' in k}
        w0 = [s for k, s in moments.items() if 'fc_0.w_0' in k]
        assert w0, moments
        want = (16, 32) if name == 'zero1_replicated' else (4, 32)
        assert all(s == want for s in w0), moments
        # the parameter itself stays whole under ZeRO-1
        assert tuple(res['shape/fc_0.w_0']) == (16, 32)


def test_zero3_sharded_params(mesh_runs):
    """test_parallel_axes.py::test_zero3_sharded_params: a [10, 32]
    weight shards its axis 1 ([10, 8] on 4 ranks), a [32, 1] weight its
    axis 0, the moments follow, and the losses are the replicated
    run's."""
    for res in _case(mesh_runs, 'zero3'):
        np.testing.assert_allclose(res['losses'], mesh_runs[1]['zero3'],
                                   rtol=STEP_TOL)
        assert tuple(res['shape/z3w']) == (10, 8)
        assert tuple(res['shape/z3w2']) == (8, 1)
        moments = {tuple(v) for k, v in res.items()
                   if k.startswith('shape/') and 'moment' in k}
        assert (10, 8) in moments, moments


def test_local_equals_sync_on_one_device():
    """test_bn_local_stats.py::test_local_equals_sync_on_one_device: one
    rank, both forms the same numbers."""
    feed = {'x': np.random.RandomState(0).rand(16, 3, 8, 8).astype('f4'),
            'y': np.random.RandomState(0).randint(0, 10, (16, 1))
            .astype('int64')}
    out = []
    for local in (False, True):
        tfluid.flags.set_flags({'FLAGS_bn_local_stats': local})
        try:
            with tunique_name.guard():
                prog, startup, loss = W.bn_program(tfluid)
            scope = tfluid.Scope()
            startup.random_seed = 7
            tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
            pe = tfluid.ParallelExecutor(use_cuda=False, main_program=prog,
                                         scope=scope, loss_name=loss.name)
            assert pe.device_count == 1
            out.append([float(pe.run(fetch_list=[loss.name],
                                     feed=feed)[0]) for _ in range(3)])
        finally:
            tfluid.flags.set_flags({'FLAGS_bn_local_stats': False})
    np.testing.assert_allclose(out[0], out[1], rtol=1e-6)


def test_local_mode_trains_and_tracks_sync(mesh_runs):
    """test_bn_local_stats.py::test_local_mode_trains_and_tracks_sync:
    each form within 1e-4 of the JAX package's same form over the same
    4 shards."""
    for res in _case(mesh_runs, 'bn_sync'):
        np.testing.assert_allclose(res['losses'],
                                   mesh_runs[1]['bn_False'], rtol=STEP_TOL)
    for res in _case(mesh_runs, 'bn_local'):
        np.testing.assert_allclose(res['losses'],
                                   mesh_runs[1]['bn_True'], rtol=STEP_TOL)
        assert res['losses'][-1] < res['losses'][0]


def test_collective_audit_local_vs_sync(mesh_runs):
    """test_bn_local_stats.py::test_collective_audit_local_vs_sync: the
    local form issues no batch-norm all-reduce; the synchronised form
    one a BN layer each way (2 layers x 2). The port's record also holds
    the loss mean's all-reduce beside the one bucketed gradient
    all-reduce (the JAX package's HLO folds both into one)."""
    sync = _case(mesh_runs, 'bn_sync')[0]
    local = _case(mesh_runs, 'bn_local')[0]
    assert int(local['n_coll']) == 2
    assert int(sync['n_coll']) == int(local['n_coll']) + 4


def test_local_mode_nhwc(mesh_runs):
    for res in _case(mesh_runs, 'bn_local_nhwc'):
        np.testing.assert_allclose(res['losses'],
                                   mesh_runs[1]['bn_nhwc_True'][:3],
                                   rtol=STEP_TOL)
        assert res['losses'][-1] < res['losses'][0]
        assert int(res['n_coll']) == 2


def test_build_strategy_knob(mesh_runs):
    """test_bn_local_stats.py::test_build_strategy_knob: the override is
    the executor's own; the flag stays off and a sibling keeps the
    synchronised form."""
    for res in _case(mesh_runs, 'bn_knob'):
        assert int(res['local_n']) == 2
        assert int(res['sync_n']) == 6
        assert not bool(res['flag_after'])


def test_two_trainers_match_single(mesh_runs):
    """test_dist_multihost.py::test_two_trainers_match_single."""
    two = _case(mesh_runs, 'dist_dp', world=2)
    np.testing.assert_allclose(two[0]['losses'], two[1]['losses'],
                               rtol=1e-6)
    np.testing.assert_allclose(two[0]['losses'], mesh_runs[1]['dist_dp'],
                               rtol=STEP_TOL)
    assert two[0]['losses'][-1] < two[0]['losses'][0]


@pytest.mark.parametrize('mode', ['zero1', 'sp', 'tp'])
def test_four_trainers_match_single(mesh_runs, mode):
    """test_dist_multihost.py's four-trainer ZeRO-1, ring attention and
    tensor-parallel cases."""
    four = _case(mesh_runs, 'dist_' + mode)
    for other in four[1:]:
        np.testing.assert_allclose(four[0]['losses'], other['losses'],
                                   rtol=1e-6)
    ref = mesh_runs[1]['dist_' + ('dp' if mode == 'zero1' else mode)]
    np.testing.assert_allclose(four[0]['losses'], ref, rtol=STEP_TOL)
    assert four[0]['losses'][-1] < four[0]['losses'][0]
