"""The pipeline engine (paddle_tpu_torch/parallel/{api,pipeline,
pp_lowering}.py, DistributedStrategy(pp=), TransformerConfig(pp_stages=))
held to the JAX package on the CPU.

The JAX side runs in this process on conftest's 8 virtual devices; the
port's ranks are tests/torch_mesh_worker.py processes under gloo (one
spawn of 4 ranks serves every multi-rank case of this file), each from
the JAX package's initial weights (io.load_numpy_params). The oracles:
- tests/test_pipeline_program.py: pp=2 x dp=2 against the serial run
  at rtol 2e-3, and within 1e-4 of the JAX package's own pp=2 x dp=2
  run; the use_tp program on pp=2 x tp=2 at rtol 5e-3 (the JAX test's
  pp x dp x tp case, without its 8-device spawn); 4 layers over 2
  stages; the grad-clip refusal; and pp=4;
- tests/test_parallel_axes.py::test_pipeline_parallel_matches_serial_and_
  trains: pipeline_apply alone against a serial stack of stages,
  forward and gradients;
- the JAX package's pp_lowering checks and their messages, and the
  Program that pipeline_stage_guard and TransformerConfig(pp_stages=)
  build (no spawn).
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.parallel import pp_lowering as jpp
from paddle_tpu.parallel import DistributedStrategy as JStrategy
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.parallel import pp_lowering as tpp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

STEP_TOL = 1e-4
LM = dict(vocab=64, dim=16, heads=2, layers=2, ffn=32, max_len=8,
          use_tp=False, use_sp=False)
# tag -> (cfg, port mesh, JAX pp mesh or None)
RUNS = {
    'pp_dp': (dict(LM, pp_stages=2), dict(dp=2, pp=2, micro_batches=4),
              dict(dp=2, pp=2, micro_batches=4)),
    'pp_tp': (dict(LM, pp_stages=2, use_tp=True),
              dict(tp=2, pp=2, micro_batches=2), None),
    'pp_layers': (dict(LM, pp_stages=2, layers=4),
                  dict(dp=2, pp=2, micro_batches=2), None),
    'pp4': (dict(LM, pp_stages=4, layers=4), dict(pp=4, micro_batches=4),
            None),
}


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


def _batch(cfg, B=8):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg['vocab'], (B, cfg['max_len'], 1)
                       ).astype('int64')
    return {'tokens': toks, 'labels': np.roll(toks, -1, axis=1)}


def _kv(d):
    return ','.join('%s=%s' % kv for kv in sorted(d.items()))


def _jax_run(cfg, strategy=None, devices=None, steps=3):
    """test_pipeline_program.py::_run: the losses and the initial
    weights."""
    with junique_name.guard():
        prog, startup, loss = W.pp_program(cfg, jfluid)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    params = {v.name: np.array(scope.find_var(v.name))
              for v in prog.list_vars() if v.persistable and
              scope.find_var(v.name) is not None}
    pe = jfluid.ParallelExecutor(
        use_cuda=True, loss_name=loss.name, main_program=prog, scope=scope,
        devices=devices or jax.devices()[:1], strategy=strategy)
    feed = _batch(cfg)
    losses = [float(np.asarray(pe.run(fetch_list=[loss.name], feed=feed)[0])
                    .reshape(-1)[0]) for _ in range(steps)]
    return losses, params


@pytest.fixture(scope='module')
def pp_runs(tmp_path_factory):
    """The JAX oracles here, every multi-rank case in one spawn of 4."""
    inputs, oracle = {}, {}
    feed = _batch(LM)
    inputs['pp/tokens'], inputs['pp/labels'] = feed['tokens'], feed['labels']
    for tag, (cfg, mesh, jmesh) in RUNS.items():
        serial_cfg = dict(cfg, pp_stages=0)
        oracle[tag], params = _jax_run(serial_cfg)
        if jmesh is not None:
            oracle[tag + '/jax_pp'], _ = _jax_run(
                cfg, JStrategy(**jmesh), jax.devices()[:4])
        inputs[tag + '/cfg'] = np.array(_kv(cfg))
        inputs[tag + '/mesh'] = np.array(_kv(mesh))
        for k, v in params.items():
            inputs['%s/p/%s' % (tag, k)] = v
    rng = np.random.RandomState(0)
    S, M, mb, D = 4, 8, 2, 16
    for i in range(S):
        inputs['pa/w%d' % i] = (rng.randn(D, D) * 0.1).astype('f4')
        inputs['pa/b%d' % i] = (rng.randn(D) * 0.1).astype('f4')
    inputs['pa/x'] = rng.randn(M, mb, D).astype('f4')
    inputs['pt/root'] = np.array(str(tmp_path_factory.mktemp('pp_ckpt')))
    res = W.spawn(tmp_path_factory.mktemp('pp4'), 4,
                  ['pp_dp', 'pp_tp', 'pp_layers', 'pp4', 'pp_clip',
                   'pipe_apply', 'pp_checked', 'pp_trainer', 'pp_batches'],
                  inputs)
    return res, oracle, inputs


# -- the Program and the checks, no spawn ----------------------------------------

def _build(F, U, cfg, guard_stage=None):
    import importlib
    tr = importlib.import_module(F.__name__ + '.models.transformer')
    prog, startup = F.Program(), F.Program()
    with U.guard(), F.program_guard(prog, startup):
        tokens = F.layers.data(name='tokens', shape=[8, 1], dtype='int64')
        labels = F.layers.data(name='labels', shape=[8, 1], dtype='int64')
        _, cost = tr.train_network(tokens, labels,
                                   tr.TransformerConfig(**cfg))
        if guard_stage is not None:
            with F.parallel.pipeline_stage_guard(guard_stage):
                F.layers.scale(cost, scale=2.0)
        F.optimizer.SGD(0.01).minimize(cost)
    return prog


@pytest.mark.parametrize('cfg', [dict(LM, pp_stages=2),
                                 dict(LM, pp_stages=2, layers=4),
                                 dict(LM, pp_stages=2, use_tp=True)],
                         ids=['2x1', '2x2', 'tp'])
def test_pp_stages_build_the_jax_packages_program(cfg):
    jprog = _build(jfluid, junique_name, cfg)
    tprog = _build(tfluid, tunique_name, cfg)
    assert tprog.to_string() == jprog.to_string()
    stages = [op.attr('pp_stage', None)
              for op in tprog.global_block().ops]
    assert stages == [op.attr('pp_stage', None)
                      for op in jprog.global_block().ops]
    assert set(s for s in stages if s is not None) == {0, 1}


def test_pipeline_stage_guard_stamps_and_restores():
    for F, U in ((jfluid, junique_name), (tfluid, tunique_name)):
        prog = F.Program()
        with F.program_guard(prog, F.Program()):
            x = F.layers.data(name='x', shape=[4], dtype='float32')
            with pytest.raises(RuntimeError):
                with F.parallel.pipeline_stage_guard(3):
                    F.layers.scale(x, scale=2.0)
                    with F.parallel.pipeline_stage_guard(1):
                        F.layers.scale(x, scale=3.0)
                    F.layers.scale(x, scale=4.0)
                    raise RuntimeError('boom')
            F.layers.scale(x, scale=5.0)
        assert [op.attr('pp_stage', None) for op in
                prog.global_block().ops] == [3, 1, 3, None]
        assert getattr(prog, '_pp_stage', None) is None


def test_pp_stages_must_divide_layers_as_in_jax():
    for F, U in ((jfluid, junique_name), (tfluid, tunique_name)):
        with pytest.raises(ValueError,
                           match='layers 3 not divisible by pp_stages 2'):
            _build(F, U, dict(LM, pp_stages=2, layers=3))


class _Seg(object):
    def __init__(self, prog):
        self.ops = [op for op in prog.global_block().ops
                    if op.type not in ('feed', 'fetch')]
        self.op_offsets = list(range(len(self.ops)))


def _checks(mod, prog):
    block = prog.global_block()
    seg = _Seg(prog)
    pre, stages, post, opt = mod._partition(seg)
    keys = mod._validate_stages(stages, block)
    infos = mod._stage_io(stages, keys, block)
    if hasattr(mod, '_grad_names'):
        mod._grad_names(opt)
    return len(pre), keys, [i['x_in'] for i in infos], len(post), len(opt)


def _jax_grad_check(prog):
    """The JAX package's transformed-gradient refusal, as
    build_pp_segment_fn runs it."""
    from paddle_tpu.framework import grad_var_name
    for op in prog.global_block().ops:
        if op.attr('op_role', '') == 'optimize' and op.input('Param'):
            p, g = op.single_input('Param'), op.single_input('Grad')
            if g != grad_var_name(p):
                raise NotImplementedError(
                    'pipeline parallelism: optimizer consumes a '
                    'transformed gradient %r for param %r (gradient '
                    'clipping / regularization are not supported under '
                    'pp — grads come from whole-graph autodiff)' % (g, p))


def _both(build, *args):
    """(JAX error or result, port error or result) of the checks on the
    same program built by each package."""
    out = []
    for F, U, mod in ((jfluid, junique_name, jpp),
                      (tfluid, tunique_name, tpp)):
        prog, startup = F.Program(), F.Program()
        with U.guard(), F.program_guard(prog, startup):
            build(F, *args)
        try:
            got = _checks(mod, prog)
            if mod is jpp:
                _jax_grad_check(prog)
            out.append(('ok', got))
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def _mlp_stages(F, kind):
    x = F.layers.data(name='x', shape=[8], dtype='float32')
    h = F.layers.fc(input=x, size=8)
    for s in range(2):
        with F.parallel.pipeline_stage_guard(s):
            if kind == 'nonuniform' and s == 1:
                h = F.layers.scale(F.layers.fc(input=h, size=8, act='relu'),
                                   scale=1.0)
            elif kind == 'attr' and s == 1:
                h = F.layers.fc(input=h, size=8, act='tanh')
            elif kind == 'dropout':
                h = F.layers.dropout(F.layers.fc(input=h, size=8, act='relu'),
                                     dropout_prob=0.5)
            elif kind == 'two_acts':
                h = F.layers.elementwise_add(F.layers.fc(input=h, size=8,
                                                         act='relu'), x)
            elif kind == 'shapes' and s == 1:
                h = F.layers.fc(input=F.layers.fc(input=h, size=4,
                                                  act='relu'), size=8)
                continue
            elif kind == 'shapes':
                h = F.layers.fc(input=F.layers.fc(input=h, size=8,
                                                  act='relu'), size=8)
                continue
            else:
                h = F.layers.fc(input=h, size=8, act='relu')
    loss = F.layers.mean(h)
    if kind == 'clip':
        F.clip.set_gradient_clip(F.clip.GradientClipByGlobalNorm(1.0))
    reg = F.regularizer.L2Decay(1e-4) if kind == 'regularized' else None
    F.optimizer.SGD(0.1, regularization=reg).minimize(loss)


@pytest.mark.parametrize('kind,err', [
    ('uniform', None),
    ('nonuniform', 'ValueError'),
    ('attr', 'ValueError'),
    ('dropout', 'NotImplementedError'),
    ('two_acts', 'ValueError'),
    ('shapes', 'ValueError'),
    ('clip', 'NotImplementedError'),
    ('regularized', 'NotImplementedError')])
def test_pp_checks_raise_the_jax_packages_errors(kind, err):
    jgot, tgot = _both(_mlp_stages, kind)
    assert tgot == jgot
    assert jgot[0] == (err or 'ok'), jgot


def _jax_pp_first_run(rows, micro_batches):
    """The JAX package's pp=2 x dp=2 program (pp_dp's) at `rows` rows
    over `micro_batches` microbatches: ('error', its message) or ('ok',
    the first loss)."""
    cfg = RUNS['pp_dp'][0]
    with junique_name.guard():
        prog, startup, loss = W.pp_program(cfg, jfluid)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    pe = jfluid.ParallelExecutor(
        use_cuda=True, loss_name=loss.name, main_program=prog, scope=scope,
        devices=jax.devices()[:4],
        strategy=JStrategy(dp=2, pp=2, micro_batches=micro_batches))
    feed = {k: v[:rows] for k, v in _batch(cfg).items()}
    try:
        out = pe.run(fetch_list=[loss.name], feed=feed)
    except ValueError as e:
        return 'error', str(e)
    return 'ok', float(np.asarray(out[0]).reshape(-1)[0])


def test_pp_refuses_no_loss_name_and_an_undivided_batch(pp_runs):
    """No loss_name: the JAX package's message when the engine is built;
    a batch of 6 rows over 4 microbatches on pp=2 x dp=2: the JAX
    package's 'not divisible' message, on every rank."""
    from paddle_tpu_torch.parallel.mesh import Mesh
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        _mlp_stages(tfluid, 'uniform')

    class _PE(object):
        _loss_name = None
        mesh = Mesh(('pp',), (2,))
        _strategy = tfluid.parallel.DistributedStrategy(pp=2,
                                                       micro_batches=4)
    with pytest.raises(ValueError, match='needs ParallelExecutor'
                       r'\(loss_name=\.\.\.\)'):
        tpp.build_pp_segment_fn(_PE(), _Seg(prog), prog.global_block(),
                                prog)
    kind, jmsg = _jax_pp_first_run(6, 4)
    assert (kind, jmsg) == ('error', 'batch 6 not divisible by 4 '
                                     'microbatches')
    for r in W.results(pp_runs[0], 'pp_batches'):
        assert str(r['undivided']) == jmsg


def test_pp_refuses_a_dp_ranks_rows_the_microbatches_do_not_divide(
        pp_runs):
    """A divergence (ROADMAP Queue 3): 8 rows over 8 microbatches on
    pp=2 x dp=2. The JAX package splits the global batch and runs it;
    the port splits each dp rank's 4 rows and refuses, naming them."""
    kind, loss = _jax_pp_first_run(8, 8)
    assert kind == 'ok' and np.isfinite(loss)
    for r in W.results(pp_runs[0], 'pp_batches'):
        assert str(r['dp_rows']) == (
            "batch 8: a dp rank's 4 rows are not divisible by 8 "
            "microbatches")


# -- the ranks ---------------------------------------------------------------------

def _losses(pp_runs, tag):
    res = W.results(pp_runs[0], tag)
    for r in res[1:]:
        np.testing.assert_array_equal(r['losses'], res[0]['losses'])
    return res


def test_pp_dp_matches_serial_and_the_jax_pp_run(pp_runs):
    """test_pp_matches_serial: pp=2 x dp=2 (4 microbatches of each dp
    rank's rows) within rtol 2e-3 of the serial run and 1e-4 of the JAX
    package's pp=2 x dp=2 run; the loss falls; every rank ends on the
    same weights."""
    res = _losses(pp_runs, 'pp_dp')
    oracle = pp_runs[1]
    got = res[0]['losses']
    np.testing.assert_allclose(got, oracle['pp_dp'], rtol=2e-3)
    np.testing.assert_allclose(got, oracle['pp_dp/jax_pp'], rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert got[-1] < got[0]
    for k in res[0]:
        if k.startswith('w/'):
            for r in res[1:]:
                np.testing.assert_array_equal(r[k], res[0][k])
    # stage 0 (ranks 0, 1) sends the activations, stage 1 the cotangents
    act, cot, grad = np.sum([r['stats'] for r in res], 0)
    assert act == cot > 0 and grad > 0
    assert res[0]['stats'][1] == res[2]['stats'][0] == 0


def test_pp_tp_matches_serial(pp_runs):
    """test_pp_dp_tp_matches_serial's program (use_tp) on pp=2 x tp=2,
    rtol 5e-3."""
    res = _losses(pp_runs, 'pp_tp')
    np.testing.assert_allclose(res[0]['losses'], pp_runs[1]['pp_tp'],
                               rtol=5e-3)


def test_pp_multilayer_stages(pp_runs):
    res = _losses(pp_runs, 'pp_layers')
    np.testing.assert_allclose(res[0]['losses'], pp_runs[1]['pp_layers'],
                               rtol=2e-3)


def test_pp4_matches_serial_and_counts_one_segment(pp_runs):
    """pp=4, a stage a rank: the losses, and the engine's segment in
    jit_cache_stats (built once, then hit)."""
    res = _losses(pp_runs, 'pp4')
    np.testing.assert_allclose(res[0]['losses'], pp_runs[1]['pp4'],
                               rtol=2e-3)
    for r in res:
        assert list(r['cache']) == [1, 2, 1]


def test_pp_rejects_grad_clip_on_the_mesh(pp_runs):
    for r in W.results(pp_runs[0], 'pp_clip'):
        assert 'not supported under pipeline parallelism' in \
            str(r['refused'])


def test_pipeline_apply_matches_serial_and_trains(pp_runs):
    """The GPipe schedule over pp=4 (8 microbatches of 2): the output is
    the serial stack's within 1e-5 on every rank, and each stage's
    gradients (on its own rank) are the serial ones."""
    import torch
    inputs = pp_runs[2]
    res = W.results(pp_runs[0], 'pipe_apply')
    S = len(res)
    ws = [torch.from_numpy(inputs['pa/w%d' % i]).requires_grad_()
          for i in range(S)]
    bs = [torch.from_numpy(inputs['pa/b%d' % i]).requires_grad_()
          for i in range(S)]
    ref = torch.from_numpy(inputs['pa/x'])
    for w, b in zip(ws, bs):
        ref = torch.tanh(ref @ w + b)
    torch.mean(ref ** 2).backward()
    for r in res:
        np.testing.assert_allclose(r['out'], ref.detach().numpy(), atol=1e-5)
    for i, r in enumerate(res):
        np.testing.assert_allclose(r['gw%d' % i], ws[i].grad.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(r['gb%d' % i], bs[i].grad.numpy(),
                                   atol=1e-6)
        for j in range(S):
            if j != i:
                assert not r['gw%d' % j].any()
    assert float(np.linalg.norm(res[0]['gw0'])) > 0


def test_pp_check_nan_inf_runs_op_by_op(pp_runs):
    """FLAGS_check_nan_inf on pp=2 x dp=2: the checked step's loss is
    the pipelined step's, and a NaN stage-1 weight is named at the op
    whose output it poisons, on every rank."""
    first = W.results(pp_runs[0], 'pp_dp')[0]['losses'][0]
    for r in W.results(pp_runs[0], 'pp_checked'):
        np.testing.assert_allclose(float(r['loss']), first, rtol=1e-5)
        assert 'NaN/Inf detected in output' in str(r['nan'])


def test_pp_trainer_sharded_resume_exact(pp_runs):
    """Trainer(strategy=pp=2 x dp=2) with CheckpointConfig(sharded=True):
    a second Trainer resumes from the generation the first wrote after
    its 2nd step (the whole values, on every rank) and ends on the
    uninterrupted run's weights and loss, bit for bit."""
    res = W.results(pp_runs[0], 'pp_trainer')
    names = sorted(k[2:] for k in res[0] if k.startswith('a/'))
    assert names
    for r in res:
        assert bool(r['b_resumed']) and not bool(r['a_resumed'])
        for n in names:
            assert np.array_equal(r['b0/' + n], r['a/' + n]), n
            assert np.array_equal(r['b/' + n], r['c/' + n]), n
    assert len(res[0]['c_losses']) == 3
    assert np.array_equal(res[0]['b_losses'], res[0]['c_losses'][2:])
