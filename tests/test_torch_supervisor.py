"""paddle_tpu_torch's Supervisor, elastic rejoin and pserver
checkpoints on the CPU.

- The restart budget and the incarnation bump (tests/test_chaos.py's
  unit case, on the port's Supervisor).
- One trainer kill and rejoin (tests/test_chaos.py's acceptance case on
  the port): trainer 0 of an mlp cluster under the Supervisor is killed
  at its 5th SEND_VAR (the 'exit' fault action, kill -9 mid-round), is
  restarted with incarnation 1, re-registers, resumes, and the run ends
  on the fault-free weights (the port's local run, within 1e-5; both
  trainers the same bits).
- Trainer(checkpoint_config=CheckpointConfig(pserver_endpoints=)) has
  each pserver save its shard into every checkpoint, and a pserver
  restored from the saved shards serves those values (as
  tests/test_dist_pserver.py::test_checkpoint_notify_saves_pserver_shards
  holds for the JAX package); the pservers run in threads here.
"""
import json
import os
import sys
import threading

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.distributed.supervisor import Supervisor

_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, 'torch_ps_worker.py')
sys.path.insert(0, _HERE)

from test_torch_dist_pserver import _free_ports, _port_local  # noqa: E402


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


def test_supervisor_restart_budget_and_incarnation(tmp_path):
    """exit 0 is done, nonzero restarts with a bumped
    FLAGS_trainer_incarnation until the budget is spent,
    restartable=False is terminal, and FLAGS_fault_plan is stripped from
    restart environments."""
    sup = Supervisor(max_restarts=3, backoff=0.05,
                     backoff_multiplier=1.0, log_dir=str(tmp_path))
    py = sys.executable
    flaky = ("import os, sys\n"
             "inc = os.environ.get('FLAGS_trainer_incarnation', '0')\n"
             "print('inc', inc, flush=True)\n"
             "sys.exit(0 if inc == '2' else 3)\n")
    planned = ("import os, sys\n"
               "sys.exit(5 if os.environ.get('FLAGS_fault_plan')"
               " else 0)\n")
    sup.add_role('flaky', [py, '-c', flaky])
    sup.add_role('clean', [py, '-c', 'pass'])
    sup.add_role('hard', [py, '-c', 'raise SystemExit(4)'],
                 restartable=False)
    sup.add_role('planned', [py, '-c', planned],
                 env=dict(os.environ, FLAGS_fault_plan='{"rules": []}'))
    sup.add_role('budget', [py, '-c', 'raise SystemExit(6)'],
                 max_restarts=1)
    sup.start()
    states = sup.wait(timeout=60)
    sup.stop()
    assert states == {'flaky': 'done', 'clean': 'done',
                      'hard': 'failed', 'planned': 'done',
                      'budget': 'failed'}
    assert sup.restarts == {'flaky': 2, 'clean': 0, 'hard': 0,
                            'planned': 1, 'budget': 1}
    out = sup.output('flaky')
    assert 'inc 0' in out and 'inc 2' in out


@pytest.mark.timeout(300)
def test_trainer_kill_rejoins_and_matches_fault_free(tmp_path):
    plan = json.dumps({'rules': [
        {'when': 'send', 'type': 'SEND_VAR', 'nth': 5,
         'action': 'exit'}]})
    eps = ','.join('127.0.0.1:%d' % p for p in _free_ports(2))
    base = dict(os.environ)
    base.update({'PS_MODEL': 'mlp', 'PS_ENDPOINTS': eps,
                 'PS_TRAINERS': '2', 'PS_STEPS': '3', 'PS_SYNC': '1',
                 'PS_OPTIMIZER': 'sgd',
                 # cover the victim's death, backoff and restart without
                 # the liveness reaper retiring anyone first
                 'FLAGS_rpc_deadline': '120',
                 'FLAGS_rpc_max_retries': '12',
                 'FLAGS_rpc_reconnect_secs': '10'})
    base.pop('FLAGS_fault_plan', None)
    sup = Supervisor(max_restarts=2, backoff=0.5, log_dir=str(tmp_path))
    for i in range(2):
        sup.add_role('pserver%d' % i, [sys.executable, _WORKER],
                     env=dict(base, PS_ROLE='pserver',
                              PS_PSERVER_ID=str(i)))
    for i in range(2):
        env = dict(base, PS_ROLE='trainer', PS_TRAINER_ID=str(i))
        if i == 0:
            env['FLAGS_fault_plan'] = plan
        sup.add_role('trainer%d' % i, [sys.executable, _WORKER], env=env)
    sup.start()
    try:
        states = sup.wait(timeout=240)
        outs = [sup.output('trainer%d' % i) for i in range(2)]
        assert all(s == 'done' for s in states.values()), \
            (states, outs[0][-4000:])
        restarts = dict(sup.restarts)
    finally:
        sup.stop()
    assert restarts['trainer0'] == 1 and restarts['trainer1'] == 0
    assert 'fault injection: exit' in outs[0]
    assert 'REJOIN inc=1' in outs[0]
    weights = []
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith('RESULT ')]
        assert line, out[-4000:]
        weights.append(json.loads(line[-1][len('RESULT '):])['weights'])
    _, local_w = _port_local('mlp', steps=3)
    for p, lw in local_w.items():
        np.testing.assert_allclose(np.asarray(weights[0][p]),
                                   np.asarray(lw), rtol=0, atol=1e-5,
                                   err_msg=p)
        assert np.array_equal(np.asarray(weights[0][p]),
                              np.asarray(weights[1][p])), p


def _mlp():
    x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
    y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
    h = tfluid.layers.fc(input=x, size=4096, act='relu',
                         param_attr=tfluid.ParamAttr(
                             name='cw1',
                             initializer=tfluid.initializer.Normal(
                                 scale=0.1, seed=3)))
    pred = tfluid.layers.fc(input=h, size=1,
                            param_attr=tfluid.ParamAttr(name='cw2'))
    return tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))


def _reader():
    rng = np.random.RandomState(7)
    for _ in range(4):
        x = rng.randn(8, 4).astype('float32')
        yield [x, x.sum(1, keepdims=True)]


def _serve_pservers(t, restore=None):
    """Each pserver program of `t` served by a thread of this process
    (startup, then listen_and_serv until its trainer completes)."""
    scopes, threads, errors = {}, [], []

    def serve(main, startup, scope):
        try:
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            exe.run(main, scope=scope)
        except Exception as e:       # noqa: BLE001 -- asserted by callers
            errors.append(e)
    for ep in t.pserver_endpoints:
        main, startup = t.get_pserver_programs(ep, checkpoint_dir=restore)
        scopes[ep] = tfluid.Scope()
        th = threading.Thread(target=serve,
                              args=(main, startup, scopes[ep]), daemon=True)
        th.start()
        threads.append(th)
    return scopes, threads, errors


def _transpiled(eps):
    main, startup = tframework.Program(), tframework.Program()
    with tunique_name.guard(), tframework.program_guard(main, startup):
        loss = _mlp()
        tfluid.optimizer.SGD(0.1).minimize(loss)
    t = tfluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers=eps, trainers=1,
                startup_program=startup)
    return t


def test_trainer_checkpoints_save_the_pservers_shards(tmp_path):
    from paddle_tpu_torch.distributed.rpc import close_all_clients
    from paddle_tpu_torch.ops.io_ops import read_tensor
    eps = ['127.0.0.1:%d' % p for p in _free_ports(2)]
    t = _transpiled(','.join(eps))
    scopes, threads, errors = _serve_pservers(t)
    ckpt = str(tmp_path / 'ckpt')
    try:
        cfg = tfluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=2,
                                      pserver_endpoints=eps, trainer_id=0)
        trainer = tfluid.Trainer(_mlp, lambda: tfluid.optimizer.SGD(0.1),
                                 place=tfluid.CPUPlace(),
                                 checkpoint_config=cfg)
        trainer.train(num_epochs=1, event_handler=lambda e: None,
                      reader=_reader, feed_order=['x', 'y'])
    finally:
        close_all_clients(send_complete=True)
        for th in threads:
            th.join(timeout=30)
    assert not errors and not any(th.is_alive() for th in threads)
    ckpts = sorted(d for d in os.listdir(ckpt) if d.startswith('checkpoint'))
    assert ckpts
    for c in ckpts:
        shards = os.path.join(ckpt, c, 'pserver_shards')
        assert sorted(os.listdir(shards)) == sorted(
            ep.replace(':', '_') for ep in eps)
        # the digest manifest covers the shards
        digests = json.load(open(os.path.join(ckpt, c,
                                              'CHECKPOINT_DIGESTS')))
        assert any(k.startswith('pserver_shards') for k in digests)
    newest = os.path.join(ckpt, ckpts[-1], 'pserver_shards')
    saved = {}
    for ep in eps:
        d = os.path.join(newest, ep.replace(':', '_'))
        for fn in os.listdir(d):
            with open(os.path.join(d, fn), 'rb') as f:
                saved[fn] = read_tensor(f)
            assert np.array_equal(saved[fn],
                                  scopes[ep].find_var(fn).numpy()), fn
    assert {'cw1.block0', 'cw1.block1'} <= set(saved)
    # the restore half: fresh pservers serve the saved shards
    t2 = _transpiled(','.join('127.0.0.1:%d' % p for p in _free_ports(2)))
    scopes2, threads2, errors2 = _serve_pservers(t2, restore=newest)
    trainer_scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    try:
        exe.run(t2.get_trainer_startup_program(), scope=trainer_scope)
    finally:
        exe.close()
        for th in threads2:
            th.join(timeout=30)
    assert not errors2
    cw1 = trainer_scope.find_var('cw1').numpy()
    assert np.array_equal(cw1, np.concatenate(
        [saved['cw1.block0'], saved['cw1.block1']]))
