"""paddle_tpu_torch's RPC layer, parameter service and master against the
JAX package's, in threads of one process on the CPU.

- A port PSClient against the JAX package's PSServer + ParameterService,
  and a JAX PSClient against the port's: sends (single and batched),
  gets, barriers, prefetch, checkpoint and complete, with the same
  parameters on both sides.
- The merge adds the trainers' values in the JAX package's order: the
  same bits, dense and sparse.
- tests/test_chaos.py's cases that need no cluster, on the port:
  reconnect and replay exactly once, a stale incarnation refused, the
  master's cached reply, snapshot and journal round trips, a FaultPlan
  naming SEND_VAR that fires on its nth send, the merge denominator,
  zombie fencing and liveness, the exit action.
- tests/test_task_master.py's cases that need no cluster, on the port.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import param_service as jps
from paddle_tpu.distributed import resilience as jres
from paddle_tpu.distributed import rpc as jrpc
from paddle_tpu.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu_torch.distributed import resilience, wire
from paddle_tpu_torch.distributed.master import (MasterClient, MasterServer,
                                                 TaskMaster)
from paddle_tpu_torch.distributed.param_service import ParameterService
from paddle_tpu_torch.distributed.resilience import (FatalRPCError,
                                                     FaultPlan, RetryPolicy,
                                                     RetryableRPCError,
                                                     StaleIncarnationError)
from paddle_tpu_torch.distributed.rpc import PSClient, PSServer
from paddle_tpu_torch.selected_rows import SelectedRows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fast_retry(mod=resilience):
    return mod.RetryPolicy(max_attempts=5, backoff=0.01, max_backoff=0.05,
                           reconnect_secs=5.0)


# -- across packages -----------------------------------------------------------

def _service(pkg, num_trainers=1, tmp=None):
    """A sync ParameterService of one package over a dense param 'w', a
    [10, 3] lookup table 'emb' (prefetch) and a checkpoint callback;
    its values stay in that package's type (numpy or torch)."""
    as_value = (lambda a: a) if pkg == 'jax' else torch.from_numpy
    params = {'w': as_value(np.zeros(4, 'f4')),
              'emb': as_value(np.arange(30, dtype='f4').reshape(10, 3))}
    rounds, saved = [], []

    def run_round(merged):
        rounds.append(sorted(merged))
        for name, v in merged.items():
            p = name.split('@')[0]
            if isinstance(v, (SelectedRows, JSelectedRows)):
                rows = np.asarray(v.rows).astype('int64')
                vals = np.asarray(v.values)
                dense = np.zeros(np.shape(params[p]), 'f4')
                np.add.at(dense, rows, vals)
                v = dense
            params[p] = params[p] - as_value(np.asarray(v))

    def prefetch(table, ids):
        return params[table][np.asarray(ids).astype('int64')]

    cls = jps.ParameterService if pkg == 'jax' else ParameterService
    svc = cls(num_trainers=num_trainers, sync_mode=True,
              get_param=lambda name: params[name], run_round=run_round,
              prefetch=prefetch, save_params=saved.append,
              rpc_deadline=60.0)
    return svc, params, rounds, saved


def _serve(server_cls, svc):
    srv = server_cls('127.0.0.1:0', svc)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


@pytest.mark.parametrize('client_pkg,server_pkg',
                         [('torch', 'jax'), ('jax', 'torch')])
def test_a_client_of_one_package_trains_against_the_others_server(
        client_pkg, server_pkg):
    svc, params, rounds, saved = _service(server_pkg)
    srv, st = _serve(jrpc.PSServer if server_pkg == 'jax' else PSServer,
                     svc)
    cls = PSClient if client_pkg == 'torch' else jrpc.PSClient
    as_value = torch.from_numpy if client_pkg == 'torch' else (lambda a: a)
    res = resilience if client_pkg == 'torch' else jres
    cli = cls('127.0.0.1:%d' % srv.port, trainer_id=0,
              retry_policy=_fast_retry(res))
    try:
        g = np.array([1, 2, 3, 4], 'f4')
        cli.send_var('w@GRAD', as_value(g.copy()))
        cli.batch_barrier()
        got = cli.get_var('w')
        assert isinstance(got, torch.Tensor if client_pkg == 'torch'
                          else np.ndarray)
        assert np.array_equal(np.asarray(got), -g)
        # round 2: a sparse grad and the pipelined, batched path
        sr_cls = SelectedRows if client_pkg == 'torch' else JSelectedRows
        sg = sr_cls(as_value(np.ones((2, 3), 'f4')),
                    as_value(np.array([1, 1], 'int32')), 10)
        futs = cli.send_vars_async([('w@GRAD', as_value(g.copy())),
                                    ('emb@GRAD', sg)])
        for f in futs:
            f.result()
        cli.batch_barrier_async().result()
        assert np.array_equal(np.asarray(cli.get_var_async('w').result()),
                              -2 * g)
        want = np.arange(30, dtype='f4').reshape(10, 3)
        want[1] -= 2.0
        rows = cli.prefetch('emb', as_value(np.array([1, 7], 'int64')))
        assert np.array_equal(np.asarray(rows), want[[1, 7]])
        rows = cli.prefetch_async('emb', as_value(np.array([0], 'int64')))
        assert np.array_equal(np.asarray(rows.result()), want[[0]])
        cli.fetch_barrier()
        cli.checkpoint_notify('/ckpt/shard0')
        assert saved == ['/ckpt/shard0']
        assert rounds == [['w@GRAD'], ['emb@GRAD', 'w@GRAD']]
        cli.complete()
    finally:
        cli.close()
        st.join(timeout=10.0)
    assert not st.is_alive()


def test_get_client_pool_and_close_all_clients_send_complete():
    """get_client keys the pool by (endpoint, trainer_id);
    close_all_clients(send_complete=True) retires every trainer, which
    ends the server (all trainers complete)."""
    from paddle_tpu_torch.distributed import rpc
    svc, params, rounds, _ = _service('torch', num_trainers=2)
    srv, st = _serve(PSServer, svc)
    ep = '127.0.0.1:%d' % srv.port
    a, b = rpc.get_client(ep, 0), rpc.get_client(ep, 1)
    assert a is rpc.get_client(ep, 0) and a is not b
    assert (a.trainer_id, b.trainer_id) == (0, 1)
    rpc.close_all_clients(send_complete=True)
    st.join(timeout=10.0)
    assert not st.is_alive() and svc._done_tids == {0, 1}
    assert rpc.get_client is not None and not rpc._clients


def test_recv_copies_into_the_scope_tensor_and_refuses_a_mismatch():
    """`recv` writes a received persistable into the tensor the scope
    already holds (what a captured segment reads); a held tensor of
    another shape or dtype raises instead of being replaced."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import rpc
    svc, params, rounds, _ = _service('torch')
    params['w'] = torch.tensor([1., 2., 3., 4.])
    srv, st = _serve(PSServer, svc)
    ep = '127.0.0.1:%d' % srv.port
    prog = fluid.Program()
    block = prog.global_block()
    block.create_var(name='w', shape=[4], dtype='float32', persistable=True)
    block.append_op(type='recv', inputs={}, outputs={'Out': ['w']},
                    attrs={'epmap': [ep], 'trainer_id': 0})
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    try:
        held = torch.zeros(4)
        scope.set_var('w', held)
        exe.run(prog, scope=scope)
        assert scope.find_var('w') is held
        assert torch.equal(held, params['w'])
        for bad in (torch.zeros(5), torch.zeros(4, dtype=torch.float64)):
            scope.set_var('w', bad)
            with pytest.raises(RuntimeError, match='binding a new tensor'):
                exe.run(prog, scope=scope)
            assert scope.find_var('w') is bad and not bad.any()
    finally:
        rpc.close_all_clients(send_complete=True)
        st.join(timeout=10.0)
    assert not st.is_alive()


@pytest.mark.parametrize('kind', ['dense', 'sparse'])
def test_the_merge_is_the_jax_packages_bits(kind):
    """Three trainers' gradients merged by each package's service: sum
    in arrival order, then the scale rounded to fp32 -- the same bits."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(64).astype('f4') * 10 ** rng.uniform(-3, 3)
             for _ in range(3)]
    out = {}
    for pkg in ('jax', 'torch'):
        svc, _, _, _ = _service(pkg, num_trainers=3)
        if kind == 'dense':
            vals = grads if pkg == 'jax' else \
                [torch.from_numpy(g.copy()) for g in grads]
        else:
            cls = JSelectedRows if pkg == 'jax' else SelectedRows
            conv = (lambda a: a) if pkg == 'jax' else torch.from_numpy
            vals = [cls(conv(g.reshape(16, 4).copy()),
                        conv(np.arange(16, dtype='int32')), 32)
                    for g in grads]
        m = svc._merge(vals)
        out[pkg] = np.asarray(m.values if kind == 'sparse' else m)
    assert out['jax'].dtype == out['torch'].dtype == np.float32
    assert out['jax'].tobytes() == out['torch'].tobytes()


def test_type_names_cover_the_wire_and_master_namespaces():
    """A FaultPlan rule naming a message type resolves as in the JAX
    package (until this slice the port knew only '*')."""
    assert resilience._type_names() == jres._type_names()
    assert resilience._type_names()['SEND_VAR'] == wire.SEND_VAR
    assert resilience._type_names()['TASK_FINISHED'] == 21


# -- tests/test_chaos.py's cases that need no cluster ------------------------

def test_fault_plan_seed_determinism():
    for seed in range(8):
        assert FaultPlan.from_seed(seed).to_json() == \
            FaultPlan.from_seed(seed).to_json() == \
            jres.FaultPlan.from_seed(seed).to_json()
    plans = {FaultPlan.from_seed(s).to_json() for s in range(16)}
    assert len(plans) > 4


def test_fault_plan_roundtrip_and_fires_on_nth():
    """The Nth SEND_VAR write raises; writes before/after pass through,
    and the fired-fault audit log records exactly one event."""
    plan = FaultPlan.from_json(json.dumps({'rules': [
        {'when': 'send', 'type': 'SEND_VAR', 'nth': 2,
         'action': 'error', 'retryable': True}]}))
    assert FaultPlan.from_json(plan.to_json()).to_json() == plan.to_json()
    a, b = socket.socketpair()
    try:
        with resilience.active_plan(plan):
            wire.write_msg(a, wire.SEND_VAR, {'name': 'g'}, torch.ones(2))
            with pytest.raises(RetryableRPCError):
                wire.write_msg(a, wire.SEND_VAR, {'name': 'g'},
                               torch.ones(2))
            wire.write_msg(a, wire.SEND_VAR, {'name': 'g'}, torch.ones(2))
            wire.write_msg(a, wire.BATCH_BARRIER)
            fired = resilience.fired_faults()
        assert [f['action'] for f in fired] == ['error']
        for _ in range(3):
            wire.read_msg(b)
    finally:
        a.close()
        b.close()


def _mini_service(sync_mode=True, num_trainers=1):
    params = {'w': torch.zeros(4)}
    rounds = []
    singles = []

    def run_round(merged):
        rounds.append(sorted(merged))
        for v in merged.values():
            params['w'] = params['w'] - torch.as_tensor(v)

    def run_one_grad(name, value):
        singles.append(name)
        params['w'] = params['w'] - torch.as_tensor(value)

    svc = ParameterService(
        num_trainers=num_trainers, sync_mode=sync_mode,
        get_param=lambda name: params[name], run_round=run_round,
        run_one_grad=run_one_grad, rpc_deadline=60.0)
    return svc, params, rounds, singles


def test_param_service_replayed_send_var_applies_once():
    svc, params, _, singles = _mini_service(sync_mode=False)
    g = torch.ones(4)
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 1))
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 1))   # replay
    assert singles == ['w@GRAD']
    assert torch.equal(params['w'], -g)
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 2))
    assert singles == ['w@GRAD', 'w@GRAD']


def test_param_service_replayed_barrier_closes_one_round():
    svc, params, rounds, _ = _mini_service(sync_mode=True)
    g = torch.ones(4)
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 1))
    svc.on_batch_barrier(0, seq=('c1', 2))
    assert len(rounds) == 1
    svc.on_batch_barrier(0, seq=('c1', 2))   # replay: round already ran
    assert len(rounds) == 1
    assert svc._trainer_rounds[0] == 1
    assert torch.equal(params['w'], -g)


def test_psclient_reconnects_and_replays_exactly_once():
    """Round 1's SEND_VAR is dropped (replay must APPLY it); round 2's
    is delivered then the connection closes before the reply (replay
    must be DEDUPED). Both rounds apply exactly once."""
    svc, params, rounds, _ = _mini_service(sync_mode=True)
    srv, st = _serve(PSServer, svc)
    plan = FaultPlan([
        resilience.FaultRule('send', 1, 'drop', type='SEND_VAR'),
        resilience.FaultRule('send', 3, 'close', type='SEND_VAR'),
    ])
    g1, g2 = torch.ones(4), 2 * torch.ones(4)
    with resilience.active_plan(plan):
        cli = PSClient('127.0.0.1:%d' % srv.port, trainer_id=0,
                       retry_policy=_fast_retry())
        cli.send_var('w@GRAD', g1)
        cli.batch_barrier()
        assert torch.equal(cli.get_var('w'), -g1)
        cli.send_var('w@GRAD', g2)
        cli.batch_barrier()
        assert torch.equal(cli.get_var('w'), -(g1 + g2))
        cli.complete()
        fired = resilience.fired_faults()
    cli.close()
    st.join(timeout=10.0)
    assert not st.is_alive()
    assert len(rounds) == 2
    assert [f['action'] for f in fired] == ['drop', 'close']


def test_pipelined_engine_replays_in_seq_order_after_a_drop():
    """The async engine: a dropped connection mid-window is rebuilt and
    every unacked request replayed in seq order; the dedup window makes
    it at-most-once."""
    svc, params, rounds, _ = _mini_service(sync_mode=True)
    srv, st = _serve(PSServer, svc)
    plan = FaultPlan([resilience.FaultRule('send', 2, 'close',
                                           type='SEND_VAR')])
    with resilience.active_plan(plan):
        cli = PSClient('127.0.0.1:%d' % srv.port, trainer_id=0,
                       retry_policy=_fast_retry())
        futs = [cli.send_var_async('w@GRAD', torch.full((4,), float(i)))
                for i in (1, 2)]
        for f in futs:
            f.result()
        cli.batch_barrier_async().result()
        got = cli.get_var_async('w').result()
        cli.complete()
    cli.close()
    st.join(timeout=10.0)
    # both sends arrived once; the service keeps one per (name, tid): the
    # second overwrote the first, as in the JAX package
    assert rounds == [['w@GRAD']] and torch.equal(got, -2 * torch.ones(4))


def test_master_replayed_finish_returns_cached_reply():
    srv = MasterServer('127.0.0.1:0', timeout_secs=30.0).start()
    try:
        plan = FaultPlan([
            resilience.FaultRule('send', 1, 'close',
                                 type='TASK_FINISHED')])
        with resilience.active_plan(plan):
            cli = MasterClient('127.0.0.1:%d' % srv.port, worker='w0',
                               retry_policy=_fast_retry())
            cli.set_dataset(['shard0'])
            tid, payload, _ = cli.get_task()
            assert payload == 'shard0'
            assert cli.task_finished(tid) is True
        status = cli.status()
        assert status['done'] == 1 and status['pending'] == 0
        cli.close()
    finally:
        srv.shutdown()


def _sub_env():
    env = dict(os.environ)
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    env.pop('FLAGS_fault_plan', None)
    return env


def test_exit_action_kills_process_at_nth_event():
    assert resilience.FaultRule('send', 1, 'exit').code == 137
    prog = (
        "import json, socket\n"
        "import torch\n"
        "from paddle_tpu_torch.distributed import resilience, wire\n"
        "plan = resilience.FaultPlan.from_json(json.dumps({'rules': [\n"
        "    {'when': 'send', 'type': 'SEND_VAR', 'nth': 2,\n"
        "     'action': 'exit', 'code': 41}]}))\n"
        "resilience.install_plan(plan)\n"
        "a, b = socket.socketpair()\n"
        "wire.write_msg(a, wire.SEND_VAR, {'name': 'g'}, torch.ones(2))\n"
        "wire.write_msg(a, wire.SEND_VAR, {'name': 'g'}, torch.ones(2))\n"
        "print('UNREACHABLE')\n")
    r = subprocess.run([sys.executable, '-c', prog], env=_sub_env(),
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 41, (r.stdout, r.stderr)
    assert 'UNREACHABLE' not in r.stdout
    assert 'fault injection: exit(41)' in r.stderr


def _two_trainer_service(average_live):
    params = {'w': torch.zeros(4)}

    def run_round(merged):
        for v in merged.values():
            params['w'] = params['w'] - torch.as_tensor(v)

    svc = ParameterService(
        num_trainers=2, sync_mode=True,
        get_param=lambda name: params[name], run_round=run_round,
        rpc_deadline=60.0, average_live=average_live)
    return svc, params


def test_merge_denominator_semantics():
    g = 4 * torch.ones(4)
    for average_live, expect in ((False, -2.0), (True, -4.0)):
        svc, params = _two_trainer_service(average_live)
        svc.on_complete(1)
        svc.on_send_var('w@GRAD', 0, g, seq=('c', 1))
        svc.on_batch_barrier(0, seq=('c', 2))
        assert torch.equal(params['w'], torch.full((4,), expect)), \
            average_live


def test_fetch_barrier_rejects_zombie_and_stale_incarnation():
    svc, _, _, _ = _mini_service()
    svc.dead_tids.add(0)
    svc._done_tids.add(0)
    with pytest.raises(RuntimeError, match='retired by the liveness'):
        svc.on_fetch_barrier(0)
    svc2, _, _, _ = _mini_service()
    svc2.on_register(0, inc=1)
    with pytest.raises(StaleIncarnationError):
        svc2.on_fetch_barrier(0, inc=0)


def test_stale_incarnation_rejected_non_retryable():
    svc, params, rounds, _ = _mini_service(sync_mode=True)
    srv, st = _serve(PSServer, svc)
    g = torch.ones(4)
    try:
        fresh = PSClient('127.0.0.1:%d' % srv.port, trainer_id=0,
                         retry_policy=_fast_retry(), incarnation=1)
        info = fresh.register()
        assert info == {'round': 0, 'expected': 0, 'rejoined': False}
        zombie = PSClient('127.0.0.1:%d' % srv.port, trainer_id=0,
                          retry_policy=_fast_retry(), incarnation=0)
        with pytest.raises(FatalRPCError, match='incarnation'):
            zombie.send_var('w@GRAD', g)
        assert rounds == []
        fresh.send_var('w@GRAD', g)
        fresh.batch_barrier()
        assert torch.equal(fresh.get_var('w'), -g)
        fresh.complete()
        fresh.close()
        zombie.close()
    finally:
        st.join(timeout=10.0)
    assert not st.is_alive()
    assert len(rounds) == 1


def test_check_liveness_retired_then_rejoined():
    params = {'w': torch.zeros(4)}
    svc = ParameterService(
        num_trainers=1, sync_mode=True,
        get_param=lambda name: params[name],
        run_round=lambda merged: None, rpc_deadline=0.05)
    svc._barrier_ever.add(0)
    svc._last_seen[0] = -1e9
    assert svc.check_liveness() is True
    assert 0 in svc.dead_tids
    info = svc.on_register(0, inc=1)
    assert info['rejoined'] is True
    assert svc.check_liveness() is False
    assert 0 not in svc.dead_tids
    svc.on_complete(0, inc=1)
    assert svc.check_liveness() is True


def _durable_service(path, snapshot_every=1, dtype=torch.float32):
    params = {'w': torch.zeros(4, dtype=dtype)}

    def run_round(merged):
        for v in merged.values():
            params['w'] = params['w'] - torch.as_tensor(v)

    svc = ParameterService(
        num_trainers=1, sync_mode=True,
        get_param=lambda name: params[name], run_round=run_round,
        rpc_deadline=60.0, snapshot_path=path,
        snapshot_every=snapshot_every,
        dump_state=lambda: dict(params),
        load_state=lambda p: params.update(
            {k: torch.as_tensor(v) for k, v in p.items()}))
    return svc, params


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_snapshot_restore_round_trip(tmp_path, dtype):
    path = str(tmp_path / 'ps.state')
    svc, params = _durable_service(path, dtype=dtype)
    for r in range(3):
        svc.on_send_var('w@GRAD', 0, (r + 1) * torch.ones(4, dtype=dtype),
                        seq=('c1', 2 * r + 1), inc=0, round_idx=r)
        svc.on_batch_barrier(0, seq=('c1', 2 * r + 2), inc=0,
                             round_idx=r)
    expect = params['w'].clone()
    svc2, params2 = _durable_service(path, dtype=dtype)
    assert params2['w'].dtype == dtype and torch.equal(params2['w'], expect)
    assert svc2._completed_rounds == 3
    assert svc2._trainer_rounds == {0: 3}
    assert svc2._seq_seen[0] == svc._seq_seen[0]
    svc2.on_send_var('w@GRAD', 0, 99 * torch.ones(4, dtype=dtype),
                     seq=('c1', 5), inc=0, round_idx=2)
    assert 0 not in svc2._pending.get('w@GRAD', {})


def test_journal_replays_mid_round_mutations(tmp_path):
    path = str(tmp_path / 'ps.state')
    svc, params = _durable_service(path, snapshot_every=10)
    svc.on_send_var('w@GRAD', 0, torch.ones(4),
                    seq=('c1', 1), inc=0, round_idx=0)
    svc.on_batch_barrier(0, seq=('c1', 2), inc=0, round_idx=0)
    svc.on_send_var('w@GRAD', 0, 2 * torch.ones(4),
                    seq=('c1', 3), inc=0, round_idx=1)
    post_round0 = params['w'].clone()
    with open(path + '.journal', 'ab') as f:
        f.write(b'\x07\x00')              # torn tail
    svc2, params2 = _durable_service(path, snapshot_every=10)
    assert torch.equal(params2['w'], post_round0)
    assert svc2._completed_rounds == 1
    assert torch.equal(svc2._pending['w@GRAD'][0], 2 * torch.ones(4))
    svc2.on_send_var('w@GRAD', 0, 2 * torch.ones(4),
                     seq=('c1', 3), inc=0, round_idx=1)
    assert list(svc2._seq_order[0]) == [('c1', 1), ('c1', 2), ('c1', 3)]


def test_a_port_journal_replays_in_the_jax_package(tmp_path):
    """A journal record is a wire frame: the JAX package's service
    replays the port's journal to the same pending gradient."""
    path = str(tmp_path / 'ps.state')
    svc, _ = _durable_service(path, snapshot_every=10)
    svc.on_send_var('w@GRAD', 0, torch.arange(4.0),
                    seq=('c1', 1), inc=0, round_idx=0)
    params = {'w': np.zeros(4, 'f4')}
    jsvc = jps.ParameterService(
        num_trainers=1, sync_mode=True,
        get_param=lambda name: params[name], run_round=lambda m: None,
        rpc_deadline=60.0, snapshot_path=path, snapshot_every=10,
        dump_state=lambda: dict(params), load_state=params.update)
    assert np.array_equal(jsvc._pending['w@GRAD'][0], np.arange(4.0))


# -- tests/test_task_master.py's cases that need no cluster ------------------

def test_lease_finish_cycle():
    m = TaskMaster(timeout_secs=60)
    m.set_dataset(['a', 'b'])
    t1, p1, l1 = m.get_task('w1')
    t2, p2, l2 = m.get_task('w2')
    assert {p1, p2} == {'a', 'b'}
    assert m.get_task('w3') == (None, None, None)
    assert not m.all_done()
    assert m.task_finished(t1)
    assert m.task_finished(t2)
    assert m.all_done()
    assert m.status()['done'] == 2


def test_timeout_requeues_task():
    m = TaskMaster(timeout_secs=0.2)
    m.set_dataset(['x'])
    t1, _, lease1 = m.get_task('dead-worker')
    assert m.get_task('w2') == (None, None, None)
    time.sleep(0.3)
    t2, p, lease2 = m.get_task('w2')
    assert p == 'x'
    assert not m.task_failed(t1, lease1)
    assert not m.task_finished(t1, lease1)
    assert m.task_finished(t2, lease2)
    assert m.all_done()


def test_failure_max_kills_task():
    m = TaskMaster(timeout_secs=60, failure_max=2)
    m.set_dataset(['poison'])
    for _ in range(2):
        tid, _, lease = m.get_task()
        m.task_failed(tid, lease)
    assert m.all_done()
    assert m.status()['dead'] == 1


def test_snapshot_recover(tmp_path):
    snap = str(tmp_path / 'master.json')
    m = TaskMaster(timeout_secs=60, snapshot_path=snap)
    m.set_dataset(['a', 'b', 'c'])
    t1, _, l1 = m.get_task('w')
    m.task_finished(t1, l1)
    m.get_task('w')
    del m
    m2 = TaskMaster(timeout_secs=60, snapshot_path=snap)
    st = m2.status()
    assert st['done'] == 1 and st['todo'] == 2
    got = {m2.get_task('w')[1], m2.get_task('w')[1]}
    assert len(got) == 2 and 'a' not in got


def test_tcp_roundtrip_against_the_jax_master():
    """The port's MasterClient against the JAX package's MasterServer
    and the reverse: the same message numbers and metas."""
    from paddle_tpu.distributed import master as jmaster
    for srv_cls, cli_cls in ((jmaster.MasterServer, MasterClient),
                             (MasterServer, jmaster.MasterClient)):
        srv = srv_cls('127.0.0.1:0', timeout_secs=60).start()
        try:
            cli = cli_cls('127.0.0.1:%d' % srv.port)
            cli.set_dataset(['s1', 's2'])
            tid, payload, drained = cli.get_task()
            assert payload in ('s1', 's2') and not drained
            assert cli.task_finished(tid)
            tid2, _, _ = cli.get_task()
            assert cli.task_failed(tid2)
            tid3, _, _ = cli.get_task()
            assert cli.task_finished(tid3)
            assert cli.status()['done'] == 2
            cli.close()
        finally:
            srv.shutdown()


def test_master_restart_on_same_port(tmp_path):
    snap = str(tmp_path / 'm.json')
    srv = MasterServer('127.0.0.1:0', timeout_secs=2.0,
                       snapshot_path=snap).start()
    port = srv.port
    c1 = MasterClient('127.0.0.1:%d' % port, worker='w1')
    c1.set_dataset(['t%d' % i for i in range(5)])
    done = []
    for _ in range(2):
        tid, p, _ = c1.get_task()
        done.append(p)
        c1.task_finished(tid)
    c1.get_task()
    srv.shutdown()
    srv2 = MasterServer('127.0.0.1:%d' % port, timeout_secs=2.0,
                        snapshot_path=snap).start()
    try:
        st = srv2.master.status()
        assert st['done'] == 2 and st['todo'] == 3
        c2 = MasterClient('127.0.0.1:%d' % port, worker='w2')
        while True:
            tid, p, drained = c2.get_task()
            if tid is None:
                assert drained
                break
            done.append(p)
            c2.task_finished(tid)
        assert sorted(done) == ['t%d' % i for i in range(5)]
        c2.close()
        c1.close()
    finally:
        srv2.shutdown()
