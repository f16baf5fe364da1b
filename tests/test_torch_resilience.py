"""The step half of paddle_tpu_torch's resilience layer, its state files
and the Trainer's fault handling, against the JAX package's on the CPU.

- FaultPlan.from_spec over the specs the JAX package's tests use gives
  the same to_dict()/to_json(); malformed specs fail loudly;
  RetryPolicy draws the same schedule; the step hook's actions.
- statefile: atomic writes, digest sidecars and quarantine, the same
  digests as the JAX package's.
- The Trainer under step faults (tests/test_chaos.py:357-400): a
  retryable fault retries once with the same losses, a fatal one rolls
  back to the last SUCCESS checkpoint and replays to the same bits, and
  without a checkpoint it surfaces; the FaultEvent sequences equal the
  JAX package's.
- The anomaly guard (tests/test_integrity.py:559-600): a poisoned feed
  is skipped, then rolled back, every surviving step the same bits as a
  fault-free run, and the same events as the JAX package's; off by
  default. A corrupt checkpoint is quarantined and resume falls back.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.distributed import resilience as jres
from paddle_tpu.distributed import statefile as jstate
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.distributed import statefile as tstate

from test_torch_trainer import fc_scripts, fc_train_func, fc_reader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the specs the JAX package's tests hand to FaultPlan.from_spec (chaos,
# integrity, grayfail and elastic sweeps)
SPECS = ['seed:%d' % n for n in range(8)] + \
    ['kill:trainer:%d' % n for n in range(4)] + \
    ['kill:pserver:%d' % n for n in range(4)] + \
    ['corrupt:%d' % n for n in range(6)] + \
    ['grayfail:replica:%d' % n for n in range(3)] + [
        json.dumps({'rules': [
            {'when': 'send', 'type': 'SEND_VAR', 'nth': 6,
             'action': 'drop'},
            {'when': 'send', 'type': 'BATCH_BARRIER', 'nth': 2,
             'action': 'close'},
            {'when': 'recv', 'type': 'REPLY_VAR', 'nth': 3,
             'action': 'delay', 'secs': 0.05}]}),
        '{"rules": []}',
        json.dumps({'rules': [{'when': 'step', 'nth': 4, 'action': 'nan'},
                              {'when': 'step', 'nth': 8, 'action': 'error',
                               'retryable': False},
                              {'when': 'send', 'nth': 2, 'action': 'exit',
                               'code': 41},
                              {'when': 'send', 'nth': 1,
                               'action': 'corrupt', 'bits': 3}],
                    'seed': 9}),
    ]


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The JAX package's fixture (conftest.py) resets only its own
    default programs; reset the port's too."""
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


# -- plans, policy, hook -----------------------------------------------------------

@pytest.mark.parametrize('spec', SPECS)
def test_fault_plan_from_spec_matches_jax(spec):
    want = jres.FaultPlan.from_spec(spec)
    got = tres.FaultPlan.from_spec(spec)
    assert [r.to_dict() for r in got.rules] == \
        [r.to_dict() for r in want.rules]
    assert got.to_json() == want.to_json()
    assert tres.FaultPlan.from_json(got.to_json()).to_json() == got.to_json()


def test_fault_plan_from_a_file_and_malformed_specs(tmp_path):
    path = str(tmp_path / 'plan.json')
    with open(path, 'w') as f:
        f.write(SPECS[-1])
    assert tres.FaultPlan.from_spec(path).to_json() == \
        jres.FaultPlan.from_spec(path).to_json()
    for bad in ('{"rules": [', 'kill:nobody:3',
                '{"rules": [{"when": "step", "nth": 1, "action": "stall"}]}'):
        with pytest.raises(ValueError, match='unparseable fault plan'):
            tres.FaultPlan.from_spec(bad)
    # the env bootstrap dies at import, loudly, naming the text
    env = dict(os.environ, FLAGS_fault_plan='{oops')
    r = subprocess.run([sys.executable, '-c',
                        'import paddle_tpu_torch.distributed.resilience'],
                       env=env, capture_output=True, text=True, timeout=180,
                       cwd=ROOT)
    assert r.returncode != 0 and '{oops' in r.stderr


def test_retry_policy_schedule_matches_jax():
    for kw in ({}, dict(max_attempts=7, backoff=0.01, max_backoff=0.05,
                        seed=3)):
        assert list(tres.RetryPolicy(**kw).schedule())[:1] == [0.0]
        if 'seed' in kw:
            assert list(tres.RetryPolicy(**kw).schedule()) == \
                list(jres.RetryPolicy(**kw).schedule())
    assert vars(tres.RetryPolicy.from_flags()) == \
        vars(jres.RetryPolicy.from_flags())


def test_step_hook_actions_and_audit_log():
    plan = tres.FaultPlan([
        tres.FaultRule('step', 1, 'delay', secs=0.0),
        tres.FaultRule('step', 2, 'nan'),
        tres.FaultRule('step', 3, 'error', retryable=True),
        tres.FaultRule('step', 4, 'error', retryable=False),
        tres.FaultRule('send', 1, 'drop', type='SEND_VAR')])
    assert tres.on_step() is None               # no plan installed
    with tres.active_plan(plan):
        assert tres.current_plan() is plan
        assert tres.on_step() is None
        assert tres.on_step() == 'nan'
        with pytest.raises(tres.RetryableRPCError):
            tres.on_step()
        with pytest.raises(tres.FatalRPCError):
            tres.on_step()
        assert tres.on_step() is None
        assert [f['nth'] for f in tres.fired_faults()] == [1, 2, 3, 4]
    assert tres.current_plan() is None
    assert issubclass(tres.TransientError, ConnectionError)
    assert issubclass(tres.StaleIncarnationError, tres.FatalRPCError)


def test_exit_step_rule_kills_at_the_exact_step():
    """FLAGS_fault_plan's env bootstrap installs the plan at import; an
    'exit' step rule is os._exit at that step, nothing after it runs."""
    prog = ('import paddle_tpu_torch.distributed.resilience as r\n'
            'r.on_step()\n'
            'print("STEP2", flush=True)\n'
            'r.on_step()\n'
            'print("UNREACHABLE", flush=True)\n')
    env = dict(os.environ, FLAGS_fault_plan=json.dumps(
        {'rules': [{'when': 'step', 'nth': 2, 'action': 'exit',
                    'code': 41}]}))
    r = subprocess.run([sys.executable, '-c', prog], env=env,
                       capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert r.returncode == 41, (r.stdout, r.stderr)
    assert 'UNREACHABLE' not in r.stdout
    assert 'fault injection: exit(41) at trainer step' in r.stderr


# -- statefile ------------------------------------------------------------------------

def _flip_byte(path, off):
    with open(path, 'r+b') as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def test_statefile_digests_and_quarantine_match_jax(tmp_path):
    path = str(tmp_path / 'state.bin')
    with tstate.atomic_replace(path) as f:
        f.write(os.urandom(4096))
    assert not [n for n in os.listdir(tmp_path) if n.endswith('.tmp')]
    assert tstate.verify_digest(path) == 'missing'
    tstate.write_digest(path)
    assert tstate.read_json(tstate.digest_path(path)) == \
        {'crc32': jstate.read_json(jstate.digest_path(path))['crc32'],
         'size': 4096}
    assert tstate.verify_digest(path) == jstate.verify_digest(path) == 'ok'
    _flip_byte(path, 2048)
    assert tstate.verify_digest(path) == jstate.verify_digest(path) == \
        'mismatch'
    q = tstate.quarantine(path, 'test')
    assert q == path + '.corrupt' and os.path.exists(q + '.crc')
    assert not os.path.exists(path)
    tstate.atomic_write_json(str(tmp_path / 'j.json'), {'a': [1, 2]})
    assert tstate.read_json(str(tmp_path / 'j.json')) == {'a': [1, 2]}
    assert tstate.read_json(str(tmp_path / 'none.json'), 7) == 7
    with pytest.raises(RuntimeError):
        with tstate.atomic_replace(str(tmp_path / 'j.json'), 'w') as f:
            f.write('torn')
            raise RuntimeError('crash mid-write')
    assert tstate.read_json(str(tmp_path / 'j.json')) == {'a': [1, 2]}
    d = tmp_path / 'ckpt'
    d.mkdir()
    assert tstate.quarantine_dir(str(d), 'x') == str(d) + '.corrupt'
    d.mkdir()
    assert tstate.quarantine_dir(str(d), 'y') == str(d) + '.corrupt-1'


# -- the Trainer under faults (tests/test_chaos.py, test_integrity.py) ----------------

def _run_trainer(fluid, res, ckpt_dir, plan=None, epochs=1):
    """The JAX tests' _run_trainer: the fc model, Adam(0.02), checkpoints
    every 3 steps (newest 2 kept); returns ({(epoch, step): loss},
    [(action, attempt), ...])."""
    fluid.unique_name.switch()
    train_func, opt_func, reader, order = fc_scripts(fluid)
    losses, faults = {}, []

    def handler(event):
        if isinstance(event, fluid.EndStepEvent):
            losses[(event.epoch, event.step)] = float(
                np.asarray(event.metrics[0]))
        elif isinstance(event, fluid.FaultEvent):
            faults.append((event.action, event.attempt))

    cfg = None if ckpt_dir is None else fluid.CheckpointConfig(
        checkpoint_dir=ckpt_dir, max_num_checkpoints=2, step_interval=3)
    with res.active_plan(plan):
        trainer = fluid.Trainer(train_func, opt_func, place=fluid.CPUPlace(),
                                checkpoint_config=cfg)
        trainer.train(num_epochs=epochs, event_handler=handler, reader=reader,
                      feed_order=order)
    return losses, faults


def _both(tmp_path, name, rules):
    jplan = jres.FaultPlan([jres.FaultRule(**r) for r in rules]) \
        if rules else None
    tplan = tres.FaultPlan([tres.FaultRule(**r) for r in rules]) \
        if rules else None
    return (_run_trainer(jfluid, jres, str(tmp_path / ('j' + name)), jplan),
            _run_trainer(tfluid, tres, str(tmp_path / ('t' + name)), tplan))


def test_retryable_step_fault_retries_with_the_same_losses(tmp_path):
    (_, jbase_f), (base, base_f) = _both(tmp_path, 'base', None)
    assert base_f == jbase_f == []
    (_, jf), (losses, faults) = _both(
        tmp_path, 'retry', [dict(when='step', nth=4, action='error',
                                 retryable=True)])
    assert faults == jf == [('retry', 1)]
    assert losses == base


def test_fatal_step_fault_rolls_back_to_the_same_bits(tmp_path):
    """Fatal fault at step 7 (checkpoints after steps 2 and 5): one
    rollback FaultEvent, the step-5 checkpoint restored, and the replay
    to the end has the same loss bits as an undisturbed run."""
    _, (base, _) = _both(tmp_path, 'base', None)
    (_, jf), (losses, faults) = _both(
        tmp_path, 'roll', [dict(when='step', nth=8, action='error',
                                retryable=False)])
    assert faults == jf and ('rollback', 1) in faults
    assert losses == base


def test_exhausted_retries_escalate_to_a_rollback(tmp_path):
    rules = [dict(when='step', nth=n, action='error', retryable=True)
             for n in (5, 6, 7)]
    _, (base, _) = _both(tmp_path, 'base', None)
    (_, jf), (losses, faults) = _both(tmp_path, 'esc', rules)
    assert faults == jf == [('retry', 1), ('retry', 2), ('rollback', 1)]
    assert losses == base


def test_fatal_step_fault_without_a_checkpoint_raises():
    plan = tres.FaultPlan([tres.FaultRule('step', 2, 'error',
                                          retryable=False)])
    with pytest.raises(tres.FatalRPCError):
        _run_trainer(tfluid, tres, None, plan)


def test_anomaly_guard_skips_then_rolls_back_bit_exact(tmp_path):
    """A poisoned feed (the 'nan' step action) trips the fused isfinite
    guard: the step is skipped (never checkpointed), the poison persists
    in the parameters so the streak escalates, and the rollback restores
    the last SUCCESS checkpoint; every surviving step has the loss bits
    of a fault-free run with the same flags, and the events are the JAX
    package's."""
    flags = {'FLAGS_anomaly_action': 'rollback', 'FLAGS_anomaly_skip_steps': 1}
    jfluid.set_flags(flags)
    tfluid.set_flags(flags)
    try:
        (_, jbase_f), (base, base_f) = _both(tmp_path, 'base', None)
        assert base_f == jbase_f == [] and len(base) == 10
        (_, jf), (losses, faults) = _both(
            tmp_path, 'guard', [dict(when='step', nth=4, action='nan')])
        assert faults == jf
        assert ('anomaly', 1) in faults and ('rollback', 1) in faults
        assert losses == base
    finally:
        off = {'FLAGS_anomaly_action': 'none', 'FLAGS_anomaly_skip_steps': 1}
        jfluid.set_flags(off)
        tfluid.set_flags(off)


def test_anomaly_guard_fatal_raises_once_the_skip_budget_is_spent(tmp_path):
    tfluid.set_flags({'FLAGS_anomaly_action': 'fatal'})
    try:
        plan = tres.FaultPlan([tres.FaultRule('step', 4, 'nan')])
        with pytest.raises(FloatingPointError, match='non-finite'):
            _run_trainer(tfluid, tres, str(tmp_path / 'f'), plan)
    finally:
        tfluid.set_flags({'FLAGS_anomaly_action': 'none'})


def test_anomaly_guard_off_by_default():
    t = tfluid.Trainer(fc_train_func(tfluid), lambda: tfluid.optimizer.Adam(
        0.02), place=tfluid.CPUPlace())
    assert t._guard_var is None
    assert 'isfinite' not in [op.type for op in
                              t.train_program.global_block().ops]
    tfluid.set_flags({'FLAGS_anomaly_action': 'rollback'})
    try:
        tunique_name.switch()
        t = tfluid.Trainer(fc_train_func(tfluid),
                           lambda: tfluid.optimizer.Adam(0.02),
                           place=tfluid.CPUPlace())
        guard = t.train_program.global_block().ops[-1]
        assert guard.type == 'isfinite'
        # the loss and the two dense float gradients
        assert len(guard.input('X')) == 3
    finally:
        tfluid.set_flags({'FLAGS_anomaly_action': 'none'})


def test_corrupt_checkpoint_quarantined_and_resume_falls_back(tmp_path):
    ckpt = str(tmp_path / 'ck')
    _run_trainer(tfluid, tres, ckpt)
    dirs = sorted((d for d in os.listdir(ckpt) if d.startswith('checkpoint')),
                  key=lambda d: int(d.split('_')[-1]))
    assert len(dirs) == 2
    newest = os.path.join(ckpt, dirs[-1])
    with open(os.path.join(newest, 'CHECKPOINT_DIGESTS')) as f:
        man = json.load(f)
    victim = sorted(man)[0]
    _flip_byte(os.path.join(newest, victim),
               os.path.getsize(os.path.join(newest, victim)) // 2)
    tunique_name.switch()
    t = tfluid.Trainer(fc_train_func(tfluid),
                       lambda: tfluid.optimizer.Adam(0.02),
                       place=tfluid.CPUPlace(),
                       checkpoint_config=tfluid.CheckpointConfig(
                           checkpoint_dir=ckpt))
    assert t._resumed
    assert os.path.exists(newest + '.corrupt')
    assert not os.path.exists(newest)
    with open(os.path.join(ckpt, dirs[-2], 'TRAINER_METADATA')) as f:
        assert t.step_id == json.load(f)['step_id'] + 1


def test_fault_events_reach_the_counters_and_the_trace_log(tmp_path):
    from paddle_tpu_torch.obs import telemetry, trace
    d = str(tmp_path / 'obs')
    telemetry.reset()
    telemetry.enable(d, role='t0', period=60.0)
    trace.enable(d, role='t0')
    try:
        plan = tres.FaultPlan([tres.FaultRule('step', 4, 'error',
                                              retryable=True)])
        _run_trainer(tfluid, tres, str(tmp_path / 'ck'), plan)
        snap = telemetry.snapshot()
    finally:
        trace.disable()
        telemetry.disable(final_flush=False)
        telemetry.reset()
    assert snap['counters']['trainer.fault.retry'] == 1
    # a retried step counts once
    assert snap['counters']['trainer.steps'] == 10
    assert snap['hists']['trainer.step_latency']['count'] == 10
    assert snap['counters']['faults.injected'] == 1
    events = [json.loads(line)
              for fn in os.listdir(d) if fn.startswith('events-')
              for line in open(os.path.join(d, fn))]
    faults = [e for e in events if e['type'] == 'fault']
    assert [(e['action'], e['step'], e['attempt']) for e in faults] == \
        [('retry', 3, 1)]


def test_trainer_test_runs_with_the_anomaly_guard():
    """The guard reads gradients; the port tags it 'backward', so the
    eval program Trainer.test clones drops it. (The JAX package leaves
    it untagged and its test() raises on the first gradient it reads:
    ROADMAP.md, Queue 3, known reference-side faults.)"""
    flags = {'FLAGS_anomaly_action': 'rollback'}
    tfluid.set_flags(flags)
    jfluid.set_flags(flags)
    try:
        trainers = []
        for fluid in (jfluid, tfluid):
            fluid.unique_name.switch()
            trainers.append(fluid.Trainer(fc_train_func(fluid),
                                          lambda f=fluid: f.optimizer.SGD(0.1),
                                          place=fluid.CPUPlace()))
        with pytest.raises(RuntimeError, match='@GRAD'):
            trainers[0].test(reader=fc_reader, feed_order=['x', 'y'])
        got = trainers[1].test(reader=fc_reader, feed_order=['x', 'y'])
        assert len(got) == 1 and np.isfinite(got[0])
        assert trainers[1].train_program.global_block().ops[-1].attr(
            'op_role') == 'backward'
    finally:
        off = {'FLAGS_anomaly_action': 'none'}
        tfluid.set_flags(off)
        jfluid.set_flags(off)
