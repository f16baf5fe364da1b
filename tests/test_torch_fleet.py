"""paddle_tpu_torch's fleet serving (serving/{replica,fleet}.py and
tools/serve_replica.py) against the JAX package.

Each test of tests/test_fleet.py that applies to one device, on the
port, with the same name: a replica killed mid-stream fails over with
every stream equal to the solo reference; a rolling deploy drops no
stream and converges each replica to the published digests; admission
control sheds before the TTFT SLO; the ReplicaServer's wire surface; the
SRV_SUBMIT priority/deadline meta under both meta codecs; the progress
watchdog fails a stalled replica over; the Supervisor's restart budget;
the engine's drain races. Replica processes are the port's entry point,
`python -m paddle_tpu_torch.tools.serve_replica` with SERVE_PLACE=cpu
(tests/torch_fleet_worker.py); the rest run in process.

Cross-package (one wire, two packages): the port's FleetRouter drives a
JAX ReplicaServer over a JAX LMServer, and the JAX router drives a port
replica; each gets the streams its own package's solo decode gives. A
port replica's SRV_HEALTH reply carries every key the JAX package's
does. Streams are compared each package against itself, never across.
"""
import json
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.integrity import crc32
from paddle_tpu_torch.serving import (FleetRouter, LMServer, OverloadError,
                                      ReplicaServer, ServingEngine)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_fleet_worker as tfw  # noqa: E402

GEN = 12
VOCAB = tfw.CFG['vocab']
CPU = tfluid.CPUPlace()


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


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('torch_fleet_model'))
    tfw.build_model(d)
    return d


@pytest.fixture(scope='module')
def ref_dec(model_dir):
    """The port's in-process decode over the same saved bytes."""
    pred = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=CPU))
    return pred.prepare_decoding(slots=8, prefill_batch=1)


def _refs(dec, prompts, n):
    """Each prompt's greedy stream from `dec` through one ServingEngine:
    the solo generate streams (test_torch_serving.py holds engine
    streams equal to them), batched 8 at a time."""
    with ServingEngine(dec) as eng:
        reqs = [eng.submit(p, max_new_tokens=n) for p in prompts]
        return [r.result(120) for r in reqs]


def _server(model_dir, **kw):
    return LMServer(model_dir, place=CPU, **kw)


class _InprocReplica(object):
    """A ReplicaServer (of either package) over an in-process LMServer,
    serving on a daemon thread."""

    def __init__(self, srv, replica_cls=ReplicaServer):
        self.rs = replica_cls(srv, '127.0.0.1:0')
        self.ep = '127.0.0.1:%d' % self.rs.port
        self._t = threading.Thread(target=self.rs.serve_forever,
                                   daemon=True)
        self._t.start()

    def stop(self):
        self.rs.shutdown()
        self._t.join(timeout=10)


# -- acceptance 1: a replica killed mid-stream, failover ------------------------

@pytest.mark.timeout(600)
def test_fleet_replica_kill_failover_bit_exact(model_dir, ref_dec):
    procs, eps = tfw.launch_replicas(model_dir, 2)
    router = FleetRouter(eps, poll_secs=0.005, probe_secs=0.05,
                         probe_fail_threshold=2)
    router.start()
    try:
        router.wait_healthy(timeout=120.0)
        work = tfw.make_prompts(0, 30, GEN)
        reqs = [router.submit(p, max_new_tokens=GEN, session=s)
                for p, s in work]
        # kill the moment a replica is provably mid-stream: >= 2 active
        # streams that already produced tokens
        victim_ep, deadline = None, time.monotonic() + 120
        while victim_ep is None and time.monotonic() < deadline:
            with router._mu:
                for ep, rep in router._reps.items():
                    if len([r for r in rep.active.values()
                            if r.tokens]) >= 2:
                        victim_ep = ep
                        break
            time.sleep(0.002)
        assert victim_ep, 'no replica reached 2 live streams'
        procs[eps.index(victim_ep)].kill()        # SIGKILL
        for r in reqs:
            assert r.wait(timeout=120.0), (r.id, r.state)
        assert router.stats()['failovers'] >= 1
        refs = _refs(ref_dec, [p for p, _s in work], GEN)
        for r, ref in zip(reqs, refs):
            assert r.state == 'DONE'
            assert r.result() == ref
    finally:
        router.stop()
        tfw.cleanup_replicas(procs, eps)


# -- acceptance 2: rolling deploy, zero drops, digest convergence --------------

@pytest.mark.timeout(600)
def test_fleet_rolling_deploy_zero_drop(model_dir):
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.distributed.param_service import ParameterService
    from paddle_tpu_torch.distributed.rpc import PSClient, PSServer

    srv_a = _server(model_dir, slots=4)
    srv_b = _server(model_dir, slots=4)
    params = {n: srv_a._decode._weight_scope.find_var(n).clone()
              for n in srv_a._decode.param_names()}
    svc = ParameterService(num_trainers=1, sync_mode=True,
                           get_param=lambda n: params[n],
                           run_round=lambda merged: None,
                           rpc_deadline=60.0, param_names=sorted(params))
    ps = PSServer('127.0.0.1:0', svc)
    pst = threading.Thread(target=ps.serve_forever, daemon=True)
    pst.start()
    ps_eps = ['127.0.0.1:%d' % ps.port]
    srv_a.enable_refresh(ps_eps, subscriber_id=101, poll_secs=0.05,
                         paused=True)
    srv_b.enable_refresh(ps_eps, subscriber_id=102, poll_secs=0.05,
                         paused=True)
    ra, rb = _InprocReplica(srv_a), _InprocReplica(srv_b)
    router = FleetRouter([ra.ep, rb.ep], poll_secs=0.005,
                         probe_secs=0.05)
    reqs, stop_traffic = [], threading.Event()

    def traffic():
        # a replica's slots of streams in flight at any time
        rng = np.random.RandomState(7)
        while not stop_traffic.is_set():
            if sum(not r.wait(0) for r in reqs) < 4:
                prompt = [int(t) for t in rng.randint(1, VOCAB, 3)]
                reqs.append(router.submit(prompt, max_new_tokens=8))
            stop_traffic.wait(0.005)

    t = threading.Thread(target=traffic, daemon=True)
    try:
        router.start()
        router.wait_healthy(timeout=120.0)
        t.start()
        # the deploy starts once streams are live on both replicas
        deadline = time.monotonic() + 60
        while not all(v['active'] for v in
                      router.stats()['replicas'].values()):
            assert time.monotonic() < deadline, router.stats()
            time.sleep(0.002)
        for n in list(params):
            params[n] = params[n] + 0.01
        svc.on_send_var('r@GRAD', 0, torch.zeros(1), seq=('t', 1))
        svc.on_batch_barrier(0, seq=('t', 2))     # publish version 1
        out = router.rolling_deploy(min_version=1)
        assert out == {ra.ep: 1, rb.ep: 1}
        # post-deploy traffic too: stop once it reached both replicas
        n0 = len(reqs)
        while len(reqs) < n0 + 4:
            time.sleep(0.005)
        stop_traffic.set()
        t.join(timeout=10)
        assert reqs
        for r in reqs:
            assert r.wait(timeout=120.0), (r.id, r.state)
            assert r.state == 'DONE'          # zero drops
            assert len(r.tokens) == 8
        want = {n: crc32(wire._payload_of(params[n])[1]) for n in params}
        assert srv_a.param_digests() == want
        assert srv_b.param_digests() == want
        st = router.stats()
        assert st['deploys'] == 1
        assert st['shed'] == 0 and st['failed'] == 0
        assert {v['param_version']
                for v in st['replicas'].values()} == {1}
    finally:
        stop_traffic.set()
        t.join(timeout=10) if t.is_alive() else None
        router.stop()
        ra.stop()
        rb.stop()
        srv_a.close(drain=False)
        srv_b.close(drain=False)
        # the subscribers' pooled connections end before the pserver does
        rpc.close_all_clients(send_complete=False)
        cli = PSClient('127.0.0.1:%d' % ps.port, trainer_id=0)
        cli.complete()
        cli.close()
        pst.join(timeout=10)


# -- acceptance 3: admission control sheds before the TTFT SLO -----------------

@pytest.mark.timeout(600)
def test_fleet_admission_control_sheds_before_slo(model_dir):
    from paddle_tpu_torch.obs import telemetry
    from paddle_tpu_torch.obs.slo import SLORule

    srv = _server(model_dir, slots=2)
    rep = _InprocReplica(srv)
    router = FleetRouter(
        [rep.ep], poll_secs=0.005, probe_secs=0.02, shed_consecutive=1,
        admission_rules=[{'name': 'fleet_backlog',
                          'metric': 'fleet.queue_depth',
                          'kind': 'gauge_max', 'threshold': 6}])
    telemetry.enable()
    try:
        telemetry.reset()
        router.start()
        router.wait_healthy(timeout=120.0)
        rng = np.random.RandomState(9)
        accepted, sheds = [], 0
        for _ in range(60):
            prompt = [int(v) for v in rng.randint(1, VOCAB, 3)]
            try:
                accepted.append(router.submit(prompt, max_new_tokens=6))
            except OverloadError:
                sheds += 1
            time.sleep(0.005)
        assert sheds > 0, router.stats()
        assert accepted
        st = router.stats()
        assert st['shed'] == sheds
        snap = telemetry.snapshot()
        assert snap['counters'].get('fleet.shed') == sheds
        for r in accepted:
            assert r.wait(timeout=120.0), (r.id, r.state)
            assert r.state == 'DONE'
        rule = SLORule('ttft_slo', 'fleet.ttft', 'p99_max', 10.0)
        out = rule.evaluate(router.admission_snapshot())
        assert out is not None and not out[1], out
    finally:
        telemetry.disable(final_flush=False)
        telemetry.reset()
        router.stop()
        rep.stop()
        srv.close(drain=False)


# -- the ReplicaServer's wire surface ------------------------------------------

def _caller(sock):
    seq = [0]

    def call(mt, meta=None, value=None):
        seq[0] += 1
        m = dict(meta or {}, seq=seq[0])
        wire.write_msg(sock, mt, m, value)
        rt, rmeta, _ = wire.read_msg(sock)
        assert rmeta['seq'] == seq[0]     # every reply echoes the seq
        return rt, rmeta
    return call


@pytest.mark.timeout(600)
def test_replica_server_wire_roundtrip(model_dir, ref_dec):
    srv = _server(model_dir, slots=2)
    rep = _InprocReplica(srv)
    sock = socket.create_connection(('127.0.0.1', rep.rs.port), timeout=10)
    call = _caller(sock)
    try:
        rt, h = call(wire.SRV_HEALTH, {})
        assert rt == wire.REPLY_OK
        assert h['capacity'] == 2
        assert h['max_len'] == tfw.CFG['max_len']
        assert h['draining'] is False
        assert (h['mesh_shape'], h['mesh_devices']) == ('', 1)
        rt, h2 = call(wire.SRV_HEALTH, {'digests': True})
        assert h2['digests'] == srv.param_digests()

        prompt = [3, 1, 4]
        rt, _m = call(wire.SRV_SUBMIT, {'rid': 'r1', 'mnt': 6},
                      np.asarray(prompt, np.int64))
        assert rt == wire.REPLY_OK
        deadline = time.monotonic() + 120
        while True:
            rt, pr = call(wire.SRV_POLL, {'rids': ['r1', 'ghost']})
            assert pr['streams']['ghost'] == {'state': 'UNKNOWN',
                                              'tokens': []}
            if pr['streams']['r1']['state'] == 'DONE':
                break
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert pr['streams']['r1']['tokens'] == ref_dec.generate(prompt, 6)

        # drain fence: submits rejected retryably while draining
        rt, _m = call(wire.SRV_DRAIN, {'on': True})
        assert rt == wire.REPLY_OK
        rt, err = call(wire.SRV_SUBMIT, {'rid': 'r2', 'mnt': 2},
                       np.asarray([5], np.int64))
        assert rt == wire.REPLY_ERR and err['retryable'] is True
        rt, _m = call(wire.SRV_DRAIN, {'on': False})

        # cancel mid-stream: terminal state, partial tokens kept
        rt, _m = call(wire.SRV_SUBMIT, {'rid': 'r3', 'mnt': 10 ** 6},
                      np.asarray([2, 6], np.int64))
        assert rt == wire.REPLY_OK
        while True:
            rt, pr = call(wire.SRV_POLL, {'rids': ['r3']})
            if pr['streams']['r3']['tokens']:
                break
            assert time.monotonic() < deadline
            time.sleep(0.01)
        rt, _m = call(wire.SRV_CANCEL, {'rid': 'r3'})
        assert rt == wire.REPLY_OK
        while pr['streams']['r3']['state'] != 'CANCELLED':
            rt, pr = call(wire.SRV_POLL, {'rids': ['r3']})
            assert time.monotonic() < deadline
            time.sleep(0.01)

        # no subscriber attached: refresh is a non-retryable error
        rt, err = call(wire.SRV_REFRESH, {})
        assert rt == wire.REPLY_ERR and err['retryable'] is False
        # a message type the replica does not serve
        rt, err = call(wire.GET_VAR, {'name': 'w'})
        assert rt == wire.REPLY_ERR and err['retryable'] is False
    finally:
        sock.close()
        rep.stop()
        srv.close(drain=False)


@pytest.mark.timeout(600)
def test_replica_submit_prio_deadline_meta_roundtrip(model_dir):
    """priority and deadline_ms survive the SRV_SUBMIT hop under both
    meta encodings; a meta without them decodes to tier 0 and no
    deadline; a spent deadline's typed failure crosses SRV_POLL."""
    srv = _server(model_dir, slots=2)
    seen = []
    orig_submit = srv.submit

    def spy(prompt, **kw):
        seen.append(dict(kw))
        return orig_submit(prompt, **kw)

    srv.submit = spy
    rep = _InprocReplica(srv)
    try:
        for bmeta in (False, True):
            sock = socket.create_connection(('127.0.0.1', rep.rs.port),
                                            timeout=10)
            if bmeta:
                wire._mark_peer_bmeta(sock)
            call = _caller(sock)
            try:
                tag = 'b' if bmeta else 'j'
                rt, _m = call(wire.SRV_SUBMIT,
                              {'rid': tag + '1', 'mnt': 4, 'prio': 2,
                               'deadline_ms': 60000.0},
                              np.asarray([3, 1, 4], np.int64))
                assert rt == wire.REPLY_OK
                assert seen[-1]['priority'] == 2
                assert seen[-1]['deadline_ms'] == pytest.approx(60000.0)
                rt, _m = call(wire.SRV_SUBMIT, {'rid': tag + '2', 'mnt': 2},
                              np.asarray([5], np.int64))
                assert rt == wire.REPLY_OK
                assert seen[-1]['priority'] == 0
                assert seen[-1]['deadline_ms'] is None
                rt, _m = call(wire.SRV_SUBMIT,
                              {'rid': tag + '3', 'mnt': 10 ** 6,
                               'deadline_ms': 1.0},
                              np.asarray([2, 6], np.int64))
                assert rt == wire.REPLY_OK
                deadline = time.monotonic() + 120
                while True:
                    rt, pr = call(wire.SRV_POLL, {'rids': [tag + '3']})
                    st = pr['streams'][tag + '3']
                    if st['state'] in ('DONE', 'FAILED', 'CANCELLED'):
                        break
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
                assert st['state'] == 'FAILED'
                assert 'DeadlineExceeded' in st['error']
            finally:
                sock.close()
    finally:
        rep.stop()
        srv.close(drain=False)


# -- the progress watchdog gray-marks a stalled replica ------------------------

@pytest.mark.timeout(600)
def test_fleet_watchdog_fails_over_stalled_replica_bit_exact(model_dir,
                                                             ref_dec):
    """replica 0's data path freezes for 25 s mid-burst (a stall rule
    on its 2nd inbound SRV_POLL) while its probes keep answering: the
    watchdog gray-marks it and fails its streams over, every stream the
    solo reference's."""
    from paddle_tpu_torch import flags
    plan = json.dumps({'rules': [{'when': 'recv', 'type': 'SRV_POLL',
                                  'nth': 2, 'action': 'stall',
                                  'secs': 25.0}]})
    procs, eps = tfw.launch_replicas(
        model_dir, 2, extra_env={0: {'FLAGS_fault_plan': plan}})
    router = None
    old_timeout = flags.get_flag('fleet_progress_timeout_secs')
    try:
        work = tfw.make_prompts(3, 8, GEN)
        for ep in eps:
            tfw.warm_replica(ep, work[0][0], GEN)
        flags.set_flags({'FLAGS_fleet_progress_timeout_secs': 2.5})
        router = FleetRouter(eps, poll_secs=0.005, probe_secs=0.05,
                             probe_fail_threshold=2)
        router.start()
        router.wait_healthy(timeout=120.0)
        reqs = [router.submit(p, max_new_tokens=GEN, session=s)
                for p, s in work]
        for r in reqs:
            assert r.wait(timeout=120.0), (r.id, r.state)
        st = router.stats()
        assert st['gray_marks'] >= 1, st
        refs = _refs(ref_dec, [p for p, _s in work], GEN)
        for r, ref in zip(reqs, refs):
            assert r.state == 'DONE'
            assert r.result() == ref
    finally:
        flags.set_flags({'FLAGS_fleet_progress_timeout_secs': old_timeout})
        if router is not None:
            router.stop()
        tfw.cleanup_replicas(procs, eps)


# -- the Supervisor's restart budget -------------------------------------------

def test_supervisor_budget_reset_after_healthy_uptime(tmp_path):
    from paddle_tpu_torch.distributed.supervisor import Supervisor
    script = 'import time, sys; time.sleep(0.7); sys.exit(1)'
    sup = Supervisor(max_restarts=1, backoff=0.05, healthy_secs=0.5,
                     log_dir=str(tmp_path))
    sup.add_role('r', [sys.executable, '-c', script])
    sup.start()
    try:
        deadline = time.monotonic() + 60
        while sup.restarts['r'] < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.restarts['r'] >= 2
        assert any('budget reset' in e[2] for e in sup.events)
        assert sup.states()['r'] != 'failed'
    finally:
        sup.stop()


def test_supervisor_budget_still_bounds_crash_loops(tmp_path):
    from paddle_tpu_torch.distributed.supervisor import Supervisor
    sup = Supervisor(max_restarts=1, backoff=0.05, healthy_secs=0.5,
                     log_dir=str(tmp_path))
    sup.add_role('r', [sys.executable, '-c', 'import sys; sys.exit(1)'])
    sup.start()
    try:
        states = sup.wait(timeout=60)
        assert states['r'] == 'failed'
        assert sup.restarts['r'] == 1
        assert not any('budget reset' in e[2] for e in sup.events)
    finally:
        sup.stop()


# -- the engine's drain timeout and drain races --------------------------------

@pytest.fixture()
def engine_dec(model_dir):
    pred = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=CPU))
    return pred.prepare_decoding(slots=2, prefill_batch=1)


def _wait_tokens(req, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not req.tokens:
        assert time.monotonic() < deadline, req.state
        time.sleep(0.005)


@pytest.mark.timeout(600)
def test_engine_drain_timeout_escalates_to_cancel(engine_dec):
    eng = ServingEngine(engine_dec).start()
    req = eng.submit([1, 2, 3], max_new_tokens=10 ** 9)
    _wait_tokens(req)
    t0 = time.monotonic()
    clean = eng.stop(drain=True, timeout=0.5)
    took = time.monotonic() - t0
    assert clean is False          # the escalation fired
    assert took < 30.0
    assert req.state == 'CANCELLED'
    assert req.tokens


@pytest.mark.timeout(600)
def test_engine_submit_during_drain_rejected(engine_dec):
    eng = ServingEngine(engine_dec).start()
    req = eng.submit([1, 2], max_new_tokens=10 ** 9)
    _wait_tokens(req)
    stopper = threading.Thread(
        target=lambda: eng.stop(drain=True, timeout=2.0), daemon=True)
    stopper.start()
    deadline = time.monotonic() + 30
    while eng._accepting:          # stop() flips it first
        assert time.monotonic() < deadline
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match='draining'):
        eng.submit([3], max_new_tokens=2)
    stopper.join(timeout=60.0)
    assert not stopper.is_alive()
    assert req.state == 'CANCELLED'


@pytest.mark.timeout(600)
def test_engine_cancel_during_drain_completes_promptly(engine_dec):
    eng = ServingEngine(engine_dec).start()
    req = eng.submit([1, 2], max_new_tokens=10 ** 9)
    _wait_tokens(req)
    result = {}

    def stopper():
        result['clean'] = eng.stop(drain=True, timeout=120.0)

    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while eng._accepting:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    eng.cancel(req)                # unblocks the drain immediately
    t.join(timeout=60.0)
    assert not t.is_alive()
    assert result['clean'] is True
    assert req.state == 'CANCELLED'
    assert req.tokens


# -- cross-package: one wire, two packages -------------------------------------

def _jax_solo(model_dir):
    from paddle_tpu.inference import AnalysisConfig, AnalysisPredictor
    return AnalysisPredictor(AnalysisConfig(
        model_dir, place=jfluid.CPUPlace())).prepare_decoding(
            slots=4, prefill_batch=1)


@pytest.mark.timeout(600)
def test_port_router_drives_a_jax_replica(model_dir):
    """The port's FleetRouter over a JAX ReplicaServer (a JAX LMServer in
    this process): every stream DONE with the JAX package's own solo
    decode."""
    from paddle_tpu.serving import LMServer as JLMServer
    from paddle_tpu.serving import ReplicaServer as JReplicaServer
    jsrv = JLMServer(model_dir, place=jfluid.CPUPlace(), slots=4)
    rep = _InprocReplica(jsrv, JReplicaServer)
    router = FleetRouter([rep.ep], poll_secs=0.005, probe_secs=0.05)
    try:
        router.start()
        router.wait_healthy(timeout=120.0)
        work = tfw.make_prompts(5, 8, GEN)
        reqs = [router.submit(p, max_new_tokens=GEN, session=s)
                for p, s in work]
        jdec = _jax_solo(model_dir)
        for r, (p, _s) in zip(reqs, work):
            assert r.result(timeout=120.0) == \
                [int(t) for t in jdec.generate(p, GEN)]
        st = router.stats()
        assert st['completed'] == len(work) and st['failed'] == 0
        assert st['replicas'][rep.ep]['capacity'] == 4
    finally:
        router.stop()
        rep.stop()
        jsrv.close(drain=False)


@pytest.mark.timeout(600)
def test_jax_router_drives_a_port_replica(model_dir, ref_dec):
    """The JAX package's FleetRouter over a port replica process: every
    stream DONE with the port's own solo decode."""
    from paddle_tpu.serving import FleetRouter as JFleetRouter
    procs, eps = tfw.launch_replicas(model_dir, 1)
    router = JFleetRouter(eps, poll_secs=0.005, probe_secs=0.05)
    try:
        router.start()
        router.wait_healthy(timeout=120.0)
        work = tfw.make_prompts(6, 8, GEN)
        reqs = [router.submit(p, max_new_tokens=GEN, session=s)
                for p, s in work]
        refs = _refs(ref_dec, [p for p, _s in work], GEN)
        for r, ref in zip(reqs, refs):
            assert r.result(timeout=120.0) == ref
        assert router.stats()['failed'] == 0
    finally:
        router.stop()
        launches = tfw.cleanup_replicas(procs, eps)
    # a replica on the CPU runs the plain versions: no kernel launch
    assert launches[0] is not None
    assert launches[0]['flash_attention_fwd'] == 0


@pytest.mark.parametrize('paged', [False, True])
def test_health_reports_the_jax_replicas_keys(model_dir, paged):
    """A port replica's SRV_HEALTH reply carries every key a JAX
    replica's does for the same server (dense, and paged with its
    prefix-cache keys), each of the same type."""
    from paddle_tpu.serving import LMServer as JLMServer
    from paddle_tpu.serving import ReplicaServer as JReplicaServer
    kw = dict(slots=2, paged=paged)
    if paged:
        kw.update(page_tokens=4, kv_pages=17)
    jsrv = JLMServer(model_dir, place=jfluid.CPUPlace(), **kw)
    tsrv = _server(model_dir, **kw)
    reps = [_InprocReplica(jsrv, JReplicaServer), _InprocReplica(tsrv)]
    try:
        got = []
        for rep in reps:
            host, port = rep.ep.rsplit(':', 1)
            with socket.create_connection((host, int(port)),
                                          timeout=10) as s:
                got.append(_caller(s)(wire.SRV_HEALTH, {'digests': True})[1])
        jh, th = got
        assert set(th) == set(jh)
        for k in jh:
            if jh[k] is None or th[k] is None:
                assert jh[k] is th[k] is None or k in (
                    'effective_tokens_per_step', 'spec_accept_rate'), k
            else:
                assert type(th[k]) is type(jh[k]), (k, th[k], jh[k])
        assert th['digests'] == jh['digests']
        assert (th['mesh_shape'], th['mesh_devices']) == ('', 1)
    finally:
        for rep in reps:
            rep.stop()
        jsrv.close(drain=False)
        tsrv.close(drain=False)
