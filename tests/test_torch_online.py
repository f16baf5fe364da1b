"""paddle_tpu_torch's online refresh (online/, LMServer.enable_refresh,
DecodePredictor.param_digests / stage_weights) against the JAX package.

Each test of tests/test_online.py that applies to one device, on the
port, with the same name: version publication at the service, the wire
round trip in the serving client range, the subscriber's reassembly,
digest checks and tolerance, staleness and its SLO breach, step-boundary
swaps on the real decode engine, LMServer's stats and the trainer x
pserver x serving cluster (tests/torch_fleet_worker.py's roles). Then
the cross-package checks:
- param_digests() of both packages over one saved model are equal;
- the port's ParamSubscriber against the JAX package's ParameterService
  on sockets installs weights whose digests are that service's manifest;
- stage_weights takes the CPU tensors the port's wire decodes, bf16
  included, and copies them to the device without numpy (the JAX
  package's stage_weights starts from np.ascontiguousarray, which has no
  bf16: a bf16 tensor from the wire would fail there).
Streams are compared each package against itself, never across.
"""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.distributed import param_service as jparam_service
from paddle_tpu.distributed import rpc as jrpc
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.distributed import resilience, rpc, wire
from paddle_tpu_torch.distributed.param_service import ParameterService
from paddle_tpu_torch.distributed.resilience import FaultPlan, RetryPolicy
from paddle_tpu_torch.distributed.rpc import PSClient, PSServer
from paddle_tpu_torch.integrity import crc32
from paddle_tpu_torch.online import ParamSubscriber, RefreshError

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
import torch_fleet_worker as tfw  # noqa: E402

_WORKER = os.path.join(_HERE, 'torch_fleet_worker.py')


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


def _digest(value):
    return crc32(wire._payload_of(value)[1])


# -- version publication (service level) ---------------------------------------

def _versioned_service(sync_mode=True, num_trainers=1, params=None):
    params = params if params is not None else {
        'w': torch.arange(4, dtype=torch.float32),
        'b': torch.ones(2)}

    def run_round(merged):
        for name, v in merged.items():
            p = name[:-len('@GRAD')]
            params[p] = params[p] - v

    def run_one_grad(name, value):
        p = name[:-len('@GRAD')]
        params[p] = params[p] - value

    svc = ParameterService(
        num_trainers=num_trainers, sync_mode=sync_mode,
        get_param=lambda name: params[name], run_round=run_round,
        run_one_grad=run_one_grad, rpc_deadline=60.0,
        param_names=sorted(params))
    return svc, params


def test_version_bumps_once_per_sync_round():
    svc, params = _versioned_service()
    assert svc.on_get_version(0) == {'version': 0}
    g = torch.ones(4)
    for r in range(3):
        svc.on_send_var('w@GRAD', 0, g, seq=('c1', 2 * r + 1))
        svc.on_batch_barrier(0, seq=('c1', 2 * r + 2))
        assert svc.on_get_version(0)['version'] == r + 1
    # a replayed barrier closes no round and publishes no version
    svc.on_batch_barrier(0, seq=('c1', 6))
    assert svc.on_get_version(0)['version'] == 3


def test_version_bumps_per_applied_async_grad():
    svc, params = _versioned_service(sync_mode=False)
    g = torch.ones(4)
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 1))
    assert svc.on_get_version(0)['version'] == 1
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 1))   # dedup: no apply
    assert svc.on_get_version(0)['version'] == 1
    svc.on_send_var('w@GRAD', 0, g, seq=('c1', 2))
    assert svc.on_get_version(0)['version'] == 2


def test_manifest_digests_track_param_bytes():
    svc, params = _versioned_service()
    m0 = svc.on_get_version(0, with_manifest=True)['manifest']
    assert sorted(m0) == ['b', 'w']
    assert m0['w'] == _digest(params['w'])
    svc.on_send_var('w@GRAD', 0, torch.ones(4), seq=('c1', 1))
    svc.on_batch_barrier(0, seq=('c1', 2))
    m1 = svc.on_get_version(0, with_manifest=True)['manifest']
    assert m1['w'] == _digest(params['w'])
    assert m1['w'] != m0['w']
    assert m1['b'] == m0['b']        # untouched param, same bytes


def test_get_vars_reads_version_consistent_image():
    svc, params = _versioned_service()
    version, items = svc.on_get_vars(['w', 'b'], 0)
    assert version == 0
    got = {e['name']: (e['digest'], v) for e, v in items}
    for name in ('w', 'b'):
        assert got[name][0] == _digest(params[name])
        assert torch.equal(got[name][1], params[name])


def test_snapshot_restores_param_version(tmp_path):
    path = str(tmp_path / 'ps.state')
    params = {'w': torch.zeros(4)}

    def make():
        def run_round(merged):
            for v in merged.values():
                params['w'] = params['w'] - v
        return ParameterService(
            num_trainers=1, sync_mode=True,
            get_param=lambda n: params[n], run_round=run_round,
            rpc_deadline=60.0, param_names=['w'], snapshot_path=path,
            snapshot_every=1, dump_state=lambda: dict(params),
            load_state=lambda p: params.update(
                {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}))

    svc = make()
    for r in range(2):
        svc.on_send_var('w@GRAD', 0, torch.ones(4),
                        seq=('c1', 2 * r + 1), inc=0, round_idx=r)
        svc.on_batch_barrier(0, seq=('c1', 2 * r + 2), inc=0,
                             round_idx=r)
    assert svc.on_get_version(0)['version'] == 2
    svc2 = make()
    # the restarted shard publishes the version it died at
    assert svc2.on_get_version(0)['version'] == 2


def test_serving_complete_is_inert():
    svc, _ = _versioned_service(num_trainers=1)
    assert svc.on_complete(rpc.SERVING_TID_BASE) is False
    assert not svc._done_tids
    assert svc.on_complete(0) is True


# -- the wire round trip in the serving client range ---------------------------

def _fast_retry():
    return RetryPolicy(max_attempts=2, backoff=0.01, max_backoff=0.05,
                       reconnect_secs=5.0)


def _serve(svc, server_cls=PSServer):
    srv = server_cls('127.0.0.1:0', svc)
    st = threading.Thread(target=srv.serve_forever, daemon=True)
    st.start()
    return srv, st


def _complete(port):
    tcli = PSClient('127.0.0.1:%d' % port, trainer_id=0,
                    retry_policy=_fast_retry())
    tcli.complete()
    tcli.close()


def test_get_version_get_vars_over_sockets():
    svc, params = _versioned_service()
    srv, st = _serve(svc)
    cli = PSClient('127.0.0.1:%d' % srv.port,
                   trainer_id=rpc.SERVING_TID_BASE,
                   retry_policy=_fast_retry())
    try:
        out = cli.get_version(with_manifest=True)
        assert out['version'] == 0
        assert sorted(out['manifest']) == ['b', 'w']
        version, entries, values = cli.get_vars(['w', 'b'])
        assert version == 0
        assert [e['name'] for e in entries] == ['w', 'b']
        assert torch.equal(values[0], params['w'])
        assert torch.equal(values[1], params['b'])
        for e, v in zip(entries, values):
            assert _digest(v) == e['digest']
        assert cli.get_version_async().result(10.0)['version'] == 0
        v2, e2, _ = cli.get_vars_async(['b']).result(10.0)
        assert (v2, e2[0]['name']) == (0, 'b')
    finally:
        cli.close()
        assert st.is_alive()
        _complete(srv.port)
        st.join(timeout=10.0)
        assert not st.is_alive()


# -- the subscriber over fake clients ------------------------------------------

class _FakePredictor(object):
    def __init__(self, served):
        self.served = dict(served)        # name -> shape
        self.installed = {}
        self.installs = 0

    def param_names(self):
        return sorted(self.served)

    def stage_weights(self, params):
        for name, val in params.items():
            if name not in self.served:
                raise KeyError(name)
            if tuple(val.shape) != self.served[name]:
                raise ValueError(name)
        return dict(params)

    def install_weights(self, staged):
        self.installed.update(staged)
        self.installs += 1


class _FakeFuture(object):
    def __init__(self, value):
        self._value = value

    def result(self, timeout=None):
        if isinstance(self._value, Exception):
            raise self._value
        return self._value


class _FakeClient(object):
    def __init__(self, shard, version, tamper=None):
        self.shard, self.version, self.tamper = shard, version, tamper

    def _manifest(self):
        return {n: _digest(v) for n, v in self.shard.items()}

    def get_version_async(self, with_manifest=False):
        out = {'version': self.version}
        if with_manifest:
            out['manifest'] = self._manifest()
        return _FakeFuture(out)

    def get_vars_async(self, names):
        entries, values = [], []
        for n in names:
            d = self._manifest()[n]
            if n == self.tamper:
                d ^= 0xFFFF
            entries.append({'name': n, 'digest': d})
            values.append(self.shard[n])
        return _FakeFuture((self.version, entries, values))


def _fake_fleet(monkeypatch, shards):
    monkeypatch.setattr(rpc, 'get_serving_client',
                        lambda ep, sid=0: shards[ep])


def test_subscriber_reassembles_row_blocks(monkeypatch):
    g = torch.Generator().manual_seed(0)
    w = torch.rand(6, 3, generator=g)
    b = torch.rand(2, generator=g)
    _fake_fleet(monkeypatch, {
        'a:1': _FakeClient({'w.block0': w[:3].clone(), 'b': b}, version=4),
        'b:2': _FakeClient({'w.block1': w[3:].clone()}, version=4)})
    pred = _FakePredictor({'w': (6, 3), 'b': (2,)})
    sub = ParamSubscriber(['a:1', 'b:2'], pred)
    assert sub.refresh_once() == 4
    assert sub.installed_version == 4 and sub.staleness_rounds() == 0
    assert torch.equal(pred.installed['w'], w)
    assert torch.equal(pred.installed['b'], b)
    assert pred.installs == 1
    assert sub.stats()['refreshes'] == 1


def test_subscriber_reports_oldest_shard_version(monkeypatch):
    _fake_fleet(monkeypatch, {
        'a:1': _FakeClient({'w': torch.ones(2, 2)}, version=7),
        'b:2': _FakeClient({'b': torch.ones(2)}, version=5)})
    pred = _FakePredictor({'w': (2, 2), 'b': (2,)})
    sub = ParamSubscriber(['a:1', 'b:2'], pred)
    assert sub.refresh_once() == 5
    assert sub.published_version == 7
    assert sub.staleness_rounds() == 2


def test_subscriber_corrupt_digest_keeps_old_version(monkeypatch):
    w = torch.ones(2, 2)
    good = _FakeClient({'w': w}, version=1)
    _fake_fleet(monkeypatch, {'a:1': good})
    pred = _FakePredictor({'w': (2, 2)})
    sub = ParamSubscriber(['a:1'], pred)
    assert sub.refresh_once() == 1
    good.shard['w'] = 2 * w
    good.version, good.tamper = 2, 'w'
    with pytest.raises(RefreshError, match='digest mismatch'):
        sub.refresh_once()
    assert torch.equal(pred.installed['w'], w)
    assert sub.installed_version == 1
    assert sub.stats()['failures'] == 1
    assert 'digest mismatch' in sub.stats()['last_error']
    good.tamper = None
    assert sub.refresh_once() == 2
    assert torch.equal(pred.installed['w'], 2 * w)


def test_subscriber_skips_unserved_params(monkeypatch):
    _fake_fleet(monkeypatch, {
        'a:1': _FakeClient({'w': torch.ones(2, 2),
                            'table.block0': torch.ones(8, 4)}, version=1)})
    pred = _FakePredictor({'w': (2, 2)})
    sub = ParamSubscriber(['a:1'], pred)
    assert sub.refresh_once() == 1
    assert sorted(pred.installed) == ['w']


def test_subscriber_rejects_gapped_blocks_and_missing_params(monkeypatch):
    pred = _FakePredictor({'w': (4, 2)})
    _fake_fleet(monkeypatch, {
        'a:1': _FakeClient({'w.block0': torch.ones(2, 2),
                            'w.block2': torch.ones(2, 2)}, version=1)})
    sub = ParamSubscriber(['a:1'], pred)
    with pytest.raises(RefreshError, match='non-contiguous'):
        sub.refresh_once()
    assert pred.installs == 0
    _fake_fleet(monkeypatch, {
        'a:1': _FakeClient({'b': torch.ones(2)}, version=1)})
    pred2 = _FakePredictor({'w': (4, 2), 'b': (2,)})
    sub2 = ParamSubscriber(['a:1'], pred2)
    with pytest.raises(RefreshError, match='missing served'):
        sub2.refresh_once()
    assert pred2.installs == 0


# -- refresh over sockets, with a corrupt pull ---------------------------------

def _socket_fleet(monkeypatch, svc, server_cls=PSServer):
    srv, st = _serve(svc, server_cls)
    clients = []

    def fresh(ep, sid=0):
        c = PSClient(ep, trainer_id=rpc.SERVING_TID_BASE + sid,
                     retry_policy=_fast_retry())
        clients.append(c)
        return c

    monkeypatch.setattr(rpc, 'get_serving_client', fresh)
    return srv, st, clients


def _shutdown_fleet(srv, st, clients):
    for c in clients:
        try:
            c.close()
        except Exception:
            pass
    _complete(srv.port)
    st.join(timeout=10.0)
    assert not st.is_alive()


def test_refresh_over_sockets_bit_exact(monkeypatch):
    svc, params = _versioned_service()
    srv, st, clients = _socket_fleet(monkeypatch, svc)
    try:
        pred = _FakePredictor({'w': (4,), 'b': (2,)})
        sub = ParamSubscriber(['127.0.0.1:%d' % srv.port], pred)
        svc.on_send_var('w@GRAD', 0, torch.ones(4), seq=('c1', 1))
        svc.on_batch_barrier(0, seq=('c1', 2))
        sub.poll_published()
        assert sub.published_version == 1
        assert sub.refresh_once() == 1
        assert torch.equal(pred.installed['w'], params['w'])
        assert torch.equal(pred.installed['b'], params['b'])
    finally:
        _shutdown_fleet(srv, st, clients)


def test_corrupt_pull_keeps_old_version_serving(monkeypatch):
    svc, params = _versioned_service()
    srv, st, clients = _socket_fleet(monkeypatch, svc)
    try:
        pred = _FakePredictor({'w': (4,), 'b': (2,)})
        sub = ParamSubscriber(['127.0.0.1:%d' % srv.port], pred)
        assert sub.refresh_once() == 0
        w0 = pred.installed['w'].clone()
        svc.on_send_var('w@GRAD', 0, torch.ones(4), seq=('c1', 1))
        svc.on_batch_barrier(0, seq=('c1', 2))
        plan = FaultPlan([
            resilience.FaultRule('send', n, 'corrupt',
                                 type='REPLY_VAR', bits=4)
            for n in (1, 2, 3)])
        with resilience.active_plan(plan):
            with pytest.raises(RefreshError):
                sub.refresh_once()
        assert torch.equal(pred.installed['w'], w0)
        assert sub.installed_version == 0
        assert sub.stats()['failures'] == 1
        assert sub.refresh_once() == 1
        assert torch.equal(pred.installed['w'], params['w'])
    finally:
        _shutdown_fleet(srv, st, clients)


def test_staleness_gauge_and_slo_breach_when_stalled(monkeypatch):
    from paddle_tpu_torch.obs import telemetry
    from paddle_tpu_torch.obs.slo import SLOWatchdog, parse_rules
    svc, params = _versioned_service()
    srv, st, clients = _socket_fleet(monkeypatch, svc)
    telemetry.enable()
    try:
        telemetry.reset()
        pred = _FakePredictor({'w': (4,), 'b': (2,)})
        sub = ParamSubscriber(['127.0.0.1:%d' % srv.port], pred)
        dog = SLOWatchdog(parse_rules(json.dumps([
            {'name': 'serving_staleness',
             'metric': 'serving.staleness_rounds',
             'kind': 'gauge_max', 'threshold': 2}])))
        sub.refresh_once()
        assert dog.check_now() == []
        sub.pause()
        for r in range(4):
            svc.on_send_var('w@GRAD', 0, torch.ones(4),
                            seq=('c1', 2 * r + 1))
            svc.on_batch_barrier(0, seq=('c1', 2 * r + 2))
        sub.poll_published()
        assert sub.staleness_rounds() == 4
        snap = telemetry.snapshot()
        assert snap['gauges']['serving.staleness_rounds'] == 4
        breaches = dog.check_now()
        assert [b['rule'] for b in breaches] == ['serving_staleness']
        assert breaches[0]['value'] == 4
        sub.resume()
        sub.refresh_once()
        assert sub.staleness_rounds() == 0
        assert dog.check_now() == []
    finally:
        telemetry.disable()
        telemetry.reset()
        _shutdown_fleet(srv, st, clients)


# -- step-boundary swaps on the real decode engine -----------------------------

@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('torch_online_lm'))
    tfw.build_model(d)
    return d


@pytest.fixture(scope='module')
def lm_predictor(model_dir):
    return tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=tfluid.CPUPlace()))


def _current_weights(dec):
    return {n: dec._weight_scope.find_var(n).clone()
            for n in dec.param_names()}


def test_stage_install_weights_roundtrip(lm_predictor):
    dec = lm_predictor.prepare_decoding(slots=2, prefill_batch=1)
    cur = _current_weights(dec)
    assert cur, 'decode predictor serves no params?'
    staged = dec.stage_weights(cur)
    dec.install_weights(staged)
    for n, v in cur.items():
        assert torch.equal(dec._weight_scope.find_var(n), v)
    with pytest.raises(KeyError, match='unknown param'):
        dec.stage_weights({'bogus': np.zeros(3, 'f4')})
    name = next(iter(cur))
    bad = np.zeros(tuple(cur[name].shape) + (2,), 'f4')
    with pytest.raises(ValueError, match='shape mismatch'):
        dec.stage_weights({name: bad})


def _solo(pred, prompt, n):
    T = tfw.CFG['max_len']

    def step(toks):
        feed = np.zeros((1, T, 1), np.int64)
        feed[0, :len(toks), 0] = toks
        return int(np.argmax(pred.run({'tokens': feed})[0]
                             [0, len(toks) - 1]))
    toks, out = list(prompt), []
    for _ in range(n):
        t = step(toks)
        out.append(t)
        toks.append(t)
    return out


def test_identity_swap_midstream_is_bit_exact(lm_predictor):
    """An identity swap mid-stream leaves the stream the undisturbed
    run's, token for token."""
    from paddle_tpu_torch.serving import ServingEngine
    solo = _solo(lm_predictor, [3, 1, 4], 10)
    dec = lm_predictor.prepare_decoding(slots=2, prefill_batch=1)
    staged = dec.stage_weights(_current_weights(dec))
    with ServingEngine(dec) as eng:
        req = eng.submit([3, 1, 4], max_new_tokens=10)
        deadline = time.monotonic() + 60
        while len(req.tokens) < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        eng.request_swap(lambda: dec.install_weights(staged))
        assert req.result(120) == solo
        assert eng.stats()['weight_swaps'] == 1


def test_swap_switches_stream_at_one_boundary(lm_predictor):
    """Zeroing the lm_head makes every post-swap logit row constant, so
    every post-swap token is argmax's first index, 0: the stream is an
    old-version prefix equal to the undisturbed run, then zeros."""
    from paddle_tpu_torch.serving import ServingEngine
    prompt, budget = [9, 9, 1, 5], 12
    solo = _solo(lm_predictor, prompt, budget)
    assert 0 not in solo, 'pick a prompt whose solo stream avoids 0'
    dec = lm_predictor.prepare_decoding(slots=2, prefill_batch=1)
    cur = _current_weights(dec)
    head = [n for n in cur if 'lm_head' in n]
    assert head, sorted(cur)
    zeroed = dict(cur)
    for n in head:
        zeroed[n] = torch.zeros_like(cur[n])
    staged = dec.stage_weights(zeroed)
    restore = dec.stage_weights(cur)
    try:
        with ServingEngine(dec) as eng:
            req = eng.submit(prompt, max_new_tokens=budget)
            deadline = time.monotonic() + 60
            while len(req.tokens) < 3 and time.monotonic() < deadline:
                time.sleep(0.001)
            eng.request_swap(lambda: dec.install_weights(staged))
            out = req.result(120)
        assert len(out) == budget
        k = out.index(0) if 0 in out else budget
        assert k >= 3
        assert out[:k] == solo[:k], 'pre-swap prefix diverged'
        assert all(t == 0 for t in out[k:]), \
            'post-swap tokens blended versions: %r' % (out[k:],)
    finally:
        dec.install_weights(restore)


def test_request_swap_runs_inline_when_engine_stopped(lm_predictor):
    from paddle_tpu_torch.serving import ServingEngine
    dec = lm_predictor.prepare_decoding(slots=1, prefill_batch=1)
    eng = ServingEngine(dec)                # never started
    ran = []
    assert eng.request_swap(lambda: ran.append(1) or 'ok') == 'ok'
    assert ran == [1]
    assert eng.stats()['weight_swaps'] == 1


def test_lmserver_stats_report_version_and_staleness(lm_predictor):
    from paddle_tpu_torch.serving import LMServer
    dec = lm_predictor.prepare_decoding(slots=2, prefill_batch=1)
    with LMServer(dec) as srv:
        stats = srv.stats()
        assert stats['param_version'] is None
        assert stats['staleness_rounds'] is None
        assert srv.subscriber is None
        with pytest.raises(RuntimeError, match='enable_refresh'):
            srv.refresh_once()
        srv._subscriber = ParamSubscriber(['x:1'], dec)   # not started
        srv._subscriber.installed_version = 3
        srv._subscriber.published_version = 5
        srv._subscriber.refreshes = 3
        stats = srv.stats()
        assert stats['param_version'] == 3
        assert stats['staleness_rounds'] == 2
        assert stats['refreshes'] == 3
        assert stats['refresh_failures'] == 0


# -- the repaired stage_weights: wire tensors, bf16 included -------------------

def test_stage_weights_takes_wire_tensors_bf16_included(lm_predictor):
    """A weight served in bf16 takes a bf16 CPU tensor as the port's
    wire decodes it, bits unchanged, and its digest is the JAX
    package's for the same values (its wire writes bf16 as the same
    2-byte pattern)."""
    import ml_dtypes
    from paddle_tpu.distributed import wire as jwire
    from paddle_tpu.integrity import crc32 as jcrc32
    dec = lm_predictor.prepare_decoding(slots=2, prefill_batch=1)
    cur = _current_weights(dec)
    name = sorted(n for n in cur if cur[n].dim() == 2)[0]
    try:
        dec._weight_scope.set_var(name, cur[name].to(torch.bfloat16))
        g = torch.Generator().manual_seed(3)
        new = torch.randn(cur[name].shape, generator=g).to(torch.bfloat16)
        frame = wire.pack_msg(wire.REPLY_VAR, {'name': name}, value=new)
        (_, _, value), = wire.unpack_msgs(frame)
        assert value.dtype == torch.bfloat16 and value.device.type == 'cpu'
        staged = dec.stage_weights({name: value})
        assert staged[name].dtype == torch.bfloat16
        dec.install_weights(staged)
        served = dec._weight_scope.find_var(name)
        assert torch.equal(served.view(torch.int16), new.view(torch.int16))
        j = new.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        assert dec.param_digests()[name] == \
            jcrc32(jwire._payload_of(j)[1])
        # fp32 tensors from the wire go in as they are
        staged = dec.stage_weights({n: v for n, v in cur.items()
                                    if n != name})
        assert all(t.dtype == torch.float32 for t in staged.values())
    finally:
        dec.install_weights(dec.stage_weights(
            {name: cur[name].to(torch.bfloat16)}))
        dec._weight_scope.set_var(name, cur[name])


# -- cross-package: digests, and a port subscriber on JAX pservers -------------

def test_param_digests_equal_the_jax_packages(model_dir):
    from paddle_tpu.inference import AnalysisConfig, AnalysisPredictor
    jdec = AnalysisPredictor(AnalysisConfig(
        model_dir, place=jfluid.CPUPlace())).prepare_decoding(
            slots=2, prefill_batch=1)
    tdec = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=tfluid.CPUPlace())
    ).prepare_decoding(slots=2, prefill_batch=1)
    want = jdec.param_digests()
    assert want and tdec.param_digests() == want
    with jfluid.serving.LMServer(jdec) as js, \
            tfluid.serving.LMServer(tdec) as ts:
        assert ts.param_digests() == js.param_digests() == want


def test_port_subscriber_on_jax_pservers_installs_the_manifest(model_dir,
                                                               monkeypatch):
    """The JAX package's ParameterService on its own PSServer hosts the
    model's parameters plus a seeded update (version 1); a port LMServer
    refreshes from it over sockets and serves that service's manifest."""
    tdec = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=tfluid.CPUPlace())
    ).prepare_decoding(slots=2, prefill_batch=1)
    rng = np.random.RandomState(5)
    params = {n: tdec._weight_scope.find_var(n).numpy().copy()
              for n in tdec.param_names()}

    def run_round(merged):
        for n in params:
            params[n] = params[n] + rng.randn(*params[n].shape).astype(
                'f4') * np.float32(0.01)
    svc = jparam_service.ParameterService(
        num_trainers=1, sync_mode=True, get_param=lambda n: params[n],
        run_round=run_round, rpc_deadline=60.0, param_names=sorted(params))
    jsrv = jrpc.PSServer('127.0.0.1:0', svc)
    st = threading.Thread(target=jsrv.serve_forever, daemon=True)
    st.start()
    ep = '127.0.0.1:%d' % jsrv.port
    clients = []

    def fresh(e, sid=0):
        c = PSClient(e, trainer_id=rpc.SERVING_TID_BASE + sid,
                     retry_policy=_fast_retry())
        clients.append(c)
        return c
    monkeypatch.setattr(rpc, 'get_serving_client', fresh)
    try:
        svc.on_send_var('r@GRAD', 0, np.zeros(1, 'f4'), seq=('t', 1))
        svc.on_batch_barrier(0, seq=('t', 2))           # version 1
        with tfluid.serving.LMServer(tdec) as srv:
            srv.enable_refresh([ep], start=False)
            assert srv.refresh_once() == 1
            manifest = svc.on_get_version(0, with_manifest=True)['manifest']
            assert srv.param_digests() == manifest
            assert srv.stats()['param_version'] == 1
    finally:
        for c in clients:
            c.close()
        tcli = jrpc.PSClient(ep, trainer_id=0)
        tcli.complete()
        tcli.close()
        st.join(timeout=10.0)


# -- the trainer x pserver x serving cluster -----------------------------------

@pytest.mark.timeout(600)
def test_online_cluster_serving_tracks_training(tmp_path):
    """1 trainer x 2 pservers x 1 serving process of the port under the
    port's Supervisor: after N sync rounds the serving process's
    installed parameters digest-match what the trainer pulled after
    round N, the installed version reads N, and one serving process did
    it all (weight_swaps counted by the engine that answered the
    warm-up generate)."""
    from paddle_tpu_torch.distributed.supervisor import Supervisor
    steps, pservers = 3, 2
    eps = ','.join('127.0.0.1:%d' % p for p in tfw.free_ports(pservers))
    workdir = str(tmp_path)
    base = dict(os.environ, PS_ENDPOINTS=eps, PS_STEPS=str(steps),
                ON_DIR=workdir, FLAGS_online_poll_secs='0.1',
                OMP_NUM_THREADS='1')
    sup = Supervisor(max_restarts=0, backoff=0.5, log_dir=workdir)
    for i in range(pservers):
        sup.add_role('pserver%d' % i, [sys.executable, _WORKER],
                     env=dict(base, ON_ROLE='pserver',
                              PS_PSERVER_ID=str(i)))
    sup.add_role('trainer', [sys.executable, _WORKER],
                 env=dict(base, ON_ROLE='trainer'))
    sup.add_role('serving', [sys.executable, _WORKER],
                 env=dict(base, ON_ROLE='serving'))
    sup.start()
    try:
        states = sup.wait(timeout=480)
        tout = sup.output('trainer')
        sout = sup.output('serving')
        assert all(s == 'done' for s in states.values()), \
            (states, tout[-4000:], sout[-4000:])
        assert all(r == 0 for r in sup.restarts.values()), sup.restarts
    finally:
        sup.stop()

    def result_of(out):
        lines = [ln for ln in out.splitlines() if ln.startswith('RESULT ')]
        assert lines, out[-4000:]
        return json.loads(lines[-1][len('RESULT '):])

    trainer, serving = result_of(tout), result_of(sout)
    assert serving['installed_version'] == steps
    assert serving['refreshes'] >= 1
    assert serving['weight_swaps'] >= 1
    assert serving['refresh_failures'] == 0
    assert serving['digests'], 'serving reported no params'
    for name, digest in serving['digests'].items():
        assert name in trainer['digests'], \
            'serving installed %r the trainer never trained' % name
        assert digest == trainer['digests'][name], name
    assert len(serving['tokens_before']) == len(
        serving['tokens_after']) == tfw.ON_GEN
    assert all(np.isfinite(trainer['losses']))
