"""paddle_tpu_torch's observability against the JAX package's, on the
CPU: the telemetry registry, the trace log, the merged report, the SLO
watchdog (also the serving engine's), the perf hooks of the Executor and
the memory estimators.

The parts of tests/test_obs.py and tests/test_perf_obs.py that need no
socket, profiler or tool run here against both packages:
- histograms, the exporter, clock offsets, the rollup and the timeline
  (test_obs.py:126, 143, 252, 293, 331): the same synthetic logs give
  the same outputs;
- perf telemetry through the Executor, the fingerprint and the FLOP
  count (cost_flops of an fc program is 2·M·N·K for each matmul it
  runs: the forward and the two grads), the disabled mode, the memory
  estimates (the same numbers as the JAX package's on the same
  Program), percentiles, torn tails and device lanes
  (test_perf_obs.py:84, 135, 147, 194, 217, 228, 241, 249, 272, 290);
- the three SLO rule tests and watchdog_from_flags (test_perf_obs.py:350,
  378, 388, 395), each against the JAX package's breach list.
Device lanes from a profiler capture (write_report(xplane_dir=)) come
from the torch.profiler trace that fluid.profiler writes: on the CPU
one lane of the ATen ops each program op ran, labeled `<type>.<idx>`,
inside the host span that ran them (tests/test_torch_profiler.py holds
the profiler itself).
"""
import json
import os
import time
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import memory as jmemory
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.obs import report as jreport
from paddle_tpu.obs import slo as jslo
from paddle_tpu.obs import telemetry as jtelemetry
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import memory as tmemory
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.obs import perf, report, slo, telemetry, trace


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


@pytest.fixture
def obs_on(tmp_path):
    """Telemetry + tracing into a tmp dir; always restored to the
    disabled default afterwards."""
    d = str(tmp_path / 'obs')
    telemetry.reset()
    perf._reset_for_tests()
    telemetry.enable(d, role='t0', period=60.0)
    trace.enable(d, role='t0')
    yield d
    trace.disable()
    telemetry.disable(final_flush=False)
    telemetry.reset()
    perf._reset_for_tests()
    slo.stop_global()


@pytest.fixture
def both_on(tmp_path):
    """Both packages' registries on (no export), for the same script."""
    for tm in (telemetry, jtelemetry):
        tm.reset()
        tm.enable()
    yield
    for tm in (telemetry, jtelemetry):
        tm.disable(final_flush=False)
        tm.reset()


def _events(obs_dir):
    out = []
    for dirpath, _, files in os.walk(obs_dir):
        for fn in files:
            if fn.startswith('events-'):
                with open(os.path.join(dirpath, fn)) as f:
                    out.extend(json.loads(line) for line in f if line.strip())
    return out


def _write_jsonl(path, recs):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'w') as f:
        for r in recs:
            f.write(json.dumps(r) + '\n')


# -- the registry (test_obs.py:126, 143; test_perf_obs.py:228, 241) -----------------

def test_histogram_buckets_and_reset_in_place(both_on):
    for tm in (jtelemetry, telemetry):
        h = tm.histogram('test.buckets')
        for v in (5e-5, 2e-4, 1e9):
            h.observe(v)
    got = telemetry.snapshot()['hists']['test.buckets']
    assert got == jtelemetry.snapshot()['hists']['test.buckets']
    assert got['count'] == 3 and got['buckets'][0] == 1 and \
        got['buckets'][1] == 1 and got['buckets'][-1] == 1
    telemetry.reset()
    h.observe(1.0)
    assert telemetry.snapshot()['hists']['test.buckets']['count'] == 1


def test_exporter_appends_snapshot_lines(obs_on):
    telemetry.counter('test.exported').inc(3)
    telemetry.flush()
    telemetry.counter('test.exported').inc(4)
    telemetry.flush()
    fn = [f for f in os.listdir(obs_on) if f.startswith('metrics-t0-')]
    assert len(fn) == 1
    with open(os.path.join(obs_on, fn[0])) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert [ln['counters']['test.exported'] for ln in lines] == [3, 7]
    assert lines[-1]['role'] == 't0' and lines[-1]['pid'] == os.getpid()


def test_histogram_percentiles_match_jax(both_on):
    for tm in (telemetry, jtelemetry):
        h = tm.histogram('test.pct')
        for v in [0.001] * 50 + [0.010] * 45 + [0.100] * 5:
            h.observe(v)
    d = telemetry.snapshot()['hists']['test.pct']
    assert d == jtelemetry.snapshot()['hists']['test.pct']
    assert d['min'] <= d['p50'] <= d['p95'] <= d['p99'] <= d['max']
    assert d['p50'] < 0.01 < d['p99']
    single = {'count': 1, 'min': 0.005, 'max': 0.005, 'sum': 0.005,
              'buckets': [0, 0, 0, 1] + [0] * 8}
    assert telemetry.hist_quantile(single, 0.5) == pytest.approx(0.005)
    assert telemetry.hist_quantile({'count': 0, 'buckets': []}, 0.99) is None


# -- the trace log -------------------------------------------------------------------

def test_spans_events_and_their_parents(obs_on):
    with trace.span('outer', kind='host', step=1) as outer:
        with trace.span('inner') as inner:
            trace.event('mark', name='m')
        trace.host_span('timed', 1.0, 2.0, k=3)
    trace.record_span('rpc', 'client', 'abc', 5.0, 6.0)
    assert trace.wire_trace(outer) == {'sid': outer.sid}
    assert trace.wire_trace(None) is None
    with trace.server_span('SEND_VAR', {'sid': 'abc'}) as srv:
        assert srv.sid == 'abc'
    with trace.server_span('SEND_VAR', None) as srv:
        assert srv is None
    ev = {e.get('name'): e for e in _events(obs_on)}
    assert ev['inner']['psid'] == outer.sid and ev['outer']['psid'] is None
    assert ev['outer']['step'] == 1 and ev['timed']['k'] == 3
    assert ev['timed']['psid'] == outer.sid
    assert ev['m']['type'] == 'mark'
    assert ev['rpc']['kind'] == 'client' and ev['rpc']['sid'] == 'abc'
    assert ev['SEND_VAR']['kind'] == 'server'
    assert all(e['role'] == 't0' and e['pid'] == os.getpid()
               for e in ev.values())
    assert inner.sid != outer.sid and trace.current_sid() is None
    files = [f for f in os.listdir(obs_on) if f.startswith('events-')]
    assert files == ['events-t0-%d.jsonl' % os.getpid()]
    trace.disable()
    with trace.span('off') as sp:
        assert sp is None
    trace.event('mark', name='dropped')
    assert 'dropped' not in {e.get('name') for e in _events(obs_on)}


# -- the report (test_obs.py:252, 293, 331; test_perf_obs.py:249, 272, 290) ----------

def _skewed_logs(root, skew=5.0):
    cspans = [{'type': 'span', 'kind': 'client', 'name': 'rpc.SEND_VAR',
               'sid': 's%d' % i, 'psid': None, 't0': 100.0 + i,
               't1': 100.2 + i, 'tid': 1, 'role': 'tr', 'pid': 10}
              for i in range(3)]
    sspans = [{'type': 'span', 'kind': 'server', 'name': 'SEND_VAR',
               'sid': 's%d' % i, 'psid': None,
               't0': 100.05 + i + skew, 't1': 100.15 + i + skew,
               'tid': 2, 'role': 'ps', 'pid': 20}
              for i in range(3)]
    faults = [{'type': 'fault', 't': 101.5, 'action': 'rollback',
               'role': 'tr', 'pid': 10},
              {'type': 'slo.breach', 't': 106.5, 'rule': 'r', 'role': 'ps',
               'pid': 20}]
    _write_jsonl(os.path.join(root, 'tr', 'events-tr-10.jsonl'),
                 cspans + faults[:1])
    _write_jsonl(os.path.join(root, 'ps', 'events-ps-20.jsonl'),
                 sspans + faults[1:])


def test_clock_offsets_and_timeline_match_jax(tmp_path):
    root = str(tmp_path)
    _skewed_logs(root)
    events, _ = report.collect(root)
    jevents, _ = jreport.collect(root)
    assert events == jevents and len(events) == 8
    offsets = report.estimate_offsets(events)
    assert offsets == jreport.estimate_offsets(jevents)
    assert offsets['tr'] == 0.0 and abs(offsets['ps'] + 5.0) < 1e-6
    tl = report.build_timeline(events)
    assert tl == jreport.build_timeline(jevents)
    lanes = {e['args']['name']: e['pid'] for e in tl['traceEvents']
             if e.get('ph') == 'M'}
    xs = [e for e in tl['traceEvents'] if e.get('ph') == 'X']
    c0 = next(e for e in xs if e['args'].get('sid') == 's0'
              and e['pid'] == lanes['tr'])
    s0 = next(e for e in xs if e['args'].get('sid') == 's0'
              and e['pid'] == lanes['ps'])
    assert c0['ts'] <= s0['ts'] <= c0['ts'] + c0['dur']
    assert sum(1 for e in tl['traceEvents'] if e.get('ph') == 's') == 3
    assert sum(1 for e in tl['traceEvents'] if e.get('ph') == 'f') == 3
    keys = [(e.get('ts', 0), e.get('pid', 0)) for e in tl['traceEvents']]
    assert keys == sorted(keys)
    instants = {e['name'] for e in tl['traceEvents'] if e.get('ph') == 'i'}
    assert instants == {'fault:rollback', 'slo.breach:'}


def test_timeline_sort_is_stable_and_keeps_flows(tmp_path):
    """Equal timestamps keep the lower pid first, and every flow event
    keeps its ph / id / bp (what tools/timeline.py round-trips in the
    JAX package's test_obs.py:331), the same as the JAX package's."""
    events = [
        {'type': 'span', 'kind': 'client', 'name': 'a', 'sid': 'z',
         't0': 10.0, 't1': 12.0, 'tid': 0, 'role': 'b', 'pid': 1},
        {'type': 'span', 'kind': 'server', 'name': 'b', 'sid': 'z',
         't0': 10.5, 't1': 11.5, 'tid': 0, 'role': 'a', 'pid': 2},
        {'type': 'span', 'kind': 'host', 'name': 'c', 'sid': 'y',
         't0': 10.0, 't1': 11.0, 'tid': 0, 'role': 'a', 'pid': 2},
    ]
    tl = report.build_timeline(events, offsets={})
    assert tl == jreport.build_timeline(events, offsets={})
    out = tl['traceEvents']
    keys = [(e.get('ts', 0), e.get('pid', 0)) for e in out]
    assert keys == sorted(keys)
    flow_s = next(e for e in out if e['ph'] == 's')
    flow_f = next(e for e in out if e['ph'] == 'f')
    assert flow_s['id'] == flow_f['id'] == 'z' and flow_f['bp'] == 'e'
    at10 = [e['pid'] for e in out if e.get('ts') == 0.0]
    assert at10 == sorted(at10)


def _rollup_logs(root):
    h1 = {'count': 2, 'sum': 0.4, 'min': 0.1, 'max': 0.3,
          'buckets': [0, 0, 0, 1, 1] + [0] * 7}
    h2 = {'count': 1, 'sum': 0.5, 'min': 0.5, 'max': 0.5,
          'buckets': [0, 0, 0, 0, 1] + [0] * 7}
    _write_jsonl(os.path.join(root, 'tr', 'metrics-tr-10.jsonl'), [
        {'ts': 1.0, 'role': 'tr', 'pid': 10,
         'counters': {'rpc.client.retries': 2}, 'gauges': {'q': 5},
         'hists': {'lat': h1}},
        {'ts': 2.0, 'role': 'tr', 'pid': 10,
         'counters': {'rpc.client.retries': 4}, 'gauges': {'q': 3},
         'hists': {'lat': h1}}])
    _write_jsonl(os.path.join(root, 'tr', 'metrics-tr-11.jsonl'), [
        {'ts': 3.0, 'role': 'tr', 'pid': 11,
         'counters': {'rpc.client.retries': 1}, 'gauges': {'q': 7},
         'hists': {'lat': h2}}])
    _write_jsonl(os.path.join(root, 'ps', 'metrics-ps-20.jsonl'), [
        {'ts': 1.5, 'role': 'ps', 'pid': 20,
         'counters': {'rpc.client.retries': 10, 'ps.rounds_completed': 6},
         'gauges': {}, 'hists': {}}])


def test_rollup_sums_roles_and_incarnations_like_jax(tmp_path):
    root = str(tmp_path)
    _rollup_logs(root)
    _, lasts = report.collect(root)
    _, jlasts = jreport.collect(root)
    ru = report.rollup(lasts)
    assert ru == jreport.rollup(jlasts)
    assert ru['roles']['tr']['counters']['rpc.client.retries'] == 5
    assert ru['roles']['tr']['gauges']['q'] == 7
    assert ru['roles']['tr']['hists']['lat']['count'] == 3
    assert 'buckets' not in ru['roles']['tr']['hists']['lat']
    assert ru['totals'] == {'rpc.client.retries': 15,
                            'ps.rounds_completed': 6}
    text = report.format_rollup_text(ru)
    assert text == jreport.format_rollup_text(ru)
    assert 'p50=' in text and 'tr:' in text


def test_rollup_ships_percentiles_from_a_live_export(tmp_path):
    d = str(tmp_path / 'obs')
    telemetry.reset()
    telemetry.enable(d, role='r0', period=60.0)
    try:
        h = telemetry.histogram('test.roll')
        for v in (0.001, 0.002, 0.004, 0.2):
            h.observe(v)
        telemetry.flush()
    finally:
        telemetry.disable(final_flush=False)
        telemetry.reset()
    _, lasts = report.collect(d)
    hd = report.rollup(lasts)['roles']['r0']['hists']['test.roll']
    assert 'buckets' not in hd
    assert hd['min'] <= hd['p50'] <= hd['p99'] <= hd['max']


def test_torn_metrics_tail_warns_not_crashes(tmp_path):
    d = str(tmp_path / 'obs')
    os.makedirs(d)
    good = {'ts': 1.0, 'role': 'r0', 'counters': {'c': 3},
            'gauges': {}, 'hists': {}}
    with open(os.path.join(d, 'metrics-r0-1.jsonl'), 'w') as f:
        f.write(json.dumps(good) + '\n')
        f.write(json.dumps(good)[:25])
    with pytest.warns(UserWarning, match='torn tail'):
        _, lasts = report.collect(d)
    assert len(lasts) == 1 and report.rollup(lasts)['totals']['c'] == 3


def test_device_lanes_round_trip_like_jax():
    base = 1700000000.0
    host = [{'type': 'span', 'kind': 'host', 'name': 'step', 'sid': 'h1',
             't0': base, 't1': base + 0.010, 'tid': 0, 'role': 'trainer0',
             'pid': 10}]
    dev = [('gemm.1', int((base + 0.002) * 1e9), 1_000_000, '/device:GPU:0'),
           ('flash.3', int((base + 0.004) * 1e9), 2_000_000, '/device:GPU:1')]
    recs = report.device_events_to_records(dev)
    assert recs == jreport.device_events_to_records(dev)
    tl = report.build_timeline(host + recs)
    lanes = {e['args']['name']: e['pid'] for e in tl['traceEvents']
             if e.get('ph') == 'M'}
    assert len({lanes['trainer0'], lanes['device:GPU:0'],
                lanes['device:GPU:1']}) == 3
    spans = {e['name']: e for e in tl['traceEvents'] if e.get('ph') == 'X'}
    assert spans['gemm.1']['cat'] == 'device'
    assert spans['gemm.1']['ts'] - spans['step']['ts'] == \
        pytest.approx(2000, abs=1)
    assert spans['flash.3']['dur'] == pytest.approx(2000, abs=1)


def test_write_report_merges_and_writes(tmp_path):
    root = str(tmp_path / 'obs')
    _skewed_logs(root)
    _rollup_logs(root)
    tl_path, ru_path = str(tmp_path / 'tl.json'), str(tmp_path / 'ru.json')
    tl, ru = report.write_report(root, timeline_path=tl_path,
                                 rollup_path=ru_path)
    jtl, jru = jreport.write_report(root)
    assert (tl, ru) == (jtl, jru)
    with open(tl_path) as f:
        assert json.load(f)['traceEvents'] == \
            json.loads(json.dumps(tl))['traceEvents']
    with open(ru_path) as f:
        assert json.load(f)['totals'] == ru['totals']
    # device lanes from a fluid.profiler capture of a CPUPlace run, on the
    # clock of the host spans RecordEvent sends to obs.trace
    prof_root = str(tmp_path / 'prof_obs')
    path = str(tmp_path / 'profile')
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[8], dtype='float32')
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=4))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    trace.enable(prof_root, role='trainer0')
    try:
        with tfluid.profiler.profiler('All', profile_path=path):
            with tfluid.profiler.RecordEvent('step'):
                exe.run(main, feed={'x': np.ones((4, 8), 'f4')},
                        fetch_list=[loss])
    finally:
        trace.disable()
    tl, _ = report.write_report(prof_root, xplane_dir=path + '.xplane',
                                hlo_dir=path + '.hlo')
    lanes = {e['pid']: e['args']['name'] for e in tl['traceEvents']
             if e.get('ph') == 'M'}
    assert set(lanes.values()) == {'trainer0', 'device:CPU:0'}
    spans = [e for e in tl['traceEvents'] if e.get('ph') == 'X']
    step = [e for e in spans if e['name'] == 'step']
    dev = [e for e in spans if lanes[e['pid']] == 'device:CPU:0']
    assert len(step) == 1 and dev
    assert {e['name'].rsplit('.', 1)[0] for e in dev} >= \
        {'mul', 'mean', 'mul_grad', 'sgd'}
    for e in dev:
        assert step[0]['ts'] - 1 <= e['ts'] and \
            e['ts'] + e['dur'] <= step[0]['ts'] + step[0]['dur'] + 1


# -- the SLO watchdog (test_perf_obs.py:350, 378, 388, 395) ---------------------------

RULES = [{'name': 'mfu_floor', 'metric': 'test.slo.mfu', 'kind': 'gauge_min',
          'threshold': 0.45},
         {'name': 'lat_p99', 'metric': 'test.slo.lat', 'kind': 'p99_max',
          'threshold': 0.010, 'min_count': 5},
         {'name': 'ok_rule', 'metric': 'test.slo.mfu', 'kind': 'gauge_max',
          'threshold': 0.90},
         {'name': 'mean', 'metric': 'test.slo.lat', 'kind': 'mean_max',
          'threshold': 1.0}]


def test_slo_breach_emits_event_like_jax(obs_on):
    jtelemetry.reset()
    jtelemetry.enable()
    try:
        for tm in (telemetry, jtelemetry):
            tm.gauge('test.slo.mfu').set(0.10)
            h = tm.histogram('test.slo.lat')
            for _ in range(10):
                h.observe(0.5)
        breaches = slo.SLOWatchdog(slo.parse_rules(json.dumps(RULES))) \
            .check_now()
        want = jslo.SLOWatchdog(jslo.parse_rules(json.dumps(RULES))) \
            .check_now()
    finally:
        jtelemetry.disable(final_flush=False)
        jtelemetry.reset()
    assert breaches == want
    assert {b['rule'] for b in breaches} == {'mfu_floor', 'lat_p99'}
    evs = [e for e in _events(obs_on) if e.get('type') == 'slo.breach']
    assert {e['rule'] for e in evs} == {'mfu_floor', 'lat_p99'}
    snap = telemetry.snapshot()
    assert snap['counters']['slo.breaches'] == 2
    assert snap['gauges']['slo.breaching'] == 2
    assert [r.to_dict() for r in slo.parse_rules(RULES)] == \
        [r.to_dict() for r in jslo.parse_rules(RULES)]
    with pytest.raises(ValueError, match='unknown SLO kind'):
        slo.SLORule('x', 'm', 'p42_max', 1.0)


def test_slo_rate_rule_needs_two_checks(obs_on):
    c = telemetry.counter('test.slo.tokens')
    wd = slo.SLOWatchdog([slo.SLORule('tok_floor', 'test.slo.tokens',
                                      'rate_min', 1e9)])
    assert wd.check_now() == []
    c.inc(100)
    assert [b['rule'] for b in wd.check_now()] == ['tok_floor']


def test_slo_min_count_suppresses_cold_registry(obs_on):
    telemetry.histogram('test.slo.cold').observe(9.0)
    wd = slo.SLOWatchdog([slo.SLORule('cold', 'test.slo.cold', 'p99_max',
                                      0.001, min_count=5)])
    assert wd.check_now() == []


def test_watchdog_from_flags(obs_on, tmp_path):
    rules_path = str(tmp_path / 'rules.json')
    with open(rules_path, 'w') as f:
        json.dump([{'name': 'r', 'metric': 'g', 'kind': 'gauge_min',
                    'threshold': 1.0}], f)
    assert slo.watchdog_from_flags() is None
    tfluid.set_flags({'FLAGS_slo_rules': '@' + rules_path,
                      'FLAGS_slo_check_secs': 0.5})
    try:
        wd = slo.watchdog_from_flags()
        assert wd.rules[0].name == 'r' and wd.period == 0.5
        assert slo.maybe_start_global() is slo.maybe_start_global()
    finally:
        slo.stop_global()
        tfluid.set_flags({'FLAGS_slo_rules': '', 'FLAGS_slo_check_secs': 5.0})


SERVE_CFG = dict(vocab=64, dim=32, heads=2, layers=1, ffn=64, max_len=16,
                 use_tp=False, use_sp=False)


def test_serving_engine_owns_a_watchdog(obs_on, tmp_path):
    """start() arms watchdog_from_flags(), the breaching rule lands
    slo.breach events while requests run, the holding one none, and
    stop() runs the final check and releases the watchdog."""
    model_dir = str(tmp_path / 'lm')
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 7
    with tfluid.program_guard(prog, startup):
        toks = tfluid.layers.data(name='tokens',
                                  shape=[1, SERVE_CFG['max_len'], 1],
                                  dtype='int64', append_batch_size=False)
        logits = ttransformer.language_model_logits(
            toks, ttransformer.TransformerConfig(**SERVE_CFG))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.io.save_inference_model(model_dir, ['tokens'], [logits], exe,
                                       main_program=prog)
    pred = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=tfluid.CPUPlace()))
    dec = pred.prepare_decoding(slots=2, prefill_batch=1)
    rules = [{'name': 'ttft', 'metric': 'serving.ttft', 'kind': 'p95_max',
              'threshold': 10.0},
             {'name': 'tokens_floor', 'metric': 'serving.tokens_generated',
              'kind': 'rate_min', 'threshold': 1e9}]
    tfluid.set_flags({'FLAGS_slo_rules': json.dumps(rules),
                      'FLAGS_slo_check_secs': 0.05})
    try:
        engine = tfluid.serving.ServingEngine(dec).start()
        assert engine._slo is not None and engine._slo._thread is not None
        # a rate rule is judged from its second check on: let the first
        # one prime the baseline before any token
        time.sleep(0.3)
        reqs = [engine.submit([1, 2, 3], 8), engine.submit([4, 5], 8)]
        for r in reqs:
            assert len(r.result(timeout=120)) == 8
        assert engine.stop(timeout=60)
    finally:
        tfluid.set_flags({'FLAGS_slo_rules': '', 'FLAGS_slo_check_secs': 5.0})
    assert engine._slo is None
    breached = {e['rule'] for e in _events(obs_on)
                if e.get('type') == 'slo.breach'}
    assert breached == {'tokens_floor'}
    assert telemetry.snapshot()['counters']['slo.breaches'] >= 1


# -- perf through the Executor (test_perf_obs.py:84, 135, 147) ------------------------

def _tiny_train(fluid, bs=4):
    x = fluid.layers.data(name='x', shape=[8], dtype='float32')
    y = fluid.layers.fc(input=x, size=4)
    loss = fluid.layers.mean(y)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss, {'x': np.ones((bs, 8), dtype='float32')}


def test_two_step_train_emits_perf_telemetry(obs_on):
    """Startup + two identical steps: hit and miss counts, a compile
    span with a fingerprint on each first run and none on the cache
    hit, three step latencies, live hbm gauges (the scope footprint on
    the CPU) and a nonzero MFU against a pinned 1 TFLOP/s peak."""
    tfluid.set_flags({'FLAGS_perf_peak_tflops': 1.0})
    try:
        loss, feed = _tiny_train(tfluid)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(tfluid.default_startup_program())
        exe.run(feed=feed, fetch_list=[loss])
        snap = telemetry.snapshot()
        assert snap['counters']['xla.jit_cache.miss'] >= 2
        before = [e for e in _events(obs_on) if e.get('name') == 'xla.compile']
        assert before and all(e['fingerprint'] for e in before)
        assert snap['hists']['xla.compile_latency']['count'] == \
            snap['counters']['xla.jit_cache.miss']
        exe.run(feed=feed, fetch_list=[loss])
        snap = telemetry.snapshot()
        assert snap['counters']['xla.jit_cache.hit'] >= 1
        after = [e for e in _events(obs_on) if e.get('name') == 'xla.compile']
        assert len(after) == len(before)
        assert snap['hists']['perf.step_latency']['count'] == 3
        assert snap['counters']['perf.steps'] == 3
        assert snap['gauges']['hbm.bytes_in_use'] > 0
        assert snap['gauges']['hbm.watermark_bytes'] >= \
            snap['gauges']['hbm.bytes_in_use']
        assert snap['gauges']['hbm.scope_bytes'] > 0
        assert snap['gauges']['hbm.bytes_limit'] == 0
        assert snap['gauges']['perf.achieved_tflops'] > 0
        assert snap['gauges']['perf.mfu'] > 0
        stats = exe.jit_cache_stats()
        assert snap['counters']['xla.jit_cache.miss'] == \
            stats['segment_misses']
        assert snap['counters']['xla.jit_cache.hit'] == stats['segment_hits']
        # return_numpy=False goes through the sync path
        exe.run(feed=feed, fetch_list=[loss], return_numpy=False)
        assert telemetry.snapshot()['counters']['perf.steps'] == 4
    finally:
        tfluid.set_flags({'FLAGS_perf_peak_tflops': 0.0})


def test_fingerprint_and_cost_flops_of_an_fc_program(obs_on):
    """cost_flops is FlopCounterMode's count of the warm-up: 2·M·N·K for
    the forward x·w and for each of its two grads (the recorded forward
    differentiates every float input, the fed x too)."""
    bs, k, n = 4, 8, 4
    loss, feed = _tiny_train(tfluid, bs)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    prepared = list(exe._prepared_cache.values())
    assert all(p.fingerprint for p in prepared)
    assert len({p.fingerprint for p in prepared}) == 2
    main = next(p for p in prepared
                if p.program is tfluid.default_main_program())
    assert main.cost_flops == 3 * 2 * bs * n * k
    exe.run(feed=feed, fetch_list=[loss])
    assert main.cost_flops == 3 * 2 * bs * n * k   # counted once


def test_flash_attention_is_priced_by_the_attention_model():
    """Under priced() the flash op adds 4·BH·T²·d forward and twice that
    backward, and FlopCounterMode sees none of its plain version's
    matmuls (no double count)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = (torch.randn(6, 16, 8, requires_grad=True) for _ in range(3))
    with tfa.priced() as model, FlopCounterMode(display=False) as counter:
        o = tfa.flash_attention(q, k, v, causal=True)
        o.sum().backward()
    assert model.flops == 3 * 4.0 * 6 * 16 * 16 * 8
    assert counter.get_total_flops() == 0
    assert tfa._pricing == []
    with FlopCounterMode(display=False) as counter:     # unpriced: seen
        tfa.flash_attention(q, k, v, causal=True)
    assert counter.get_total_flops() > 0
    assert perf.kernel_extra_flops() == 0.0


def test_disabled_mode_records_nothing():
    telemetry.reset()
    loss, feed = _tiny_train(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    assert perf.step_begin() is None
    telemetry.enable()
    try:
        snap = telemetry.snapshot()
    finally:
        telemetry.disable(final_flush=False)
        telemetry.reset()
    assert snap['counters']['perf.steps'] == 0
    assert snap['counters']['xla.jit_cache.miss'] == 0
    assert snap['hists']['perf.step_latency']['count'] == 0
    assert all(p.cost_flops == 0.0 for p in exe._prepared_cache.values())


def test_peak_table_and_override():
    assert perf.device_peak_flops(None) == 0.0
    assert perf.device_peak_flops('cpu') == 0.0
    assert perf._PEAK_BF16 == {'NVIDIA H100 80GB HBM3': 989.4e12}
    tfluid.set_flags({'FLAGS_perf_peak_tflops': 2.5})
    try:
        assert perf.device_peak_flops('cpu') == 2.5e12
    finally:
        tfluid.set_flags({'FLAGS_perf_peak_tflops': 0.0})


# -- memory (test_perf_obs.py:194, 217) ------------------------------------------------

def _lm_program(fluid, unique_name, transformer, amp):
    prog, startup = fluid.Program(), fluid.Program()
    cfg = transformer.TransformerConfig(vocab=64, dim=64, heads=4, layers=2,
                                        ffn=128, max_len=16, use_tp=False,
                                        use_sp=False, flash_attention=True,
                                        remat='nothing')
    with unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[16, 1], dtype='int64')
        labels = fluid.layers.data(name='labels', shape=[16, 1],
                                   dtype='int64')
        cost = fluid.layers.fused_softmax_cross_entropy(
            transformer.language_model_trunk(toks, cfg), labels, 64,
            chunk=16, name='lm_head')
        avg = fluid.layers.mean(cost)
        opt = fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg)
    return prog


@pytest.mark.parametrize('amp', [False, True])
def test_memory_estimates_match_jax(amp):
    """The same Program (remat sub-blocks included) gives the same
    estimates in both packages."""
    jprog = _lm_program(jfluid, junique_name, jtransformer, amp)
    tprog = _lm_program(tfluid, tunique_name, ttransformer, amp)
    assert tprog.to_string() == jprog.to_string()
    assert len(tprog.blocks) > 1
    for bs in (1, 8):
        assert tmemory.estimate_program_memory(tprog, bs) == \
            jmemory.estimate_program_memory(jprog, bs)
        assert tmemory.estimate_peak_memory(tprog, bs, amp_bf16=amp) == \
            jmemory.estimate_peak_memory(jprog, bs, amp_bf16=amp)
    est = tmemory.estimate_program_memory(tprog, 8)
    assert 0 < tmemory.estimate_peak_memory(tprog, 8) <= est['total']
    assert tmemory.dtype_bytes('bfloat16') == 2 and \
        tmemory.dtype_bytes('nope') == 4


def test_estimate_bounds_live_footprint(obs_on):
    loss, feed = _tiny_train(tfluid)
    est = tmemory.estimate_program_memory(tfluid.default_main_program(),
                                          batch_size=4)
    assert est['params'] > 0 and est['total'] >= est['params']
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    exe.run(feed=feed, fetch_list=[loss])
    actual = tmemory.max_memory_allocated('cpu')      # the scope footprint
    assert 0 < actual <= est['total']
    assert tmemory.memory_stats('cpu') is None
    assert tmemory.memory_limit(tfluid.CPUPlace()) is None
    snap = telemetry.snapshot()
    for g in ('hbm.bytes_in_use', 'hbm.peak_bytes', 'hbm.scope_bytes',
              'hbm.watermark_bytes'):
        assert snap['gauges'][g] > 0, g


def test_hbm_snapshot_shape():
    snap = tmemory.hbm_snapshot('cpu')
    assert set(snap) == {'bytes_in_use', 'peak_bytes', 'bytes_limit',
                         'scope_bytes'}
    assert snap['peak_bytes'] >= snap['bytes_in_use']
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert set(jmemory.hbm_snapshot()) == set(snap)
