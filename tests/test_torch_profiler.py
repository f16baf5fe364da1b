"""fluid.profiler in the port (paddle_tpu_torch/profiler.py) against the
JAX package's (paddle_tpu/profiler.py; tests/test_profiler.py), on the
CPU:
- tests/test_profiler.py's four tests with CPUPlace(): the chrome trace,
  nesting and reset, per-op attribution (the op maps of a profiled run
  name mul, mul_grad and sgd), the Executor's device_segment: events;
- the summary table's text is the JAX package's for the same events,
  under every sorted_key;
- tools.timeline.convert gives the JAX tool's output on the same input,
  and tools.obs_report the JAX tool's rollup text on
  test_obs_report_cli_runs' synthetic root (tests/test_obs.py:519);
- write_report(xplane_dir=) and timeline --xplane_dir on a CPU capture:
  a device lane of the ATen ops each op ran, labeled `<type>.<idx>`, on
  the clock of the host spans;
- a synthetic CUDA trace (the layout torch.profiler writes: kernels tied
  to their launches by correlation id): eager kernels take the op range
  around their launch, a replayed graph's kernels the op its segment's
  map aligns them with by name (the warm-up's first-use kernel skipped),
  a kernel that does not align its raw name;
- a CUDA session that fails raises, and the op hooks cost nothing while
  the profiler is off.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import profiler as jprofiler
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import profiler
from paddle_tpu_torch import unique_name as tunique_name

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    profiler._enabled = False


def _sgd_program(fluid, width=8, hidden=None):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[width], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        h = fluid.layers.fc(input=x, size=hidden, act='relu') \
            if hidden else x
        p = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(p, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def _feed(rng, n=4, width=8):
    return {'x': rng.rand(n, width).astype('f4'),
            'y': rng.rand(n, 1).astype('f4')}


# -- tests/test_profiler.py's four, with CPUPlace() ----------------------------

def test_profiler_records_and_writes_chrome_trace(tmp_path):
    prog, startup, loss = _sgd_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    path = str(tmp_path / 'trace')
    feed = _feed(np.random.RandomState(0))
    with profiler.profiler(state='All', profile_path=path):
        for _ in range(3):
            with profiler.RecordEvent('train_step'):
                exe.run(prog, feed=feed, fetch_list=[loss])
    trace = json.load(open(path))
    events = trace['traceEvents']
    durs = [e for e in events if e.get('name') == 'train_step'
            and e.get('ph') == 'X']
    assert len(durs) == 3
    assert all(e['dur'] >= 0 for e in durs)
    assert isinstance(trace['otherData']['perf_counter_to_unix_s'], float)
    # the device trace and the op maps, where the JAX package writes its
    # xplane capture and its HLO texts
    assert os.path.isfile(os.path.join(path + '.xplane', 'trace.json'))
    assert os.listdir(path + '.hlo') == ['segment000.json']


def test_record_event_nesting_and_reset():
    profiler.reset_profiler()
    profiler.start_profiler('All')
    try:
        with profiler.RecordEvent('outer'):
            with profiler.RecordEvent('inner'):
                pass
        names = [e[0] for e in profiler._events]
        assert 'outer' in names and 'inner' in names
        profiler.reset_profiler()
        assert not profiler._events
    finally:
        profiler._enabled = False
    with pytest.raises(ValueError):
        profiler.start_profiler('TPU')


def test_per_op_attribution(tmp_path):
    """The counterpart of test_per_op_hlo_attribution: the op map of a
    profiled run resolves the kernels (on the CPU, the ATen ops) of
    forward, backward and optimizer ops back to `<type>.<idx>`."""
    prog, startup, loss = _sgd_program(tfluid, hidden=16)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    path = str(tmp_path / 'p')
    with profiler.profiler('All', profile_path=path):
        exe.run(prog, feed=_feed(np.random.RandomState(0)),
                fetch_list=[loss])
    maps = profiler.read_op_maps(path + '.hlo')
    assert maps == profiler.kernel_op_map(path + '.xplane')
    (key, kernels), = maps.items()
    assert key.count('/') == 2
    labels = {label for _, label in kernels if label}
    types = {label.rsplit('.', 1)[0] for label in labels}
    assert {'mul', 'mul_grad', 'sgd'} <= types, types
    ops = prog.global_block().ops
    for label in labels:
        op_type, idx = label.rsplit('.', 1)
        assert ops[int(idx)].type == op_type
    # the map is kept with the segment
    (seg,) = [s for p in exe._prepared_cache.values() for s in p.steps
              if getattr(s, 'op_maps', None)]
    assert seg.op_maps == {key: kernels}


def test_executor_emits_host_record_events():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        rdr = tfluid.layers.py_reader(capacity=2, shapes=[(-1, 4)],
                                      dtypes=['float32'], name='prof_r',
                                      use_double_buffer=False)
        x = tfluid.layers.read_file(rdr)
        out = tfluid.layers.fc(input=x, size=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    rdr.decorate_tensor_provider(lambda: iter([[np.ones((2, 4), 'f4')]]))
    rdr.start()
    profiler.start_profiler('CPU')
    exe.run(prog, fetch_list=[out])
    agg = profiler._aggregate()
    profiler.stop_profiler(profile_path=None)
    rdr.reset()
    assert any(k.startswith('device_segment:') for k in agg), agg
    assert 'host_op:read' in agg, agg


# -- the summary, the tools ---------------------------------------------------

EVENTS = [('device_segment:0(12 ops)', 1, 10.0, 10.004),
          ('device_segment:0(12 ops)', 1, 11.0, 11.0061),
          ('host_op:read', 1, 9.9, 9.9002),
          ('train_step', 2, 9.8, 10.1),
          ('a_rather_long_event_name_that_overflows_the_column', 1, 3.0,
           3.5)]


@pytest.mark.parametrize('sorted_key', [None, 'default', 'calls', 'total',
                                        'ave', 'min', 'max'])
def test_summary_text_is_the_jax_packages(sorted_key):
    texts = []
    for mod in (jprofiler, profiler):
        mod._events = list(EVENTS)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod._print_summary(sorted_key)
        mod._events = []
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[1].count('\n') == 2 + 4


def test_timeline_convert_is_the_jax_tools(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    try:
        import timeline as jtimeline
    finally:
        sys.path.pop(0)
    from paddle_tpu_torch.tools import timeline as ttimeline
    merged = {'traceEvents': [
        {'ph': 'X', 'name': 'b', 'pid': 2, 'tid': 0, 'ts': 10.0, 'dur': 1.0},
        {'ph': 'X', 'name': 'a', 'pid': 1, 'tid': 0, 'ts': 10.0, 'dur': 2.0},
        {'ph': 's', 'name': 'rpc', 'cat': 'rpc', 'id': 'abc', 'pid': 1,
         'tid': 0, 'ts': 11.0},
        {'ph': 'f', 'bp': 'e', 'name': 'rpc', 'cat': 'rpc', 'id': 'abc',
         'pid': 2, 'tid': 0, 'ts': 11.0},
        {'ph': 'M', 'name': 'process_name', 'pid': 1,
         'args': {'name': 'tr'}}],
        'otherData': {'perf_counter_to_unix_s': 1.5}}
    listed = [{'name': 'x', 'pid': 0, 'tid': 0, 'ts': 1.0, 'dur': 2.0},
              {'name': 'y', 'pid': 3, 'tid': 1, 'ts': 0.5, 'dur': 1.0,
               'cat': 'host', 'args': {'k': 1}},
              {'name': 'rpc', 'ph': 's', 'id': 'z', 'pid': 0, 'tid': 0,
               'ts': 2.0}]
    for i, data in enumerate((merged, listed)):
        src = str(tmp_path / ('in%d.json' % i))
        with open(src, 'w') as f:
            json.dump(data, f)
        for pretty in (False, True):
            outs = []
            for tool in (jtimeline, ttimeline):
                dst = str(tmp_path / ('out_%s.json' % tool.__name__))
                tool.convert(src, dst, pretty)
                outs.append(open(dst).read())
            assert outs[0] == outs[1]


def _cli_root(root):
    """test_obs_report_cli_runs' synthetic obs root."""
    for path, recs in (
            (os.path.join(root, 'tr', 'events-tr-1.jsonl'), [
                {'type': 'span', 'kind': 'client', 'name': 'rpc.GET_VAR',
                 'sid': 'q', 'psid': None, 't0': 1.0, 't1': 1.2, 'tid': 0,
                 'role': 'tr', 'pid': 1}]),
            (os.path.join(root, 'tr', 'metrics-tr-1.jsonl'), [
                {'ts': 1.0, 'role': 'tr', 'pid': 1,
                 'counters': {'rpc.client.calls': 9}, 'gauges': {},
                 'hists': {}}])):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, 'w') as f:
            for r in recs:
                f.write(json.dumps(r) + '\n')


def test_obs_report_cli_is_the_jax_tools(tmp_path):
    root = str(tmp_path / 'obs')
    _cli_root(root)
    outs = []
    for cmd in ([sys.executable, os.path.join(ROOT, 'tools',
                                              'obs_report.py')],
                [sys.executable, '-m', 'paddle_tpu_torch.tools.obs_report']):
        tl = str(tmp_path / ('tl%d.json' % len(outs)))
        ru = str(tmp_path / ('ru%d.json' % len(outs)))
        r = subprocess.run(cmd + ['--obs_dir', root, '--timeline', tl,
                                  '--rollup', ru, '--all'],
                           capture_output=True, text=True, timeout=180,
                           cwd=ROOT, env=dict(os.environ,
                                              JAX_PLATFORMS='cpu'))
        assert r.returncode == 0, r.stdout + r.stderr
        assert 'rpc.client.calls' in r.stdout
        outs.append((r.stdout.replace(tl, 'TL').replace(ru, 'RU'),
                     json.load(open(tl)), json.load(open(ru))))
    assert outs[0] == outs[1]


# -- device lanes of a CPU capture ---------------------------------------------

def _profiled_steps(tmp_path, obs_root=None, steps=2):
    prog, startup, loss = _sgd_program(tfluid, hidden=16)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    path = str(tmp_path / 'profile')
    rng = np.random.RandomState(0)
    if obs_root:
        tfluid.obs.trace.enable(obs_root, role='trainer0')
    try:
        with profiler.profiler('All', 'total', path):
            for _ in range(steps):
                with profiler.RecordEvent('train_step'):
                    exe.run(prog, feed=_feed(rng), fetch_list=[loss])
    finally:
        if obs_root:
            tfluid.obs.trace.disable()
    return prog, path


def _inside(inner, outer, slack_us=1.0):
    return any(o['ts'] - slack_us <= inner['ts'] and
               inner['ts'] + inner['dur'] <= o['ts'] + o['dur'] + slack_us
               for o in outer)


def test_write_report_reads_a_cpu_capture_into_device_lanes(tmp_path):
    root = str(tmp_path / 'obs')
    prog, path = _profiled_steps(tmp_path, obs_root=root)
    tl, _ = tfluid.obs.report.write_report(
        root, xplane_dir=path + '.xplane', hlo_dir=path + '.hlo')
    lanes = {e['pid']: e['args']['name'] for e in tl['traceEvents']
             if e.get('ph') == 'M'}
    assert sorted(lanes.values()) == ['device:CPU:0', 'trainer0']
    spans = [e for e in tl['traceEvents'] if e.get('ph') == 'X']
    steps = [e for e in spans if e['name'] == 'train_step']
    dev = [e for e in spans if lanes[e['pid']] == 'device:CPU:0']
    assert len(steps) == 2 and len(dev) > 20
    ops = prog.global_block().ops
    for e in dev:
        assert e['cat'] == 'device'
        op_type, idx = e['name'].rsplit('.', 1)
        assert ops[int(idx)].type == op_type
        assert _inside(e, steps)
    events = profiler.device_op_events(path + '.xplane', with_plane=True)
    assert len(events) == len(dev)
    assert {ev[3] for ev in events} == {'/device:CPU:0'}


def test_timeline_merges_the_device_stream_on_one_clock(tmp_path):
    from paddle_tpu_torch.tools import timeline as ttimeline
    _, path = _profiled_steps(tmp_path)
    out = str(tmp_path / 'tl.json')
    ttimeline.main(['--profile_path', path, '--timeline_path', out,
                    '--xplane_dir', path + '.xplane', '--hlo_dir',
                    path + '.hlo'])
    events = json.load(open(out))['traceEvents']
    steps = [e for e in events if e.get('name') == 'train_step']
    dev = [e for e in events if e.get('pid') == 1 and e.get('ph') == 'X']
    assert len(steps) == 2 and dev
    assert all(_inside(e, steps, slack_us=50.0) for e in dev)
    assert min(e['ts'] for e in events if 'ts' in e) == 0.0


def test_cuda_profiler_writes_the_trace_beside_the_output_file(tmp_path):
    prog, startup, loss = _sgd_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    out = str(tmp_path / 'cuda_prof')
    with profiler.cuda_profiler(out):
        exe.run(prog, feed=_feed(np.random.RandomState(1)),
                fetch_list=[loss])
    assert profiler.device_op_events(out + '.xplane')
    assert profiler.read_op_maps(out + '.hlo')
    assert not profiler.tracing


# -- a synthetic CUDA trace -----------------------------------------------------

BASE_NS = 1_790_000_000_000_000_000


def gpu_trace(runs, device=0, backward_tid=None):
    """A chrome trace in torch.profiler's layout for `runs`, each
    (segment key, phase, [(op label or None, kernel name), ...]): an
    eager run launches each kernel with cudaLaunchKernel inside its op's
    range, a replay or capture run launches all of them with one
    cudaGraphLaunch (its kernels share that launch's correlation id and
    carry no op range). With backward_tid, the kernels of `*_grad` ops
    launch from that thread (the autograd engine's), inside the op's
    range on the calling thread. Times in microseconds from BASE_NS."""
    events = []
    corr = [100]
    t = [0.0]

    def nxt():
        corr[0] += 1
        return corr[0]

    for key, phase, kernels in runs:
        t0 = t[0]
        span = 10.0 * len(kernels) + 10.0
        events.append({'ph': 'X', 'cat': 'user_annotation',
                       'name': 'segment@%s:%s' % (key, phase), 'pid': 1,
                       'tid': 1, 'ts': t0, 'dur': span})
        if phase == 'eager':
            for i, (label, name) in enumerate(kernels):
                at = t0 + 1.0 + 10.0 * i
                if label:
                    events.append({'ph': 'X', 'cat': 'user_annotation',
                                   'name': label, 'pid': 1, 'tid': 1,
                                   'ts': at, 'dur': 8.0})
                c = nxt()
                tid = backward_tid if backward_tid and label and \
                    label.split('.')[0].endswith('_grad') else 1
                events.append({'ph': 'X', 'cat': 'cpu_op',
                               'name': 'aten::something' if tid == 1 else
                               'autograd::engine::evaluate_function: '
                               'FlashBackward', 'pid': 1,
                               'tid': tid, 'ts': at + 1.0, 'dur': 5.0})
                events.append({'ph': 'X', 'cat': 'cuda_runtime',
                               'name': 'cudaLaunchKernel', 'pid': 1,
                               'tid': tid, 'ts': at + 2.0, 'dur': 1.0,
                               'args': {'correlation': c}})
                events.append({'ph': 'X', 'cat': 'kernel', 'name': name,
                               'pid': device, 'tid': 7, 'ts': at + 4.0,
                               'dur': 3.0, 'args': {'correlation': c,
                                                    'device': device}})
        else:
            c = nxt()
            events.append({'ph': 'X', 'cat': 'cuda_runtime',
                           'name': 'cudaGraphLaunch', 'pid': 1, 'tid': 1,
                           'ts': t0 + 1.0, 'dur': 2.0,
                           'args': {'correlation': c}})
            for i, (_, name) in enumerate(kernels):
                events.append({'ph': 'X', 'cat': 'kernel', 'name': name,
                               'pid': device, 'tid': 7,
                               'ts': t0 + 4.0 + 5.0 * i, 'dur': 4.0,
                               'args': {'correlation': c,
                                        'device': device}})
        t[0] = t0 + span + 5.0
    return {'schemaVersion': 1, 'baseTimeNanoseconds': BASE_NS,
            'traceEvents': events}


def write_trace(tmp_path, trace, name='gpu'):
    d = tmp_path / name
    d.mkdir()
    with open(d / 'trace.json', 'w') as f:
        json.dump(trace, f)
    return str(d)


WARM = [('fill_constant.0', 'memset_first_use'), ('mul.1', 'gemm_kernel'),
        ('mul.1', 'splitk_reduce'), ('flash_attention.2', 'flash_fwd'),
        ('flash_attention_grad.5', 'flash_bwd'), ('sgd.7', 'axpy')]


def test_synthetic_replay_takes_its_warm_ups_op_labels(tmp_path):
    replay = [(None, n) for _, n in WARM[1:]] + [(None, 'stray_kernel')]
    trace_dir = write_trace(tmp_path, gpu_trace(
        [('fp/0/aa', 'eager', WARM), ('fp/0/aa', 'replay', replay),
         ('fp/0/aa', 'replay', replay[:-1])]))
    maps = profiler.kernel_op_map(trace_dir)
    assert maps == {'fp/0/aa': [[n, l] for l, n in WARM]}
    events = profiler.device_op_events(trace_dir, maps, with_plane=True)
    assert len(events) == len(WARM) + 2 * len(replay) - 1
    labels = [e[0] for e in events]
    # eager: the op range around each launch
    assert labels[:len(WARM)] == [l for l, _ in WARM]
    # replays: aligned by name, the first-use memset skipped; the kernel
    # that does not align keeps its raw name
    want = [l for l, _ in WARM[1:]]
    assert labels[len(WARM):len(WARM) + len(replay)] == want + \
        ['stray_kernel']
    assert labels[len(WARM) + len(replay):] == want
    assert {e[3] for e in events} == {'/device:GPU:0'}
    first = gpu_trace([('fp/0/aa', 'eager', WARM)])['traceEvents']
    k0 = next(e for e in first if e.get('cat') == 'kernel')
    assert events[0][1] == BASE_NS + int(round(k0['ts'] * 1e3))
    assert events[0][2] == 3000
    # without a map the replays keep their kernels' names
    bare = profiler.device_op_events(trace_dir)
    assert [e[0] for e in bare[len(WARM):len(WARM) + 5]] == \
        [n for _, n in WARM[1:]]


def test_a_backward_launched_from_the_autograd_thread_takes_its_op(
        tmp_path):
    trace_dir = write_trace(tmp_path, gpu_trace(
        [('fp/0/aa', 'eager', WARM),
         ('fp/0/aa', 'replay', [(None, n) for _, n in WARM[1:]])],
        backward_tid=99))
    maps = profiler.kernel_op_map(trace_dir)
    assert maps['fp/0/aa'][4] == ['flash_bwd', 'flash_attention_grad.5']
    labels = [e['label'] for e in profiler.device_events(trace_dir, maps)]
    assert labels.count('flash_attention_grad.5') == 2
    phases = [e['phase'] for e in profiler.device_events(trace_dir, maps)]
    assert phases == ['eager'] * len(WARM) + ['replay'] * (len(WARM) - 1)
    # a launch from another thread that runs no autograd work (a reader's
    # copy) takes no op from the thread that holds the ranges
    trace = gpu_trace([('fp/0/aa', 'eager', WARM)], backward_tid=98)
    for e in trace['traceEvents']:
        if e.get('tid') == 98 and e.get('cat') == 'cpu_op':
            e['name'] = 'aten::copy_'
    other = write_trace(tmp_path, trace, name='copy')
    labels = [e['label'] for e in profiler.device_events(other)]
    assert labels[4] == 'flash_bwd'
    assert labels[:4] == [l for l, _ in WARM[:4]]


def test_synthetic_trace_without_a_time_base_raises(tmp_path):
    trace = gpu_trace([('k', 'eager', WARM)])
    del trace['baseTimeNanoseconds']
    with pytest.raises(ValueError, match='time base'):
        profiler.device_op_events(write_trace(tmp_path, trace))


@pytest.mark.parametrize('seed', range(6))
def test_align_pairs_equal_names_in_order(seed):
    rng = np.random.RandomState(seed)
    a = [str(x) for x in rng.randint(0, 5, 60)]
    b = list(a)
    for _ in range(rng.randint(0, 8)):
        b.insert(rng.randint(0, len(b) + 1), str(rng.randint(0, 7)))
    pairs = profiler.align(a, b)
    assert all(a[i] == b[j] for i, j in pairs)
    assert all(p[0] < q[0] and p[1] < q[1] for p, q in zip(pairs,
                                                           pairs[1:]))
    # what was only inserted into b leaves every element of a aligned
    assert len(pairs) == len(a)


# -- failures and the cost while off -------------------------------------------

class _FailingSession(object):
    def __init__(self, trace_dir, cuda):
        raise RuntimeError('CUPTI unavailable')


def test_a_failing_cuda_session_raises(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(profiler, '_Session', _FailingSession)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(RuntimeError, match='failed to start its CUDA'):
        with profiler.profiler('All', profile_path=str(tmp_path / 'p')):
            pass
    assert not profiler.tracing and not profiler._enabled


def test_a_failing_cpu_session_warns(monkeypatch, tmp_path):
    monkeypatch.setattr(profiler, '_Session', _FailingSession)
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.warns(UserWarning, match='failed to start'):
        with profiler.profiler('All', profile_path=str(tmp_path / 'p')):
            pass
    assert json.load(open(str(tmp_path / 'p')))['traceEvents'] == []


class _LostDeviceTrace(object):
    """A session whose trace holds launches and no device activity."""

    def __init__(self, trace_dir, cuda):
        self.trace_dir, self.cuda, self.segments = trace_dir, cuda, {}
        self.prof = self

    def start(self):
        pass

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        trace = gpu_trace([('k', 'eager', WARM)])
        trace['traceEvents'] = [e for e in trace['traceEvents']
                                if e.get('cat') != 'kernel']
        with open(path, 'w') as f:
            json.dump(trace, f)


def test_a_cuda_session_that_lost_its_device_events_raises(monkeypatch,
                                                           tmp_path):
    import torch
    monkeypatch.setattr(profiler, '_Session', _LostDeviceTrace)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(RuntimeError, match='no device activity'):
        with profiler.profiler('GPU', profile_path=str(tmp_path / 'p')):
            pass


def test_the_op_hooks_are_not_entered_while_the_profiler_is_off(
        monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError('a profiler range opened while it is off')
    monkeypatch.setattr(profiler, 'op_range', forbidden)
    monkeypatch.setattr(profiler, 'segment_range', forbidden)
    prog, startup, loss = _sgd_program(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    profiler.start_profiler('CPU')      # the host table alone
    try:
        exe.run(prog, feed=_feed(np.random.RandomState(0)),
                fetch_list=[loss])
    finally:
        profiler.stop_profiler(profile_path=None)


def test_the_jax_package_and_the_port_export_the_profiler():
    assert 'profiler' in jfluid.__all__ and 'profiler' in tfluid.__all__
    assert set(jprofiler.__all__) == set(profiler.__all__)
    for name in ('device_op_events', 'collective_audit'):
        assert callable(getattr(profiler, name))
