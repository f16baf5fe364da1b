"""Profiler (counterpart of paddle_tpu/profiler.py): host RecordEvent
scopes with the JAX package's summary table and chrome trace, and a
device trace taken with torch.profiler.

- RecordEvent / record_event time a block on the host while the profiler
  is on, and send it to obs.trace as a host span while tracing is on.
  The Executor opens one around each host step (`host_op:<type>`) and
  each device segment's run (`device_segment:<i>(<n> ops)`), as the JAX
  package's does.
- profiler(state, sorted_key, profile_path): the host table and its
  chrome trace at `profile_path`; with state 'GPU' or 'All' also a
  torch.profiler session (CPU activity, and CUDA activity when a card is
  present) whose chrome trace goes to `<profile_path>.xplane/trace.json`,
  where the JAX package writes its xplane capture. While that session is
  on, the Executor runs each op it runs eagerly inside
  torch.profiler.record_function('<type>.<idx>') and each segment inside
  a `segment@<key>:<phase>` range (phase eager, capture or replay).
- The op maps, the counterpart of the JAX package's hlo_op_map: a
  replayed CUDA graph's kernels carry no range, so each segment's map is
  built from an eager run of it (its warm-up on the card, every run on
  the CPU): the kernels it launched, in order, each with the
  `<type>.<idx>` of the op that launched it. The map is kept with the
  segment and written to `<profile_path>.hlo/segmentNNN.json`, where the
  JAX package writes its HLO texts; a replay's kernels are aligned with
  it by kernel name, not by position (a warm-up also launches
  first-use work that the graph does not repeat), and a kernel that
  does not align keeps its raw name, as the JAX package drops
  ambiguous instructions.
- device_op_events reads the device events of such a trace: on the card
  its kernels, copies and memsets (plane `/device:GPU:<i>`); in a trace
  with no CUDA activity (a CPUPlace run) the ATen ops each op ran
  (plane `/device:CPU:0`). Times are unix-epoch nanoseconds, from the
  trace's own time base (`baseTimeNanoseconds`), the clock obs.trace's
  host spans use.

The JAX package swallows every failure of its device trace. Here a
session that traces CUDA and fails to start or stop raises, as does one
that saw kernel launches on the host and no device activity; without a
card the failure of the CPU-only session is a warning, as the JAX
package's would be silent.
"""
from __future__ import annotations

import contextlib
import difflib
import glob
import hashlib
import json
import os
import re
import shutil
import threading
import time
import warnings

from .obs import trace as _obs_trace

__all__ = ['RecordEvent', 'record_event', 'profiler', 'start_profiler',
           'stop_profiler', 'reset_profiler', 'cuda_profiler']

_lock = threading.Lock()
_enabled = False
_events = []     # (name, thread_id, start_s, end_s)
# time.time() - time.perf_counter() when the profiler last started: the
# host trace's perf_counter stamps plus this are unix-epoch seconds
_clock_offset = None

# the torch.profiler session of profiler() / cuda_profiler(); the
# Executor opens its ranges while `tracing` is True
_session = None
tracing = False


class RecordEvent(object):
    """Timing scope (reference platform/profiler.h RecordEvent). While
    obs tracing is on (FLAGS_obs_dir or obs.trace.enable), every scope
    also lands in the per-process obs event log as a host span,
    whether or not the profiler is on."""

    def __init__(self, name):
        self.name = name
        self.start = None
        self._obs_t0 = None

    def __enter__(self):
        if _enabled:
            self.start = time.perf_counter()
        if _obs_trace.enabled():
            self._obs_t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            end = time.perf_counter()
            # the flag is read under the lock, with the append: a
            # concurrent reset or stop must not see the event land in a
            # list it has replaced
            with _lock:
                if _enabled:
                    _events.append((self.name, threading.get_ident(),
                                    self.start, end))
        if self._obs_t0 is not None:
            _obs_trace.host_span(self.name, self._obs_t0, time.time())
        return False


record_event = RecordEvent


def reset_profiler():
    global _events
    with _lock:
        _events = []


def start_profiler(state='All'):
    """state in {CPU, GPU, All}; the device trace is profiler()'s."""
    global _enabled, _clock_offset
    if state not in ('CPU', 'GPU', 'All'):
        raise ValueError("state must be 'CPU', 'GPU' or 'All'")
    reset_profiler()
    with _lock:
        _clock_offset = time.time() - time.perf_counter()
        _enabled = True


def stop_profiler(sorted_key=None, profile_path='/tmp/profile'):
    global _enabled
    with _lock:
        _enabled = False
    _print_summary(sorted_key)
    if profile_path:
        _write_chrome_trace(profile_path)


def _aggregate():
    agg = {}
    with _lock:
        for name, tid, start, end in _events:
            total, calls, mn, mx = agg.get(name, (0.0, 0, float('inf'), 0.0))
            dur = end - start
            agg[name] = (total + dur, calls + 1, min(mn, dur), max(mx, dur))
    return agg


def _print_summary(sorted_key=None):
    agg = _aggregate()
    if not agg:
        return
    rows = [(name, calls, total * 1e3, total / calls * 1e3, mn * 1e3,
             mx * 1e3)
            for name, (total, calls, mn, mx) in agg.items()]
    keyfun = {None: lambda r: 0, 'default': lambda r: 0,
              'calls': lambda r: -r[1], 'total': lambda r: -r[2],
              'ave': lambda r: -r[3], 'min': lambda r: -r[4],
              'max': lambda r: -r[5]}[sorted_key]
    rows.sort(key=keyfun)
    print('------------------------->  Profiling Report  '
          '<-------------------------')
    print('%-40s %8s %12s %12s %12s %12s'
          % ('Event', 'Calls', 'Total(ms)', 'Avg(ms)', 'Min(ms)', 'Max(ms)'))
    for r in rows:
        print('%-40s %8d %12.4f %12.4f %12.4f %12.4f' % r)


def _write_chrome_trace(path):
    """chrome://tracing JSON of the host events, the JAX package's
    layout; `otherData.perf_counter_to_unix_s` puts its perf_counter
    stamps on the unix-epoch clock (tools/timeline.py)."""
    agg_events = []
    with _lock:
        for name, tid, start, end in _events:
            agg_events.append({
                'name': name, 'cat': 'host', 'ph': 'X',
                'ts': start * 1e6, 'dur': (end - start) * 1e6,
                'pid': 0, 'tid': tid,
            })
        offset = _clock_offset
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, 'w') as f:
        json.dump({'traceEvents': agg_events,
                   'otherData': {'perf_counter_to_unix_s': offset}}, f)


# ---------------------------------------------------------------------------
# The torch.profiler session and the Executor's ranges
# ---------------------------------------------------------------------------

TRACE_FILE = 'trace.json'


class _Session(object):
    """One torch.profiler session: the trace directory, whether it traces
    CUDA, and the segments the Executor ran under it ({key: segment}),
    whose op maps are kept on them at stop."""

    def __init__(self, trace_dir, cuda):
        from torch.profiler import ProfilerActivity, profile
        self.trace_dir = trace_dir
        self.cuda = cuda
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.segments = {}


def op_range(op_type, pos):
    """record_function('<type>.<idx>') around one op's emitter (the
    Executor calls it only while `tracing`)."""
    from torch.profiler import record_function
    return record_function('%s.%d' % (op_type, pos))


def segment_key(fingerprint, step_idx, sig):
    """A device segment's key: its prepared program, its index and a hash
    of its input signature (a segment captures one graph a signature)."""
    return '%s/%d/%s' % (fingerprint, step_idx,
                         hashlib.md5(repr(sig).encode()).hexdigest()[:8])


def segment_range(key, phase, segment):
    """record_function('segment@<key>:<phase>') around one run of a
    device segment; notes the segment so that the op map built from
    this session's trace is kept on it (`segment.op_maps[key]`)."""
    from torch.profiler import record_function
    session = _session
    if session is not None:
        session.segments[key] = segment
    return record_function('segment@%s:%s' % (key, phase))


def _start_session(trace_dir):
    """Start a torch.profiler session writing to `trace_dir` (cleared
    first: a stale trace would be read with the new one)."""
    global _session, tracing
    import torch
    cuda = torch.cuda.is_available()
    if os.path.isdir(trace_dir):
        shutil.rmtree(trace_dir)
    try:
        session = _Session(trace_dir, cuda)
        session.prof.start()
    except Exception as e:     # noqa: BLE001 — raised on the card
        if cuda:
            raise RuntimeError('torch.profiler failed to start its CUDA '
                               'session: %s: %s'
                               % (type(e).__name__, e)) from e
        warnings.warn('profiler: torch.profiler failed to start (%s: %s); '
                      'no device trace is written' % (type(e).__name__, e))
        return None
    _session, tracing = session, True
    return session


def _stop_session(session, profile_path):
    """Stop the session, write its trace, build the op maps of the
    segments it ran eagerly, keep each map with its segment and write
    the maps of every segment it ran to `<profile_path>.hlo/`."""
    global _session, tracing
    _session, tracing = None, False
    try:
        session.prof.stop()
        os.makedirs(session.trace_dir, exist_ok=True)
        path = os.path.join(session.trace_dir, TRACE_FILE)
        session.prof.export_chrome_trace(path)
    except Exception as e:     # noqa: BLE001 — raised on the card
        if session.cuda:
            raise RuntimeError('torch.profiler failed to stop its CUDA '
                               'session: %s: %s'
                               % (type(e).__name__, e)) from e
        warnings.warn('profiler: torch.profiler failed to stop (%s: %s); '
                      'no device trace is written' % (type(e).__name__, e))
        return None
    traces = _read_traces(path)
    if session.cuda:
        launches = sum(1 for t in traces for e in t['runtime'].values()
                       if 'Launch' in e['name'])
        if launches and not any(t['gpu'] for t in traces):
            raise RuntimeError(
                'torch.profiler saw %d kernel launches on the host and no '
                'device activity: the CUDA trace was lost' % launches)
    built = _op_maps(traces)
    maps = {}
    for key, segment in session.segments.items():
        if key in built:
            segment.op_maps[key] = built[key]
        if key in segment.op_maps:
            maps[key] = segment.op_maps[key]
    write_op_maps(profile_path + '.hlo', maps)
    return path


@contextlib.contextmanager
def profiler(state='All', sorted_key=None, profile_path='/tmp/profile'):
    """The host table and its chrome trace at `profile_path`; with a
    device state ('GPU', 'All') also the torch.profiler trace in
    `<profile_path>.xplane/` and the op maps in `<profile_path>.hlo/`,
    which tools/timeline.py --xplane_dir / --hlo_dir merge into one
    chrome trace with a labeled device lane."""
    start_profiler(state)
    session = None
    try:
        if state in ('GPU', 'All'):
            session = _start_session(profile_path + '.xplane')
        yield
    finally:
        try:
            if session is not None:
                _stop_session(session, profile_path)
        finally:
            stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """The reference's nvprof control: the block runs between
    torch.cuda.profiler.start() and stop() (cudaProfilerStart/Stop, the
    capture range of an external CUDA profiler), inside a torch.profiler
    session whose trace is written to `<output_file>.xplane/` and op
    maps to `<output_file>.hlo/`. output_mode and config are the
    reference's nvprof options and are not read."""
    import torch
    session = _start_session(output_file + '.xplane')
    cuda = torch.cuda.is_available()
    try:
        if cuda:
            torch.cuda.profiler.start()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.profiler.stop()
    finally:
        if session is not None:
            _stop_session(session, output_file)


def collective_audit(records):
    """kind -> [payload bytes] for every collective a mesh run issued,
    in the JAX package's five kind names ('all-reduce', 'all-gather',
    'reduce-scatter', 'collective-permute', 'all-to-all'); kinds with
    none are left out. Its input is the port's record of the
    collectives (ParallelExecutor.collective_records(), or the list
    parallel.collectives.recording() collects): one dict a collective
    with its 'kind' and 'bytes' (the result's bytes, as the JAX
    package counts an HLO instruction's result shape). The JAX package
    reads the same counts out of compiled HLO texts."""
    from .parallel.collectives import KINDS
    colls = {k: [] for k in KINDS}
    for r in records:
        if r['kind'] not in colls:
            raise ValueError('unknown collective kind %r' % (r['kind'],))
        colls[r['kind']].append(int(r['bytes']))
    return {k: v for k, v in colls.items() if v}


# ---------------------------------------------------------------------------
# Reading a trace: device events, their ops, the op maps
# ---------------------------------------------------------------------------

_OP_LABEL = re.compile(r'^[A-Za-z_]\w*\.\d+$')
_SEGMENT = re.compile(r'^segment@(.+):(eager|capture|replay)$')
_GPU_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _trace_files(trace_dir):
    if os.path.isfile(trace_dir):
        return [trace_dir]
    return sorted(glob.glob(os.path.join(trace_dir, '**', '*.json'),
                            recursive=True))


def _enclosing(ranges, points):
    """For each point (ts, tid, id): the ranges (ts, end, tid, name) of
    its thread that hold it, outermost first. The ranges of one thread
    nest (record_function keeps a stack)."""
    out = {}
    by_tid = {}
    for r in ranges:
        by_tid.setdefault(r[2], ([], []))[0].append(r)
    for p in points:
        by_tid.setdefault(p[1], ([], []))[1].append(p)
    for rs, ps in by_tid.values():
        rs.sort(key=lambda r: (r[0], -r[1]))
        ps.sort(key=lambda p: p[0])
        stack, i = [], 0
        for ts, _tid, pid in ps:
            while i < len(rs) and rs[i][0] <= ts:
                while stack and stack[-1][1] < rs[i][0]:
                    stack.pop()
                stack.append(rs[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[pid] = list(stack)
    return out


def _read_trace(path):
    """One chrome trace of torch.profiler -> {'devices': its device
    events, 'runtime': its runtime events by correlation id, 'gpu':
    whether it traced CUDA activity}. A device event is {name, start_ns,
    dur_ns (unix-epoch clock), plane, seq (its launch order), op (the
    innermost `<type>.<idx>` range around its launch, or None), run
    ((segment key, phase, range start) of the innermost segment range
    around its launch, or None)}."""
    with open(path) as f:
        data = json.load(f)
    if 'baseTimeNanoseconds' not in data:
        raise ValueError('%s has no baseTimeNanoseconds: the trace does not '
                         'say its time base' % path)
    base_ns = int(data['baseTimeNanoseconds'])
    events = [e for e in data.get('traceEvents', [])
              if e.get('ph') == 'X' and 'ts' in e]
    ranges = [(e['ts'], e['ts'] + e.get('dur', 0), e.get('tid'), e['name'])
              for e in events if e.get('cat') == 'user_annotation'
              and (_OP_LABEL.match(e['name']) or _SEGMENT.match(e['name']))]
    # the host's CUDA API calls (category cuda_*), by the correlation id
    # their kernels, copies and memsets carry
    runtime = {}
    for e in events:
        corr = (e.get('args') or {}).get('correlation')
        if str(e.get('cat', '')).startswith('cuda_') and corr is not None:
            runtime[corr] = e
    gpu = [e for e in events if e.get('cat') in _GPU_CATS]
    devices, points = [], []
    if gpu:
        for e in gpu:
            args = e.get('args') or {}
            launch = runtime.get(args.get('correlation'))
            if launch is not None:
                points.append((launch['ts'], launch.get('tid'), len(devices)))
            devices.append({
                'name': e['name'], 'ts': e['ts'], 'dur': e.get('dur', 0),
                'plane': '/device:GPU:%d' % int(args.get('device', 0)),
                'seq': (launch['ts'] if launch else e['ts'], e['ts'])})
    else:
        # no CUDA activity: on a CPUPlace the device is the CPU, and an
        # op's device work is the ATen ops its emitter called (those
        # whose parent is the op's range)
        cpu = [e for e in events
               if e.get('cat') in ('cpu_op', 'user_annotation')]
        chains = _enclosing(
            [(e['ts'], e['ts'] + e.get('dur', 0), e.get('tid'), i)
             for i, e in enumerate(cpu)],
            [(e['ts'], e.get('tid'), i) for i, e in enumerate(cpu)
             if e.get('cat') == 'cpu_op'])
        for i in sorted(chains):
            # a chain ends with the op itself
            chain = [r[3] for r in chains[i]]
            parent = cpu[chain[-2]] if len(chain) >= 2 else None
            if parent is None or parent.get('cat') != 'user_annotation' \
                    or not _OP_LABEL.match(parent['name']):
                continue
            e = cpu[i]
            points.append((e['ts'], e.get('tid'), len(devices)))
            devices.append({'name': e['name'], 'ts': e['ts'],
                            'dur': e.get('dur', 0), 'plane': '/device:CPU:0',
                            'seq': (e['ts'], e['ts'])})
    held = _enclosing(ranges, points)
    # on the card the autograd engine runs a backward on a thread of its
    # own while the thread that called it waits inside the grad op's
    # range: a launch from such a thread takes the ranges that hold its
    # time on the one other thread that has any (where two threads do,
    # it keeps none); launches from other threads (a reader's copies)
    # keep none
    autograd = {e.get('tid') for e in events if e.get('cat') == 'cpu_op'
                and e['name'].startswith('autograd::engine::')}
    orphans = [p for p in points if p[1] in autograd and not held.get(p[2])]
    if orphans:
        found = {}
        for tid in {r[2] for r in ranges}:
            chains = _enclosing([r for r in ranges if r[2] == tid],
                                [(ts, tid, i) for ts, _, i in orphans])
            for i, chain in chains.items():
                if chain:
                    found.setdefault(i, []).append(chain)
        for i, chains in found.items():
            if len(chains) == 1:
                held[i] = chains[0]
    for i, dev in enumerate(devices):
        dev['op'] = dev['run'] = None
        for ts, _end, _tid, name in held.get(i, ()):
            seg = _SEGMENT.match(name)
            if seg is not None:
                dev['run'] = (seg.group(1), seg.group(2), ts)
            else:
                dev['op'] = name
        dev['start_ns'] = base_ns + int(round(dev['ts'] * 1e3))
        dev['dur_ns'] = int(round(dev['dur'] * 1e3))
    return {'devices': devices, 'runtime': runtime, 'gpu': bool(gpu)}


def _read_traces(trace_dir):
    return [_read_trace(p) for p in _trace_files(trace_dir)]


def _op_maps(traces):
    """{segment key: [[kernel name, '<type>.<idx>' or None], ...]} built
    from the eager runs of each segment in the traces (the first, where
    a segment ran eagerly more than once), in launch order."""
    runs = {}
    for t in traces:
        for dev in t['devices']:
            run = dev['run']
            if run is not None and run[1] == 'eager':
                runs.setdefault(run[0], {}).setdefault(run[2], []).append(
                    dev)
    return {key: [[d['name'], d['op']] for d in
                  sorted(by_start[min(by_start)], key=lambda d: d['seq'])]
            for key, by_start in runs.items()}


def kernel_op_map(trace_dir):
    """{segment key: [[kernel name, op label], ...]} from the eager
    segment runs of the trace(s) under `trace_dir`: the counterpart of
    the JAX package's hlo_op_map."""
    return _op_maps(_read_traces(trace_dir))


def write_op_maps(hlo_dir, maps):
    """Write each segment's op map to `<hlo_dir>/segmentNNN.json`
    (cleared first: a stale map would label another program's kernels)."""
    if os.path.isdir(hlo_dir):
        shutil.rmtree(hlo_dir)
    if not maps:
        return None
    os.makedirs(hlo_dir, exist_ok=True)
    for i, key in enumerate(sorted(maps)):
        with open(os.path.join(hlo_dir, 'segment%03d.json' % i), 'w') as f:
            json.dump({'segment': key, 'kernels': maps[key]}, f)
    return hlo_dir


def read_op_maps(hlo_dir):
    """{segment key: [[kernel name, op label], ...]} of the maps a
    profiler session wrote to `hlo_dir`."""
    maps = {}
    for path in sorted(glob.glob(os.path.join(hlo_dir, '*.json'))):
        with open(path) as f:
            rec = json.load(f)
        maps[rec['segment']] = [list(k) for k in rec['kernels']]
    return maps


def align(a, b):
    """Index pairs (i, j), a[i] == b[j], of the blocks a and b share in
    order (difflib's matching blocks, with no junk heuristic: a kernel
    name that recurs hundreds of times a step still aligns)."""
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    return [(m.a + k, m.b + k) for m in matcher.get_matching_blocks()
            for k in range(m.size)]


def device_events(trace_dir, op_map=None):
    """Every device event of the torch.profiler trace(s) under
    `trace_dir`, as {name, label, start_ns, dur_ns, plane, phase}: its
    kernel (or ATen op) name; the `<type>.<idx>` of the op that launched
    it where it was launched eagerly, for a graph's kernels the op its
    segment's map (`op_map`, {key: kernels}, from read_op_maps or
    kernel_op_map) aligns it with, else its name; start_ns on the
    unix-epoch clock; its plane (`/device:GPU:<i>` or `/device:CPU:0`);
    the phase of the segment run that launched it (eager, capture,
    replay, or None outside any segment)."""
    op_map = op_map or {}
    out = []
    for t in _read_traces(trace_dir):
        devices = t['devices']
        labels = {}
        replays = {}
        for i, dev in enumerate(devices):
            if dev['op'] is not None:
                labels[i] = dev['op']
            elif dev['run'] is not None and dev['run'][1] != 'eager':
                replays.setdefault(dev['run'], []).append(i)
        for run, idx in replays.items():
            kernels = op_map.get(run[0])
            if not kernels:
                continue
            idx.sort(key=lambda i: devices[i]['ts'])
            for ka, jb in align([k[0] for k in kernels],
                                [devices[i]['name'] for i in idx]):
                if kernels[ka][1] is not None:
                    labels[idx[jb]] = kernels[ka][1]
        for i, dev in enumerate(devices):
            out.append({'name': dev['name'],
                        'label': labels.get(i, dev['name']),
                        'start_ns': dev['start_ns'],
                        'dur_ns': dev['dur_ns'], 'plane': dev['plane'],
                        'phase': dev['run'][1] if dev['run'] else None})
    return out


def device_op_events(trace_dir, op_map=None, with_plane=False):
    """[(label, start_ns, dur_ns)] for every device event of the
    torch.profiler trace(s) under `trace_dir` (device_events; with
    with_plane=True the plane name, `/device:GPU:<i>` or
    `/device:CPU:0`, as a 4th element: one lane a device in
    obs/report.py)."""
    out = []
    for ev in device_events(trace_dir, op_map):
        tup = (ev['label'], ev['start_ns'], ev['dur_ns'])
        out.append(tup + (ev['plane'],) if with_plane else tup)
    return out
