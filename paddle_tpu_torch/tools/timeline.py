"""Profile -> chrome://tracing converter, with the device stream merged.

The counterpart of tools/timeline.py (reference tools/timeline.py).

fluid.profiler writes its host events as a chrome trace already; this
tool keeps the reference's command line for workflows that post-process
saved profile files:

    python -m paddle_tpu_torch.tools.timeline --profile_path out.json \
        --timeline_path tl.json

It takes a file the profiler wrote (chrome format: passed through with
its events stable-sorted by (ts, pid), flow events untouched) or a JSON
list of {name, pid, tid, ts, dur} event dicts, which it wraps into the
chrome trace envelope as the reference's _ChromeTraceFormatter does; a
list event's own 'ph' wins over the default 'X' region.

With --xplane_dir (the torch.profiler trace directory
`<profile_path>.xplane` that fluid.profiler.profiler('All'/'GPU') writes)
it merges the device stream into the host trace: one device lane of the
card's kernels (or, for a CPUPlace run, the ATen ops), each named by the
`<type>.<idx>` of the op that launched it, through the op maps of
--hlo_dir (`<profile_path>.hlo`) for a replayed CUDA graph. Both
streams are put on the unix-epoch clock: the host trace records its
perf_counter offset, the device trace its own time base.
"""
from __future__ import annotations

import argparse
import json


class _ChromeTraceFormatter(object):
    """(reference tools/timeline.py:36) Build the chrome trace dict."""

    def __init__(self):
        self._events = []
        self._metadata = []

    def _create_event(self, ph, category, name, pid, tid, timestamp):
        return {'ph': ph, 'cat': category, 'name': name, 'pid': pid,
                'tid': tid, 'ts': timestamp}

    def emit_pid(self, name, pid):
        self._metadata.append({'name': 'process_name', 'ph': 'M',
                               'pid': pid,
                               'args': {'name': name}})

    def emit_region(self, timestamp, duration, pid, tid, category, name,
                    args):
        event = self._create_event('X', category, name, pid, tid,
                                   timestamp)
        event['dur'] = duration
        event['args'] = args
        self._events.append(event)

    def format_to_string(self, pretty=False):
        trace = {'traceEvents': self._metadata + self._events}
        if pretty:
            return json.dumps(trace, indent=4, separators=(',', ': '))
        return json.dumps(trace, separators=(',', ':'))


def convert(profile_path, timeline_path, pretty=False):
    with open(profile_path) as f:
        data = json.load(f)
    if isinstance(data, dict) and 'traceEvents' in data:
        # already chrome format (profiler.py native output, or an
        # obs_report.py cluster merge): normalize with a STABLE
        # (ts, pid) sort — equal-timestamp events from one process stay
        # in emission order instead of shuffling across lanes — and
        # leave every event's fields alone (flow events ph 's'/'f'
        # carry id/bp that must survive the round trip)
        data['traceEvents'].sort(
            key=lambda e: (e.get('ts', 0), e.get('pid', 0)))
        out = json.dumps(data, indent=4 if pretty else None)
    else:
        fmt = _ChromeTraceFormatter()
        pids = {}
        for ev in data:
            pid = ev.get('pid', 0)
            if pid not in pids:
                fmt.emit_pid(ev.get('process', 'process %d' % pid), pid)
                pids[pid] = True
            if ev.get('ph') and ev['ph'] != 'X':
                # pre-formed phase (flow 's'/'f', instant 'i', counter
                # 'C', ...): pass through unmangled
                fmt._events.append(dict(ev))
                continue
            fmt.emit_region(ev['ts'], ev.get('dur', 0), pid,
                            ev.get('tid', 0), ev.get('cat', 'Op'),
                            ev['name'], ev.get('args', {}))
        out = fmt.format_to_string(pretty)
    with open(timeline_path, 'w') as f:
        f.write(out)
    return timeline_path


def merge_device_stream(profile_path, timeline_path, xplane_dir,
                        hlo_dir=None, pretty=False):
    """Merge the host RecordEvent chrome trace with the torch.profiler
    device stream into ONE chrome trace on one clock, device slices
    named by the ops that launched them (paddle_tpu_torch.profiler
    device_op_events, read_op_maps). Host events render under pid 0,
    device events under pid 1; timestamps are microseconds from the
    earliest event of either stream."""
    import os
    from paddle_tpu_torch import profiler as prof

    with open(profile_path) as f:
        data = json.load(f)
    events = list(data.get('traceEvents', []))
    events.append({'name': 'process_name', 'ph': 'M', 'pid': 0,
                   'args': {'name': 'host (RecordEvent)'}})
    events.append({'name': 'process_name', 'ph': 'M', 'pid': 1,
                   'args': {'name': 'device (kernels)'}})

    offset = (data.get('otherData') or {}).get('perf_counter_to_unix_s')
    if offset is None:
        raise ValueError('%s does not record its perf_counter offset (not '
                         'a trace paddle_tpu_torch.profiler wrote): its '
                         'events cannot be put on the device clock'
                         % profile_path)
    op_map = {}
    if hlo_dir and os.path.isdir(hlo_dir):
        op_map = prof.read_op_maps(hlo_dir)
    dev_events = prof.device_op_events(xplane_dir, op_map)
    host = [e for e in events if 'ts' in e]
    for e in host:
        e['ts'] += offset * 1e6
    base = min([e['ts'] for e in host] +
               [s / 1e3 for _, s, _ in dev_events] or [0.0])
    for e in host:
        e['ts'] -= base
    for label, start_ns, dur_ns in dev_events:
        events.append({'name': label, 'cat': 'device', 'ph': 'X',
                       'ts': start_ns / 1e3 - base,
                       'dur': dur_ns / 1e3, 'pid': 1, 'tid': 0})
    events.sort(key=lambda e: (e.get('ts', 0), e.get('pid', 0)))
    with open(timeline_path, 'w') as f:
        json.dump({'traceEvents': events}, f,
                  indent=4 if pretty else None)
    return timeline_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--profile_path', required=True,
                        help='the host chrome trace fluid.profiler wrote '
                             '(profile_path), or a JSON list of events')
    parser.add_argument('--timeline_path', required=True)
    parser.add_argument('--xplane_dir', default=None,
                        help='merge the device stream from this '
                             'torch.profiler trace directory '
                             '(<profile_path>.xplane)')
    parser.add_argument('--hlo_dir', default=None,
                        help='the op maps fluid.profiler wrote '
                             '(<profile_path>.hlo): a replayed CUDA '
                             'graph\'s kernels named by their ops')
    parser.add_argument('--pretty', action='store_true')
    args = parser.parse_args(argv)
    if args.xplane_dir:
        print(merge_device_stream(args.profile_path, args.timeline_path,
                                  args.xplane_dir, args.hlo_dir,
                                  args.pretty))
    else:
        print(convert(args.profile_path, args.timeline_path, args.pretty))


if __name__ == '__main__':
    main()
