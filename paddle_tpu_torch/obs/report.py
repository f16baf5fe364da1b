"""Merge per-role obs JSONL logs into one timeline and a metrics rollup
(counterpart of paddle_tpu/obs/report.py, copied: it is plain Python).

Input layout:

    <obs_root>/[<role>/]events-<role>-<pid>.jsonl    span/fault records
    <obs_root>/[<role>/]metrics-<role>-<pid>.jsonl   telemetry snapshots

A restarted role leaves one file pair PER INCARNATION (pids differ);
metrics are summed across incarnations of a role, events simply
concatenate.

Clock alignment: processes stamp records with their own `time.time()`.
For every RPC whose client and server spans share a sid, the server's
handling happens strictly inside the client's request/reply window, so
`midpoint(server span) - midpoint(client span)` estimates the server
clock's offset relative to the client (the classic NTP estimate). Per
role pair the median over all such spans is taken, then the role graph
is walked breadth-first from a reference role, accumulating shifts, so
roles that never talk directly land on one clock too.

Timeline output is chrome://tracing JSON: one pid lane per role, spans
as 'X' duration events, client->server RPC links as 's'/'f' flow events
(same `id` = span id), faults and SLO breaches as instant events.
`device_events_to_records` turns (label, start_ns, dur_ns[, plane])
tuples into device lanes on the same unix-epoch clock; with
`write_report(xplane_dir=...)` they come from a torch.profiler trace
that fluid.profiler wrote (profiler.device_op_events, which reads the
trace's own time base), labeled through the op maps of `hlo_dir`.
"""
from __future__ import annotations

import collections
import json
import os
import warnings

from . import telemetry

__all__ = ['collect', 'estimate_offsets', 'build_timeline', 'rollup',
           'write_report', 'format_rollup_text',
           'device_events_to_records']


def _read_jsonl(path):
    out = []
    bad = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    bad += 1   # torn tail from a kill -9 mid-write
    except OSError:
        pass
    if bad:
        warnings.warn(
            'obs merge: skipped %d unparseable line(s) in %s '
            '(torn tail from an unclean shutdown?)' % (bad, path),
            stacklevel=2)
    return out


def collect(root):
    """-> (events, metric_lasts): every event record under `root`, and
    the LAST metrics snapshot of every metrics file (one per process
    incarnation — summed later by rollup())."""
    events, metric_lasts = [], []
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if not fn.endswith('.jsonl'):
                continue
            path = os.path.join(dirpath, fn)
            if fn.startswith('events-'):
                events.extend(_read_jsonl(path))
            elif fn.startswith('metrics-'):
                recs = _read_jsonl(path)
                if recs:
                    metric_lasts.append(recs[-1])
    return events, metric_lasts


def _span_pairs(events):
    """sid -> (client spans, server spans) for sids seen on both
    sides — the cross-process links."""
    by_sid = collections.defaultdict(lambda: ([], []))
    for e in events:
        if e.get('type') != 'span' or 'sid' not in e:
            continue
        if e.get('kind') == 'client':
            by_sid[e['sid']][0].append(e)
        elif e.get('kind') == 'server':
            by_sid[e['sid']][1].append(e)
    return {sid: cs for sid, cs in by_sid.items() if cs[0] and cs[1]}


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def estimate_offsets(events):
    """-> {role: shift_seconds}; adding a role's shift to its
    timestamps moves them onto the reference role's clock."""
    deltas = collections.defaultdict(list)
    client_counts = collections.Counter()
    roles = set()
    for e in events:
        if 'role' in e:
            roles.add(e['role'])
    for cspans, sspans in _span_pairs(events).values():
        for c in cspans:
            client_counts[c.get('role')] += 1
            for s in sspans:
                if c.get('role') == s.get('role'):
                    continue   # same process: no offset information
                mid_c = 0.5 * (c['t0'] + c['t1'])
                mid_s = 0.5 * (s['t0'] + s['t1'])
                deltas[(c['role'], s['role'])].append(mid_s - mid_c)
    # undirected role graph with signed medians
    edges = collections.defaultdict(dict)
    for (a, b), ds in deltas.items():
        d = _median(ds)
        edges[a][b] = d          # clock_b - clock_a (estimated)
        edges[b].setdefault(a, -d)
    if client_counts:
        ref = max(sorted(client_counts), key=lambda r: client_counts[r])
    else:
        ref = min(roles) if roles else None
    shifts = {r: 0.0 for r in roles}
    if ref is None:
        return shifts
    seen = {ref}
    frontier = [ref]
    while frontier:
        a = frontier.pop(0)
        for b, d in sorted(edges.get(a, {}).items()):
            if b in seen:
                continue
            # t_b + shift_b must equal t_a + shift_a for the same
            # instant; d estimates clock_b - clock_a
            shifts[b] = shifts[a] - d
            seen.add(b)
            frontier.append(b)
    return shifts


def build_timeline(events, offsets=None):
    """-> chrome://tracing dict. One pid lane per role, spans as 'X',
    client/server RPC links as flow events, faults as instants."""
    if offsets is None:
        offsets = estimate_offsets(events)
    roles = sorted({e.get('role', '?') for e in events})
    role_pid = {r: i + 1 for i, r in enumerate(roles)}

    def adj(role, t):
        return t + offsets.get(role, 0.0)

    base = None
    for e in events:
        t = e.get('t0', e.get('t'))
        if t is not None:
            at = adj(e.get('role', '?'), t)
            base = at if base is None else min(base, at)
    base = base or 0.0

    def us(role, t):
        return (adj(role, t) - base) * 1e6

    out = [{'name': 'process_name', 'ph': 'M', 'pid': pid,
            'args': {'name': role}} for role, pid in role_pid.items()]
    for e in events:
        role = e.get('role', '?')
        pid = role_pid[role]
        if e.get('type') == 'span':
            args = {k: v for k, v in e.items()
                    if k not in ('type', 'kind', 'name', 't0', 't1',
                                 'tid', 'pid')}
            out.append({'ph': 'X', 'cat': e.get('kind', 'host'),
                        'name': e['name'], 'pid': pid,
                        'tid': e.get('tid', 0),
                        'ts': us(role, e['t0']),
                        'dur': max((e['t1'] - e['t0']) * 1e6, 0.0),
                        'args': args})
        elif 't' in e:
            args = {k: v for k, v in e.items()
                    if k not in ('type', 't', 'pid')}
            out.append({'ph': 'i', 's': 'p', 'cat': e.get('type', 'mark'),
                        'name': '%s:%s' % (e.get('type', 'mark'),
                                           e.get('action',
                                                 e.get('name', ''))),
                        'pid': pid, 'tid': e.get('tid', 0),
                        'ts': us(role, e['t']), 'args': args})
    # flow events: client span midpoint -> each server span midpoint
    for sid, (cspans, sspans) in sorted(_span_pairs(events).items()):
        for c in cspans:
            crole = c.get('role', '?')
            out.append({'ph': 's', 'cat': 'rpc', 'name': 'rpc',
                        'id': sid, 'pid': role_pid[crole],
                        'tid': c.get('tid', 0),
                        'ts': us(crole, 0.5 * (c['t0'] + c['t1']))})
        for s in sspans:
            srole = s.get('role', '?')
            out.append({'ph': 'f', 'bp': 'e', 'cat': 'rpc',
                        'name': 'rpc', 'id': sid,
                        'pid': role_pid[srole], 'tid': s.get('tid', 0),
                        'ts': us(srole, 0.5 * (s['t0'] + s['t1']))})
    out.sort(key=lambda e: (e.get('ts', 0), e.get('pid', 0)))
    return {'traceEvents': out,
            'metadata': {'clock_shifts': offsets}}


def device_events_to_records(device_events, role='device',
                             clock_offset=0.0):
    """Device-op events -> span records that merge straight into the
    host event stream. Accepts (label, start_ns,
    dur_ns) 3-tuples (one shared lane) or (label, start_ns, dur_ns,
    plane) 4-tuples (one timeline lane PER PLANE — per device chip).

    Device timestamps are unix-epoch nanoseconds (the clock host spans
    stamp with time.time(); profiler.device_op_events converts a
    torch.profiler trace's times from its baseTimeNanoseconds), so t0 =
    start_ns/1e9 lands directly on the merged clock;
    `clock_offset` is there for captures known to be shifted."""
    recs = []
    for i, ev in enumerate(device_events):
        label, start_ns, dur_ns = ev[0], ev[1], ev[2]
        plane = ev[3] if len(ev) > 3 else ''
        # '/device:TPU:0' -> lane 'device:TPU:0' (already self-naming)
        lane = plane.rsplit('/', 1)[-1] if plane else role
        t0 = start_ns / 1e9 + clock_offset
        recs.append({'type': 'span', 'kind': 'device', 'name': label,
                     'sid': 'dev-%d' % i, 't0': t0,
                     't1': t0 + dur_ns / 1e9, 'tid': 0, 'role': lane,
                     'pid': 0})
    return recs


def _merge_hist(into, h):
    if h.get('count', 0) == 0:
        return
    if into.get('count', 0) == 0:
        into.update({k: h[k] for k in ('count', 'sum', 'min', 'max',
                                       'buckets')})
        into['buckets'] = list(h['buckets'])
        return
    into['count'] += h['count']
    into['sum'] += h['sum']
    into['min'] = min(into['min'], h['min'])
    into['max'] = max(into['max'], h['max'])
    bs = into['buckets']
    for i, n in enumerate(h.get('buckets', ())):
        if i < len(bs):
            bs[i] += n


def rollup(metric_lasts):
    """-> {'roles': {role: {counters, gauges, hists}}, 'totals':
    {counter: sum}}. Counters sum across incarnations AND roles;
    gauges keep the latest-ts value per role; histograms merge, then
    report p50/p95/p99 recomputed over the MERGED buckets (the raw
    bucket arrays are dropped from the output — percentiles are the
    consumable form)."""
    roles = {}
    for rec in sorted(metric_lasts, key=lambda r: r.get('ts', 0)):
        role = rec.get('role', '?')
        agg = roles.setdefault(role, {'counters': {}, 'gauges': {},
                                      'hists': {}})
        for n, v in rec.get('counters', {}).items():
            agg['counters'][n] = agg['counters'].get(n, 0) + v
        for n, v in rec.get('gauges', {}).items():
            agg['gauges'][n] = v
        for n, h in rec.get('hists', {}).items():
            _merge_hist(agg['hists'].setdefault(n, {'count': 0}), h)
    totals = {}
    for agg in roles.values():
        for n, v in agg['counters'].items():
            totals[n] = totals.get(n, 0) + v
        for h in agg['hists'].values():
            if h.get('buckets') is not None:
                for key, q in (('p50', 0.50), ('p95', 0.95),
                               ('p99', 0.99)):
                    h[key] = telemetry.hist_quantile(h, q)
                del h['buckets']
    return {'roles': roles, 'totals': totals}


def format_rollup_text(ru, nonzero_only=True):
    lines = ['cluster totals:']
    for n in sorted(ru['totals']):
        v = ru['totals'][n]
        if v or not nonzero_only:
            lines.append('  %-40s %d' % (n, v))
    for role in sorted(ru['roles']):
        agg = ru['roles'][role]
        shown = [(n, v) for n, v in sorted(agg['counters'].items())
                 if v or not nonzero_only]
        shown += [('%s (gauge)' % n, v)
                  for n, v in sorted(agg['gauges'].items())
                  if v or not nonzero_only]
        hists = [(n, h) for n, h in sorted(agg['hists'].items())
                 if h.get('count')]
        if not (shown or hists):
            continue
        lines.append('%s:' % role)
        for n, v in shown:
            lines.append('  %-40s %d' % (n, v))
        for n, h in hists:
            pcts = ''
            if h.get('p50') is not None:
                pcts = ' p50=%.6fs p95=%.6fs p99=%.6fs' % (
                    h['p50'], h.get('p95') or 0.0, h.get('p99') or 0.0)
            lines.append('  %-40s n=%d mean=%.6fs%s max=%.6fs'
                         % (n, h['count'], h['sum'] / h['count'],
                            pcts, h['max']))
    return '\n'.join(lines)


def write_report(obs_root, timeline_path=None, rollup_path=None,
                 pretty=False, xplane_dir=None, hlo_dir=None):
    """Merge everything under obs_root; optionally write the timeline
    and rollup JSON files. -> (timeline dict, rollup dict).

    With xplane_dir (the torch.profiler trace directory that
    fluid.profiler.profiler writes, `<profile_path>.xplane`), its device
    events join the timeline as one lane a device; hlo_dir (the op maps
    it writes, `<profile_path>.hlo`) labels a replayed graph's kernels
    with the ops that launched them."""
    events, metric_lasts = collect(obs_root)
    if xplane_dir:
        from .. import profiler
        op_map = {}
        if hlo_dir and os.path.isdir(hlo_dir):
            op_map = profiler.read_op_maps(hlo_dir)
        events = events + device_events_to_records(
            profiler.device_op_events(xplane_dir, op_map, with_plane=True))
    tl = build_timeline(events)
    ru = rollup(metric_lasts)
    indent = 2 if pretty else None
    if timeline_path:
        with open(timeline_path, 'w') as f:
            json.dump(tl, f, indent=indent)
    if rollup_path:
        with open(rollup_path, 'w') as f:
            json.dump(ru, f, indent=indent)
    return tl, ru
