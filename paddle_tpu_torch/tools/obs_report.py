"""Merge a run's observability output into one report.

The counterpart of tools/obs_report.py.

Every process in an instrumented run (FLAGS_obs_dir set, or obs.trace
and obs.telemetry enabled) appends two JSONL streams under its obs
dir: metrics-<role>-<pid>.jsonl snapshots from the telemetry registry,
and events-<role>-<pid>.jsonl span/fault records from obs.trace. This
tool walks the run's obs root, aligns the per-process clocks from
client/server RPC span midpoints, and writes:

- a chrome://tracing timeline (one pid lane per role-process, flow
  arrows linking each client RPC span to its server handler span,
  instant markers for injected faults and trainer FaultEvents), and
- a metrics rollup (per-role counters/gauges/histograms plus cluster
  totals summed across roles and incarnations). The rollup is
  name-agnostic, so the serving engine's serving.* series (TTFT /
  per-token latency histograms, queue-depth / slot-occupancy gauges,
  request counters — paddle_tpu_torch/serving/engine.py) appear alongside
  the rpc.* / trainer.* training metrics when a serving process runs
  under FLAGS_obs_dir.

    python -m paddle_tpu_torch.tools.obs_report --obs_dir /tmp/run_obs \
        --timeline tl.json --rollup rollup.json

With neither --timeline nor --rollup, prints the text rollup only.
The timeline loads directly in chrome://tracing / perfetto, or can be
round-tripped through paddle_tpu_torch/tools/timeline.py (which
preserves the flow events and the per-lane ordering). With
--xplane_dir (a torch.profiler trace that fluid.profiler wrote) the
card's kernels join it as one lane a device, on the host spans' clock.
"""
from __future__ import annotations

import argparse
import os
import sys

from paddle_tpu_torch.obs import report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--obs_dir', required=True,
                    help='obs root to merge (walked recursively; the '
                         'dir set as FLAGS_obs_dir or given to '
                         'obs.trace.enable / obs.telemetry.enable)')
    ap.add_argument('--timeline', default=None,
                    help='write the merged chrome trace here')
    ap.add_argument('--rollup', default=None,
                    help='write the metrics rollup JSON here')
    ap.add_argument('--pretty', action='store_true')
    ap.add_argument('--all', action='store_true',
                    help='show zero-valued series in the text rollup '
                         'too')
    ap.add_argument('--xplane_dir', default=None,
                    help='the torch.profiler trace directory '
                         'fluid.profiler wrote during the run '
                         '(<profile_path>.xplane): its device events join '
                         'the timeline as one lane a device')
    ap.add_argument('--hlo_dir', default=None,
                    help='the op maps fluid.profiler wrote '
                         '(<profile_path>.hlo), which name a replayed '
                         'CUDA graph\'s kernels by the ops that '
                         'launched them on the device lanes')
    args = ap.parse_args(argv)
    if not os.path.isdir(args.obs_dir):
        ap.error('--obs_dir %s is not a directory' % args.obs_dir)

    tl, ru = report.write_report(args.obs_dir,
                                 timeline_path=args.timeline,
                                 rollup_path=args.rollup,
                                 pretty=args.pretty,
                                 xplane_dir=args.xplane_dir,
                                 hlo_dir=args.hlo_dir)
    n_span = sum(1 for e in tl['traceEvents'] if e.get('ph') == 'X')
    n_flow = sum(1 for e in tl['traceEvents'] if e.get('ph') == 's')
    shifts = tl.get('metadata', {}).get('clock_shifts', {})
    print(report.format_rollup_text(ru, nonzero_only=not args.all))
    print('\ntimeline: %d spans, %d linked rpc pairs, %d role lanes'
          % (n_span, n_flow, len(ru['roles'])))
    if shifts:
        print('clock shifts applied: %s' % ' '.join(
            '%s=%+.1fms' % (r, s * 1e3)
            for r, s in sorted(shifts.items()) if s))
    for what, path in (('timeline', args.timeline),
                       ('rollup', args.rollup)):
        if path:
            print('wrote %s -> %s' % (what, path))
    return 0


if __name__ == '__main__':
    sys.exit(main())
