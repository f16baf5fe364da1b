"""Trace spans and the per-process JSONL event log (counterpart of
paddle_tpu/obs/trace.py, copied: it is plain Python).

Every traced unit of work becomes one JSON record in
`<obs_dir>/events-<role>-<pid>.jsonl`; three record shapes share the
file so one merge produces one timeline (obs/report.py):

  span   {'type':'span','kind':'client'|'server'|'host', 'name',
          'sid','psid', 't0','t1' (unix epoch seconds), 'tid','pid',
          'role', ...attrs}
  fault  {'type':'fault', 't', 'action', ...}      (trainer FaultEvents)
  mark   {'type':'mark', 't', 'name', ...}         (one-shot milestones;
                                                    slo.breach events)

`wire_trace` and `server_span` carry a span id across an RPC as an
optional `trace` field of the request's meta dict, so report.py can link
a client span to the server's handling of it and estimate clock offsets
from their midpoints: PSClient and MasterClient put their call's span on
the wire (distributed/rpc.py, master.py), and PSServer and MasterServer
open each handler's span under it.

Parent ids come from a thread-local span stack: a span opened inside
another records that span's sid as `psid`.

Off unless `FLAGS_obs_dir` is set at import or enable() is called.
"""
from __future__ import annotations

import binascii
import contextlib
import json
import os
import threading
import time

__all__ = ['span', 'server_span', 'host_span', 'record_span', 'event',
           'wire_trace', 'current_sid', 'new_id', 'enabled', 'enable',
           'disable']

_lock = threading.Lock()
_enabled = False
_file = None
_role = ''
_tls = threading.local()


def new_id():
    return binascii.hexlify(os.urandom(8)).decode()


def enabled():
    return _enabled


def current_sid():
    stack = getattr(_tls, 'stack', None)
    return stack[-1] if stack else None


def _push(sid):
    stack = getattr(_tls, 'stack', None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(sid)


def _pop():
    stack = getattr(_tls, 'stack', None)
    if stack:
        stack.pop()


def _emit(rec):
    rec['role'] = _role
    rec['pid'] = os.getpid()
    line = json.dumps(rec) + '\n'
    with _lock:
        f = _file
        if f is None:
            return
        f.write(line)
        f.flush()


class _Span(object):
    __slots__ = ('sid', 'psid', 'name', 'kind')

    def __init__(self, sid, psid, name, kind):
        self.sid = sid
        self.psid = psid
        self.name = name
        self.kind = kind


@contextlib.contextmanager
def span(name, kind='host', sid=None, **attrs):
    """Timed scope -> one span record; yields the _Span (None when
    tracing is off, so callers can guard their own extra work)."""
    if not _enabled:
        yield None
        return
    sp = _Span(sid or new_id(), current_sid(), name, kind)
    _push(sp.sid)
    t0 = time.time()
    try:
        yield sp
    finally:
        t1 = time.time()
        _pop()
        rec = {'type': 'span', 'kind': kind, 'name': name,
               'sid': sp.sid, 'psid': sp.psid, 't0': t0, 't1': t1,
               'tid': threading.get_ident() & 0xffff}
        rec.update(attrs)
        _emit(rec)


def wire_trace(sp):
    """The meta-dict trace field for an outbound request carrying this
    client span's id — None (field omitted, untraced) when tracing is
    off."""
    if sp is None:
        return None
    return {'sid': sp.sid}


@contextlib.contextmanager
def server_span(name, trace_meta, **attrs):
    """Server-side handler scope. Only records when BOTH this process
    traces and the request carried a trace field: the span re-uses the
    client's sid, which is the whole cross-process correlation."""
    if not _enabled or not isinstance(trace_meta, dict) \
            or 'sid' not in trace_meta:
        yield None
        return
    with span(name, kind='server', sid=str(trace_meta['sid']),
              **attrs) as sp:
        yield sp


def host_span(name, t0, t1, **attrs):
    """Record an already-timed host scope."""
    if not _enabled:
        return
    rec = {'type': 'span', 'kind': 'host', 'name': name,
           'sid': new_id(), 'psid': current_sid(), 't0': t0, 't1': t1,
           'tid': threading.get_ident() & 0xffff}
    rec.update(attrs)
    _emit(rec)


def record_span(name, kind, sid, t0, t1, **attrs):
    """Record a span whose start and end were observed on DIFFERENT
    threads (t0 on the thread that sends a request, t1 on the one that
    matches its reply): a contextmanager cannot straddle that split.
    `sid` rides the wire meta exactly like span()'s."""
    if not _enabled:
        return
    rec = {'type': 'span', 'kind': kind, 'name': name,
           'sid': sid, 'psid': None, 't0': t0, 't1': t1,
           'tid': threading.get_ident() & 0xffff}
    rec.update(attrs)
    _emit(rec)


def event(etype, **fields):
    """Instant record ('fault', 'mark', ...)."""
    if not _enabled:
        return
    rec = {'type': etype, 't': time.time()}
    rec.update(fields)
    _emit(rec)


def _default_role():
    from ..flags import get_flag
    return get_flag('obs_role', '') or ('pid%d' % os.getpid())


def enable(obs_dir, role=None):
    """Open (or retarget) the event log. Idempotent."""
    global _enabled, _file, _role
    disable()
    os.makedirs(obs_dir, exist_ok=True)
    role = role or _default_role()
    path = os.path.join(obs_dir,
                        'events-%s-%d.jsonl' % (role, os.getpid()))
    with _lock:
        _file = open(path, 'a')
        _role = role
    _enabled = True


def disable():
    global _enabled, _file
    _enabled = False
    with _lock:
        f, _file = _file, None
    if f is not None:
        try:
            f.close()
        except OSError:
            pass


def _bootstrap_from_flags():
    from ..flags import get_flag
    obs_dir = get_flag('obs_dir', '')
    if obs_dir:
        enable(obs_dir)


_bootstrap_from_flags()
