"""Pserver dispatchers: how parameter blocks map to parameter servers
(counterpart of paddle_tpu/transpiler/ps_dispatcher.py, copied; reference
python/paddle/fluid/transpiler/ps_dispatcher.py)."""
from __future__ import annotations

__all__ = ['PSDispatcher', 'RoundRobin', 'HashName']


class PSDispatcher(object):
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._step = 0

    @property
    def eps(self):
        return self._eps

    def reset(self):
        self._step = 0

    def dispatch(self, varlist):
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    """Blocks go to pservers in rotation — balanced for equal-size blocks."""

    def dispatch(self, varlist):
        out = []
        for _ in varlist:
            out.append(self._eps[self._step % len(self._eps)])
            self._step += 1
        return out


class HashName(PSDispatcher):
    """Deterministic by name hash — stable across runs AND processes
    (crc32, not Python's per-process-randomized str hash: every trainer
    and pserver transpiles independently and must agree on placement)."""

    def dispatch(self, varlist):
        import zlib
        return [self._eps[zlib.crc32(str(v).encode('utf-8'))
                          % len(self._eps)] for v in varlist]
