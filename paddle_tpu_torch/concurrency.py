"""CSP concurrency API (counterpart of paddle_tpu/concurrency.py,
copied; reference python/paddle/fluid/concurrency.py: Go, make_channel,
channel_send/recv/close, Select).

The reference lowers these to IR ops (go_op runs a sub-block on a
thread). Here, as in the JAX package, Go runs a Python callable on a
daemon thread against the shared scope, and the channel primitives
delegate to channels.py."""
from __future__ import annotations

import threading

from .channels import Channel, ChannelClosed, Select, make_channel

__all__ = ['Go', 'make_channel', 'channel_send', 'channel_recv',
           'channel_close', 'Select']


class Go(object):
    """In the reference, `with Go():` captures the body as an IR
    sub-block that go_op later runs on its own thread. Python context
    managers CANNOT defer their body: statements inside `with Go():`
    execute immediately on the calling thread, so a verbatim port that
    does an unbuffered channel_send inside the body would deadlock.
    Concurrency must therefore be explicit here: register thunks with
    g.go(fn, ...) (spawned on a daemon thread at block exit), or use
    the module-level go(fn, ...). A bare `with Go():` body that ran
    synchronously and registered nothing raises to catch exactly that
    silent-deadlock port."""

    def __init__(self, name=None):
        self.name = name
        self._fns = []

    def __enter__(self):
        return self

    def go(self, fn, *args, **kwargs):
        self._fns.append((fn, args, kwargs))
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        if not self._fns:
            raise RuntimeError(
                'Go(): the with-body runs synchronously in this '
                'framework — wrap the concurrent work in a function and '
                'register it with g.go(fn, ...) (see concurrency.Go '
                'docstring)')
        for fn, args, kwargs in self._fns:
            t = threading.Thread(target=fn, args=args, kwargs=kwargs,
                                 daemon=True)
            t.start()
        return False


def go(fn, *args, **kwargs):
    """Spawn fn on a daemon thread (functional form of go_op)."""
    t = threading.Thread(target=fn, args=args, kwargs=kwargs, daemon=True)
    t.start()
    return t


def channel_send(channel, value, is_copy=False, timeout=None):
    """(reference concurrency.py channel_send -> channel_send_op).
    Returns True on success, False if the channel was closed."""
    try:
        channel.send(value, timeout=timeout)
        return True
    except ChannelClosed:
        return False


def channel_recv(channel, return_value=None, timeout=None):
    """Returns (value, ok) like the reference's Out/Status pair."""
    try:
        return channel.recv(timeout=timeout), True
    except ChannelClosed:
        return return_value, False


def channel_close(channel):
    channel.close()
