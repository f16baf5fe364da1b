"""CSP channels (counterpart of paddle_tpu/channels.py, copied: it is
plain Python; reference fluid's channel_create / channel_send /
channel_recv / channel_close and Select).

In the reference these were Program ops that let the C++ executor run
concurrent blocks. Within a captured or compiled block there is nothing
for a channel op to coordinate, so, as in the JAX package, channels are
host objects that coordinate producer and consumer Python threads
around Executor.run calls, with the reference's semantics: bounded or
unbuffered rendezvous, close drains then raises, and a Select that
commits to exactly one ready case.
"""
from __future__ import annotations

import time
from collections import deque
import threading

__all__ = ['Channel', 'make_channel', 'ChannelClosed', 'Select']


class ChannelClosed(Exception):
    """Receive on a drained closed channel / send on a closed channel."""


class Channel(object):
    """capacity=0 gives Go-style unbuffered rendezvous (send blocks for
    a receiver); capacity>0 a bounded buffer.

    One Condition guards all state, so the Go contracts hold exactly:
    close() never blocks, a timed-out recv leaves no stale rendezvous
    ticket, and every sender blocked at close() wakes and raises."""

    def __init__(self, capacity=0):
        self._cap = int(capacity)
        self._buf = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._recv_waiting = 0     # receivers currently blocked in recv

    def _can_send(self):
        if self._cap > 0:
            return len(self._buf) < self._cap
        # rendezvous: an unmatched receiver is waiting (each buffered
        # item already has a claimant; both counters move under _cv)
        return self._recv_waiting > len(self._buf)

    def send(self, value, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    raise ChannelClosed('send on closed channel')
                if self._can_send():
                    self._buf.append(value)
                    self._cv.notify_all()
                    return
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError('send timed out')
                self._cv.wait(0.05)

    def try_send(self, value):
        """Non-blocking send: True if committed (Select's send case)."""
        with self._cv:
            if self._closed or not self._can_send():
                return False
            self._buf.append(value)
            self._cv.notify_all()
            return True

    def recv(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            self._recv_waiting += 1
            self._cv.notify_all()
            try:
                while True:
                    if self._buf:
                        value = self._buf.popleft()
                        self._cv.notify_all()
                        return value
                    if self._closed:
                        raise ChannelClosed(
                            'recv on closed empty channel')
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        raise TimeoutError('recv timed out')
                    self._cv.wait(0.05)
            finally:
                self._recv_waiting -= 1

    def poll(self):
        """Non-blocking receive: (True, value) or (False, None)."""
        with self._cv:
            if self._buf:
                value = self._buf.popleft()
                self._cv.notify_all()
                return True, value
            if self._closed:
                raise ChannelClosed('recv on closed empty channel')
            return False, None

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self):
        with self._cv:
            return self._closed

    def __iter__(self):
        """Drain until closed (Go's `for v := range ch`)."""
        while True:
            try:
                yield self.recv()
            except ChannelClosed:
                return


def make_channel(dtype=None, capacity=0):
    """(reference fluid.make_channel) dtype accepted for API parity;
    host channels are dynamically typed."""
    return Channel(capacity=capacity)


class Select(object):
    """Commit to exactly ONE ready case (reference Select op semantics).

    with Select() as sel:
        sel.case_recv(ch_a, on_a)        # on_a(value)
        sel.case_send(ch_b, v, on_b)     # on_b()
        sel.default(on_none)             # optional; else Select blocks
    """

    def __init__(self):
        self._cases = []
        self._default = None

    def __enter__(self):
        return self

    def case_recv(self, ch, handler):
        self._cases.append(('recv', ch, None, handler))

    def case_send(self, ch, value, handler):
        self._cases.append(('send', ch, value, handler))

    def default(self, handler):
        self._default = handler

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        while True:
            for kind, ch, value, handler in self._cases:
                if kind == 'recv':
                    ok, v = ch.poll()
                    if ok:
                        handler(v)
                        return False
                else:
                    if ch.try_send(value):
                        handler()
                        return False
            if self._default is not None:
                self._default()
                return False
            time.sleep(0.005)     # nothing ready: poll, don't spin hot
