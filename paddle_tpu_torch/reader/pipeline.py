"""Async input pipeline: blocking queue + double-buffered device copy
(counterpart of paddle_tpu/reader/pipeline.py).

- A feeder thread runs the user's Python generator and pushes host
  batches into a bounded queue (the blocking queue).
- With double buffering, a placer thread pops host batches and copies
  them to the reader's device AHEAD of the step: on a CUDA device each
  batch goes through pinned memory on a side stream, and an event
  recorded after the copy travels with it. `read()` makes the consuming
  stream wait on that event and marks the tensors as used there
  (record_stream), so the step never sees a half-copied batch and the
  caching allocator never hands the memory back to the side stream
  early.

The `read` host op (ops/io_ops.py) pops one batch per step and raises
EOFException when the pass ends: users catch it, reset() and start()
the next pass.
"""
from __future__ import annotations

import queue
import sys
import threading

import numpy as np
import torch

__all__ = ['PyReader', 'get_reader', 'EOFException', 'leaked_threads',
           'note_leak']

# worker threads that outlived their join timeout (a thread blocked in a
# user generator cannot be interrupted from Python)
_leaked = 0
_leak_lock = threading.Lock()


def leaked_threads():
    """Process-wide count of reader worker threads that missed their
    join deadline (monotonic)."""
    return _leaked


def note_leak(reader_name, thread):
    """Count a worker that missed its join deadline and say so on
    stderr. The py_reader and the reader decorators' workers report
    here."""
    global _leaked
    with _leak_lock:
        _leaked += 1
        n = _leaked
    sys.stderr.write(
        'WARNING: reader %r worker %s did not exit within its join '
        'timeout and was leaked (likely blocked in the user data '
        'generator; %d leaked so far this process)\n'
        % (reader_name, thread.name, n))


class EOFException(Exception):
    """End of one data pass (reference fluid.core.EOFException)."""


_EOF = object()


class _SourceError(object):
    """Sentinel carrying a generator exception to the consuming step."""
    def __init__(self, exc):
        self.exc = exc


_readers = {}


def stack_samples(batch, dtypes):
    """Stack a list of per-sample slot tuples into one array per slot."""
    slots = list(zip(*batch))
    return [np.stack([np.asarray(s, dtype=dt) for s in slot])
            for slot, dt in zip(slots, dtypes)]


def get_reader(name):
    r = _readers.get(name)
    if r is None:
        raise KeyError('py_reader %r is not registered' % name)
    return r


class PyReader(object):
    """Runtime half of fluid.layers.py_reader; quacks enough like a
    Variable (name attr) for fluid.layers.read_file(reader).

    device: where batches are placed. None means the card when one is
    present, else the CPU; the read op moves a batch to the executor's
    device if it lies elsewhere."""

    def __init__(self, name, shapes, dtypes, lod_levels=None, capacity=64,
                 use_double_buffer=True, device=None, join_timeout=10.0):
        self.name = name
        self.join_timeout = float(join_timeout)
        self.shapes = [tuple(s) for s in shapes]
        self.dtypes = list(dtypes)
        self.lod_levels = list(lod_levels or [0] * len(shapes))
        self.capacity = int(capacity)
        self.use_double_buffer = use_double_buffer
        self.device = device
        self._source = None
        self._host_q = None
        self._dev_q = None
        self._threads = []
        self._started = False
        self._stop = threading.Event()
        old = _readers.get(name)
        if old is not None and old._started:
            raise ValueError(
                'py_reader %r already exists and is started — reset() it '
                'before building another reader with the same name' % name)
        _readers[name] = self

    # -- decoration --------------------------------------------------------
    def decorate_tensor_provider(self, provider):
        """provider(): generator of ready per-slot array lists. Slots
        that are already torch tensors pass through untouched."""
        def source():
            for batch in provider():
                yield [a if isinstance(a, torch.Tensor)
                       else np.asarray(a, dtype=dt)
                       for a, dt in zip(batch, self.dtypes)]
        self._source = source
        return self

    decorate_batch_generator = decorate_tensor_provider

    def decorate_paddle_reader(self, reader):
        """reader(): generator of batches, each a list of per-sample
        tuples (fluid.batch's form), stacked into one array per slot."""
        def source():
            for batch in reader():
                yield stack_samples(batch, self.dtypes)
        self._source = source
        return self

    # -- lifecycle ---------------------------------------------------------
    def _target_device(self):
        if self.device is not None:
            return torch.device(self.device)
        if torch.cuda.is_available():
            return torch.device('cuda', torch.cuda.current_device())
        return torch.device('cpu')

    def start(self):
        if self._source is None:
            raise RuntimeError('py_reader %r: call decorate_tensor_provider '
                               'first' % self.name)
        if self._started:
            raise RuntimeError('py_reader %r already started (reset() '
                               'after EOFException)' % self.name)
        # each pass's threads get their own queues and stop event, so a
        # stale thread from a timed-out reset only touches dead queues
        self._stop = threading.Event()
        self._host_q = queue.Queue(maxsize=self.capacity)
        self._threads = [threading.Thread(target=self._feed_loop,
                                          args=(self._host_q, self._stop),
                                          daemon=True)]
        if self.use_double_buffer:
            # depth 2: one batch in flight to the device, one ready
            self._dev_q = queue.Queue(maxsize=2)
            self._threads.append(threading.Thread(
                target=self._place_loop,
                args=(self._host_q, self._dev_q, self._stop,
                      self._target_device()),
                daemon=True))
        for t in self._threads:
            t.start()
        self._started = True

    def reset(self):
        """Drain after EOF (or mid-pass) so start() can begin a new pass."""
        self._stop.set()
        for q in (self._host_q, self._dev_q):
            while q is not None:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in self._threads:
            t.join(timeout=self.join_timeout)
            if t.is_alive():
                note_leak(self.name, t)
        self._threads = []
        self._started = False

    # -- step side ---------------------------------------------------------
    def read(self):
        """One batch of per-slot values; raises EOFException at pass end.
        Double-buffered: tensors already on the reader's device, ready
        for the current stream."""
        if not self._started:
            raise RuntimeError('py_reader %r: start() before running the '
                               'program' % self.name)
        q = self._dev_q if self.use_double_buffer else self._host_q
        item = q.get()
        if isinstance(item, _SourceError):
            self._started = False
            raise RuntimeError('py_reader %r data source failed'
                               % self.name) from item.exc
        if item is _EOF:
            self._started = False
            for t in self._threads:
                t.join(timeout=self.join_timeout)
                if t.is_alive():
                    note_leak(self.name, t)
            self._threads = []
            raise EOFException('pass end in py_reader %r' % self.name)
        if not self.use_double_buffer:
            return [torch.as_tensor(a) for a in item]
        tensors, event = item
        if event is not None:
            stream = torch.cuda.current_stream(tensors[0].device)
            stream.wait_event(event)
            for t in tensors:
                t.record_stream(stream)
        return tensors

    # -- threads -----------------------------------------------------------
    def _feed_loop(self, host_q, stop):
        # a generator failure must surface at the consuming step, not
        # masquerade as a clean pass end
        tail = _EOF
        try:
            for batch in self._source():
                if stop.is_set():
                    return
                self._put_interruptible(host_q, batch, stop)
        except Exception as e:         # noqa: BLE001 — re-raised in read()
            tail = _SourceError(e)
        finally:
            self._put_interruptible(host_q, tail, stop)

    def _place_loop(self, host_q, dev_q, stop, device):
        stream = (torch.cuda.Stream(device) if device.type == 'cuda'
                  else None)
        while True:
            # poll with a timeout so a mid-pass reset() cannot strand
            # this thread
            if stop.is_set():
                return
            try:
                item = host_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is _EOF or isinstance(item, _SourceError):
                self._put_interruptible(dev_q, item, stop)
                return
            try:
                placed = self._place(item, device, stream)
            except Exception as e:     # noqa: BLE001 — re-raised in read()
                # a placement failure (bad dtype, device OOM) must reach
                # the consuming step, not kill this thread and hang read()
                self._put_interruptible(dev_q, _SourceError(e), stop)
                return
            self._put_interruptible(dev_q, placed, stop)

    @staticmethod
    def _place(item, device, stream):
        if stream is None:
            return [torch.as_tensor(a).to(device) for a in item], None
        with torch.cuda.stream(stream):
            tensors = []
            for a in item:
                t = torch.as_tensor(a)
                if t.device.type == 'cpu':
                    t = t.pin_memory()
                tensors.append(t.to(device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return tensors, event

    def _put_interruptible(self, q, item, stop):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue
