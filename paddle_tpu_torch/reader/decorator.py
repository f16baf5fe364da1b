"""Reader decorators (counterpart of paddle_tpu/reader/decorator.py).

A reader is a zero-argument callable that returns an iterable of
samples. map_readers, shuffle, chain, compose, firstn and cache give the
JAX package's samples in the JAX package's order (shuffle draws from
Python's `random`, as there). buffered, xmap_readers and
multiprocess_reader run workers in threads, as the JAX package does;
here every worker stops and is joined when its reader ends or its
consumer stops early (closes the generator), and a worker that misses
its join deadline (blocked inside a user reader) is counted by
pipeline.leaked_threads(). xmap_readers(order=True) gives the mapped
samples in the source order without spinning.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import random
import subprocess
import threading

from .pipeline import note_leak

__all__ = ['map_readers', 'buffered', 'shuffle', 'chain', 'compose',
           'firstn', 'xmap_readers', 'cache', 'multiprocess_reader',
           'PipeReader', 'ComposeNotAligned', 'XmapEndSignal']

JOIN_TIMEOUT_S = 10.0
_POLL_S = 0.05


def map_readers(func, *readers):
    """Apply func elementwise across samples drawn from several readers."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """Windowed shuffle: fill a buffer of buf_size, shuffle, drain."""
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b
    return data_reader


def chain(*readers):
    """Concatenate readers back to back."""
    def reader():
        for r in readers:
            for e in r():
                yield e
    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into tuple samples; with check_alignment (the
    default) a reader that ends early raises ComposeNotAligned."""
    check_alignment = kwargs.pop('check_alignment', True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(map(make_tuple, outputs), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        'outputs of readers are not aligned')
                yield sum(map(make_tuple, outputs), ())
    return reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item
    return data_reader


def cache(reader):
    """Materialize once, replay from memory thereafter."""
    all_data = []
    filled = [False]

    def data_reader():
        if not filled[0]:
            for d in reader():
                all_data.append(d)
                yield d
            filled[0] = True
        else:
            for d in all_data:
                yield d
    return data_reader


class XmapEndSignal(object):
    pass


class _Failure(object):
    """A worker's exception, carried to the consumer."""

    def __init__(self, exc):
        self.exc = exc


def _put(q, item, stop):
    """Put unless `stop` is set first; True if the item went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _get(q, stop):
    """Get unless `stop` is set first (then XmapEndSignal)."""
    while not stop.is_set():
        try:
            return q.get(timeout=_POLL_S)
        except queue.Empty:
            continue
    return XmapEndSignal()


class _Workers(object):
    """Daemon threads that share one stop event; close() sets it and
    joins them, counting a worker that misses its deadline as leaked."""

    def __init__(self, name):
        self.name = name
        self.stop = threading.Event()
        self.threads = []

    def start(self, target, *args):
        t = threading.Thread(target=target, args=args, daemon=True,
                             name='%s-%d' % (self.name, len(self.threads)))
        t.start()
        self.threads.append(t)

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(JOIN_TIMEOUT_S)
            if t.is_alive():
                note_leak(self.name, t)


def _drain_into(reader, q, stop):
    """Worker body: put every sample of reader(), then the end signal; a
    failure of the reader is put in their place."""
    try:
        for s in reader():
            if not _put(q, s, stop):
                return
    except Exception as e:          # noqa: BLE001 — raised by the consumer
        _put(q, _Failure(e), stop)
        return
    _put(q, XmapEndSignal(), stop)


def buffered(reader, size):
    """Prefetch up to `size` samples in a background thread."""
    def data_reader():
        q = queue.Queue(maxsize=size)
        workers = _Workers('buffered')
        workers.start(_drain_into, reader, q, workers.stop)
        try:
            while True:
                e = _get(q, workers.stop)
                if isinstance(e, XmapEndSignal):
                    break
                if isinstance(e, _Failure):
                    raise e.exc
                yield e
        finally:
            workers.close()
    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map samples with `process_num` threads; order=True keeps the
    source order."""
    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        workers = _Workers('xmap_readers')
        stop = workers.stop

        def read_worker():
            try:
                for item in enumerate(reader()):
                    if not _put(in_q, item, stop):
                        return
            except Exception as e:  # noqa: BLE001 — raised by the consumer
                _put(out_q, _Failure(e), stop)
            for _ in range(process_num):
                _put(in_q, XmapEndSignal(), stop)

        def handle_worker():
            while True:
                item = _get(in_q, stop)
                if isinstance(item, XmapEndSignal):
                    break
                i, d = item
                try:
                    r = (i, mapper(d))
                except Exception as e:  # noqa: BLE001 — consumer raises
                    r = _Failure(e)
                if not _put(out_q, r, stop):
                    return
            _put(out_q, XmapEndSignal(), stop)

        workers.start(read_worker)
        for _ in range(process_num):
            workers.start(handle_worker)
        try:
            finished, pending, want = 0, [], 0
            while finished < process_num:
                r = _get(out_q, stop)
                if isinstance(r, XmapEndSignal):
                    finished += 1
                    continue
                if isinstance(r, _Failure):
                    raise r.exc
                if not order:
                    yield r[1]
                    continue
                heapq.heappush(pending, r)
                while pending and pending[0][0] == want:
                    yield heapq.heappop(pending)[1]
                    want += 1
        finally:
            workers.close()
    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Run several readers at once, one thread each, and merge their
    samples as they come."""
    def data_reader():
        q = queue.Queue(queue_size)
        workers = _Workers('multiprocess_reader')
        for r in readers:
            workers.start(_drain_into, r, q, workers.stop)
        try:
            finished = 0
            while finished < len(readers):
                s = _get(q, workers.stop)
                if isinstance(s, XmapEndSignal):
                    finished += 1
                    continue
                if isinstance(s, _Failure):
                    raise s.exc
                yield s
        finally:
            workers.close()
    return data_reader


class PipeReader(object):
    """Stream lines (or raw chunks) from a shell command's stdout."""

    def __init__(self, command, bufsize=8192, file_type='plain'):
        if not isinstance(command, str):
            raise TypeError('command must be a string')
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type
        if file_type not in ('plain', 'gzip'):
            raise TypeError('file_type %s is not allowed' % file_type)

    def get_line(self, cut_lines=True, line_break='\n'):
        process = subprocess.Popen(
            self.command.split(' '), bufsize=self.bufsize,
            stdout=subprocess.PIPE)
        if self.file_type == 'gzip':
            import zlib
            dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        remained = ''
        try:
            while True:
                buff = process.stdout.read(self.bufsize)
                if not buff:
                    break
                if self.file_type == 'gzip':
                    buff = dec.decompress(buff)
                buff = buff.decode('utf-8', errors='ignore')
                if cut_lines:
                    lines = (remained + buff).split(line_break)
                    remained = lines.pop(-1)
                    for line in lines:
                        yield line
                else:
                    yield buff
            if remained:
                yield remained
        finally:
            process.stdout.close()
            if process.poll() is None:
                process.kill()
            process.wait()
