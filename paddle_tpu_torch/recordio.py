"""RecordIO: chunked, checksummed, compressed record files (counterpart
of paddle_tpu/recordio.py, the same file format byte for byte: a file
either package writes, the other reads).

The chunk engine is C++ (native/recordio.cc: framing, CRC32 over the raw
payload, deflate), the multi-file prefetcher and its image-decode stage
too (native/prefetcher.cc); the tensor serialization is Python. A
record is one SAMPLE: a tuple of per-slot numpy arrays, each a standard
.npy blob with u32 framing (dtype and shape travel with the data, no
pickle).

`reader(path)` is an ordinary sample-reader creator, so fluid.batch,
DataFeeder and py_reader compose with it; layers.open_files and
layers.open_recordio_file feed a program from these files.
"""
from __future__ import annotations

import glob as _glob
import io
import struct
import zlib

import ctypes
import numpy as np

from .integrity import crc32
from .native import load_library

__all__ = ['Compressor', 'RecordIOWriter', 'RecordIOScanner',
           'ParallelRecordIOScanner', 'parallel_reader', 'reader',
           'convert_reader_to_recordio_file',
           'convert_reader_to_recordio_files', 'verify_file']


class Compressor(object):
    NoCompress = 0
    Deflate = 1
    # the reference's scripts say Snappy; the engine's compressed mode is
    # deflate, as in the JAX package
    Snappy = 1


def _lib():
    lib = load_library('recordio')
    if not getattr(lib, '_rupt_typed', False):
        lib.rupt_writer_open.restype = ctypes.c_void_p
        lib.rupt_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                         ctypes.c_uint32]
        lib.rupt_writer_append.restype = ctypes.c_int
        lib.rupt_writer_append.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p,
                                           ctypes.c_uint32]
        lib.rupt_writer_close.restype = ctypes.c_int
        lib.rupt_writer_close.argtypes = [ctypes.c_void_p]
        lib.rupt_scanner_open.restype = ctypes.c_void_p
        lib.rupt_scanner_open.argtypes = [ctypes.c_char_p]
        lib.rupt_scanner_next.restype = ctypes.c_int
        lib.rupt_scanner_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.rupt_scanner_close.argtypes = [ctypes.c_void_p]
        lib.rupt_last_error.restype = ctypes.c_char_p
        lib._rupt_typed = True
    return lib


def _err(lib):
    return lib.rupt_last_error().decode('utf-8', 'replace')


def _encode_sample(slots):
    """slots: sequence of array-likes -> bytes (u32 nslots, then per slot
    u32 len + .npy blob)."""
    parts = [struct.pack('<I', len(slots))]
    for s in slots:
        buf = io.BytesIO()
        np.save(buf, np.asarray(s), allow_pickle=False)
        blob = buf.getvalue()
        parts.append(struct.pack('<I', len(blob)))
        parts.append(blob)
    return b''.join(parts)


def _decode_sample(data):
    (nslots,) = struct.unpack_from('<I', data, 0)
    off = 4
    slots = []
    for _ in range(nslots):
        (ln,) = struct.unpack_from('<I', data, off)
        off += 4
        slots.append(np.load(io.BytesIO(data[off:off + ln]),
                             allow_pickle=False))
        off += ln
    return slots


class RecordIOWriter(object):
    """Chunked record writer (reference recordio/writer.h)."""

    Compressor = Compressor

    def __init__(self, filename, compressor=Compressor.Deflate,
                 max_num_records=1000):
        self._libref = _lib()
        self._h = self._libref.rupt_writer_open(
            filename.encode(), compressor, max_num_records)
        if not self._h:
            raise IOError(_err(self._libref))

    def append_record(self, data):
        """Append raw bytes as one record."""
        if self._h is None:
            raise ValueError('writer is closed')
        if len(data) > 0xFFFFFF00:   # u32 framing; ctypes would truncate
            raise ValueError('record too large for recordio framing '
                             '(%d bytes, max ~4GB)' % len(data))
        if self._libref.rupt_writer_append(self._h, data, len(data)) != 0:
            raise IOError(_err(self._libref))

    def append_sample(self, slots):
        """Append one sample (tuple of array-likes)."""
        self.append_record(_encode_sample(slots))

    def close(self):
        if self._h is not None:
            h, self._h = self._h, None
            if self._libref.rupt_writer_close(h) != 0:
                raise IOError(_err(self._libref))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordIOScanner(object):
    """Sequential record iterator (reference recordio/scanner.h)."""

    def __init__(self, filename):
        self._libref = _lib()
        self._h = self._libref.rupt_scanner_open(filename.encode())
        if not self._h:
            raise IOError(_err(self._libref))

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        out = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint32()
        rc = self._libref.rupt_scanner_next(self._h, ctypes.byref(out),
                                            ctypes.byref(ln))
        if rc == 1:
            self.close()
            raise StopIteration
        if rc != 0:
            msg = _err(self._libref)
            self.close()
            raise IOError(msg)
        return ctypes.string_at(out, ln.value)

    def close(self):
        if self._h is not None:
            h, self._h = self._h, None
            self._libref.rupt_scanner_close(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# chunk header (native/recordio.cc): magic 'RUPT', version, compressor,
# num_records, raw_len, stored_len, crc32(RAW payload), reserved
_CHUNK_HDR = struct.Struct('<8I')
_CHUNK_MAGIC = 0x54505552
_CHUNK_VERSION = 1


def verify_file(path):
    """Audit every chunk of a recordio file without the native scanner:
    header sanity, inflate, CRC over the raw payload (the same
    integrity.crc32 the wire and statefile layers use), and record
    framing. Raises IOError naming the byte offset of the first damaged
    chunk; returns (num_chunks, num_records) when the file is clean."""
    num_chunks = num_records = 0
    with open(path, 'rb') as f:
        while True:
            off = f.tell()
            hdr = f.read(_CHUNK_HDR.size)
            if not hdr:
                return num_chunks, num_records
            if len(hdr) < _CHUNK_HDR.size:
                raise IOError('%s: truncated chunk header at offset %d'
                              % (path, off))
            (magic, version, compressor, n_rec, raw_len, stored_len,
             crc, _reserved) = _CHUNK_HDR.unpack(hdr)
            if magic != _CHUNK_MAGIC:
                raise IOError('%s: bad magic at offset %d: not a '
                              'recordio chunk' % (path, off))
            if version != _CHUNK_VERSION:
                raise IOError('%s: unsupported chunk version %d at '
                              'offset %d' % (path, version, off))
            stored = f.read(stored_len)
            if len(stored) < stored_len:
                raise IOError('%s: truncated chunk payload at offset %d '
                              '(%d of %d bytes)'
                              % (path, off, len(stored), stored_len))
            if compressor == Compressor.Deflate:
                try:
                    raw = zlib.decompress(stored)
                except zlib.error as e:
                    raise IOError('%s: inflate failed for chunk at '
                                  'offset %d: %s' % (path, off, e))
            else:
                raw = stored
            if len(raw) != raw_len:
                raise IOError('%s: chunk at offset %d inflates to %d '
                              'bytes, header says %d'
                              % (path, off, len(raw), raw_len))
            if crc32(raw) != crc:
                raise IOError('%s: crc mismatch in chunk at offset %d'
                              % (path, off))
            rec_off = 0
            for _ in range(n_rec):
                if rec_off + 4 > len(raw):
                    raise IOError('%s: record framing overruns chunk '
                                  'at offset %d' % (path, off))
                (rlen,) = _U32.unpack_from(raw, rec_off)
                rec_off += 4 + rlen
            if rec_off != len(raw):
                raise IOError('%s: record framing does not cover chunk '
                              'at offset %d' % (path, off))
            num_chunks += 1
            num_records += n_rec


def reader(pattern):
    """Sample-reader creator over recordio file(s) (glob pattern or list)
    — composes with paddle.batch / DataFeeder / py_reader."""
    paths = pattern if isinstance(pattern, (list, tuple)) \
        else sorted(_glob.glob(pattern)) or [pattern]

    def _read():
        for path in paths:
            with RecordIOScanner(path) as sc:
                for rec in sc:
                    yield tuple(_decode_sample(rec))
    return _read



_U32 = struct.Struct('<I')

_pf_lib = None


def _prefetch_lib():
    global _pf_lib
    if _pf_lib is None:
        lib = load_library('prefetcher')
        lib.rupt_prefetcher_open.restype = ctypes.c_void_p
        lib.rupt_prefetcher_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
        lib.rupt_prefetcher_next_chunk.restype = ctypes.c_int
        lib.rupt_prefetcher_next_chunk.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.rupt_prefetcher_close.argtypes = [ctypes.c_void_p]
        lib.rupt_prefetcher_take_chunk.restype = ctypes.c_int
        lib.rupt_prefetcher_take_chunk.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32)]
        lib.rupt_chunk_free.argtypes = [ctypes.c_void_p]
        lib.rupt_pf_last_error.restype = ctypes.c_char_p
        _pf_lib = lib
    return _pf_lib


class ParallelRecordIOScanner(object):
    """Multi-threaded record iterator over MANY recordio files
    (native/prefetcher.cc): C++ workers claim files from an atomic
    cursor and run IO, CRC32 and inflate off the interpreter lock into
    one bounded queue, which Python drains a whole decompressed chunk at
    a time. Records keep file order WITHIN a file; the order across
    files depends on the workers. Single-consumer: drive it from one
    thread."""

    def __init__(self, filenames, n_threads=4, capacity=64,
                 loop=False):
        if isinstance(filenames, str):
            filenames = [filenames]
        self._libref = _prefetch_lib()
        arr = (ctypes.c_char_p * len(filenames))(
            *[f.encode() for f in filenames])
        self._pending = []
        self._h = self._libref.rupt_prefetcher_open(
            arr, len(filenames), n_threads, capacity, 1 if loop else 0)
        if not self._h:
            raise IOError(
                self._libref.rupt_pf_last_error().decode(
                    'utf-8', 'replace'))

    def __iter__(self):
        return self

    def _translate_rc(self, rc):
        """Shared end-of-data / native-error translation for the two
        fetch flavors: rc 1 -> StopIteration, rc<0 -> IOError, both
        closing the handle."""
        if rc == 1:
            self.close()
            raise StopIteration
        if rc != 0:
            msg = self._libref.rupt_pf_last_error().decode(
                'utf-8', 'replace')
            self.close()
            raise IOError(msg)

    def _fetch_chunk(self):
        """One (payload bytes, n_records) pair from the native queue.
        Raises StopIteration at end-of-data and IOError on a native
        error."""
        if self._h is None:
            raise StopIteration
        out = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint32()
        nrec = ctypes.c_uint32()
        rc = self._libref.rupt_prefetcher_next_chunk(
            self._h, ctypes.byref(out), ctypes.byref(ln),
            ctypes.byref(nrec))
        self._translate_rc(rc)
        return ctypes.string_at(out, ln.value), nrec.value

    class _ChunkOwner(object):
        __slots__ = ('_lib', '_h')

        def __init__(self, lib, h):
            self._lib, self._h = lib, h

        def __del__(self):
            h, self._h = self._h, None
            if h:
                self._lib.rupt_chunk_free(h)

    def _fetch_chunk_owned(self):
        """Zero-copy chunk fetch: returns (uint8 ndarray view, nrec)
        where the view's base chain owns the native buffer (freed when
        the LAST array referencing it is collected), so no per-chunk
        copy serialises the drain."""
        if self._h is None:
            raise StopIteration
        out = ctypes.POINTER(ctypes.c_uint8)()
        fh = ctypes.c_void_p()
        ln = ctypes.c_uint32()
        nrec = ctypes.c_uint32()
        rc = self._libref.rupt_prefetcher_take_chunk(
            self._h, ctypes.byref(out), ctypes.byref(fh),
            ctypes.byref(ln), ctypes.byref(nrec))
        self._translate_rc(rc)
        cbuf = (ctypes.c_uint8 * ln.value).from_address(
            ctypes.cast(out, ctypes.c_void_p).value or 0)
        # the ctypes array becomes the numpy base; pinning the owner on
        # it ties the native free to the LAST numpy view's lifetime
        cbuf._owner = self._ChunkOwner(self._libref, fh.value)
        arr = np.frombuffer(cbuf, dtype=np.uint8)
        return arr, nrec.value

    def __next__(self):
        # hand-off is per CHUNK (one FFI+lock crossing per hundreds of
        # records); records of the current chunk drain from a local list
        while not self._pending:        # loop: empty chunks are legal
            payload, n = self._fetch_chunk()
            recs = []
            off = 0
            for _ in range(n):
                (rlen,) = _U32.unpack_from(payload, off)
                off += 4
                recs.append(payload[off:off + rlen])
                off += rlen
            recs.reverse()              # pop() yields in file order
            self._pending = recs
        return self._pending.pop()

    def close(self):
        if self._h is not None:
            self._libref.rupt_prefetcher_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def parallel_reader(filenames, n_threads=4, capacity=64):
    """Reader creator: decoded samples from many recordio files (or
    glob patterns) via the native prefetcher — drop-in for `reader`
    (same tuple samples, same glob support). capacity counts CHUNKS in
    flight, matching the C ABI (a records-sized number here would
    buffer GBs of decompressed chunks)."""
    # EXACTLY reader()'s path contract: a string is a glob pattern,
    # a list is literal paths (diverging by thread count would make
    # the same open_files call read different file sets)
    paths = filenames if isinstance(filenames, (list, tuple)) \
        else sorted(_glob.glob(filenames)) or [filenames]

    def impl():
        with ParallelRecordIOScanner(paths, n_threads, capacity) as sc:
            for rec in sc:
                yield tuple(_decode_sample(rec))
    return impl


def convert_reader_to_recordio_file(filename, reader_creator,
                                    compressor=Compressor.Deflate,
                                    max_num_records=1000):
    """Write every sample of `reader_creator()` (array tuples) to one
    recordio file; returns the number of records written."""
    n = 0
    with RecordIOWriter(filename, compressor, max_num_records) as w:
        for sample in reader_creator():
            w.append_sample(sample)
            n += 1
    return n


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator,
                                     compressor=Compressor.Deflate,
                                     max_num_records=1000):
    """Shard into numbered files of `batch_per_file` records each."""
    counts = []
    w = None
    try:
        for i, sample in enumerate(reader_creator()):
            if i % batch_per_file == 0:
                if w is not None:
                    w.close()
                w = RecordIOWriter('%s-%05d' % (filename,
                                                i // batch_per_file),
                                   compressor, max_num_records)
                counts.append(0)
            w.append_sample(sample)
            counts[-1] += 1
    finally:
        if w is not None:
            w.close()
    return counts


class ParallelImageScanner(ParallelRecordIOScanner):
    """Chunk iterator with the native decode stage: C++ workers parse
    each record's (u8 CHW image, int64 label) .npy slots and normalise
    the image to float32, (x/255 - mean[c]) / std[c], while the chunk is
    cache-hot, off the trainer's interpreter lock. Yields (images f32
    [n, C, H, W], labels i64 [n]) per chunk with no copy: the arrays are
    views whose base chain owns the native buffer (freed when the last
    view is collected), so they may be held across next() calls."""

    def __init__(self, filenames, image_shape, mean=None, std=None,
                 n_threads=4, capacity=16, loop=False):
        if isinstance(filenames, str):
            filenames = [filenames]
        c, h, w = (int(d) for d in image_shape)
        self._shape = (c, h, w)
        mean = np.asarray([0.0] * c if mean is None else mean,
                          dtype='float32')
        std = np.asarray([1.0] * c if std is None else std,
                         dtype='float32')
        if mean.shape != (c,) or std.shape != (c,):
            raise ValueError(
                'image_norm mean/std must have one value per channel '
                '(%d); got mean%s std%s' % (c, mean.shape, std.shape))
        self._libref = _prefetch_lib()
        lib = self._libref
        if not hasattr(lib, '_image_open_wired'):
            lib.rupt_prefetcher_open_image.restype = ctypes.c_void_p
            lib.rupt_prefetcher_open_image.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float)]
            lib._image_open_wired = True
        arr = (ctypes.c_char_p * len(filenames))(
            *[f.encode() for f in filenames])
        self._pending = []
        self._h = lib.rupt_prefetcher_open_image(
            arr, len(filenames), n_threads, capacity,
            1 if loop else 0, c, h * w,
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not self._h:
            raise IOError(lib.rupt_pf_last_error().decode(
                'utf-8', 'replace'))

    def __next__(self):
        buf, n = self._fetch_chunk_owned()
        c, h, w = self._shape
        elems = c * h * w
        imgs = buf[:n * elems * 4].view('float32') \
            .reshape(n, c, h, w)
        # labels block starts 8-byte aligned (native layout contract)
        label_off = (n * elems * 4 + 7) & ~7
        labels = buf[label_off:label_off + n * 8].view('int64')
        return imgs, labels


def parallel_image_reader(filenames, image_shape, mean=None, std=None,
                          n_threads=4, capacity=16, loop=False):
    """Sample-reader creator over natively-decoded image shards:
    yields (image f32 [C,H,W], label int64) — composes with
    paddle.batch / py_reader like any reader creator."""
    paths = filenames if isinstance(filenames, (list, tuple)) \
        else sorted(_glob.glob(filenames)) or [filenames]

    def _read():
        with ParallelImageScanner(list(paths), image_shape, mean=mean,
                                  std=std, n_threads=n_threads,
                                  capacity=capacity, loop=loop) as sc:
            for imgs, labels in sc:
                for i in range(imgs.shape[0]):
                    yield imgs[i], labels[i:i + 1]

    def _read_chunks():
        """Chunk-level arrays for the batching fast path
        (layers/io.py _set_batched_source): one (images [n,C,H,W],
        labels [n,1]) pair per chunk, no per-record slicing."""
        with ParallelImageScanner(list(paths), image_shape, mean=mean,
                                  std=std, n_threads=n_threads,
                                  capacity=capacity, loop=loop) as sc:
            for imgs, labels in sc:
                yield imgs, labels.reshape(-1, 1)

    _read._chunk_gen = _read_chunks
    return _read
