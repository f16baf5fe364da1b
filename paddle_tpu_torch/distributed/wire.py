"""Binary wire format for the parameter-server RPC layer (counterpart of
paddle_tpu/distributed/wire.py: the same frames, byte for byte, so a
frame either package writes decodes in the other).

Frame layout, version 2 (all integers little-endian):

    u32 crc | u32 body_len | u8 version | u8 msg_type | u32 meta_len
    | meta (JSON, utf-8) | payload

`crc` is zlib crc32 (`integrity.crc32`) over EVERYTHING after the crc
field -- the remaining header fields plus meta plus payload -- so a
flipped bit anywhere in the frame fails verification. `body_len` counts
meta + payload bytes only. A frame that fails its CRC or carries an
unknown version raises `FrameCorruptError`, a ConnectionError subclass:
the RPC clients treat ConnectionError as retryable (drop the socket,
reconnect, replay the same seq), so a corrupted frame costs one round
trip and is never applied.

Dense payload:        raw C-contiguous bytes (dtype/shape in meta).
SelectedRows payload: values bytes followed by int32 rows bytes
                      (meta: value dtype/shape, nrows, height).

Version 3 (FLAGS_wire_binary_meta) keeps the frame layout but encodes
`meta` with the binary codec below (embedded-length tag bytes, zigzag
varints, per-message dict-key interning) instead of JSON: an 80-var
SEND_VARS meta encodes ~2x smaller. The upgrade is negotiated per
connection: a flag-on sender adds 'bmeta': 1 to its v2 JSON metas; a
receiver that sees the advert -- or an actual v3 frame -- marks the
socket, and a flag-on sender emits v3 only to a peer so proven. Readers
accept both versions unconditionally (the journal decoder too).

The torch boundary: `encode` (`pack_msg`, `write_msg`) takes a torch
tensor (CPU or CUDA), a numpy array, or a SelectedRows whose values are
either; a CUDA value is copied to the host first (the `send` op hands
over host tensors, so the hot path never does). A decoded value is a
CPU tensor over the received bytes (`torch.frombuffer`: no copy beyond
the socket read), a SelectedRows of two such tensors for a sparse one.
bf16 travels under the dtype name `bfloat16` as its 2-byte pattern,
never widened, as the JAX package writes it.
"""
from __future__ import annotations

import json
import struct
import sys
import weakref

import numpy as np
import torch

from ..integrity import crc32
from ..obs import telemetry as _tm

# telemetry series (no-ops while FLAGS_obs_dir is unset): every frame
# on the socket path counts here, both directions, plus every CRC
# verification failure — wire or journal
_FRAMES_OUT = _tm.counter('wire.frames_out')
_BYTES_OUT = _tm.counter('wire.bytes_out')
_FRAMES_IN = _tm.counter('wire.frames_in')
_BYTES_IN = _tm.counter('wire.bytes_in')
_CRC_FAILURES = _tm.counter('wire.crc_failures')

# message types
SEND_VAR = 1        # trainer -> pserver: push a gradient (dense or sparse)
GET_VAR = 2         # trainer -> pserver: pull a parameter
SEND_VARS = 12      # trainer -> pserver: MANY small dense gradients in
                    # one frame (meta['vars'] lists per-var name/dtype/
                    # shape/len/seq/round; payload is their concatenated
                    # bytes). One CRC + one JSON header + one reply
                    # covers the whole batch; each contained var keeps
                    # its OWN (cli, seq) dedup token and round tag, so a
                    # replayed batch is applied per-var at-most-once
                    # exactly like individual SEND_VARs
PREFETCH = 3        # trainer -> pserver: distributed-lookup-table row fetch
BATCH_BARRIER = 4   # trainer -> pserver: all grads for this step sent
FETCH_BARRIER = 5   # trainer -> pserver: all params for this step fetched
COMPLETE = 6        # trainer -> pserver: this trainer is done training
CHECKPOINT = 10     # trainer -> pserver: save your param shard to dir
REGISTER = 11       # trainer -> pserver: (re)join handshake — carries the
                    # trainer's incarnation; reply meta reports the
                    # server's round state so a restarted trainer knows
                    # where to resume (elastic recovery)
GET_VARS = 13       # serving -> pserver: pull MANY params in one frame
                    # (meta['names']); the REPLY_VAR carries meta['vars']
                    # entries (name/dtype/shape/len/digest) + the params'
                    # concatenated bytes, all read atomically under the
                    # service lock and stamped with the param version
                    # they belong to (online refresh pulls one
                    # version-consistent shard per round trip)
GET_VERSION = 14    # serving -> pserver: current param version; with
                    # meta['manifest'] the REPLY_OK also carries the
                    # per-param crc32 digest manifest the subscriber
                    # verifies pulled bytes against
SRV_SUBMIT = 20     # router -> replica: open a generation stream
                    # (meta rid/max_new_tokens/eos_id + 'prio', the SLO
                    # tier — higher = more important, absent reads as
                    # the lowest tier 0; value = prompt token ids). A
                    # failover re-submit carries the original prompt
                    # PLUS the tokens already decoded — greedy
                    # determinism makes the re-prefilled stream
                    # bit-exact with the unkilled one
SRV_POLL = 21       # router -> replica: progress of meta['rids'];
                    # reply meta['streams'] maps rid -> {state, tokens}
                    # (UNKNOWN for a rid the replica never saw — a
                    # restarted replica's answer for pre-kill streams)
SRV_CANCEL = 22     # router -> replica: cancel stream meta['rid']
SRV_HEALTH = 23     # router -> replica: liveness + load probe; reply
                    # carries queue_depth/active/capacity/max_len/
                    # param_version/draining (and with meta['digests']
                    # the per-param crc32s a deploy convergence check
                    # compares against the pserver manifest)
SRV_DRAIN = 24      # router -> replica: drain fence — meta['on'] stops
                    # (or resumes) THIS replica admitting new streams;
                    # in-flight streams keep decoding to completion
SRV_REFRESH = 25    # router -> replica: pull + install the pservers'
                    # newest params NOW (ParamSubscriber.refresh_once);
                    # the rolling-deploy step after the drain completes
SRV_PAGES = 26      # disaggregated serving (serving/disagg.py): a
                    # first-class KV-page shipment. meta carries the
                    # hash-chain keys ('keys', hex, in chain order),
                    # how many leading chain pages the receiver already
                    # held ('skip' — content-addressed dedup: a page
                    # already present is acknowledged without
                    # transfer), the prompt tokens and page geometry;
                    # the value is one float32 array
                    # [pools, pages, page_tokens, heads, dk] under the
                    # usual CRC/bmeta discipline. Sent prefill ->
                    # decode as the SRV_PAGE_FETCH reply, or pushed
                    # directly at a replica, which installs via
                    # PagePool.restore_pages + PrefixCache and acks
                    # REPLY_OK {'installed', 'deduped'}
SRV_PAGE_FETCH = 27  # decode replica -> prefill replica: prefill
                    # meta-described prompt (value: token ids) if its
                    # pages are not already cached, then reply with an
                    # SRV_PAGES frame shipping every full prefix page
                    # the requester's 'have' key list lacks
REPLY_VAR = 7       # pserver -> trainer: a variable value
REPLY_OK = 8        # pserver -> trainer: ack
REPLY_ERR = 9       # pserver -> trainer: error (meta['error'])

WIRE_VERSION = 2        # JSON meta (the on-disk journal default)
WIRE_VERSION_BMETA = 3  # binary meta (negotiated; FLAGS_wire_binary_meta)
_WIRE_VERSIONS = (WIRE_VERSION, WIRE_VERSION_BMETA)

# crc, body_len, version, msg_type, meta_len
_HDR = struct.Struct('<IIBBI')
_CRC_SKIP = 4   # the crc field itself is excluded from its own coverage


class FrameCorruptError(ConnectionError):
    """A frame failed its CRC32 or version check. Subclassing
    ConnectionError makes the existing retry machinery handle it: the
    client drops the socket and replays the request (same seq), the
    server closes the connection — a corrupt frame is never parsed past
    its header, let alone applied."""


_resilience = None


def _faults():
    """Fault-injection hook module (resilience.py), resolved lazily so
    wire stays import-light; the hooks are no-ops without an active
    FaultPlan (FLAGS_fault_plan)."""
    global _resilience
    if _resilience is None:
        from . import resilience
        _resilience = resilience
    return _resilience


# dtype name on the wire (numpy's name; ml_dtypes' 'bfloat16') <-> torch
_TORCH_DTYPES = {
    'float32': torch.float32, 'float64': torch.float64,
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'int64': torch.int64, 'int32': torch.int32, 'int16': torch.int16,
    'int8': torch.int8, 'uint8': torch.uint8, 'bool': torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name):
    """The torch dtype of a wire dtype name."""
    try:
        return _TORCH_DTYPES[str(name)]
    except KeyError:
        raise FrameCorruptError('wire dtype %r is not supported' % name)


def _bytes_view(arr):
    """A flat byte view over a C-contiguous array WITHOUT copying.
    Falls back to tobytes() for the shapes memoryview.cast cannot
    flatten (0-d, exotic buffers)."""
    try:
        return memoryview(arr).cast('B')
    except (TypeError, ValueError):
        return arr.tobytes()


def _host_array(value):
    """(dtype name, shape, contiguous host array viewing the value's
    bytes). A CPU tensor is viewed, not copied; a bf16 one through its
    2-byte pattern; a CUDA tensor is copied to the host."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type != 'cpu':
            t = t.cpu()
        t = t.contiguous()
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError('wire cannot carry dtype %s' % t.dtype)
        shape = list(t.shape)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, shape, t.numpy()
    arr = np.asarray(value)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return arr.dtype.name, list(arr.shape), arr


def _payload_of(value):
    """(meta_fields, payload_bytes) for a dense value or SelectedRows.
    The payload may be a memoryview aliasing the value's buffer (dense,
    already-contiguous host case) -- every consumer (crc32, len,
    b''.join, sendall) speaks the buffer protocol."""
    from ..selected_rows import SelectedRows
    if isinstance(value, SelectedRows):
        name, shape, vals = _host_array(value.values)
        rows = value.rows
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().to('cpu', torch.int32).numpy()
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int32))
        meta = {'sparse': True, 'dtype': name, 'shape': shape,
                'height': int(value.height)}
        return meta, b''.join((_bytes_view(vals), _bytes_view(rows)))
    name, shape, arr = _host_array(value)
    meta = {'sparse': False, 'dtype': name, 'shape': shape}
    return meta, _bytes_view(arr)


def _tensor_of(buf, dtype, shape):
    """A CPU tensor over `buf` (no copy) of the given dtype and shape."""
    count = 1
    for d in shape:
        count *= int(d)
    if count == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype,
                            count=count).reshape(tuple(shape))


def _value_of(meta, payload):
    """Inverse of _payload_of: CPU tensors over the payload's bytes."""
    from ..selected_rows import SelectedRows
    dtype = torch_dtype(meta['dtype'])
    shape = tuple(meta['shape'])
    nval = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    if meta.get('sparse'):
        values = _tensor_of(payload[:nval], dtype, shape)
        nrows = (len(payload) - nval) // 4
        rows = _tensor_of(payload[nval:], torch.int32, (nrows,))
        return SelectedRows(values, rows, meta['height'])
    return _tensor_of(payload[:nval], dtype, shape)


def value_is_finite(value):
    """True iff every float element of a dense value / SelectedRows is
    finite. Non-float dtypes are vacuously finite. Shared by the
    client-side pre-send check and the pserver's gradient guard
    (FLAGS_ps_check_grad_finite)."""
    from ..selected_rows import SelectedRows
    if isinstance(value, SelectedRows):
        value = value.values
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            return True
        return bool(torch.isfinite(value).all())
    arr = np.asarray(value)
    if arr.dtype.kind != 'f':
        return True
    return bool(np.isfinite(arr).all())


# -- binary meta codec (wire version 3) -----------------------------------
# Compact tag-byte encoding built to beat JSON on SIZE (pure-Python
# can't beat the C json module on CPU time; the win this codec buys is
# bytes on the wire). Three tricks:
#   * embedded lengths: small ints, short strings, and small
#     lists/dicts pack their value/length into the tag byte's low 5
#     bits (one byte of overhead total for the common case)
#   * LEB128 varints for everything bigger (ints are zigzagged first
#     so small negatives stay small)
#   * per-message dict-key interning: a key's utf-8 spells out once;
#     every repeat is a 1-byte (or varint) back-reference — SEND_VARS
#     metas repeat {'name','seq','round','dtype','shape','len'} per
#     entry, so the entry-list overhead collapses
# Dict keys keep JSON semantics (non-string keys stringify, decode
# always yields str keys), so the two meta encodings round-trip to the
# same Python object. Tag map:
#   0x00 None | 0x01 True | 0x02 False | 0x03 int (zigzag varint)
#   0x04 float (f64) | 0x05 str (varint len) | 0x06 bytes (varint len)
#   0x07 list (varint count) | 0x08 dict (varint count)
#   0x09 long new key (varint len) | 0x0A key backref (varint index)
#   0x20|z  small int, zigzag value z in the tag  (-16..15)
#   0x40|n  short str of n bytes | 0x60|n short list | 0x80|n short dict
#   0xC0|n  short new key of n bytes | 0xE0|i key backref, index i < 32
# Anything else (0x0B..0x1F, 0xA0..0xBF) is an unknown tag ->
# FrameCorruptError.

_BM_INT, _BM_FLOAT, _BM_STR = 0x03, 0x04, 0x05
_BM_BYTES, _BM_LIST, _BM_DICT = 0x06, 0x07, 0x08
_BM_KEYDEF, _BM_KEYREF = 0x09, 0x0A
_F64 = struct.Struct('<d')


def _bm_uvarint(out, n):
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _bm_read_uvarint(buf, off):
    shift = result = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _bm_encode(obj, out, keys):
    if obj is None:
        out.append(0x00)
    elif obj is True:
        out.append(0x01)
    elif obj is False:
        out.append(0x02)
    elif isinstance(obj, int):
        zz = (obj << 1) if obj >= 0 else ((-obj << 1) - 1)
        if zz < 0x20:
            out.append(0x20 | zz)
        else:
            out.append(_BM_INT)
            _bm_uvarint(out, zz)
    elif isinstance(obj, float):
        out.append(_BM_FLOAT)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode('utf-8')
        n = len(b)
        if n < 0x20:
            out.append(0x40 | n)
        else:
            out.append(_BM_STR)
            _bm_uvarint(out, n)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_BM_BYTES)
        _bm_uvarint(out, len(b))
        out += b
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 0x20:
            out.append(0x60 | n)
        else:
            out.append(_BM_LIST)
            _bm_uvarint(out, n)
        for v in obj:
            _bm_encode(v, out, keys)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 0x20:
            out.append(0x80 | n)
        else:
            out.append(_BM_DICT)
            _bm_uvarint(out, n)
        for k, v in obj.items():
            ks = str(k)
            idx = keys.get(ks)
            if idx is None:
                keys[ks] = len(keys)
                kb = ks.encode('utf-8')
                kn = len(kb)
                if kn < 0x20:
                    out.append(0xC0 | kn)
                else:
                    out.append(_BM_KEYDEF)
                    _bm_uvarint(out, kn)
                out += kb
            elif idx < 0x20:
                out.append(0xE0 | idx)
            else:
                out.append(_BM_KEYREF)
                _bm_uvarint(out, idx)
            _bm_encode(v, out, keys)
    else:
        raise TypeError('binary wire meta cannot encode %r'
                        % type(obj).__name__)


def bm_dumps(meta):
    """Meta dict -> version-3 binary bytes (the v3 json.dumps)."""
    out = bytearray()
    _bm_encode(meta, out, {})
    return bytes(out)


def _bm_read_key(buf, off, keys):
    tag = buf[off]
    off += 1
    hi = tag & 0xE0
    if hi == 0xE0:
        return keys[tag & 0x1F], off
    if hi == 0xC0:
        n = tag & 0x1F
    elif tag == _BM_KEYDEF:
        n, off = _bm_read_uvarint(buf, off)
    elif tag == _BM_KEYREF:
        idx, off = _bm_read_uvarint(buf, off)
        return keys[idx], off
    else:
        raise FrameCorruptError(
            'binary wire meta: invalid key tag 0x%02x at offset %d'
            % (tag, off - 1))
    k = bytes(buf[off:off + n]).decode('utf-8')
    keys.append(k)
    return k, off + n


def _bm_decode(buf, off, keys):
    tag = buf[off]
    off += 1
    if tag < 0x20:
        if tag == 0x00:
            return None, off
        if tag == 0x01:
            return True, off
        if tag == 0x02:
            return False, off
        if tag == _BM_INT:
            zz, off = _bm_read_uvarint(buf, off)
            return ((zz >> 1) if not zz & 1 else -((zz + 1) >> 1)), off
        if tag == _BM_FLOAT:
            return _F64.unpack_from(buf, off)[0], off + 8
        if tag in (_BM_STR, _BM_BYTES):
            n, off = _bm_read_uvarint(buf, off)
            raw = bytes(buf[off:off + n])
            if len(raw) != n:
                raise FrameCorruptError(
                    'binary wire meta: truncated at offset %d' % off)
            return ((raw.decode('utf-8') if tag == _BM_STR else raw),
                    off + n)
        if tag == _BM_LIST:
            n, off = _bm_read_uvarint(buf, off)
        elif tag == _BM_DICT:
            n, off = _bm_read_uvarint(buf, off)
            out = {}
            for _ in range(n):
                k, off = _bm_read_key(buf, off, keys)
                out[k], off = _bm_decode(buf, off, keys)
            return out, off
        else:
            raise FrameCorruptError(
                'binary wire meta: unknown tag 0x%02x at offset %d'
                % (tag, off - 1))
        out = []
        for _ in range(n):
            v, off = _bm_decode(buf, off, keys)
            out.append(v)
        return out, off
    hi = tag & 0xE0
    low = tag & 0x1F
    if hi == 0x20:
        return ((low >> 1) if not low & 1 else -((low + 1) >> 1)), off
    if hi == 0x40:
        raw = bytes(buf[off:off + low])
        if len(raw) != low:
            raise FrameCorruptError(
                'binary wire meta: truncated at offset %d' % off)
        return raw.decode('utf-8'), off + low
    if hi == 0x60:
        out = []
        for _ in range(low):
            v, off = _bm_decode(buf, off, keys)
            out.append(v)
        return out, off
    if hi == 0x80:
        out = {}
        for _ in range(low):
            k, off = _bm_read_key(buf, off, keys)
            out[k], off = _bm_decode(buf, off, keys)
        return out, off
    raise FrameCorruptError('binary wire meta: unknown tag 0x%02x at '
                            'offset %d' % (tag, off - 1))


def bm_loads(buf):
    """Version-3 binary meta bytes -> dict (the v3 json.loads)."""
    try:
        obj, off = _bm_decode(memoryview(buf), 0, [])
    except (IndexError, struct.error) as e:
        raise FrameCorruptError('binary wire meta: truncated (%s)' % e)
    if off != len(buf):
        raise FrameCorruptError(
            'binary wire meta: %d trailing bytes after the root value'
            % (len(buf) - off))
    return obj


# sockets proven to decode v3 (socket.socket has __slots__, so the
# capability lives in a WeakSet keyed by the socket object — it dies
# with the connection, exactly the negotiation scope we want)
_BMETA_PEERS = weakref.WeakSet()


def _peer_speaks_bmeta(sock):
    if getattr(sock, '_wire_peer_bmeta', False):  # test doubles
        return True
    try:
        return sock in _BMETA_PEERS
    except TypeError:
        return False


def _mark_peer_bmeta(sock):
    try:
        _BMETA_PEERS.add(sock)
    except TypeError:
        try:
            sock._wire_peer_bmeta = True
        except AttributeError:
            pass                  # unmarkable peer: stay on JSON


def _sender_wants_bmeta():
    from ..flags import get_flag
    return bool(get_flag('wire_binary_meta'))


def _frame_head(msg_type, meta, payload, version=WIRE_VERSION):
    """The bytes of a frame before its payload (crc, the header, the
    meta). The crc chains over the header and meta, then the payload,
    so a frame is never joined in memory to be checksummed."""
    if version == WIRE_VERSION_BMETA:
        mb = bm_dumps(meta)
    else:
        mb = json.dumps(meta).encode('utf-8')
    rest = struct.pack('<IBBI', len(mb) + len(payload), version, msg_type,
                       len(mb)) + mb
    return struct.pack('<I', crc32(payload, crc32(rest))) + rest


def pack_msg(msg_type, meta=None, value=None, payload=b'',
             version=WIRE_VERSION):
    """Serialize one frame to bytes. Shared by the socket path
    (write_msg) and the pserver's on-disk mutation journal
    (param_service) — a journal record IS a wire frame, so replay and
    socket dispatch share one decoder (and one CRC check). `version`
    picks the meta encoding: 2 = JSON (default — journals stay readable
    by any build), 3 = binary (bm_dumps)."""
    meta = dict(meta or {})
    if value is not None:
        vmeta, payload = _payload_of(value)
        meta.update(vmeta)
    return _frame_head(msg_type, meta, payload, version) + bytes(payload)


# a payload above this many bytes is sent after its frame head instead of
# being joined to it: the socket reads it from the value's own memory
_JOIN_BYTES = 1 << 16


def _send_frame(sock, head, payload):
    """Send one frame (its head, then its payload). Returns its length."""
    if len(payload) <= _JOIN_BYTES:
        sock.sendall(head + bytes(payload))
    else:
        sock.sendall(head)
        sock.sendall(payload)
    return len(head) + len(payload)


def _check_frame(buf, off, end, crc):
    if crc32(bytes(buf[off + _CRC_SKIP:end])) != crc:
        _CRC_FAILURES.inc()
        raise FrameCorruptError(
            'frame at offset %d failed its CRC32 check (corrupt bytes '
            'on the wire or on disk)' % off)


def _values_of_batch(meta, payload):
    """Decode a SEND_VARS body: meta['vars'] entries each carry their
    own dtype/shape plus 'len' (payload byte count); the payload is the
    vars' bytes back to back. Returns the values in entry order."""
    values, off = [], 0
    for e in meta['vars']:
        n = int(e['len'])
        values.append(_value_of(e, payload[off:off + n]))
        off += n
    return values


def pack_vars_body(items):
    """(entries, payload) for a multi-var frame body: items is
    [(entry_meta, value), ...]; each entry gets the value's dtype/shape
    plus 'len' filled in, the payload is the values' bytes back to back
    — the exact body _values_of_batch decodes. The inverse pairing lets
    a server build a multi-var REPLY_VAR through the ordinary write_msg
    path (fault hooks see ONE reply frame, matching the one logical
    GET_VARS request)."""
    entries, chunks = [], []
    for emeta, value in items:
        vmeta, payload = _payload_of(value)
        e = dict(emeta)
        e.update(vmeta)
        e['len'] = len(payload)
        entries.append(e)
        chunks.append(payload)
    return entries, b''.join(chunks)


def _parse_body(body, meta_len, version=WIRE_VERSION):
    # body is a memoryview over a writable buffer (a socket read or a
    # journal frame's copy): only the meta is copied out; tensor
    # payloads decode zero-copy
    if not meta_len:
        meta = {}
    elif version == WIRE_VERSION_BMETA:
        meta = bm_loads(body[:meta_len])
    else:
        meta = json.loads(bytes(body[:meta_len]).decode('utf-8'))
    payload = body[meta_len:]
    if 'vars' in meta:
        return meta, _values_of_batch(meta, payload)
    value = _value_of(meta, payload) if 'dtype' in meta else None
    return meta, value


def scan_msgs(buf):
    """Yield (msg_type, meta, value, end_offset) for each complete,
    CRC-verified frame in `buf`; `end_offset` is the byte offset just
    past the frame (journal replay truncates a torn tail to the last
    yielded end_offset before reopening for append).

    A truncated trailing frame (a journal torn by a mid-write crash, or
    a corrupt body_len that claims bytes past EOF — indistinguishable)
    ends the scan without error: the caller sees end_offset < len(buf)
    and decides how loudly to report it. A frame that is fully present
    but fails its CRC, or carries an unknown wire version, raises
    FrameCorruptError — everything yielded before it is a consistent
    prefix; nothing after it can be trusted (framing is lost)."""
    off, n = 0, len(buf)
    while off + _HDR.size <= n:
        crc, body_len, version, msg_type, meta_len = \
            _HDR.unpack_from(buf, off)
        end = off + _HDR.size + body_len
        if end > n:
            return          # torn tail
        if version not in _WIRE_VERSIONS:
            raise FrameCorruptError(
                'frame at offset %d: wire version %d (expected one of '
                '%s) — corrupt header or a file from an incompatible '
                'build' % (off, version, list(_WIRE_VERSIONS)))
        if meta_len > body_len:
            raise FrameCorruptError(
                'frame at offset %d: meta_len %d exceeds body_len %d'
                % (off, meta_len, body_len))
        _check_frame(buf, off, end, crc)
        body = memoryview(bytearray(buf[off + _HDR.size:end]))
        meta, value = _parse_body(body, meta_len, version)
        yield msg_type, meta, value, end
        off = end


def unpack_msgs(buf):
    """Yield (msg_type, meta, value) for each complete, verified frame
    in `buf` — scan_msgs without the offsets."""
    for msg_type, meta, value, _ in scan_msgs(buf):
        yield msg_type, meta, value


def write_msg(sock, msg_type, meta=None, value=None, payload=b''):
    meta = dict(meta or {})
    if value is not None:
        vmeta, payload = _payload_of(value)
        meta.update(vmeta)
    # binary-meta negotiation: emit v3 only once the peer is PROVEN to
    # speak it (it advertised, or already sent us a v3 frame); until
    # then keep advertising inside the v2 JSON meta — an old peer just
    # ignores the unknown key and the connection stays on JSON
    version = WIRE_VERSION
    if _sender_wants_bmeta():
        if _peer_speaks_bmeta(sock):
            version = WIRE_VERSION_BMETA
        else:
            meta['bmeta'] = 1
    # fault hook BEFORE any bytes hit the wire: an injected drop/error
    # never leaves a half-written frame on the socket. The hook fires
    # exactly once per send, so a retry of this message advances the
    # plan's counters past the rule that faulted it.
    effect = _faults().on_send(sock, msg_type, meta)
    action = getattr(effect, 'action', None)
    if action in ('corrupt', 'nan'):
        # same stderr audit line the exit action leaves: corrupt/nan
        # damage is meant to be INVISIBLE at the application layer
        # (detected and retried), so chaos tests grep the log to prove
        # the fault actually fired
        sys.stderr.write('fault injection: %s on send of msg type %s '
                         '(rule %s)\n' % (action, msg_type,
                                          effect.rule.to_dict()))
        sys.stderr.flush()
    if action == 'nan':
        # poison the float payload BEFORE framing: the frame carries a
        # valid CRC — this is a numeric fault (a bad gradient), not a
        # transport fault, and must get past the CRC check to exercise
        # the finite-guard path
        payload = _poison_payload(meta, payload)
    if action == 'corrupt':
        # flip bits AFTER framing, inside the CRC-covered region: the
        # receiver must detect the damage and never apply the frame
        frame = effect.mutate_frame(
            pack_msg(msg_type, meta, payload=payload, version=version),
            _HDR.size)
        sock.sendall(frame)
        n = len(frame)
    else:
        n = _send_frame(sock, _frame_head(msg_type, meta, payload, version),
                        payload)
    _FRAMES_OUT.inc()
    _BYTES_OUT.inc(n)
    if action == 'close':
        effect.post_send()   # frame delivered, connection then dies


def write_vars_msg(sock, frame_meta, items):
    """Write ONE SEND_VARS frame carrying many dense vars.

    `items` is a list of (entry_meta, value) pairs: entry_meta holds the
    per-var fields (name/seq/round), and the value's dtype/shape/len are
    filled in here; `frame_meta` holds the frame-level fields
    (trainer_id/cli/inc/trace). Fault hooks advance once PER LOGICAL VAR
    — a batch of 8 vars steps a `send SEND_VAR` rule's counter 8 times —
    so seeded plans fire at the same logical points whether or not
    batching is on. Frame-scoped actions (drop/close/corrupt) hit the
    whole batch; the per-var (cli, seq) dedup tokens make the replay
    apply each contained var at-most-once. A `nan` action poisons only
    the matched var's bytes (valid CRC, numeric fault).
    """
    entries, chunks = [], []
    for emeta, value in items:
        vmeta, payload = _payload_of(value)
        e = dict(emeta)
        e.update(vmeta)
        e['len'] = len(payload)
        entries.append(e)
        chunks.append(payload)
    effect = _faults().on_send_vars(sock, SEND_VAR, entries)
    action = getattr(effect, 'action', None)
    if action in ('corrupt', 'nan'):
        sys.stderr.write('fault injection: %s on send of msg type %s '
                         '(rule %s, batch of %d)\n'
                         % (action, SEND_VARS, effect.rule.to_dict(),
                            len(entries)))
        sys.stderr.flush()
    if action == 'nan':
        i = effect.index or 0
        chunks[i] = _poison_payload(entries[i], chunks[i])
    meta = dict(frame_meta)
    meta['vars'] = entries
    version = WIRE_VERSION
    if _sender_wants_bmeta():
        if _peer_speaks_bmeta(sock):
            version = WIRE_VERSION_BMETA
        else:
            meta['bmeta'] = 1
    frame = pack_msg(SEND_VARS, meta, payload=b''.join(chunks),
                     version=version)
    if action == 'corrupt':
        frame = effect.mutate_frame(frame, _HDR.size)
    sock.sendall(frame)
    _FRAMES_OUT.inc()
    _BYTES_OUT.inc(len(frame))
    if action == 'close':
        effect.post_send()
    return len(frame)


def _poison_payload(meta, payload):
    """Replace the dense float region of a payload with NaNs of the
    same dtype/length (the 'nan' FaultPlan action -- a deterministic
    stand-in for a diverging or corrupted gradient computation)."""
    if 'dtype' not in meta:
        return payload
    dtype = torch_dtype(meta['dtype'])
    if not dtype.is_floating_point:
        return payload
    count = int(np.prod(tuple(meta.get('shape', ())) or (0,)))
    nval = min(count * torch.empty((), dtype=dtype).element_size(),
               len(payload))
    if nval <= 0:
        return payload
    bad = torch.full((count,), float('nan'), dtype=dtype)
    bad = bytes(_host_array(bad)[2].tobytes())[:nval]
    return bad + bytes(payload[nval:])


def _read_exact(sock, n):
    """Read exactly n bytes straight into one freshly allocated buffer
    via recv_into — no per-chunk bytes objects, no b''.join copy, and no
    zeroing pass first (an uninitialised numpy buffer). Returns a
    memoryview over the buffer; decoded tensors alias it zero-copy, so
    the buffer is never reused across calls."""
    view = memoryview(np.empty(n, np.uint8))
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError('peer closed the connection')
        got += r
    return view


def read_msg(sock):
    """-> (msg_type, meta dict, value or None). value is a CPU tensor or
    SelectedRows when the meta describes one. The frame's CRC is
    verified before the meta is even parsed; a mismatch raises
    FrameCorruptError (the stream may be desynced — the connection is
    unusable either way)."""
    while True:
        hdr = _read_exact(sock, _HDR.size)
        crc, body_len, version, msg_type, meta_len = _HDR.unpack(hdr)
        if version not in _WIRE_VERSIONS:
            _CRC_FAILURES.inc()
            raise FrameCorruptError(
                'bad wire version %d (expected one of %s) — corrupt '
                'header or desynced stream'
                % (version, list(_WIRE_VERSIONS)))
        body = (_read_exact(sock, body_len) if body_len
                else memoryview(bytearray()))
        # incremental CRC (crc32 chains): covers header-after-crc then
        # body without materializing their concatenation
        if crc32(body, crc32(hdr[_CRC_SKIP:])) != crc:
            _CRC_FAILURES.inc()
            raise FrameCorruptError(
                'frame (msg type %d, %d body bytes) failed its CRC32 '
                'check — corrupt bytes on the wire' % (msg_type, body_len))
        if meta_len > body_len:
            _CRC_FAILURES.inc()
            raise FrameCorruptError(
                'frame meta_len %d exceeds body_len %d'
                % (meta_len, body_len))
        meta, value = _parse_body(body, meta_len, version)
        # capability latch: a v3 frame, or a v2 meta carrying the
        # 'bmeta' advert, proves this peer decodes binary metas — our
        # flag-on replies to THIS socket may upgrade from here on
        if version == WIRE_VERSION_BMETA or meta.get('bmeta'):
            _mark_peer_bmeta(sock)
        _FRAMES_IN.inc()
        _BYTES_IN.inc(len(hdr) + len(body))
        # fault hook AFTER the full frame was consumed (framing stays
        # intact); 'drop' discards this message and reads the next. A
        # SEND_VARS batch advances the counters once per contained var
        # (same logical firing points whether or not batching is on).
        if msg_type == SEND_VARS:
            act = _faults().on_recv_vars(sock, SEND_VAR, len(meta['vars']))
        else:
            act = _faults().on_recv(sock, msg_type, meta)
        if act == 'drop':
            continue
        return msg_type, meta, value
