"""paddle_tpu_torch's wire format against the JAX package's
(paddle_tpu/distributed/wire.py) on the CPU.

- For every message type and for dense fp32, int64 and bf16 values and
  SelectedRows, the port's frames, version 2 (JSON meta) and version 3
  (binary meta), are the JAX package's bytes; so are the SEND_VARS
  batches, the GET_VARS reply bodies and the frames the fault plan's
  'nan' and 'corrupt' actions write (but for 'nan' on bf16, which the
  port poisons and the JAX package passes by).
- Each package decodes the other's frames: the port into CPU tensors
  over the received bytes (bf16 as bf16), the JAX package into arrays.
- A flipped bit raises FrameCorruptError, on the socket and in a
  journal scan.
- tests/test_wire_bmeta.py's cases on the port's wire.
"""
import socket

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import flags as jflags
from paddle_tpu.distributed import resilience as jres
from paddle_tpu.distributed import wire as jwire
from paddle_tpu.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import resilience as tres
from paddle_tpu_torch.distributed import wire as twire
from paddle_tpu_torch.selected_rows import SelectedRows as TSelectedRows

MSG_TYPES = sorted(n for n, v in vars(jwire).items()
                   if n.isupper() and not n.startswith('_')
                   and isinstance(v, int)
                   and n not in ('WIRE_VERSION', 'WIRE_VERSION_BMETA'))


def _values(kind):
    """(JAX package value, port value) of one kind, the same bytes."""
    rng = np.random.RandomState(len(kind))
    if kind == 'fp32':
        a = rng.randn(3, 5).astype('float32')
        return a, torch.from_numpy(a.copy())
    if kind == 'int64':
        a = rng.randint(-2 ** 40, 2 ** 40, size=(7,)).astype('int64')
        return a, torch.from_numpy(a.copy())
    if kind == 'bf16':
        t = torch.randn(4, 6).to(torch.bfloat16)
        return t.float().numpy().astype(ml_dtypes.bfloat16), t
    if kind == 'rows':
        vals = rng.randn(4, 3).astype('float32')
        rows = np.array([5, 0, 5, 9], 'int32')
        return (JSelectedRows(vals, rows, 12),
                TSelectedRows(torch.from_numpy(vals.copy()),
                              torch.from_numpy(rows.copy()), 12))
    if kind == 'scalar':
        a = np.array(2.5, 'float32')
        return a, torch.tensor(2.5)
    raise KeyError(kind)


KINDS = ['fp32', 'int64', 'bf16', 'rows', 'scalar']


def _same_value(jval, tval):
    """A JAX package value equals a port value, bit for bit."""
    if isinstance(jval, JSelectedRows):
        assert isinstance(tval, TSelectedRows)
        assert jval.height == tval.height
        _same_value(np.asarray(jval.values), tval.values)
        assert np.array_equal(np.asarray(jval.rows), tval.rows.numpy())
        return
    assert isinstance(tval, torch.Tensor) and tval.device.type == 'cpu'
    jarr = np.asarray(jval)
    if tval.dtype == torch.bfloat16:
        assert jarr.dtype == ml_dtypes.bfloat16
        assert np.array_equal(jarr.view(np.int16),
                              tval.view(torch.int16).numpy())
        return
    assert jarr.dtype == tval.numpy().dtype
    assert tuple(jarr.shape) == tuple(tval.shape)
    assert jarr.tobytes() == tval.numpy().tobytes()


@pytest.mark.parametrize('version', [2, 3])
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('msg', MSG_TYPES)
def test_frames_are_the_jax_packages_bytes(msg, kind, version):
    assert getattr(twire, msg) == getattr(jwire, msg)
    jval, tval = _values(kind)
    meta = {'name': 'w@GRAD', 'seq': 7, 'trainer_id': 1, 'round': 3,
            'cli': 'abc123', 'inc': 0}
    jframe = jwire.pack_msg(getattr(jwire, msg), meta, value=jval,
                            version=version)
    tframe = twire.pack_msg(getattr(twire, msg), meta, value=tval,
                            version=version)
    assert tframe == jframe
    # and each package decodes the other's
    (jt, jmeta, jv), = list(jwire.unpack_msgs(tframe))
    (tt, tmeta, tv), = list(twire.unpack_msgs(jframe))
    assert jt == tt == getattr(jwire, msg) and jmeta == tmeta
    _same_value(jv, tv)


def test_a_cuda_free_value_is_viewed_not_copied():
    """A dense payload over a contiguous CPU tensor aliases its memory,
    and the decoded tensor lies over the frame's bytes."""
    t = torch.arange(8, dtype=torch.float32)
    meta, payload = twire._payload_of(t)
    assert isinstance(payload, memoryview)
    t[0] = 42.0
    assert np.frombuffer(payload, 'float32')[0] == 42.0
    buf = bytearray(twire.pack_msg(twire.REPLY_VAR, {}, value=t))
    (_, _, v), = list(twire.unpack_msgs(memoryview(buf)))
    assert v.dtype == torch.float32 and v.tolist()[0] == 42.0


def test_send_vars_and_get_vars_bodies_are_the_jax_packages_bytes():
    """A SEND_VARS batch (per-var entries, one frame) and a GET_VARS
    reply body, from the port and from the JAX package."""
    kinds = ['fp32', 'int64', 'bf16', 'scalar']
    pairs = [_values(k) for k in kinds]
    jitems = [({'name': 'v%d' % i, 'seq': i + 1, 'round': 0}, j)
              for i, (j, _) in enumerate(pairs)]
    titems = [({'name': 'v%d' % i, 'seq': i + 1, 'round': 0}, t)
              for i, (_, t) in enumerate(pairs)]
    assert twire.pack_vars_body(titems) == jwire.pack_vars_body(jitems)
    for w, items in ((jwire, jitems), (twire, titems)):
        a, b = socket.socketpair()
        try:
            w.write_vars_msg(a, {'trainer_id': 0, 'cli': 'c', 'inc': 0},
                             items)
            raw = b.recv(1 << 16)
        finally:
            a.close()
            b.close()
        if w is jwire:
            jraw = raw
        else:
            assert raw == jraw
    (t, meta, values), = list(twire.unpack_msgs(jraw))
    assert t == twire.SEND_VARS and len(values) == len(kinds)
    for (j, _), v in zip(pairs, values):
        _same_value(j, v)


def test_a_flipped_bit_raises_frame_corrupt_error():
    jval, tval = _values('fp32')
    frame = bytearray(twire.pack_msg(twire.SEND_VAR, {'name': 'g'},
                                     value=tval))
    # the version byte, a meta byte, the last payload byte (a flipped
    # length field makes a torn tail instead: test below)
    for pos in (8, 20, len(frame) - 1):
        bad = bytearray(frame)
        bad[pos] ^= 0x10
        with pytest.raises(twire.FrameCorruptError):
            list(twire.unpack_msgs(bytes(bad)))
        with pytest.raises(jwire.FrameCorruptError):
            list(jwire.unpack_msgs(bytes(bad)))
        a, b = socket.socketpair()
        try:
            a.sendall(bytes(bad))
            with pytest.raises(twire.FrameCorruptError):
                twire.read_msg(b)
        finally:
            a.close()
            b.close()
    assert issubclass(twire.FrameCorruptError, ConnectionError)


def test_a_torn_journal_tail_ends_the_scan_quietly():
    frames = b''.join(twire.pack_msg(twire.SEND_VAR, {'seq': i},
                                     value=torch.ones(3))
                      for i in range(3))
    ends = [end for *_, end in twire.scan_msgs(frames + frames[:9])]
    assert ends[-1] == len(frames) and len(ends) == 3


def test_check_finite_on_torch_values():
    assert twire.value_is_finite(torch.ones(3))
    assert not twire.value_is_finite(torch.tensor([1.0, float('nan')]))
    assert not twire.value_is_finite(
        torch.tensor([float('inf')], dtype=torch.bfloat16))
    assert twire.value_is_finite(torch.tensor([1, 2]))
    sr = TSelectedRows(torch.tensor([[float('nan')]]),
                       torch.tensor([0], dtype=torch.int32), 3)
    assert not twire.value_is_finite(sr)
    assert twire.value_is_finite(np.ones(2, 'f4'))


@pytest.mark.parametrize('kind', ['fp32', 'bf16', 'rows'])
@pytest.mark.parametrize('action', ['nan', 'corrupt'])
def test_fault_mutations_write_the_jax_packages_frames(action, kind):
    """The 'nan' action poisons the float payload before framing and
    'corrupt' flips bits after it; the port writes the JAX package's
    exact frame under the same plan, for torch values."""
    spec = {'rules': [{'when': 'send', 'type': 'SEND_VAR', 'nth': 1,
                       'action': action, 'bits': 3}]}
    jval, tval = _values(kind)
    raws = []
    for w, res, val in ((jwire, jres, jval), (twire, tres, tval)):
        plan = res.FaultPlan.from_dict(spec)
        a, b = socket.socketpair()
        try:
            with res.active_plan(plan):
                w.write_msg(a, w.SEND_VAR, {'name': 'g', 'seq': 1}, val)
            raws.append(b.recv(1 << 16))
        finally:
            a.close()
            b.close()
    if action == 'nan' and kind == 'bf16':
        # the one divergence by design: the JAX package's numpy view of
        # bf16 has kind 'V', so its nan action (and its finite guard)
        # pass a bf16 payload by; the port's treat bf16 as the float it
        # is
        (_, _, jv), = list(jwire.unpack_msgs(raws[0]))
        assert jwire.value_is_finite(jv)
        assert raws[0][:14] != raws[1][:14]     # another crc
    else:
        assert raws[0] == raws[1]
    if action == 'nan':
        (_, _, v), = list(twire.unpack_msgs(raws[1]))
        assert not twire.value_is_finite(v)
    else:
        with pytest.raises(twire.FrameCorruptError):
            list(twire.unpack_msgs(raws[1]))


# -- tests/test_wire_bmeta.py's cases on the port's wire ---------------------

@pytest.fixture
def bmeta_flag():
    old = tflags.get_flag('wire_binary_meta')
    jold = jflags.get_flag('wire_binary_meta')
    yield
    tflags.set_flags({'FLAGS_wire_binary_meta': old})
    jflags.set_flags({'FLAGS_wire_binary_meta': jold})


def _version_byte(sock):
    # u32 crc | u32 body_len | u8 version -- peek, don't consume
    raw = sock.recv(9, socket.MSG_PEEK)
    assert len(raw) == 9
    return raw[8]


def test_bm_codec_json_semantics_round_trip():
    meta = {'seq': 7, 'name': 'w@2', 'ok': True, 'off': False,
            'none': None, 'f': -1.5, 'big': 2 ** 40, 'neg': -3,
            'list': [1, 'two', [3.0, False, None]],
            'nested': {'a': {'b': 'c'}, 'd': [1, 2]},
            'uni': 'héllo ✓'}
    assert twire.bm_loads(twire.bm_dumps(meta)) == meta
    assert twire.bm_dumps(meta) == jwire.bm_dumps(meta)
    assert twire.bm_loads(twire.bm_dumps({1: 'x'})) == {'1': 'x'}
    out = twire.bm_loads(twire.bm_dumps({'dig': b'\x00\xff\x01'}))
    assert out['dig'] == b'\x00\xff\x01'


def test_bm_codec_rejects_corrupt_buffers():
    with pytest.raises(twire.FrameCorruptError):
        twire.bm_loads(b'\xee\x00\x00\x00\x00')       # unknown tag
    with pytest.raises(twire.FrameCorruptError):
        twire.bm_loads(twire.bm_dumps({'a': 1}) + b'\x01')  # trailing


def test_v3_frames_round_trip_and_mix_with_v2_in_one_buffer():
    val = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    buf = (twire.pack_msg(twire.REPLY_OK, {'seq': 1})
           + twire.pack_msg(twire.REPLY_VAR, {'seq': 2, 'name': 'w'},
                            value=val,
                            version=twire.WIRE_VERSION_BMETA)
           + twire.pack_msg(twire.REPLY_OK, {'seq': 3}))
    msgs = list(twire.unpack_msgs(buf))
    assert [m[0] for m in msgs] == [twire.REPLY_OK, twire.REPLY_VAR,
                                    twire.REPLY_OK]
    assert [m[1]['seq'] for m in msgs] == [1, 2, 3]
    assert msgs[1][1]['name'] == 'w'
    assert torch.equal(msgs[1][2], val)


def test_negotiated_upgrade_and_flag_off_default(bmeta_flag):
    tflags.set_flags({'FLAGS_wire_binary_meta': False})
    a, b = socket.socketpair()
    try:
        twire.write_msg(a, twire.REPLY_OK, {'seq': 0})
        assert _version_byte(b) == twire.WIRE_VERSION
        _t, meta, _v = twire.read_msg(b)
        assert 'bmeta' not in meta

        tflags.set_flags({'FLAGS_wire_binary_meta': True})
        twire.write_msg(a, twire.REPLY_OK, {'seq': 1})
        assert _version_byte(b) == twire.WIRE_VERSION
        _t, meta, _v = twire.read_msg(b)
        assert meta['seq'] == 1 and meta.get('bmeta') == 1
        twire.write_msg(b, twire.REPLY_OK, {'seq': 2})
        assert _version_byte(a) == twire.WIRE_VERSION_BMETA
        _t, meta, _v = twire.read_msg(a)
        assert meta == {'seq': 2}
        twire.write_msg(a, twire.REPLY_OK, {'seq': 3})
        assert _version_byte(b) == twire.WIRE_VERSION_BMETA
        assert twire.read_msg(b)[1] == {'seq': 3}
    finally:
        a.close()
        b.close()


def test_old_peer_keeps_connection_on_json(bmeta_flag):
    tflags.set_flags({'FLAGS_wire_binary_meta': True})
    a, b = socket.socketpair()
    try:
        twire.write_msg(a, twire.REPLY_OK, {'seq': 1})
        _t, meta, _v = twire.read_msg(b)
        assert meta.get('bmeta') == 1
        b.sendall(twire.pack_msg(twire.REPLY_OK, {'seq': 2}))
        _t, meta, _v = twire.read_msg(a)
        assert meta == {'seq': 2}
        twire.write_msg(a, twire.REPLY_OK, {'seq': 3})
        assert _version_byte(b) == twire.WIRE_VERSION
        assert twire.read_msg(b)[1].get('bmeta') == 1
    finally:
        a.close()
        b.close()


def test_a_port_peer_and_a_jax_peer_negotiate_v3(bmeta_flag):
    """Across packages: a flag-on port sender adverts, the JAX peer
    upgrades its reply to v3, and the port then speaks v3 to it."""
    tflags.set_flags({'FLAGS_wire_binary_meta': True})
    jflags.set_flags({'FLAGS_wire_binary_meta': True})
    a, b = socket.socketpair()
    try:
        twire.write_msg(a, twire.SEND_VAR, {'seq': 1}, torch.ones(2))
        _t, meta, v = jwire.read_msg(b)
        assert meta.get('bmeta') == 1 and np.array_equal(v, np.ones(2))
        jwire.write_msg(b, jwire.REPLY_OK, {'seq': 1})
        assert _version_byte(a) == twire.WIRE_VERSION_BMETA
        assert twire.read_msg(a)[1] == {'seq': 1}
        twire.write_msg(a, twire.GET_VAR, {'seq': 2, 'name': 'w'})
        assert _version_byte(b) == jwire.WIRE_VERSION_BMETA
        assert jwire.read_msg(b)[1] == {'seq': 2, 'name': 'w'}
    finally:
        a.close()
        b.close()
