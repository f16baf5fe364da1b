"""paddle_tpu_torch's disaggregated prefill (serving/disagg.py and the
replica's SRV_PAGES / SRV_PAGE_FETCH) against the JAX package.

Each test of tests/test_disagg.py, on the port, with the same name: the
page frames under both meta codecs and a CRC bit flip; the content-
addressed chain (extend, dedup, directory deltas); a decode server that
pulls a prompt's pages from a prefill replica decodes as its own cold
prefill does, with the prefill run once per unique prefix; a pushed
shipment's dedup ack and a foreign shipment's refusal; the router's
prefix directory; the ship path's typed failures. Then the
cross-package checks:
- the SRV_PAGES frames pack_pages writes and the SRV_PAGE_FETCH frame
  fetch_and_install writes are the JAX package's bytes;
- pages the JAX package exports, shipped over its wire and installed by
  the port, give prefill logits within 1e-5 (fp32) of the JAX package's
  own prefill of the prompt.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.distributed import wire as jwire
from paddle_tpu.serving import disagg as jdisagg
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.serving import LMServer, ReplicaServer, ShipError
from paddle_tpu_torch.serving import disagg
from paddle_tpu_torch.serving.fleet import FleetRequest, FleetRouter
from paddle_tpu_torch.serving.paging import PagePool, PrefixCache, chain_keys

import torch_fleet_worker as tfw

PT = 4                                    # page_tokens under test
PROMPT = [3, 9, 27, 17, 5, 41, 2, 8, 60, 33, 12, 7, 19]   # 3 full pages
GEN = 3                                   # 13 + 3 <= max_len
CPU = tfluid.CPUPlace()


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('torch_disagg_model'))
    tfw.build_model(d)
    return d


def _paged_server(model_dir):
    return LMServer(model_dir, place=CPU, slots=2, paged=True,
                    page_tokens=PT, kv_pages=33)


class _InprocReplica(object):
    def __init__(self, srv):
        self.rs = ReplicaServer(srv, '127.0.0.1:0')
        self.ep = '127.0.0.1:%d' % self.rs.port
        self._t = threading.Thread(target=self.rs.serve_forever,
                                   daemon=True)
        self._t.start()

    def stop(self):
        self.rs.shutdown()
        self._t.join(timeout=10)


# -- wire layer ----------------------------------------------------------------

def test_srv_pages_round_trip_both_meta_codecs():
    keys = chain_keys(PROMPT, PT, limit=len(PROMPT) - 1)
    meta = {'seq': 5, 'keys': keys, 'skip': 1, 'prompt': PROMPT,
            'page_tokens': PT}
    val = np.arange(4 * 2 * PT * 2 * 2, dtype='f4').reshape(4, 2, PT, 2, 2)
    for version in (wire.WIRE_VERSION, wire.WIRE_VERSION_BMETA):
        buf = wire.pack_msg(wire.SRV_PAGES, meta, value=val,
                            version=version)
        (t, m, v), = wire.unpack_msgs(buf)
        assert t == wire.SRV_PAGES
        assert m['keys'] == keys and m['skip'] == 1
        assert m['prompt'] == PROMPT and m['page_tokens'] == PT
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), val)


def test_srv_page_fetch_round_trip_over_socketpair():
    a, b = socket.socketpair()
    try:
        have = chain_keys(PROMPT, PT, limit=len(PROMPT) - 1)[:1]
        wire.write_msg(a, wire.SRV_PAGE_FETCH,
                       {'seq': 1, 'have': have, 'deadline_ms': 250.0},
                       np.asarray(PROMPT, np.int64))
        t, m, v = wire.read_msg(b)
        assert t == wire.SRV_PAGE_FETCH
        assert m['have'] == have and m['deadline_ms'] == 250.0
        assert disagg.token_ids(v) == PROMPT
    finally:
        a.close()
        b.close()


def test_srv_pages_crc_bit_flip_is_frame_corrupt():
    keys = chain_keys(PROMPT, PT, limit=len(PROMPT) - 1)
    val = np.ones((4, 3, PT, 2, 2), np.float32)
    for version in (wire.WIRE_VERSION, wire.WIRE_VERSION_BMETA):
        buf = bytearray(wire.pack_msg(
            wire.SRV_PAGES,
            {'seq': 1, 'keys': keys, 'skip': 0, 'prompt': PROMPT,
             'page_tokens': PT}, value=val, version=version))
        buf[-3] ^= 0x10                   # one bit, inside page bytes
        with pytest.raises(wire.FrameCorruptError):
            list(wire.unpack_msgs(bytes(buf)))
        a, csock = socket.socketpair()
        try:
            a.sendall(bytes(buf))
            with pytest.raises(wire.FrameCorruptError):
                wire.read_msg(csock)
        finally:
            a.close()
            csock.close()


# -- paging layer: the content-addressed chain ---------------------------------

def test_chain_extend_dedup_and_directory_deltas():
    pool = PagePool(17, PT)
    cache = PrefixCache(pool)
    keys = chain_keys(PROMPT, PT, limit=len(PROMPT) - 1)
    assert len(keys) == 3
    assert cache.chain(PROMPT, limit=len(PROMPT) - 1) == ([], [])
    ids = [pool.alloc() for _ in range(3)]
    cache.extend_chain(b'', [bytes.fromhex(k) for k in keys], ids)
    digests, pages = cache.chain(PROMPT, limit=len(PROMPT) - 1)
    assert [d.hex() for d in digests] == keys and pages == ids
    assert cache.drain_events() == {'new': keys, 'evicted': []}
    assert cache.resident_pages == 3
    dup = [pool.alloc() for _ in range(3)]
    in_use = pool.pages_in_use
    cache.extend_chain(b'', [bytes.fromhex(k) for k in keys], dup)
    assert pool.pages_in_use == in_use - 3
    assert cache.chain(PROMPT, limit=len(PROMPT) - 1)[1] == ids
    assert cache.drain_events() == {'new': [], 'evicted': []}
    longer = PROMPT + [44, 45, 46, 47, 48]          # 4th full page
    k4 = chain_keys(longer, PT, limit=len(longer) - 1)
    assert k4[:3] == keys
    p4 = pool.alloc()
    cache.extend_chain(bytes.fromhex(keys[-1]), [bytes.fromhex(k4[3])],
                       [p4])
    assert [d.hex() for d in
            cache.chain(longer, limit=len(longer) - 1)[0]] == k4
    assert cache.drain_events()['new'] == [k4[3]]
    gone = []
    while cache.evict_one():
        gone.extend(cache.drain_events()['evicted'])
    assert sorted(gone) == sorted(k4)
    pool.check()
    assert pool.pages_in_use == 0


# -- server layer: the fetch/install ship path ---------------------------------

@pytest.mark.timeout(600)
def test_page_fetch_install_decode_bit_exact_and_prefill_once(model_dir):
    with _paged_server(model_dir) as ref:
        want = ref.generate(PROMPT, GEN)
    prefill = _paged_server(model_dir)
    prefill.generate([50, 51, 52], 1)     # the programs run once
    rep = _InprocReplica(prefill)
    d1 = _paged_server(model_dir)
    d2 = _paged_server(model_dir)
    try:
        base = prefill.stats()['kv']['prefix_misses']
        out = disagg.fetch_and_install(d1, rep.ep, PROMPT, timeout=120.0)
        assert out['fetched'] and out['installed'] == 3
        assert out['deduped'] == 0 and out['bytes'] > 0
        again = disagg.fetch_and_install(d1, rep.ep, PROMPT, timeout=120.0)
        assert again == {'installed': 0, 'deduped': 3, 'fetched': False,
                         'bytes': 0}
        got = d1.generate(PROMPT, GEN)
        assert got == want
        assert d1.stats()['kv']['prefix_hits'] >= 1
        assert prefill.stats()['kv']['prefix_misses'] == base + 1
        out2 = disagg.fetch_and_install(d2, rep.ep, PROMPT, timeout=120.0)
        assert out2['fetched'] and out2['installed'] == 3
        assert prefill.stats()['kv']['prefix_misses'] == base + 1
        assert d2.generate(PROMPT, GEN) == want
    finally:
        rep.stop()
        for s in (prefill, d1, d2):
            s.close(drain=False)


@pytest.mark.timeout(600)
def test_srv_pages_push_dedup_ack_and_foreign_keys_refused(model_dir):
    src = _paged_server(model_dir)
    dst = _paged_server(model_dir)
    rep = _InprocReplica(dst)
    sock = None
    try:
        src.generate(PROMPT, 1)
        export = src.export_prefix(PROMPT)
        assert export is not None and len(export['keys']) == 3
        meta, val = disagg.pack_pages(PROMPT, export)
        assert meta['skip'] == 0 and val is not None
        host, port = rep.ep.rsplit(':', 1)
        sock = socket.create_connection((host, int(port)), timeout=30.0)
        sock.settimeout(120.0)
        wire.write_msg(sock, wire.SRV_PAGES, dict(meta, seq=1), val)
        t, m, _ = wire.read_msg(sock)
        assert t == wire.REPLY_OK
        assert m['installed'] == 3 and m['deduped'] == 0
        wire.write_msg(sock, wire.SRV_PAGES, dict(meta, seq=2), val)
        t, m, _ = wire.read_msg(sock)
        assert t == wire.REPLY_OK
        assert m['installed'] == 0 and m['deduped'] == 3
        bad = dict(meta, seq=3, keys=list(reversed(meta['keys'])))
        wire.write_msg(sock, wire.SRV_PAGES, bad, val)
        t, m, _ = wire.read_msg(sock)
        assert t == wire.REPLY_ERR
        assert 'hash chain' in m['error'] and m['retryable'] is False
    finally:
        if sock is not None:
            sock.close()
        rep.stop()
        src.close(drain=False)
        dst.close(drain=False)


# -- router layer: the fleet prefix directory ----------------------------------

def test_prefix_directory_affinity_invalidation_and_stale_fallback():
    dec_ep, pre_ep = '127.0.0.1:1', '127.0.0.1:2'
    router = FleetRouter([dec_ep], prefill_replicas=[pre_ep])
    keys = chain_keys(PROMPT, PT, limit=len(PROMPT) - 1)
    try:
        with router._mu:
            dec = router._reps[dec_ep]
            pre = router._reps[pre_ep]
            assert dec.role == 'serve' and pre.role == 'prefill'
            router._dir_apply_locked(dec, {
                'page_tokens': PT, 'prefix_new': keys,
                'prefix_hits': 4, 'prefix_misses': 2,
                'pages_shipped': 7, 'ship_bytes': 1024})
            router._dir_apply_locked(pre, {'page_tokens': PT,
                                           'prefix_new': keys[:1]})
            assert router._prefix_dir[keys[0]] == {dec_ep, pre_ep}
            assert dec.prefix_hits == 4 and dec.pages_shipped == 7
            req = FleetRequest(PROMPT, GEN, None, None)
            assert router._affinity_locked(req, dec) == 1.0
            assert router._affinity_locked(req, pre) == \
                pytest.approx(1.0 / 3.0)
            assert router._pick_prefill_locked(req) is None  # unhealthy
            pre.healthy = True
            assert router._pick_prefill_locked(req) is pre
            assert router._pick_locked(req) is None  # decode unhealthy
            dec.healthy = True
            assert router._pick_locked(req) is dec
            router._dir_apply_locked(dec, {'page_tokens': PT,
                                           'prefix_evicted': [keys[2]]})
            assert keys[2] not in router._prefix_dir
            assert dec_ep in router._prefix_dir[keys[1]]
        router._on_replica_down(pre)
        with router._mu:
            assert not any(pre_ep in eps
                           for eps in router._prefix_dir.values())
            req2 = FleetRequest(PROMPT, GEN, None, None)
            assert router._pick_prefill_locked(req2) is None
            assert router._pick_locked(req2) is dec
        stats = router.stats()
        assert stats['prefill_replicas'] == 1
        assert stats['prefix_dir_entries'] == len(router._prefix_dir)
    finally:
        router.stop()


# -- ship-path failure typing --------------------------------------------------

class _StubSrv(object):
    """What fetch_and_install reads of a server: its page size, its
    resident chain, and (for an empty reply) its install."""

    def __init__(self, have=()):
        self._have = list(have)

    def stats(self):
        return {'kv': {'page_tokens': PT}}

    def resident_keys(self, prompt):
        return list(self._have)

    def install_prefix(self, prompt, keys, data, skip=0):
        return 0, len(keys)


def test_fetch_deadline_spent_is_ship_error():
    with pytest.raises(ShipError, match='deadline spent'):
        disagg.fetch_and_install(_StubSrv(), '127.0.0.1:9', PROMPT,
                                 deadline_at=time.perf_counter() - 0.01)


def test_fetch_dead_peer_is_ship_error():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()                             # nobody listens here
    with pytest.raises(ShipError, match='page fetch from'):
        disagg.fetch_and_install(_StubSrv(), '127.0.0.1:%d' % port,
                                 PROMPT, timeout=2.0)


def test_fetch_full_local_hit_skips_the_wire():
    keys = chain_keys(PROMPT, PT, limit=len(PROMPT) - 1)
    out = disagg.fetch_and_install(_StubSrv(have=keys), '127.0.0.1:9',
                                   PROMPT)
    assert out == {'installed': 0, 'deduped': 3, 'fetched': False,
                   'bytes': 0}


# -- cross-package: the frames, and an install of the JAX package's pages ------

@pytest.fixture(scope='module')
def jax_export(model_dir):
    """The JAX package's paged predictor over the saved model: its
    prefill logits for PROMPT and the export of PROMPT's chain."""
    from paddle_tpu.inference import AnalysisConfig, AnalysisPredictor
    jdec = AnalysisPredictor(AnalysisConfig(
        model_dir, place=jfluid.CPUPlace())).prepare_decoding(
            slots=2, paged=True, page_tokens=PT, kv_pages=33)
    _, logits = jdec.prefill([PROMPT], [0], return_logits=True)
    export = jdec.export_prefix(PROMPT)
    assert export is not None and len(export['keys']) == 3
    return np.asarray(logits[0]), export


@pytest.mark.parametrize('skip', [0, 1])
def test_page_frames_are_the_jax_packages_bytes(jax_export, skip):
    _, export = jax_export
    have = export['keys'][:skip]
    jmeta, jval = jdisagg.pack_pages(PROMPT, export, have=have)
    tmeta, tval = disagg.pack_pages(PROMPT, export, have=have)
    assert tmeta == jmeta and tmeta['skip'] == skip
    for version in (jwire.WIRE_VERSION, jwire.WIRE_VERSION_BMETA):
        want = jwire.pack_msg(jwire.SRV_PAGES, dict(jmeta, seq=4),
                              value=jval, version=version)
        got = wire.pack_msg(wire.SRV_PAGES, dict(tmeta, seq=4),
                            value=tval, version=version)
        assert bytes(got) == bytes(want)
        (_, m, v), = wire.unpack_msgs(want)
        rows = disagg.unpack_rows(m, v)
        assert [r.shape for r in rows] == [r.shape for r in
                                           jdisagg.unpack_rows(m, jval)]
        assert all(np.array_equal(a, np.asarray(b)[skip:])
                   for a, b in zip(rows, export['data']))


def _recording_peer():
    """A peer that records the raw bytes of one page fetch and answers
    with an empty SRV_PAGES (a pure dedup ack). Returns (endpoint, the
    list the bytes land in, the thread)."""
    ls = socket.socket()
    ls.bind(('127.0.0.1', 0))
    ls.listen(1)
    got = []

    def serve():
        conn, _ = ls.accept()
        with conn:
            head = conn.recv(14, socket.MSG_WAITALL)
            body_len = int.from_bytes(head[4:8], 'little')
            body = conn.recv(body_len, socket.MSG_WAITALL)
            got.append(head + body)
            jwire.write_msg(conn, jwire.SRV_PAGES,
                            {'keys': [], 'skip': 0, 'prompt': PROMPT,
                             'page_tokens': PT})
        ls.close()
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return '127.0.0.1:%d' % ls.getsockname()[1], got, t


def test_page_fetch_frame_is_the_jax_packages_bytes():
    frames = []
    for mod in (jdisagg, disagg):
        ep, got, t = _recording_peer()
        out = mod.fetch_and_install(_StubSrv(), ep, PROMPT, timeout=30.0)
        t.join(timeout=30)
        assert out['fetched'] and out['installed'] == 0
        frames.append(got[0])
    assert frames[1] == frames[0]
    (t, m, v), = wire.unpack_msgs(frames[0])
    assert t == wire.SRV_PAGE_FETCH and m['have'] == []
    assert disagg.token_ids(v) == PROMPT


def test_prefill_logits_after_a_page_install_match_jax(model_dir,
                                                       jax_export):
    """The JAX package exports PROMPT's pages and ships them over its
    wire; the port installs them and prefills PROMPT from them (a prefix
    hit: only the suffix runs); its logits are within 1e-5 of the JAX
    package's own prefill of PROMPT."""
    jlogits, export = jax_export
    jmeta, jval = jdisagg.pack_pages(PROMPT, export)
    frame = jwire.pack_msg(jwire.SRV_PAGES, dict(jmeta, seq=1), value=jval)
    (_, meta, value), = wire.unpack_msgs(frame)
    tdec = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=CPU)
    ).prepare_decoding(slots=2, paged=True, page_tokens=PT, kv_pages=33)
    installed, deduped = tdec.install_prefix(
        meta['prompt'], meta['keys'], disagg.unpack_rows(meta, value),
        skip=meta['skip'])
    assert (installed, deduped) == (3, 0)
    hits = tdec.pool_stats()['prefix_hits']
    _, logits = tdec.prefill([PROMPT], [0], return_logits=True)
    assert tdec.pool_stats()['prefix_hits'] == hits + 1
    assert np.isfinite(logits).all()
    np.testing.assert_allclose(logits[0], jlogits, atol=1e-5, rtol=0)


def test_ship_timeout_flag_bounds_the_socket_wait():
    """FLAGS_disagg_ship_timeout is the budget a fetch's socket waits
    (the port reads the same flag, default 15 s): a peer that accepts
    and never answers costs that budget, then a ShipError."""
    assert flags.get_flag('disagg_ship_timeout') == \
        jfluid.get_flags(['disagg_ship_timeout'])['disagg_ship_timeout']
    ls = socket.socket()
    ls.bind(('127.0.0.1', 0))
    ls.listen(1)
    try:
        t0 = time.monotonic()
        with pytest.raises(ShipError):
            disagg.fetch_and_install(_StubSrv(), '127.0.0.1:%d'
                                     % ls.getsockname()[1], PROMPT,
                                     timeout=0.3)
        assert time.monotonic() - t0 < 10.0
    finally:
        ls.close()
