"""paddle_tpu_torch's paged KV cache against the JAX package's, and
against its own dense path.

The JAX package saves a small LM (its tests' config: vocab 64, dim 32,
2 layers, max_len 16, page_tokens 4); the port loads that directory on
the CPU. Pinned here:
- paged prefill + decode logits within 1e-4 of the JAX package's paged
  predictor, with equal greedy streams; two prepared programs, each
  segment run once cold (the card captures each once);
- the port's paged path against its own dense path and chunked prefill
  against a whole-prompt prefill, within 1e-5;
- copy-on-write isolation, typed exhaustion with a rolled-back step
  whose retry gives the same bits as a step that never failed, the
  512-token shared prompt prefilling its suffix only (same bits as a
  cold prefill: the chunks line up), and LMServer's cache-pressure
  stats;
- the telemetry series of one script equal to the JAX package's;
- no paged program reads a device value back to the host or builds a
  tensor from host data once it runs again (what a CUDA graph forbids).
"""
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.models.transformer import TransformerConfig
from paddle_tpu.obs import telemetry as jtelemetry
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.obs import telemetry as ttelemetry
from paddle_tpu_torch.serving.paging import CacheExhaustedError
from test_paged import _save_lm
from test_torch_executor import no_host_data  # noqa: F401 (a fixture)

CFG = TransformerConfig(vocab=64, dim=32, heads=2, layers=2, ffn=64,
                        max_len=16, use_tp=False, use_sp=False)
BIG = TransformerConfig(vocab=64, dim=16, heads=2, layers=1, ffn=32,
                        max_len=576, use_tp=False, use_sp=False)
XLANG_ATOL = 1e-4      # port vs the JAX package
SELF_ATOL = 1e-5       # port paged vs port dense / chunked vs whole
PROMPT = [3, 1, 4, 1, 5]


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _torch_pred(model_dir):
    return tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(str(model_dir),
                                        place=tfluid.CPUPlace()))


@pytest.fixture(scope='module')
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_paged_lm')
    _save_lm(d, CFG, 7)
    return d


@pytest.fixture(scope='module')
def jax_pred(lm_dir):
    return jinference.AnalysisPredictor(jinference.AnalysisConfig(
        str(lm_dir), place=jfluid.CPUPlace()))


@pytest.fixture(scope='module')
def torch_pred(lm_dir):
    return _torch_pred(lm_dir)


def _paged(pred, slots=3, **kw):
    kw.setdefault('page_tokens', 4)
    kw.setdefault('prefill_chunk', CFG.max_len)
    return pred.prepare_decoding(slots=slots, paged=True, **kw)


def _trace(dec, prompt=PROMPT, slot=1):
    """Prefill on `slot`, then decode to the window's end: the greedy
    stream and every step's logits."""
    ids, lg = dec.prefill([prompt], [slot], return_logits=True)
    stream, logits = [int(ids[0])], [lg[0]]
    toks = np.zeros((dec.slots,), np.int64)
    poss = np.zeros((dec.slots,), np.int32)
    pos = len(prompt)
    while pos < CFG.max_len:
        toks[slot], poss[slot] = stream[-1], pos
        ids, lg = dec.decode_step(toks, poss, return_logits=True)
        stream.append(int(ids[slot]))
        logits.append(lg[slot])
        pos += 1
    return stream, np.stack(logits)


def test_paged_decode_matches_jax_and_prepares_once(jax_pred, torch_pred):
    jstream, jlogits = _trace(_paged(jax_pred))
    dec = _paged(torch_pred)
    stream, logits = _trace(dec)
    assert stream == jstream
    np.testing.assert_allclose(logits, jlogits, atol=XLANG_ATOL, rtol=0)
    # page tables, COW pairs and positions are feeds: two prepared
    # programs, each segment cold once (captured once on the card)
    stats = dec.jit_cache_stats()
    assert stats['prepared_programs'] == 2
    assert stats['segment_misses'] == 2
    assert stats['segment_hits'] == len(stream) - 2


def test_paged_matches_own_dense(torch_pred):
    dstream, dlogits = _trace(torch_pred.prepare_decoding(slots=3))
    stream, logits = _trace(_paged(torch_pred))
    assert stream == dstream
    np.testing.assert_allclose(logits, dlogits, atol=SELF_ATOL, rtol=0)


def test_chunked_prefill_matches_whole_prompt(torch_pred):
    whole = _paged(torch_pred, slots=2)
    chunked = _paged(torch_pred, slots=2, prefill_chunk=4)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]      # 13 tokens
    wi, wl = whole.prefill([prompt], [0], return_logits=True)
    plan = chunked.open_stream(0, prompt)
    assert plan['chunks'] == 4 and plan['shared_tokens'] == 0
    steps, out = 0, None
    while out is None:
        out = chunked.prefill_step(0, return_logits=True)
        steps += 1
    assert steps == 4                     # ceil(13 / 4) chunks
    assert out[0] == int(wi[0])
    np.testing.assert_allclose(out[1], wl[0], atol=SELF_ATOL, rtol=0)


def test_cow_streams_never_cross_talk(torch_pred):
    paged = _paged(torch_pred, slots=2)
    prompt, n = [7, 3, 7, 4, 2, 9], 6
    ref = torch_pred.prepare_decoding(slots=1).generate(prompt, n)
    ida = paged.prefill([prompt], [0])
    b = paged.open_stream(1, prompt)
    assert b['shared_tokens'] == 4        # one full page; tail recomputed
    idb = paged.prefill_step(1)
    assert int(idb) == int(ida[0])
    toks = np.array([int(ida[0]), int(idb)], np.int64)
    poss = np.array([len(prompt)] * 2, np.int32)
    out_a, out_b = [int(ida[0])], [int(idb)]
    for _ in range(n - 1):
        ids = paged.decode_step(toks, poss)
        out_a.append(int(ids[0]))
        out_b.append(int(ids[1]))
        toks = np.asarray(ids, np.int64)
        poss += 1
    assert out_a == ref and out_b == ref


def test_generate_past_window_raises_typed(torch_pred):
    paged = _paged(torch_pred, slots=1)
    with pytest.raises(CacheExhaustedError) as ei:
        paged.generate([5, 9, 2], CFG.max_len + 6)
    assert ei.value.slots == (0,) and ei.value.retryable


def test_decode_exhaustion_rolls_back_and_retry_is_same_bits(torch_pred):
    """Two streams need a third page each and one is left: the step runs
    nothing, names one victim, keeps the pages in use, and after the
    victim's release the same feed gives the bits of a pool that never
    ran dry."""
    pa, pb = [1, 2, 3, 4, 5, 6, 7, 8], [8, 7, 6, 5, 4, 3, 2, 1]

    def two_streams(kv_pages):
        dec = _paged(torch_pred, slots=2, kv_pages=kv_pages)
        ida, idb = dec.prefill([pa], [0]), dec.prefill([pb], [1])
        return dec, np.array([int(ida[0]), int(idb[0])], np.int64)

    dec, toks = two_streams(6)
    poss = np.array([8, 8], np.int32)
    in_use = dec.pool_stats()['pages_in_use']
    with pytest.raises(CacheExhaustedError) as ei:
        dec.decode_step(toks, poss)
    assert len(ei.value.slots) == 1
    assert dec.pool_stats()['pages_in_use'] == in_use   # rolled back
    dec._pool.check()
    victim = ei.value.slots[0]
    dec.release(victim)
    ids, logits = dec.decode_step(toks, poss, return_logits=True)
    clean, _ = two_streams(0)
    clean.release(victim)
    want_ids, want = clean.decode_step(toks, poss, return_logits=True)
    survivor = 1 - victim
    assert int(ids[survivor]) == int(want_ids[survivor])
    assert np.array_equal(logits[survivor], want[survivor])


def test_shared_system_prompt_prefills_suffix_only(tmp_path):
    _save_lm(tmp_path, BIG, 11)
    dec = _torch_pred(tmp_path).prepare_decoding(
        slots=2, paged=True, page_tokens=32, prefill_chunk=128)
    sysp = list(np.random.RandomState(13).randint(1, BIG.vocab, 512))
    a = dec.open_stream(0, sysp + [5, 3])
    assert a['shared_tokens'] == 0 and a['chunks'] == 5   # cold: 514/128
    while dec.prefill_step(0) is None:
        pass
    b = dec.open_stream(1, sysp + [7, 1])
    assert b['shared_tokens'] == 512 and b['chunks'] == 1
    warm = dec.prefill_step(1, return_logits=True)
    assert warm is not None               # ONE chunk covered the suffix
    st = dec.pool_stats()
    assert st['prefix_hits'] == 1 and st['prefix_tokens_reused'] == 512
    dec.release(0)
    dec.release(1)
    dec.reset()
    dec.open_stream(1, sysp + [7, 1])
    cold = None
    while cold is None:
        cold = dec.prefill_step(1, return_logits=True)
    # the suffix chunk starts at 512 either way: the same ops on the
    # same pages
    assert warm[0] == cold[0]
    assert np.array_equal(warm[1], cold[1])
    dec.reset()
    with tfluid.serving.ServingEngine(dec) as eng:
        eng.submit(sysp + [5, 3], max_new_tokens=3).result(600)
        eng.submit(sysp + [7, 1], max_new_tokens=3).result(600)
        kv = eng.stats()['kv']
    assert kv['prefix_hits'] == 1 and kv['prefix_tokens_reused'] == 512


_PAGED_SERIES = ('serving.kv_pages_in_use', 'serving.kv_pages_free',
                 'serving.prefix_hits', 'serving.prefix_tokens_reused',
                 'serving.prefill_chunks')


def _telemetry_script(telemetry, pred):
    telemetry.enable()
    telemetry.reset()
    try:
        dec = pred.prepare_decoding(slots=2, paged=True, page_tokens=4,
                                    prefill_chunk=4)
        dec.prefill([[1, 2, 3, 4, 5, 6]], [0])        # 2 chunks
        dec.open_stream(1, [1, 2, 3, 4, 9])
        while dec.prefill_step(1) is None:
            pass
        snap = telemetry.snapshot()
    finally:
        telemetry.disable(final_flush=False)
        telemetry.reset()
    out = {}
    for kind in ('counters', 'gauges'):
        out.update({k: v for k, v in snap[kind].items()
                    if k in _PAGED_SERIES})
    for k, h in snap['hists'].items():
        if k in _PAGED_SERIES:
            out[k] = (h['count'], h['sum'], h['buckets'])
    return out


def test_paged_telemetry_matches_jax(jax_pred, torch_pred):
    got = _telemetry_script(ttelemetry, torch_pred)
    assert got == _telemetry_script(jtelemetry, jax_pred)
    assert got['serving.prefix_hits'] == 1
    assert got['serving.prefix_tokens_reused'] == 4
    assert got['serving.prefill_chunks'][0] == 2
    assert got['serving.kv_pages_in_use'] > 0


def test_lmserver_stats_expose_cache_pressure(torch_pred):
    dec = torch_pred.prepare_decoding(slots=2, paged=True, page_tokens=4)
    decode_step = dec.decode_step
    seen = []
    with tfluid.serving.LMServer(dec) as srv:
        def step_and_look(tokens, positions, return_logits=False):
            seen.append(srv.stats()['cache_tokens'])     # mid-stream
            return decode_step(tokens, positions, return_logits)
        dec.decode_step = step_and_look
        h = srv.submit([3, 1, 4], max_new_tokens=8)
        assert srv.result(h, timeout=60) == \
            _paged(torch_pred, slots=1).generate([3, 1, 4], 8)
        assert srv.drain(timeout=60)
        # the worker re-reads its lanes at the end of the iteration that
        # finished the request
        deadline = time.monotonic() + 60
        while srv.stats()['cache_tokens'] and time.monotonic() < deadline:
            time.sleep(0.001)
        st = srv.stats()
    assert st['paged'] is True and srv.paged
    assert max(seen) >= 3                 # the live stream was visible
    assert st['cache_tokens'] == 0        # and released on completion
    assert st['cache_capacity'] == (dec.num_pages - 1) * 4
    assert st['kv']['num_pages'] == dec.num_pages
    assert st['completed'] == 1 and st['mesh_devices'] == 1


def test_paged_programs_read_no_host_data(torch_pred, no_host_data):
    """Every paged program's second run under the host-data guard: the
    page ops index with device tensors and mask with torch.where."""
    dec = _paged(torch_pred, slots=2, prefill_chunk=4)
    spec = torch_pred.prepare_decoding(slots=2, speculative=True, spec_k=2,
                                       page_tokens=4, prefill_chunk=4)
    dec.generate(PROMPT + [9, 2, 6], 3)
    spec.generate(PROMPT + [9, 2, 6], 3)
    no_host_data['armed'] = True
    dec.generate(PROMPT + [9, 2, 6], 3)
    spec.generate(PROMPT + [9, 2, 6], 3)
    assert no_host_data['checked'] > 0
