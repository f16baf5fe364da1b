"""paddle_tpu_torch's speculative decoding against the JAX package's and
against its own plain paged decode (serving/speculative.py).

The JAX package saves its speculative tests' LM (seed 21); the port
loads it on the CPU. Pinned here:
- the self-draft's stream equals plain greedy paged decode, and the
  target keeps two prepared programs (prefill, verify) and the draft two
  (prefill, decode) over two streams;
- with the `_fake_chain` stand-in (all accept, all reject, per-slot
  mixed) the emitted streams equal plain decode and spec_stats() equals
  the JAX package's on the same script;
- mid-verify exhaustion rolls back and retries as one plain step with
  the same bits as the plain predictor's step;
- copy-on-write isolation under multi-token appends, adaptive k, and
  the engine's speculative streams and stats.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.models.transformer import TransformerConfig
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.serving.paging import CacheExhaustedError
from test_paged import _save_lm
from test_speculative import _drive, _fake_chain

CFG = TransformerConfig(vocab=64, dim=32, heads=2, layers=2, ffn=64,
                        max_len=16, use_tp=False, use_sp=False)


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


@pytest.fixture(scope='module')
def lm_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_spec_lm')
    _save_lm(d, CFG, 21)
    return d


@pytest.fixture(scope='module')
def torch_pred(lm_dir):
    return tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(str(lm_dir), place=tfluid.CPUPlace()))


@pytest.fixture(scope='module')
def jax_pred(lm_dir):
    return jinference.AnalysisPredictor(jinference.AnalysisConfig(
        str(lm_dir), place=jfluid.CPUPlace()))


def _plain(pred, slots=2, **kw):
    kw.setdefault('page_tokens', 4)
    kw.setdefault('prefill_chunk', CFG.max_len)
    return pred.prepare_decoding(slots=slots, paged=True, **kw)


def _spec(pred, slots=2, spec_k=3, **kw):
    kw.setdefault('page_tokens', 4)
    kw.setdefault('prefill_chunk', CFG.max_len)
    return pred.prepare_decoding(slots=slots, speculative=True,
                                 spec_k=spec_k, draft_layers=1, **kw)


def test_self_draft_matches_plain_and_prepares_once(torch_pred):
    prompt = [3, 1, 4, 1, 5]
    n = CFG.max_len - len(prompt) - 1
    ref = _plain(torch_pred).generate(prompt, n)
    spec = _spec(torch_pred)
    assert spec.generate(prompt, n) == ref
    st = spec.spec_stats()
    assert st['steps'] > 0 and st['draft_tokens'] > 0
    assert st['fallback_steps'] == 0
    assert st['accepted_tokens'] + st['rejected_tokens'] == \
        st['draft_tokens']
    assert spec.generate(prompt, n) == ref          # a second stream
    assert spec.jit_cache_stats()['prepared_programs'] == 2
    assert spec.draft.jit_cache_stats()['prepared_programs'] == 2


def _one_slot(pred, wrong):
    """All-accept (wrong=False) or all-reject (wrong=True) on one slot:
    (stream == plain, verify iterations, spec_stats)."""
    prompt = [9, 2, 6, 5]
    n = CFG.max_len - len(prompt)
    ref = _plain(pred, slots=1).generate(prompt, n)
    spec = _spec(pred, slots=1)
    spec._draft_chain = _fake_chain({0: ref}, len(prompt), wrong=wrong)
    first = spec.prefill([prompt], [0])
    stream, steps = _drive(spec, 0, first[0], len(prompt), n)
    return stream == ref, steps, spec.spec_stats()


def _mixed(pred):
    """Slot 0's draft always right, slot 1's always wrong, in the same
    verify iterations: (lengths of the first emission, both streams ==
    plain, spec_stats)."""
    pa, pb = [7, 3, 7, 4], [2, 9, 8, 1]
    n = CFG.max_len - 4 - 1
    plain = _plain(pred)
    ref_a = plain.generate(pa, n, slot=0)
    ref_b = plain.generate(pb, n, slot=1)
    spec = _spec(pred)
    spec._draft_chain = _fake_chain({0: ref_a, 1: ref_b}, 4, wrong={1})
    ia, ib = spec.prefill([pa], [0]), spec.prefill([pb], [1])
    toks = np.array([int(ia[0]), int(ib[0])], np.int64)
    poss = np.array([4, 4], np.int32)
    out = spec.spec_step(toks, poss)
    first = (len(out[0]), len(out[1]))
    sa = [int(ia[0])] + [int(t) for t in out[0]]
    sb = [int(ib[0])] + [int(t) for t in out[1]]
    poss = np.array([4 + len(out[0]), 4 + len(out[1])], np.int32)
    while min(len(sa), len(sb)) < n:
        for s, acc in ((0, sa), (1, sb)):
            if len(acc) >= n and s in spec._tables:
                spec.release(s)
        toks = np.array([sa[-1], sb[-1]], np.int64)
        out = spec.spec_step(toks, poss)
        for s, acc in ((0, sa), (1, sb)):
            emitted = out.get(s, ())
            acc.extend(int(t) for t in emitted)
            poss[s] += len(emitted)
    return first, sa[:n] == ref_a and sb[:n] == ref_b, spec.spec_stats()


@pytest.mark.parametrize('wrong', [False, True], ids=['accept', 'reject'])
def test_fake_chain_one_slot_matches_jax(torch_pred, jax_pred, wrong):
    got = _one_slot(torch_pred, wrong)
    assert got == _one_slot(jax_pred, wrong)
    same, steps, st = got
    assert same
    n = CFG.max_len - 4
    if wrong:
        assert steps == n - 1 and st['accept_rate'] == 0.0
        assert st['rejected_tokens'] == st['draft_tokens'] > 0
    else:
        assert steps < n - 1 and st['accept_rate'] == 1.0
        assert st['effective_tokens_per_step'] > 1.0


def test_fake_chain_mixed_slots_match_jax(torch_pred, jax_pred):
    got = _mixed(torch_pred)
    assert got == _mixed(jax_pred)
    first, same, _ = got
    assert same and first == (4, 1)      # spec_k + 1 tokens, and one


def test_exhaustion_during_verify_falls_back_same_bits(torch_pred,
                                                      monkeypatch):
    """5 usable pages at pt=2: an 8-token prompt holds 4, a plain step
    fits the 5th, verify's ensure(pos + k + 1) needs a 6th: every
    iteration rolls back and runs one plain step, with that step's
    bits."""
    kw = dict(page_tokens=2, kv_pages=6)
    plain = _plain(torch_pred, slots=1, **kw)
    spec = _spec(torch_pred, slots=1, **kw)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    ia, ib = plain.prefill([prompt], [0]), spec.prefill([prompt], [0])
    assert int(ib[0]) == int(ia[0])
    spec._draft_chain = lambda live, t, p, b: {s: [1, 1, 1] for s in live}
    paged_cls = tfluid.serving.PagedDecodePredictor
    decode_step = paged_cls.decode_step
    seen = []

    def recorded(self, tokens, positions, return_logits=False):
        ids, logits = decode_step(self, tokens, positions,
                                  return_logits=True)
        if self is spec:                  # the fallback's plain step
            seen.append(logits)
        return (ids, logits) if return_logits else ids
    monkeypatch.setattr(paged_cls, 'decode_step', recorded)
    toks = np.array([int(ia[0])], np.int64)
    poss = np.array([8], np.int32)
    for _ in range(2):
        ref, ref_logits = plain.decode_step(toks, poss, return_logits=True)
        assert spec.spec_step(toks, poss)[0] == [int(ref[0])]
        assert np.array_equal(seen[-1], ref_logits)
        assert spec.pool_stats()['pages_in_use'] == \
            plain.pool_stats()['pages_in_use']
        toks = np.asarray(ref, np.int64)
        poss += 1
    assert spec.spec_stats()['fallback_steps'] == 2
    poss[0] = 10
    with pytest.raises(CacheExhaustedError) as ei:
        spec.spec_step(toks, poss)
    assert ei.value.slots == (0,) and ei.value.retryable


def test_cow_shared_prefix_streams_never_cross_talk(torch_pred):
    spec = _spec(torch_pred)
    prompt, n = [7, 3, 7, 4, 2, 9], 6
    ref = torch_pred.prepare_decoding(slots=1).generate(prompt, n)
    ia = spec.prefill([prompt], [0])
    b = spec.open_stream(1, prompt)
    assert b['shared_tokens'] == 4
    ib = spec.prefill_step(1)
    assert int(ib) == int(ia[0]) == ref[0]
    sa, sb = [int(ia[0])], [int(ib)]
    poss = np.array([len(prompt)] * 2, np.int32)
    while min(len(sa), len(sb)) < n:
        out = spec.spec_step(np.array([sa[-1], sb[-1]], np.int64), poss)
        for s, acc in ((0, sa), (1, sb)):
            acc.extend(int(t) for t in out[s])
            poss[s] += len(out[s])
    assert sa[:n] == ref and sb[:n] == ref


def test_adaptive_k_narrows_and_recovers(torch_pred):
    prompt = [9, 2, 6, 5]
    n = CFG.max_len - len(prompt)
    ref = _plain(torch_pred, slots=1).generate(prompt, n)
    spec = _spec(torch_pred, slots=1)
    assert spec.k_live == spec.spec_k
    spec._draft_chain = _fake_chain({0: ref}, len(prompt), wrong=True)
    for _ in range(6):
        assert spec.generate(prompt, n) == ref
    assert spec.k_live == 1
    spec._draft_chain = _fake_chain({0: ref}, len(prompt))
    for _ in range(8):
        assert spec.generate(prompt, n) == ref
    assert spec.k_live > 1


def test_engine_spec_streams_and_stats(torch_pred):
    prompts = [[3, 1, 4], [1, 5, 9], [2, 6, 5], [3, 5, 8]]

    def run(**kw):
        with tfluid.serving.LMServer(torch_pred, slots=4, page_tokens=4,
                                     prefill_chunk=CFG.max_len, **kw) as srv:
            hs = [srv.submit(p, max_new_tokens=8) for p in prompts]
            toks = [srv.result(h, 120) for h in hs]
            stats = srv.stats()
        return toks, stats

    ref, _ = run(paged=True)
    got, stats = run(speculative=True, spec_k=3, draft_layers=1)
    assert got == ref
    sp = stats['spec']
    assert sp['steps'] > 0 and 0.0 <= sp['accept_rate'] <= 1.0
    assert sp['spec_k'] == 3 and stats['effective_tokens_per_step'] > 0.0
    assert stats['completed'] == len(prompts)
