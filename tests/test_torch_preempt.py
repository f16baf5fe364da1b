"""paddle_tpu_torch's preempt-first capacity, priority tiers and
deadlines against the JAX package's (serving/preempt.py, engine.py).

The JAX package saves its fleet tests' LM (tests/fleet_worker.py); the
port loads it on the CPU. Pinned here:
- victim choice, the host swap budget and the policy flag give the JAX
  package's results on the same lanes and calls;
- the tier queues pop in the JAX package's order, and only the lowest
  tier is refused when the queue is full;
- a deadline spent at submit, in the queue or mid-decode fails with the
  JAX package's typed error text, and the lane's pages come back;
- on a pool too small for two streams, a preempted stream resumes with
  the tokens of its unpreempted solo stream under 'swap', 'reprefill'
  and a dry swap budget, and under speculation; 'off' sheds typed; the
  telemetry agrees with the engine's own stats.
"""
import time

import numpy as np
import pytest

import fleet_worker as fw
from paddle_tpu.serving import engine as jengine
from paddle_tpu.serving import preempt as jpreempt
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.obs import telemetry
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import preempt as tpreempt

GEN = 8
PA = [1, 2, 3, 4, 5, 6, 7, 8]
PB = [8, 7, 6, 5, 4, 3, 2, 1]


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
def predictor(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('torch_preempt_model'))
    fw.build_model(d)
    return tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(d, place=tfluid.CPUPlace()))


@pytest.fixture(scope='module')
def refs(predictor):
    """Unpreempted solo paged streams over the same saved bytes."""
    solo = predictor.prepare_decoding(slots=1, paged=True, page_tokens=4,
                                      prefill_chunk=fw.CFG.max_len)
    return solo.generate(PA, GEN), solo.generate(PB, GEN)


@pytest.fixture()
def policy_flags():
    yield
    set_flags({'FLAGS_serving_preempt_policy': 'swap',
               'FLAGS_serving_swap_host_mb': 64})


# --------------------------------------------------------------------------
# policy units against the JAX package
# --------------------------------------------------------------------------

def _victims(engine, preempt):
    low_new = engine._Lane(engine.Request([1], 4, None, priority=0), 5, 1)
    low_old = engine._Lane(engine.Request([1], 4, None, priority=0), 5, 1)
    high = engine._Lane(engine.Request([1], 4, None, priority=2), 5, 1)
    low_new.last_active, low_old.last_active = 100.0, 50.0
    high.last_active = 1.0
    lanes = {0: low_new, 1: high, 2: low_old}
    out = [preempt.pick_victim(lanes), preempt.pick_victim(lanes, below=2),
           preempt.pick_victim(lanes, below=0)]
    low_old.ready = False
    out.append(preempt.pick_victim(lanes))
    low_new.ready = high.ready = False
    out += [preempt.pick_victim(lanes), preempt.pick_victim({})]
    return out


def test_pick_victim_matches_jax():
    got = _victims(tengine, tpreempt)
    assert got == _victims(jengine, jpreempt)
    assert got == [2, 2, None, 0, None, None]


def _budget(preempt):
    b = preempt.HostSwapBudget(limit_mb=1)
    out = [b.limit_bytes, b.reserve(1 << 19), b.used_bytes,
           b.reserve((1 << 19) + 1), b.used_bytes, b.reserve(1 << 19)]
    b.release(1 << 20)
    return out + [b.used_bytes,
                  preempt.HostSwapBudget(limit_mb=0).reserve(1)]


def test_host_swap_budget_matches_jax():
    got = _budget(tpreempt)
    assert got == _budget(jpreempt)
    assert got == [1 << 20, True, 1 << 19, False, 1 << 19, True, 0, False]


@pytest.mark.parametrize('policy', ['swap', 'reprefill', 'off', 'OFF'])
def test_preempt_policy_flag(policy_flags, policy):
    set_flags({'FLAGS_serving_preempt_policy': policy})
    assert tpreempt.preempt_policy() == policy.lower()


def test_preempt_policy_flag_validated(policy_flags):
    set_flags({'FLAGS_serving_preempt_policy': 'bogus'})
    with pytest.raises(ValueError, match='serving_preempt_policy'):
        tpreempt.preempt_policy()


# --------------------------------------------------------------------------
# tier queues and deadlines against the JAX package
# --------------------------------------------------------------------------

class _Shape(object):
    """The engine reads max_len and slots off its predictor before it
    starts; a never-started engine needs nothing else."""
    max_len, slots = 16, 2


def _tier_order(engine):
    eng = engine.ServingEngine(_Shape(), max_queue=2)
    low_a = eng.submit([1], 2)
    high = eng.submit([2], 2, priority=5)
    mid = eng.submit([3], 2, priority=1)     # past max_queue: tier 1 ok
    with pytest.raises(RuntimeError, match='queue full'):
        eng.submit([4], 2)
    victim = engine.Request([5], 2, None, priority=0)
    with eng._cond:
        eng._push_locked(victim, front=True)
    order = [eng._pop_next() for _ in range(4)]
    assert eng._pop_next() is None
    assert order == [high, mid, victim, low_a]
    return [r.prompt[0] for r in order]


def test_tier_queues_order_and_low_tier_only_rejection():
    assert _tier_order(tengine) == _tier_order(jengine) == [2, 3, 5, 1]


def _queued_deadline(engine):
    eng = engine.ServingEngine(_Shape())
    with pytest.raises(engine.DeadlineExceededError, match='spent'):
        eng.submit([1], 2, deadline_ms=0)
    req = eng.submit([1, 2], 2, deadline_ms=1.0)
    keep = eng.submit([3], 2, deadline_ms=60000.0)
    time.sleep(0.01)
    got = eng._pop_next()
    assert got is keep
    return req.state, req.error


def test_deadline_spent_at_submit_and_in_queue_matches_jax():
    got = _queued_deadline(tengine)
    assert got == _queued_deadline(jengine)
    assert got == ('FAILED', 'DeadlineExceededError: expired in queue')


def test_deadline_mid_decode_frees_pages(predictor):
    dec = predictor.prepare_decoding(slots=2, paged=True, page_tokens=4,
                                     prefill_chunk=4)
    decode_step = dec.decode_step
    spent = {}

    def step_then_spend(tokens, positions, return_logits=False):
        out = decode_step(tokens, positions, return_logits)
        if 'req' in spent:               # the budget runs out mid-stream
            spent.pop('req').deadline_at = time.perf_counter() - 1.0
        return out
    dec.decode_step = step_then_spend
    with tfluid.serving.LMServer(dec) as srv:
        h = srv.submit([3, 1, 4, 1, 5, 9], max_new_tokens=10,
                       deadline_ms=60000.0)
        spent['req'] = srv._req(h)
        with pytest.raises(RuntimeError, match='DeadlineExceededError: '
                                               'expired mid-decode'):
            srv.result(h, timeout=60)
        assert 0 < len(srv.poll(h)['tokens']) < 10
        assert srv.poll(h)['state'] == 'FAILED'
        assert srv.drain(timeout=60)
        assert srv.stats()['failed'] == 1
    st = dec.pool_stats()                 # the worker has stopped
    assert st['pages_in_use'] == st['prefix_pages']      # the lane's back
    dec._pool.check()


# --------------------------------------------------------------------------
# engine: preempt -> resume on every policy path
# --------------------------------------------------------------------------

def _tight(predictor, speculative=False):
    """2 slots over a pool too small for two full streams."""
    kw = dict(slots=2, page_tokens=4, kv_pages=6,
              prefill_chunk=fw.CFG.max_len)
    if speculative:
        return predictor.prepare_decoding(speculative=True, spec_k=3, **kw)
    return predictor.prepare_decoding(paged=True, **kw)


def _contend(eng, dec, low_priority, high_priority):
    """Low-tier PA first; PB is submitted from the worker during PA's
    first decode step, so PB's prefill and growth meet PA mid-stream on
    a pool that cannot hold both."""
    name = 'spec_step' if dec.speculative else 'decode_step'
    step = getattr(dec, name)
    reqs = {}

    def step_then_submit(*args, **kwargs):
        if 'b' not in reqs:
            reqs['b'] = eng.submit(PB, max_new_tokens=GEN,
                                   priority=high_priority)
        return step(*args, **kwargs)
    setattr(dec, name, step_then_submit)
    reqs['a'] = eng.submit(PA, max_new_tokens=GEN, priority=low_priority)
    eng.start()
    return reqs


def _run_contended(dec, refs):
    eng = tfluid.serving.ServingEngine(dec)
    try:
        reqs = _contend(eng, dec, 0, 1)
        out_a = reqs['a'].result(240)     # PB was submitted by then
        out_b = reqs['b'].result(240)
        st = eng.stats()
    finally:
        assert eng.stop(timeout=60)
    assert out_a == refs[0] and out_b == refs[1]
    dec._pool.check()
    return st


def test_preempt_swap_resume_same_tokens(predictor, refs, policy_flags):
    telemetry.enable()
    try:
        telemetry.reset()
        st = _run_contended(_tight(predictor), refs)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable(final_flush=False)
        telemetry.reset()
    assert st['preemptions'] >= 1 and st['resumes'] >= 1
    assert st['preempted_streams'] == 0 and st['swap_host_bytes'] == 0
    c = snap['counters']
    assert c['serving.preemptions'] == st['preemptions']
    assert c['serving.swapped_pages'] >= 1 and c['serving.swap_bytes'] >= 1
    assert snap['hists']['serving.resume_latency']['count'] == st['resumes']
    assert c['serving.requests.completed'] == st['completed'] == 2
    assert c['serving.tokens_generated'] == st['tokens_generated'] == 2 * GEN


@pytest.mark.parametrize('flags', [
    {'FLAGS_serving_preempt_policy': 'reprefill'},
    {'FLAGS_serving_preempt_policy': 'swap',
     'FLAGS_serving_swap_host_mb': 0},
], ids=['reprefill', 'swap_budget_dry'])
def test_preempt_reprefill_resume_same_tokens(predictor, refs, policy_flags,
                                              flags):
    set_flags(flags)
    st = _run_contended(_tight(predictor), refs)
    assert st['preemptions'] >= 1 and st['resumes'] >= 1
    assert st['swap_host_bytes'] == 0


def test_preempt_policy_off_sheds_typed(predictor, policy_flags):
    set_flags({'FLAGS_serving_preempt_policy': 'off'})
    dec = _tight(predictor)
    eng = tfluid.serving.ServingEngine(dec)
    try:
        reqs = _contend(eng, dec, 0, 0)
        ra = reqs['a']
        assert ra.wait(240)
        rb = reqs['b']
        assert rb.wait(240)
        st = eng.stats()
    finally:
        eng.stop(timeout=60)
    assert sorted([ra.state, rb.state]) == ['DONE', 'FAILED']
    failed = ra if ra.state == 'FAILED' else rb
    assert 'CacheExhausted' in failed.error
    assert st['preemptions'] == 0


def test_speculative_preemption_same_tokens(predictor, refs, policy_flags):
    st = _run_contended(_tight(predictor, speculative=True), refs)
    assert st['preemptions'] >= 1


def test_save_restore_stream_resumes_same_bits(predictor):
    """A stream swapped out to host RAM and back onto other pages
    continues with the bits of a stream that never left."""
    def steps(dec, tok, pos, n):
        toks = np.zeros((2,), np.int64)
        poss = np.zeros((2,), np.int32)
        out = []
        for _ in range(n):
            toks[0], poss[0] = tok, pos
            ids, logits = dec.decode_step(toks, poss, return_logits=True)
            tok, pos = int(ids[0]), pos + 1
            out.append(logits[0])
        return tok, np.stack(out)

    kw = dict(slots=2, paged=True, page_tokens=4,
              prefill_chunk=fw.CFG.max_len)
    ref = predictor.prepare_decoding(**kw)
    tok = int(ref.prefill([PA], [0])[0])
    tok, want_a = steps(ref, tok, len(PA), 3)
    _, want_b = steps(ref, tok, len(PA) + 3, 3)

    dec = predictor.prepare_decoding(**kw)
    tok = int(dec.prefill([PA], [0])[0])
    tok, got_a = steps(dec, tok, len(PA), 3)
    snap = dec.save_stream(0)
    pages = list(dec._tables[0].pages)
    dec.release(0)
    dec.prefill([PB], [1])                # takes the freed pages
    dec.restore_stream(0, snap)
    assert dec._tables[0].pages != pages
    assert snap['nbytes'] == sum(d.nbytes for d in snap['data'])
    _, got_b = steps(dec, tok, len(PA) + 3, 3)
    assert np.array_equal(got_a, want_a)
    assert np.array_equal(got_b, want_b)
    dec._pool.check()
