"""paddle_tpu_torch serving path against the JAX package.

The JAX package builds and saves a flash-attention LM (dh = 128, so its
Pallas kernel runs, in interpret mode on the CPU); the port loads that
directory on the CPU and must match:
- the JAX predictor's full-sequence logits, atol=1e-4;
- the JAX DecodePredictor's prefill + 8 decode-step logits, atol=1e-4,
  with equal greedy streams;
- its own full recompute with its own cached decode: equal greedy
  streams, logits within atol=1e-5 (not bit-exact: XLA on the CPU does
  not keep even JAX's own decode bit-exact with its recompute, and the
  two paths sum in different orders);
- the same outputs when the weights come from load_numpy_params;
- engine streams equal to solo generate streams, and the LMServer
  submit/poll/result path.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import transformer as ttransformer

CFG = dict(vocab=128, dim=256, heads=2, layers=2, ffn=512, max_len=128,
           use_tp=False, use_sp=False, flash_attention=True)
T = CFG['max_len']
SLOTS = 4
N_DECODE = 8
PROMPTS = [[5, 17, 99, 3, 42, 8, 61], list(range(1, 30, 2)), [77]]
XLANG_ATOL = 1e-4      # JAX package vs port
SELF_ATOL = 1e-5       # port decode vs port full recompute


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The JAX package's fixture (conftest.py) resets only its own
    default programs; reset the port's too."""
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _padded(prompt):
    toks = np.zeros((1, T, 1), np.int64)
    toks[0, :len(prompt), 0] = prompt
    return toks


def _build_lm(fluid, unique_name, transformer):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[1, T, 1],
                                 dtype='int64', append_batch_size=False)
        logits = transformer.language_model_logits(
            toks, transformer.TransformerConfig(**CFG))
    return prog, startup, logits


def _decode_trace(dec, prompt, steps):
    """prefill + `steps` decode steps on slot 1: the greedy stream and
    the logits of every step."""
    slot = 1
    ids, logits = dec.prefill([prompt], [slot], return_logits=True)
    stream, trace = [int(ids[0])], [logits[0]]
    toks = np.zeros((dec.slots,), np.int64)
    poss = np.zeros((dec.slots,), np.int32)
    pos = len(prompt)
    for _ in range(steps):
        toks[slot], poss[slot] = stream[-1], pos
        ids, logits = dec.decode_step(toks, poss, return_logits=True)
        stream.append(int(ids[slot]))
        trace.append(logits[slot])
        pos += 1
    return stream, np.stack(trace)


@pytest.fixture(scope='module')
def jax_side(tmp_path_factory):
    """The JAX package's model directory, parameters and reference
    outputs, with its prefill running the Pallas kernel (interpret)."""
    model_dir = str(tmp_path_factory.mktemp('jax_flash_lm'))
    prog, startup, logits = _build_lm(jfluid, junique_name, jtransformer)
    assert any(op.type == 'flash_attention'
               for op in prog.global_block().ops)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    jfluid.set_flags({'pallas_interpret': True})
    try:
        with jfluid.scope_guard(scope):
            exe.run(startup)
            jfluid.io.save_inference_model(model_dir, ['tokens'], [logits],
                                           exe, main_program=prog)
        params = {v.name: np.array(scope.find_var(v.name))
                  for v in prog.list_vars() if v.persistable}
        pred = jinference.AnalysisPredictor(
            jinference.AnalysisConfig(model_dir, place=jfluid.CPUPlace()))
        full = pred.run([_padded(PROMPTS[0])])[0]
        dec = pred.prepare_decoding(slots=SLOTS, prefill_batch=1)
        stream, trace = _decode_trace(dec, PROMPTS[0], N_DECODE)
    finally:
        jfluid.set_flags({'pallas_interpret': False})
    return dict(model_dir=model_dir, params=params, full=full,
                stream=stream, trace=trace)


@pytest.fixture(scope='module')
def torch_pred(jax_side):
    return tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(jax_side['model_dir'],
                                        place=tfluid.CPUPlace()))


@pytest.fixture(scope='module')
def torch_dec(torch_pred):
    return torch_pred.prepare_decoding(slots=SLOTS, prefill_batch=1)


def test_full_sequence_logits_match_jax(jax_side, torch_pred):
    got = torch_pred.run([_padded(PROMPTS[0])])[0]
    assert got.shape == (1, T, CFG['vocab'])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_side['full'], atol=XLANG_ATOL,
                               rtol=0)


def test_prefill_and_decode_match_jax(jax_side, torch_dec):
    torch_dec.reset()
    stream, trace = _decode_trace(torch_dec, PROMPTS[0], N_DECODE)
    assert stream == jax_side['stream']
    np.testing.assert_allclose(trace, jax_side['trace'], atol=XLANG_ATOL,
                               rtol=0)


def test_own_decode_matches_own_full_recompute(torch_pred, torch_dec):
    torch_dec.reset()
    prompt = PROMPTS[1]
    stream, trace = _decode_trace(torch_dec, prompt, N_DECODE)
    seq = list(prompt)
    for step, (tok, logits) in enumerate(zip(stream, trace)):
        full = torch_pred.run([_padded(seq)])[0][0, len(seq) - 1]
        assert int(np.argmax(full)) == tok, step
        np.testing.assert_allclose(logits, full, atol=SELF_ATOL, rtol=0)
        seq.append(tok)


def test_load_numpy_params_matches_saved_directory(jax_side, torch_pred):
    prog, _, logits = _build_lm(tfluid, tunique_name, ttransformer)
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, jax_side['params'],
                                tfluid.CPUPlace(), program=prog)
    exe = tfluid.Executor(tfluid.CPUPlace())
    for prompt in PROMPTS:
        got = exe.run(prog, feed={'tokens': _padded(prompt)},
                      fetch_list=[logits], scope=scope)[0]
        want = torch_pred.run([_padded(prompt)])[0]
        np.testing.assert_array_equal(got, want)


def test_engine_streams_equal_solo_generate(torch_dec):
    torch_dec.reset()
    budgets = [9, 6, 12]
    solo = [torch_dec.generate(p, n, slot=0)
            for p, n in zip(PROMPTS, budgets)]
    engine = tfluid.serving.ServingEngine(torch_dec.clone()).start()
    try:
        reqs = [engine.submit(p, n) for p, n in zip(PROMPTS, budgets)]
        got = [r.result(timeout=120) for r in reqs]
    finally:
        assert engine.stop(timeout=60)
    assert got == solo
    stats = engine.stats()
    assert stats['completed'] == 3 and stats['prefills'] == 3


def test_lm_server_submit_poll_result(torch_pred, torch_dec):
    torch_dec.reset()
    want = torch_dec.generate(PROMPTS[2], 5, slot=2)
    with tfluid.serving.LMServer(torch_pred, slots=SLOTS) as srv:
        h = srv.submit(PROMPTS[2], max_new_tokens=5)
        assert srv.poll(h)['state'] in ('QUEUED', 'RUNNING', 'DONE')
        assert srv.result(h, timeout=120) == want
        polled = srv.poll(h)
        assert polled == {'state': 'DONE', 'tokens': want}
        assert srv.generate(PROMPTS[0], 4, timeout=120) == \
            torch_dec.generate(PROMPTS[0], 4)
        assert srv.stats()['completed'] == 2
        with pytest.raises(KeyError):
            srv.poll(12345)


def test_clone_shares_weights_and_keeps_its_own_caches(torch_dec):
    twin = torch_dec.clone()
    spec = torch_dec._pair.spec
    for name in spec.param_names():
        assert twin._scope.find_var(name) is \
            torch_dec._scope.find_var(name)
    for name in spec.cache_names():
        assert twin._scope.find_var(name) is not \
            torch_dec._scope.find_var(name)
    torch_dec.reset()
    twin.prefill([PROMPTS[0]], [0])
    assert not torch_dec._scope.find_var(spec.cache_names()[0]).any()
    assert twin._scope.find_var(spec.cache_names()[0]).any()


def test_cancelled_queued_request_never_runs(torch_dec):
    torch_dec.reset()
    engine = tfluid.serving.ServingEngine(torch_dec)
    keep = engine.submit(PROMPTS[0], 3)
    drop = engine.cancel(engine.submit(PROMPTS[1], 3))
    engine.start()
    try:
        assert keep.result(timeout=120) == \
            torch_dec.clone().generate(PROMPTS[0], 3)
        assert drop.result(timeout=120) == []
        assert drop.state == 'CANCELLED'
    finally:
        assert engine.stop(timeout=60)
    assert engine.stats()['cancelled'] == 1
