"""The Executor's prepared path (PreparedProgram, the prepared-program
cache, jit_cache_stats) against the JAX package on the CPU, and the
pieces the captured path on the card stands on.

- The same programs built in both packages split into the same steps
  (device segment or host op, in order), and each segment has the same
  in_names and out_names: the flagship LM step at a small size fed by
  py_reader (AMP Momentum), the Adam step with the global-norm clip
  and noam_decay (its step counter's increment runs before the read),
  a program with save and load ops, and the decode pair.
- The cache key separates feed shapes, fetch lists, scopes, the flash
  arms (PADDLE_FLASH_FWD, PADDLE_FLASH_BWD) and the FLAGS_ values;
  use_program_cache=False prepares nothing; jit_cache_stats has the
  JAX package's four keys; the decode predictor's stats after a
  generation loop read 2 prepared programs (nothing captured on the
  CPU).
- rebound_persistables, the function the capture uses to find the
  persistables a segment writes out of place, finds the step counter
  (and batch norm's running statistics) and no parameter.
- Capture safety: on a second run (the first is the warm-up a capture
  follows), no device op reads a value back to the host or builds a
  tensor from host data (_NoHostData), on the LM, Adam, ResNet and
  decode programs and on the shape, assign_value and accuracy ops.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import paddle_tpu as jfluid
from paddle_tpu import executor as jexecutor
from paddle_tpu import inference as jinference
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer
import test_torch_adam_lm
import test_torch_training

DECODE_CFG = dict(vocab=64, dim=32, heads=2, layers=2, ffn=64, max_len=16,
                  use_tp=False, use_sp=False, flash_attention=True)


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


def _steps(prepared, segment_type):
    """[(kind, in_names, out_names)]: kind is 'segment' or the host op's
    type."""
    out = []
    for step in prepared.steps:
        if isinstance(step, segment_type):
            out.append(('segment', list(step.in_names),
                        list(step.out_names)))
        else:
            out.append((step.op.type, [], []))
    return out


def _same_steps(jprog, tprog, feeds, fetches):
    jp = jexecutor.PreparedProgram(jprog, 0, feeds, fetches)
    tp = texecutor.PreparedProgram(tprog, 0, feeds, fetches)
    want = _steps(jp, jexecutor._DeviceSegment)
    got = _steps(tp, texecutor._DeviceSegment)
    assert got == want
    return got


def test_lm_step_segments_like_the_jax_package():
    built = [test_torch_training._build_train(fluid, un, tr, True)
             for fluid, un, tr in ((jfluid, junique_name, jtransformer),
                                   (tfluid, tunique_name, ttransformer))]
    (jprog, _, _, javg), (tprog, _, _, tavg) = built
    steps = _same_steps(jprog, tprog, [], [tavg.name])
    assert [s[0] for s in steps] == ['read', 'segment']


def test_adam_step_segments_like_the_jax_package():
    built = [test_torch_adam_lm._build(fluid, un, tr, True)
             for fluid, un, tr in ((jfluid, junique_name, jtransformer),
                                   (tfluid, tunique_name, ttransformer))]
    (jprog, _, _, _, _), (tprog, _, _, tavg, lr) = built
    steps = _same_steps(jprog, tprog, [], [tavg.name, lr.name])
    # the step counter's increment is prepended: it runs before the read
    assert [s[0] for s in steps] == ['segment', 'read', 'segment']
    assert '@STEP_COUNTER@' in steps[0][2]


def _save_load_program(fluid, path):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        h = fluid.layers.fc(input=x, size=3, name='sl')
        block = prog.global_block()
        block.append_op(type='save', inputs={'X': ['sl.w_0']},
                        attrs={'file_path': path})
        block.append_op(type='load', outputs={'Out': ['sl.w_0']},
                        attrs={'file_path': path})
        y = fluid.layers.fc(input=h, size=2, name='sl2')
        s = fluid.layers.mean(fluid.layers.elementwise_mul(y, y))
    return prog, startup, s


def test_save_load_program_segments_like_the_jax_package(tmp_path):
    path = str(tmp_path / 'w')
    jprog, _, _ = _save_load_program(jfluid, path)
    tprog, tstartup, s = _save_load_program(tfluid, path)
    steps = _same_steps(jprog, tprog, ['x'], [s.name])
    assert [k for k, _, _ in steps] == ['segment', 'save', 'load',
                                        'segment']
    # and it runs: the loaded weight is the saved one
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstartup, scope=scope)
    w = scope.find_var('sl.w_0').clone()
    exe.run(tprog, feed={'x': np.ones((2, 4), 'f4')}, fetch_list=[s],
            scope=scope)
    torch.testing.assert_close(scope.find_var('sl.w_0'), w)


@pytest.fixture(scope='module')
def decode_dir(tmp_path_factory):
    """A small LM saved by the JAX package (head dim 16: the flash op
    takes its plain path in both packages)."""
    model_dir = str(tmp_path_factory.mktemp('exec_lm'))
    prog, startup = jfluid.Program(), jfluid.Program()
    prog.random_seed = startup.random_seed = 7
    with junique_name.guard(), jfluid.program_guard(prog, startup):
        toks = jfluid.layers.data(name='tokens',
                                  shape=[1, DECODE_CFG['max_len'], 1],
                                  dtype='int64', append_batch_size=False)
        logits = jtransformer.language_model_logits(
            toks, jtransformer.TransformerConfig(**DECODE_CFG))
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(model_dir, ['tokens'], [logits], exe,
                                       main_program=prog)
    return model_dir


def _decoders(model_dir):
    jpred = jinference.AnalysisPredictor(
        jinference.AnalysisConfig(model_dir, place=jfluid.CPUPlace()))
    tpred = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=tfluid.CPUPlace()))
    return (jpred.prepare_decoding(slots=2, prefill_batch=1),
            tpred.prepare_decoding(slots=2, prefill_batch=1))


def test_decode_pair_segments_like_the_jax_package(decode_dir):
    jdec, tdec = _decoders(decode_dir)
    for prog, feeds, fetches in (
            ('prefill_program', ['prefill_tokens', 'prefill_pos',
                                 'prefill_slots'], 'prefill_fetches'),
            ('decode_program', ['decode_tokens', 'decode_step_idx'],
             'decode_fetches')):
        names = [v if isinstance(v, str) else v.name
                 for v in getattr(tdec._pair, fetches)]
        steps = _same_steps(getattr(jdec._pair, prog),
                            getattr(tdec._pair, prog), feeds, names)
        assert [k for k, _, _ in steps] == ['segment']


def test_decode_predictor_stats_after_a_generation_loop(decode_dir):
    _, tdec = _decoders(decode_dir)
    assert tdec.generate([3, 9, 4], 6) == tdec.generate([3, 9, 4], 6)
    stats = tdec.jit_cache_stats()
    assert stats['prepared_programs'] == 2
    assert stats['compiled_segments'] == 0           # nothing captured
    assert stats['segment_misses'] == 2
    assert stats['segment_hits'] >= 1


def _tiny_program():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
        h = tfluid.layers.fc(input=x, size=3)
        loss = tfluid.layers.mean(h)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return prog, tfluid.Executor(tfluid.CPUPlace()), scope, h, loss


def test_jit_cache_stats_has_the_jax_keys():
    prog, exe, scope, h, loss = _tiny_program()
    stats = exe.jit_cache_stats()
    assert set(stats) == set(jfluid.Executor(jfluid.CPUPlace())
                             .jit_cache_stats())
    assert set(stats) == {'prepared_programs', 'compiled_segments',
                          'segment_hits', 'segment_misses'}


def test_cache_key_separates_shapes_fetches_scopes_and_switches(
        monkeypatch):
    prog, exe, scope, h, loss = _tiny_program()
    x2, x3 = np.ones((2, 4), 'f4'), np.ones((3, 4), 'f4')

    def prepared_after(**kw):
        kw.setdefault('feed', {'x': x2})
        kw.setdefault('fetch_list', [loss])
        kw.setdefault('scope', scope)
        exe.run(prog, **kw)
        return exe.jit_cache_stats()['prepared_programs']

    assert prepared_after() == 1
    assert prepared_after() == 1                    # a hit
    assert prepared_after(feed={'x': x3}) == 2      # feed shape
    assert prepared_after(fetch_list=[loss, h]) == 3
    other = tfluid.Scope()
    for p in prog.global_block().all_parameters():
        other.set_var(p.name, scope.find_var(p.name).clone())
    assert prepared_after(scope=other) == 4
    monkeypatch.setenv('PADDLE_FLASH_BWD', 'split')
    assert prepared_after() == 5
    monkeypatch.setenv('PADDLE_FLASH_FWD', 'twopass')
    assert prepared_after() == 6
    monkeypatch.delenv('PADDLE_FLASH_FWD')
    monkeypatch.delenv('PADDLE_FLASH_BWD')
    assert prepared_after() == 6                    # back to the first
    tfluid.set_flags({'FLAGS_use_flash_attention': False})
    try:
        assert prepared_after() == 7
    finally:
        tfluid.set_flags({'FLAGS_use_flash_attention': True})
    assert prepared_after() == 7
    stats = exe.jit_cache_stats()
    assert stats['compiled_segments'] == 0
    assert stats['segment_misses'] == 7
    assert stats['segment_hits'] == 3


def test_use_program_cache_false_prepares_nothing():
    prog, exe, scope, h, loss = _tiny_program()
    feed = {'x': np.ones((2, 4), 'f4')}
    for _ in range(3):
        got = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                      use_program_cache=False)
    stats = exe.jit_cache_stats()
    assert stats['prepared_programs'] == 0
    assert stats['compiled_segments'] == 0
    assert stats['segment_misses'] == 3 and stats['segment_hits'] == 0
    want = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(got[0], want[0])


def test_a_program_edited_after_a_run_is_prepared_again():
    prog, exe, scope, h, loss = _tiny_program()
    feed = {'x': np.ones((2, 4), 'f4')}
    exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    with tfluid.program_guard(prog):
        doubled = tfluid.layers.scale(loss, scale=2.0)
    got = exe.run(prog, feed=feed, fetch_list=[loss, doubled], scope=scope)
    assert exe.jit_cache_stats()['prepared_programs'] == 2
    np.testing.assert_allclose(got[1], 2 * got[0])


def test_rebound_persistables_finds_the_out_of_place_writes():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[3, 4, 4], dtype='float32')
        h = tfluid.layers.batch_norm(tfluid.layers.conv2d(
            x, num_filters=2, filter_size=1))
        loss = tfluid.layers.mean(h)
        lr = tfluid.layers.noam_decay(d_model=8, warmup_steps=4)
        tfluid.optimizer.Momentum(learning_rate=lr,
                                  momentum=0.9).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    prepared = texecutor.PreparedProgram(prog, 0, ['x'], [loss.name])
    seg, = [s for s in prepared.steps
            if isinstance(s, texecutor._DeviceSegment)]
    persist = {v.name for v in prog.list_vars() if v.persistable}
    before = {n: scope.find_var(n) for n in seg.out_names if n in persist}
    exe.run(prog, feed={'x': np.ones((2, 3, 4, 4), 'f4')},
            fetch_list=[loss], scope=scope)
    written = texecutor.rebound_persistables(before, scope)
    params = {p.name for p in prog.global_block().all_parameters()}
    assert '@STEP_COUNTER@' in written
    assert {'batch_norm_0.mean', 'batch_norm_0.variance'} <= set(written)
    assert not set(written) & params                    # updated in place
    assert set(written) <= set(before)


# -- capture safety: no host data on a second run -----------------------------

class _NoHostData(TorchFunctionMode):
    """Raise where a device op would read a value back to the host or
    build a tensor from host data: neither can run inside a CUDA graph
    (and each is a host synchronisation on the card)."""

    READS = ('item', 'tolist', 'cpu', 'numpy', '__bool__', '__float__',
             '__int__', '__index__', 'nonzero', 'masked_select', 'tensor',
             'unique', 'repeat_interleave')

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, '__name__', '')
        bad = name in self.READS
        if name == 'as_tensor' and not isinstance(args[0], torch.Tensor):
            bad = True
        if name == 'where' and len(args) + len(kwargs) == 1:
            bad = True
        if name == '__getitem__' and isinstance(args[1], torch.Tensor) \
                and args[1].dtype == torch.bool:
            bad = True
        if bad:
            raise AssertionError('%s in a device op: a host read or host '
                                 'data' % name)
        return func(*args, **kwargs)


@pytest.fixture
def no_host_data(monkeypatch):
    """Executor._run_ops under _NoHostData once `armed` is set."""
    state = {'armed': False, 'checked': 0}
    run_ops = texecutor.Executor._run_ops

    def guarded(step, ctx, drop):
        if not state['armed']:
            return run_ops(step, ctx, drop)
        state['checked'] += len(step.ops)
        with _NoHostData():
            return run_ops(step, ctx, drop)
    monkeypatch.setattr(texecutor.Executor, '_run_ops',
                        staticmethod(guarded))
    return state


def _two_runs(state, run):
    run()
    state['armed'] = True
    try:
        return run()
    finally:
        state['armed'] = False


def test_lm_and_adam_steps_read_nothing_back(no_host_data):
    for build in (
            lambda: test_torch_training._build_train(
                tfluid, tunique_name, ttransformer, True)[:4],
            lambda: test_torch_adam_lm._build(
                tfluid, tunique_name, ttransformer, True)[:4]):
        prog, startup, rdr, avg = build()
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        batches = test_torch_training._batches(
            test_torch_adam_lm.CFG if 'adam_reader' in rdr.name
            else test_torch_training.LM_CFG)
        rdr.decorate_tensor_provider(lambda: iter(batches))
        rdr.start()
        loss = _two_runs(no_host_data, lambda: exe.run(
            prog, fetch_list=[avg], scope=scope))
        rdr.reset()
        assert np.isfinite(loss[0]).all()
    assert no_host_data['checked'] > 0


def test_resnet_step_reads_nothing_back(no_host_data):
    prog, startup = tfluid.Program(), tfluid.Program()
    tfluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
    try:
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(prog, startup):
            img = tfluid.layers.data(name='img', shape=[3, 16, 16],
                                     dtype='float32')
            lbl = tfluid.layers.data(name='lbl', shape=[1], dtype='int64')
            _, avg, acc = tresnet.train_network(
                img, lbl, depth=8, class_dim=10, variant='cifar10')
            tfluid.optimizer.Momentum(0.01, 0.9).minimize(avg)
    finally:
        tfluid.set_flags({'FLAGS_use_pallas_fused_ops': False})
    assert any(op.type == 'conv2d_bn' for op in prog.global_block().ops)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    feed = {'img': r.rand(2, 3, 16, 16).astype('f4'),
            'lbl': r.randint(0, 10, (2, 1)).astype('int64')}
    out = _two_runs(no_host_data, lambda: exe.run(
        prog, feed=feed, fetch_list=[avg, acc], scope=scope))
    assert np.isfinite(out[0]).all()


def test_decode_pair_reads_nothing_back(no_host_data, decode_dir):
    _, tdec = _decoders(decode_dir)
    tdec.prefill([[3, 9, 4]], [0])
    tdec.decode_step([5, 0], [3, 0])
    no_host_data['armed'] = True
    try:
        tdec.prefill([[3, 9, 4]], [0])
        tdec.decode_step([5, 0], [3, 0])
    finally:
        no_host_data['armed'] = False
    assert no_host_data['checked'] > 0


def _one_op_program(build):
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        outs = build()
    return prog, outs


@pytest.mark.parametrize('case', ['shape', 'assign_value', 'accuracy'])
def test_repaired_ops_read_nothing_back(no_host_data, case):
    r = np.random.RandomState(1)
    feed = {'x': r.rand(3, 5).astype('f4'),
            'lbl': r.randint(0, 5, (3, 1)).astype('int64')}

    def build():
        x = tfluid.layers.data(name='x', shape=[5], dtype='float32')
        lbl = tfluid.layers.data(name='lbl', shape=[1], dtype='int64')
        if case == 'shape':
            return [tfluid.layers.shape(x)]
        if case == 'assign_value':
            return [tfluid.layers.assign(np.arange(6, dtype='float32')
                                         .reshape(2, 3))]
        acc, correct, total = (
            tfluid.layers.create_tensor('float32'),
            tfluid.layers.create_tensor('int32'),
            tfluid.layers.create_tensor('int32'))
        tfluid.layers.accuracy(x, lbl, k=2, correct=correct, total=total)
        return [correct, total]
    prog, outs = _one_op_program(build)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = _two_runs(no_host_data, lambda: exe.run(
        prog, feed=feed, fetch_list=outs, scope=tfluid.Scope()))
    if case == 'shape':
        np.testing.assert_array_equal(got[0], [3, 5])
    elif case == 'assign_value':
        np.testing.assert_array_equal(got[0],
                                      np.arange(6).reshape(2, 3))
    else:
        assert int(got[1]) == 3


def test_a_fetch_carries_no_autograd_record():
    """A tensor fetched with return_numpy=False is detached: the loss of
    a training step came back holding its op's autograd record."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=3))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    got, = exe.run(prog, feed={'x': np.ones((2, 4), 'f4')},
                   fetch_list=[loss], scope=scope, return_numpy=False)
    assert isinstance(got, torch.Tensor)
    assert not got.requires_grad and got.grad_fn is None


def test_an_op_appended_after_a_run_is_prepared_again():
    """The program's version keys an edit: an op appended after a run,
    with the same feeds and fetches, prepares the program anew."""
    prog, exe, scope, h, loss = _tiny_program()
    feed = {'x': np.ones((2, 4), 'f4')}
    first = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    with tfluid.program_guard(prog):
        tfluid.layers.scale(loss, scale=2.0)
    again = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.jit_cache_stats()['prepared_programs'] == 2
    np.testing.assert_array_equal(first[0], again[0])


def test_close_drops_the_prepared_programs_and_the_cache_is_bounded(
        monkeypatch):
    """Past PREPARED_LIMIT the least recently run prepared program goes;
    close() drops them all (on the card with their graphs and memory
    pool), and the stats' counts go on."""
    monkeypatch.setattr(texecutor, 'PREPARED_LIMIT', 2)
    prog, exe, scope, h, loss = _tiny_program()

    def run(rows):
        exe.run(prog, feed={'x': np.ones((rows, 4), 'f4')},
                fetch_list=[loss], scope=scope)

    def kept_rows():
        return sorted(key[3][0][1][0] for key in exe._prepared_cache)
    run(1)
    run(2)
    run(1)
    run(3)                      # 2 is the least recently run
    assert kept_rows() == [1, 3]
    assert exe.jit_cache_stats()['segment_misses'] == 3
    exe.close()
    assert exe.jit_cache_stats()['prepared_programs'] == 0
    assert exe._pool is None
    run(1)
    stats = exe.jit_cache_stats()
    assert stats['prepared_programs'] == 1
    assert stats['segment_misses'] == 4 and stats['segment_hits'] == 1


def test_a_segment_counts_runs_per_input_signature():
    """A reader's last batch is smaller: the segment it feeds keeps one
    prepared program, and each signature of its run-local inputs has
    its own first run (a miss: on the card the warm-up that its own
    capture follows)."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        rdr = tfluid.layers.py_reader(capacity=2, shapes=[(-1, 4)],
                                      dtypes=['float32'], name='sig_reader')
        x = tfluid.layers.read_file(rdr)
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=3))
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    batches = [[np.ones((rows, 4), 'f4')] for rows in (4, 4, 2, 2)]
    rdr.decorate_tensor_provider(lambda: iter(batches))
    rdr.start()
    for _ in batches:
        exe.run(prog, fetch_list=[loss], scope=scope)
    rdr.reset()
    stats = exe.jit_cache_stats()
    assert stats['prepared_programs'] == 1
    assert stats['segment_misses'] == 2 and stats['segment_hits'] == 2
    prepared, = exe._prepared_cache.values()
    seg, = [s for s in prepared.steps
            if isinstance(s, texecutor._DeviceSegment)]
    assert sorted(sig[0][1][0] for sig in seg.runs) == [2, 4]
    assert set(seg.runs.values()) == {2}


def test_a_capture_records_only_its_streams_counts(monkeypatch):
    """kernels.recording() keeps what the wrappers note while its capture
    stream is current, on any thread (the autograd engine runs a
    backward on its own thread, on the forward's stream): another
    thread's launches on another stream during a capture stay out of the
    counts that every replay adds again (count_add)."""
    import threading
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import conv_bn, flash_attention as fa
    current = threading.local()
    monkeypatch.setattr(kernels, '_current_stream',
                        lambda device: getattr(current, 'stream', 0))

    def on_stream(stream, key, d):
        current.stream = stream
        kernels.note(key, d)
    current.stream = 7
    with kernels.recording('cuda:0', 7) as rec:
        kernels.note(('k6',))
        kernels.note(('k6', conv_bn.WGMMA_KERNEL))
        for stream, d in ((7, 2), (3, 5)):     # a backward; another step
            other = threading.Thread(target=on_stream, args=(
                stream, ('launches', 'flash_attention_fwd'), d))
            other.start()
            other.join()
        kernels.note(('extra_flops',), 2.5)
    kernels.note(('k6',))       # no recording open: kept nowhere
    assert rec == {('k6',): 1, ('k6', conv_bn.WGMMA_KERNEL): 1,
                   ('launches', 'flash_attention_fwd'): 2,
                   ('extra_flops',): 2.5}
    k6 = conv_bn.matmul_bn_stats_kernel
    before = (k6.launches, dict(k6.launches_by_kernel),
              fa.flash_attention_fwd.launches, fa._extra_flops)
    try:
        kernels.count_add(rec)
        assert k6.launches == before[0] + 1
        assert k6.launches_by_kernel[conv_bn.WGMMA_KERNEL] == \
            before[1][conv_bn.WGMMA_KERNEL] + 1
        assert fa.flash_attention_fwd.launches == before[2] + 2
        assert fa._extra_flops == before[3] + 2.5
    finally:
        k6.launches, k6.launches_by_kernel = before[0], before[1]
        fa.flash_attention_fwd.launches, fa._extra_flops = before[2:]
