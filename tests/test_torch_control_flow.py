"""Control flow, tensor arrays and beam search: the port against the JAX
package on the CPU.

- tests/test_control_flow.py's twelve cases, each built in both packages
  from one build function (the same numpy inputs, made from a seed): While
  (counting, a fed accumulator), Switch (a piecewise value, a
  persistable scope var), IfElse, the tensor arrays, StaticRNN (a
  cumsum, lengths masking, a trained fc step), DynamicRNN and the grad
  of the final states. Outputs agree within 1e-5; training steps from
  the JAX package's initial parameters (io.load_numpy_params) within
  1e-4. Dropout in a step draws per step in both (the property, not the
  values: the two packages draw differently).
- A While whose trip count is fed (0, 1 and 7 trips), its host reads
  (trips + 1 a loop), a While inside a body (raises, naming why), and
  the folded array index (a data-dependent one raises the JAX
  package's RuntimeError).
- beam_search where scores tie: the lower flat index first, as
  lax.top_k takes it, in both packages.
- The recurrent and conditional_block ops' second runs read nothing
  back to the host (test_torch_executor's guard): on the card their
  segments capture.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_torch_executor import _NoHostData

TOL = 1e-5
STEP_TOL = 1e-4
BOTH = [jfluid, tfluid]


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


def _programs(fluid, build, seed=0):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        out = build(fluid, fluid.layers)
    return prog, startup, out


def _run(fluid, prog, feed, fetch, startup=None, scope=None):
    scope = scope or fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if startup is not None:
        exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(prog, feed=feed, fetch_list=fetch,
                                           scope=scope)]


def _both(build, feed, seed=0):
    """build's fetches run in both packages: (jax values, port values)."""
    got = []
    for fluid in BOTH:
        prog, startup, fetch = _programs(fluid, build, seed)
        got.append(_run(fluid, prog, feed, fetch, startup))
    return got


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g.astype('float64'), w.astype('float64'),
                                   rtol=tol, atol=tol)


# -- While ---------------------------------------------------------------------

def _count_to(limit_value=10):
    def build(fluid, L):
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        limit = L.fill_constant(shape=[1], dtype='int64', value=limit_value)
        total = L.fill_constant(shape=[1], dtype='float32', value=0.0)
        cond = L.less_than(x=i, y=limit)
        while_op = L.While(cond=cond)
        with while_op.block():
            t = L.cast(i, 'float32')
            L.assign(L.elementwise_add(total, t), output=total)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [total, i]
    return build


def test_while_counts_to_ten():
    want, got = _both(_count_to(10), {})
    assert want[0][0] == sum(range(10))
    _close(got, want)


def test_while_with_accumulating_feed():
    def build(fluid, L):
        x = L.data(name='x', shape=[4], dtype='float32')
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        n = L.fill_constant(shape=[1], dtype='int64', value=3)
        acc = L.fill_constant(shape=[1, 4], dtype='float32', value=0.0)
        cond = L.less_than(x=i, y=n)
        while_op = L.While(cond=cond)
        with while_op.block():
            L.assign(L.elementwise_add(acc, x), output=acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        return [acc]
    xv = np.random.RandomState(3).randn(1, 4).astype('float32')
    want, got = _both(build, {'x': xv})
    np.testing.assert_allclose(want[0], xv * 3, rtol=1e-6)
    _close(got, want)


def _fed_limit_loop(fluid, L):
    """A While whose trip count is a fed limit: an fc and an accumulator
    in the body (chip_smoke cf1's program at a small width)."""
    x = L.data(name='x', shape=[8], dtype='float32')
    limit = L.data(name='limit', shape=[1], dtype='int64',
                   append_batch_size=False)
    i = L.fill_constant(shape=[1], dtype='int64', value=0)
    h = L.scale(x, scale=1.0)
    acc = L.fill_constant_batch_size_like(x, shape=[-1, 8], dtype='float32',
                                          value=0.0)
    cond = L.less_than(x=i, y=limit)
    while_op = L.While(cond=cond)
    with while_op.block():
        new_h = L.fc(input=h, size=8, act='tanh',
                     param_attr=fluid.ParamAttr(name='loop_w'),
                     bias_attr=fluid.ParamAttr(name='loop_b'))
        L.assign(new_h, output=h)
        L.assign(L.elementwise_add(acc, new_h), output=acc)
        L.increment(x=i, value=1, in_place=True)
        L.less_than(x=i, y=limit, cond=cond)
    return [acc, h, i]


@pytest.mark.parametrize('trips', [0, 1, 7])
def test_while_trip_count_from_a_feed_matches_jax(trips):
    """The JAX package's initial parameters in both; the port reads the
    condition back trips + 1 times (loop_stats)."""
    xv = np.random.RandomState(5).randn(3, 8).astype('float32')
    feed = {'x': xv, 'limit': np.array([trips], 'int64')}
    jprog, jstart, jfetch = _programs(jfluid, _fed_limit_loop)
    jscope = jfluid.Scope()
    want = _run(jfluid, jprog, feed, jfetch, jstart, jscope)
    init = {n: np.asarray(jscope.find_var(n)) for n in ('loop_w', 'loop_b')}
    tprog, _, tfetch = _programs(tfluid, _fed_limit_loop)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tprog)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [np.asarray(v) for v in exe.run(tprog, feed=feed,
                                          fetch_list=tfetch, scope=tscope)]
    _close(got, want)
    assert got[2][0] == trips
    assert exe.loop_stats() == {'trips': trips, 'host_reads': trips + 1}
    assert [op.type for op in tprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]


def test_while_inside_a_body_raises_with_its_reason():
    """The port runs while as a host step, so a While in a While's body
    (one device segment) raises, naming why."""
    def nested(fluid, L):
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        j = L.fill_constant(shape=[1], dtype='int64', value=0)
        n = L.fill_constant(shape=[1], dtype='int64', value=2)
        cond = L.less_than(x=i, y=n)
        outer = L.While(cond=cond)
        with outer.block():
            cond2 = L.less_than(x=j, y=n)
            inner = L.While(cond=cond2)
            with inner.block():
                L.increment(x=j, value=1, in_place=True)
                L.less_than(x=j, y=n, cond=cond2)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        return [i]
    prog, startup, fetch = _programs(tfluid, nested)
    with pytest.raises(texecutor.OpExecutionError,
                       match='a while inside a control-flow body is not '
                             'supported'):
        _run(tfluid, prog, {}, fetch, startup)


# -- Switch and IfElse ---------------------------------------------------------------

def _piecewise(fluid, L):
    step = L.data(name='step', shape=[1], dtype='float32')
    lr = L.fill_constant(shape=[1], dtype='float32', value=0.0)
    b1 = L.fill_constant(shape=[1], dtype='float32', value=10.0)
    b2 = L.fill_constant(shape=[1], dtype='float32', value=20.0)
    with L.Switch() as switch:
        with switch.case(L.less_than(step, b1)):
            L.assign(L.fill_constant(shape=[1], dtype='float32', value=1.0),
                     output=lr)
        with switch.case(L.less_than(step, b2)):
            L.assign(L.fill_constant(shape=[1], dtype='float32', value=0.5),
                     output=lr)
        with switch.default():
            L.assign(L.fill_constant(shape=[1], dtype='float32', value=0.1),
                     output=lr)
    return [lr]


@pytest.mark.parametrize('step,want', [(5.0, 1.0), (15.0, 0.5),
                                       (25.0, 0.1)])
def test_switch_piecewise(step, want):
    jv, tv = _both(_piecewise, {'step': np.array([step], 'float32')})
    assert jv[0][0] == np.float32(want) and tv[0][0] == jv[0][0]


def test_switch_assigns_persistable_scope_var():
    """The scheduler pattern: a Switch writes an lr var that lives only in
    the scope; two runs of one program in one scope, both packages."""
    def build(fluid, L):
        lr = L.create_global_var(shape=[1], value=0.0, dtype='float32',
                                 persistable=True, name='lr_var')
        step = L.data(name='step', shape=[1], dtype='float32')
        b1 = L.fill_constant(shape=[1], dtype='float32', value=10.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(step, b1)):
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=1.0), output=lr)
            with switch.default():
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.1), output=lr)
        return [lr]
    for fluid in BOTH:
        prog, startup, fetch = _programs(fluid, build)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        exe = fluid.Executor(fluid.CPUPlace())
        for step, want in ((5.0, 1.0), (50.0, 0.1), (3.0, 1.0)):
            r, = exe.run(prog, feed={'step': np.array([step], 'float32')},
                         fetch_list=fetch, scope=scope)
            assert np.asarray(r)[0] == np.float32(want)
            assert np.asarray(scope.find_var('lr_var'))[0] == np.float32(want)


def test_ifelse_rowwise_select():
    def build(fluid, L):
        x = L.data(name='x', shape=[3], dtype='float32')
        zero = L.fill_constant(shape=[1], dtype='float32', value=0.0)
        cond = L.greater_than(L.reduce_sum(x, dim=1, keep_dim=True), zero)
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.scale(x, scale=2.0))
        with ie.false_block():
            ie.output(L.scale(x, scale=-1.0))
        out, = ie()
        return [out]
    xv = np.random.RandomState(4).randn(6, 3).astype('float32')
    want, got = _both(build, {'x': xv})
    pos = xv.sum(1, keepdims=True) > 0
    np.testing.assert_allclose(want[0], np.where(pos, 2 * xv, -xv),
                               rtol=1e-6)
    _close(got, want)


def test_conditional_block_second_run_stays_on_the_device(monkeypatch):
    """The Switch program's second run under the host-data guard."""
    prog, _, fetch = _programs(tfluid, _piecewise)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = {'step': np.array([15.0], 'float32')}
    first = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    run_ops = texecutor.Executor._run_ops

    def guarded(step, ctx, drop):
        with _NoHostData():
            return run_ops(step, ctx, drop)
    monkeypatch.setattr(texecutor.Executor, '_run_ops',
                        staticmethod(guarded))
    again = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    assert np.asarray(again[0])[0] == np.asarray(first[0])[0] == 0.5


# -- tensor arrays ---------------------------------------------------------------------

def test_array_write_read():
    def build(fluid, L):
        x = L.data(name='x', shape=[3], dtype='float32')
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        arr = L.array_write(x, i)
        i2 = L.fill_constant(shape=[1], dtype='int64', value=1)
        L.array_write(L.scale(x, scale=2.0), i2, array=arr)
        length = L.array_length(arr)
        second = L.array_read(arr, i2)
        block = fluid.default_main_program().current_block()
        stacked = block.create_var(name='stacked', dtype='float32')
        block.append_op(type='array_to_lod_tensor', inputs={'X': [arr]},
                        outputs={'Out': [stacked]})
        back = block.create_var(name='back', dtype='float32',
                                type=fluid.framework.VarType.LOD_TENSOR_ARRAY)
        block.append_op(type='lod_tensor_to_array', inputs={'X': [stacked]},
                        outputs={'Out': [back]})
        first = L.array_read(back, L.fill_constant(shape=[1], dtype='int64',
                                                   value=0))
        return [length, second, stacked, first]
    xv = np.random.RandomState(6).randn(2, 3).astype('float32')
    want, got = _both(build, {'x': xv})
    assert want[0][0] == 2 and want[2].shape == (2, 2, 3)
    np.testing.assert_allclose(want[1], 2 * xv, rtol=1e-6)
    _close(got, want)


def test_data_dependent_array_index_raises_like_jax():
    """An index produced by anything but fill_constant / increment /
    assign / cast chains is refused with the JAX package's message."""
    def build(fluid, L):
        x = L.data(name='x', shape=[3], dtype='float32')
        i = L.cast(L.argmax(x, axis=1), 'int64')
        arr = L.array_write(x, L.fill_constant(shape=[1], dtype='int64',
                                               value=0))
        return [L.array_read(arr, i)]
    xv = np.ones((2, 3), 'float32')
    msgs = []
    for fluid in BOTH:
        prog, startup, fetch = _programs(fluid, build)
        with pytest.raises(Exception) as err:
            _run(fluid, prog, {'x': xv}, fetch, startup)
        msgs.append(str(err.value))
    causes = [m[m.index('cause: '):] for m in msgs]
    assert causes[1] == causes[0]
    assert "index 'argmax_0.tmp_0' is data-dependent (produced by " \
        "'argmax')" in causes[0]


def test_rank_table_and_max_sequence_len_match_jax():
    def build(fluid, L):
        x = L.data(name='x', shape=[2], dtype='float32', lod_level=1)
        table = L.lod_rank_table(x)
        sorted_x = L.reorder_lod_tensor_by_rank(x, table)
        return [table, sorted_x, sorted_x.seq_lens,
                L.max_sequence_len(x.seq_lens),
                L.is_empty(x)]
    xv = np.random.RandomState(7).randn(4, 5, 2).astype('float32')
    feed = {'x': (xv, np.array([2, 5, 1, 5], 'int32'))}
    want, got = _both(build, feed)
    np.testing.assert_array_equal(want[0], [1, 3, 0, 2])
    _close(got, want)


# -- StaticRNN and DynamicRNN -----------------------------------------------------------

def test_static_rnn_cumsum():
    def build(fluid, L):
        x = L.data(name='x', shape=[4, 2, 3], dtype='float32',
                   append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[2, 3], value=0.0)
            acc = L.elementwise_add(xt, prev)
            rnn.update_memory(prev, acc)
            rnn.step_output(acc)
        return [rnn(), rnn.final_states()]
    xv = np.random.RandomState(0).rand(4, 2, 3).astype('float32')
    want, got = _both(build, {'x': xv})
    np.testing.assert_allclose(want[0], np.cumsum(xv, axis=0), rtol=1e-5)
    _close(got, want)


@pytest.mark.parametrize('reverse', [False, True])
def test_static_rnn_seq_lens_masking(reverse):
    """Rows past their length keep their state; reversed, the JAX
    package masks on the trip count, and so does the port."""
    def build(fluid, L):
        x = L.data(name='x', shape=[4, 3, 2], dtype='float32',
                   append_batch_size=False)
        lens = L.data(name='lens', shape=[3], dtype='int32',
                      append_batch_size=False)
        rnn = L.StaticRNN(seq_lens=lens, reverse=reverse)
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[3, 2], value=0.0)
            acc = L.elementwise_add(xt, prev)
            rnn.update_memory(prev, acc)
            rnn.step_output(acc)
        return [rnn(), rnn.final_states()]
    xv = np.random.RandomState(8).rand(4, 3, 2).astype('float32')
    lv = np.array([4, 2, 1], 'int32')
    want, got = _both(build, {'x': xv, 'lens': lv})
    if not reverse:
        np.testing.assert_allclose(want[1][:, 0], [xv[:L, b, 0].sum()
                                                   for b, L in enumerate(lv)],
                                   rtol=1e-5)
    _close(got, want)


def test_dynamic_rnn_batch_major():
    def build(fluid, L):
        x = L.data(name='x', shape=[3, 4, 2], dtype='float32',
                   append_batch_size=False)
        lens = L.data(name='lens', shape=[3], dtype='int32',
                      append_batch_size=False)
        drnn = L.DynamicRNN()
        with drnn.block(seq_lens=lens):
            xt = drnn.step_input(x)
            prev = drnn.memory(shape=[3, 2], value=0.0)
            acc = L.elementwise_add(xt, prev)
            drnn.update_memory(prev, acc)
            drnn.output(acc)
        return [drnn(), drnn.final_states()]
    xv = np.random.RandomState(9).rand(3, 4, 2).astype('float32')
    lv = np.array([4, 2, 3], 'int32')
    want, got = _both(build, {'x': xv, 'lens': lv})
    assert want[0].shape == (3, 4, 2)
    _close(got, want)


def _rnn_regression(train_final):
    """test_control_flow.py's fc step: trained on its last output through
    Adam, or (train_final) on the mean of its final state through SGD."""
    B, D = (4, 3) if train_final else (8, 4)

    def build(fluid, L):
        x = L.data(name='x', shape=[5, B, D], dtype='float32',
                   append_batch_size=False)
        y = L.data(name='y', shape=[8, 1], dtype='float32',
                   append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[B, 6], value=0.0)
            h = L.fc(input=[xt, prev], size=6, act='tanh')
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        outs = rnn()
        if train_final:
            loss = L.mean(rnn.final_states())
            fluid.optimizer.SGD(0.1).minimize(loss)
        else:
            last = L.slice(outs, axes=[0], starts=[4], ends=[5])
            last = L.reshape(L.squeeze(last, axes=[0]), shape=[8, 6])
            pred = L.fc(input=last, size=1)
            loss = L.mean(L.square_error_cost(pred, y))
            fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
        return [loss]
    return build


def _train_both(build, feeds, seed=0):
    """Steps of build's program in both packages from the JAX package's
    initial persistables: (jax losses, port losses, jax params, port
    params, port program)."""
    jprog, jstart, jfetch = _programs(jfluid, build, seed)
    tprog, _, tfetch = _programs(tfluid, build, seed)
    assert tprog.to_string() == jprog.to_string()
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jstart.list_vars() if v.persistable}
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tprog)
    texe = tfluid.Executor(tfluid.CPUPlace())
    jl, tl = [], []
    for feed in feeds:
        jl.append(float(np.asarray(jexe.run(jprog, feed=feed,
                                            fetch_list=jfetch,
                                            scope=jscope)[0])))
        tl.append(float(np.asarray(texe.run(tprog, feed=feed,
                                            fetch_list=tfetch,
                                            scope=tscope)[0])))
    params = [p.name for p in tprog.global_block().all_parameters()]
    return (jl, tl, {n: np.asarray(jscope.find_var(n)) for n in params},
            {n: np.asarray(tscope.find_var(n)) for n in params}, tprog)


def test_static_rnn_fc_trains():
    """Adam steps through the recurrence (the recurrent op's grad from
    its recorded forward): 5 steps against the JAX package within 1e-4,
    then the port's loss falls below a tenth of its first in 80."""
    rng = np.random.RandomState(1)
    xv = rng.rand(5, 8, 4).astype('float32')
    yv = xv.sum(axis=(0, 2)).reshape(8, 1).astype('float32')
    feed = {'x': xv, 'y': yv}
    want, got, jp, tp, tprog = _train_both(_rnn_regression(False),
                                           [feed] * 5)
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=n)
    assert 'recurrent_grad' in [op.type for op in tprog.global_block().ops]


def test_static_rnn_fc_trains_to_a_tenth():
    rng = np.random.RandomState(1)
    xv = rng.rand(5, 8, 4).astype('float32')
    yv = xv.sum(axis=(0, 2)).reshape(8, 1).astype('float32')
    prog, startup, fetch = _programs(tfluid, _rnn_regression(False))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(np.asarray(exe.run(prog, feed={'x': xv, 'y': yv},
                                       fetch_list=fetch, scope=scope)[0]))
              for _ in range(80)]
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])


def test_final_states_gradient_flows():
    """One SGD step on the mean of the final state: every step-block
    parameter moves as in the JAX package (within 1e-4)."""
    xv = np.random.RandomState(0).rand(5, 4, 3).astype('float32')
    feed = {'x': xv, 'y': np.zeros((8, 1), 'float32')}
    want, got, jp, tp, _ = _train_both(_rnn_regression(True), [feed])
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    moved = 0
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=n)
        moved += 1
    assert moved == 3


def test_recurrent_second_run_stays_on_the_device(monkeypatch):
    """A training step through the recurrence, run again under the
    host-data guard: forward, its record and its grad all stay on the
    device."""
    prog, startup, fetch = _programs(tfluid, _rnn_regression(False))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(2)
    feed = {'x': rng.rand(5, 8, 4).astype('float32'),
            'y': rng.rand(8, 1).astype('float32')}
    exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    run_ops = texecutor.Executor._run_ops

    def guarded(step, ctx, drop):
        with _NoHostData():
            return run_ops(step, ctx, drop)
    monkeypatch.setattr(texecutor.Executor, '_run_ops',
                        staticmethod(guarded))
    assert np.isfinite(exe.run(prog, feed=feed, fetch_list=fetch,
                               scope=scope)[0]).all()


@pytest.mark.parametrize('fluid', BOTH, ids=['jax', 'port'])
def test_dropout_varies_per_rnn_step(fluid):
    """Dropout inside the step draws anew at every step: the JAX package
    folds the trip into its key, the port's generator advances."""
    def build(fluid, L):
        x = L.data(name='x', shape=[6, 2, 50], dtype='float32',
                   append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            prev = rnn.memory(shape=[2, 50], value=0.0)
            d = L.dropout(xt, dropout_prob=0.5)
            rnn.update_memory(prev, L.elementwise_add(d, prev))
            rnn.step_output(d)
        return [rnn()]
    prog, _, fetch = _programs(fluid, build, seed=7)
    r, = _run(fluid, prog, {'x': np.ones((6, 2, 50), 'float32')}, fetch)
    masks = r != 0
    assert len({masks[t].tobytes() for t in range(6)}) > 1
    assert 0.3 < masks.mean() < 0.7


# -- beam_search ties ----------------------------------------------------------------------

def _beam_step(fluid, L):
    ids = L.data(name='ids', shape=[3], dtype='int64')
    scores = L.data(name='scores', shape=[3], dtype='float32')
    logp = L.data(name='logp', shape=[3, 5], dtype='float32')
    sel_ids, sel_scores, parents = L.beam_search(ids, scores, logp,
                                                 beam_size=3, end_id=0)
    return [sel_ids, sel_scores, parents]


def test_beam_search_ties_take_the_lower_index_first():
    """Rows where every candidate ties (the first step's -1e9 beams and
    the finished beams, whose -1e9 absorbs the log-probs) and rows with
    partial ties: the port picks the JAX package's beams, lower flat
    index first."""
    logp = np.log(np.full((4, 3, 5), 0.2, 'float32'))
    logp[1, 0] = np.log([0.1, 0.3, 0.3, 0.2, 0.1])
    logp[3] = np.log(np.random.RandomState(3).dirichlet(np.ones(5), 3))
    ids = np.array([[1, 1, 1], [2, 0, 2], [0, 0, 0], [3, 0, 4]], 'int64')
    scores = np.array([[0.0, -1e9, -1e9], [-1.0, -1.0, -1e9],
                       [-2.0, -2.0, -2.0], [-1e9, -1e9, -1e9]], 'float32')
    feed = {'ids': ids, 'scores': scores, 'logp': logp}
    want, got = _both(_beam_step, feed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(w.dtype), w)
    # row 0: beam 0's five ids tie at log 0.2 (lower index first)
    np.testing.assert_array_equal(want[0][0], [0, 1, 2])
    np.testing.assert_array_equal(want[2][0], [0, 0, 0])
    # row 2: every beam finished, each extends with end_id at no cost
    np.testing.assert_array_equal(want[2][2], [0, 1, 2])


def test_beam_search_decode_backtracks_like_jax():
    def build(fluid, L):
        ids = L.data(name='ids', shape=[4, 2, 3], dtype='int64',
                     append_batch_size=False)
        par = L.data(name='par', shape=[4, 2, 3], dtype='int32',
                     append_batch_size=False)
        sc = L.data(name='sc', shape=[2, 3], dtype='float32',
                    append_batch_size=False)
        return list(L.beam_search_decode(ids, par, sc))
    rng = np.random.RandomState(11)
    feed = {'ids': rng.randint(0, 9, (4, 2, 3)).astype('int64'),
            'par': rng.randint(0, 3, (4, 2, 3)).astype('int32'),
            'sc': rng.randn(2, 3).astype('float32')}
    want, got = _both(build, feed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.astype(w.dtype), w)
