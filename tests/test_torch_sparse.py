"""Sparse gradients (SelectedRows), the port against the JAX package on
the CPU.

Each case of tests/test_sparse_training.py is built in both packages,
its parameters loaded from one seeded numpy init (io.load_numpy_params
in the port), and trained on the same feeds: every loss and every
persistable (tables, accumulators) within 1e-5. Under lazy Adam and
Adagrad the rows no step touched keep their initial bits. Also: the
SelectedRows of one lookup_table_grad (padding_idx rows zeroed) equal
to the JAX package's, and how a fetch gives it; FLAGS_check_nan_inf
naming lookup_table_grad for a NaN in its values; a SelectedRows that
crosses a host step between two device segments, the second run
reading nothing back to the host; the Executor's capture helpers
(signature, static clone and copy) on a SelectedRows.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.executor import OpExecutionError as JOpExecutionError
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.executor import OpExecutionError
from paddle_tpu_torch.selected_rows import SelectedRows
from test_torch_executor import _NoHostData

TOL = 1e-5
UNIQUE = {jfluid: junique_name, tfluid: tunique_name}


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


def _program(fluid, build, seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with UNIQUE[fluid].guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _init(main, seed):
    """A seeded numpy value for every parameter of `main`."""
    rng = np.random.RandomState(seed)
    return {p.name: (rng.randn(*p.shape) * 0.5).astype('float32')
            for p in main.global_block().all_parameters()}


def _train(fluid, build, feeds, seed=7):
    """build's program trained on feeds from _init's parameters: the
    losses and every persistable after the last step."""
    main, startup, loss = _program(fluid, build, seed)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = _init(main, seed)
    if fluid is tfluid:
        fluid.io.load_numpy_params(scope, init, fluid.CPUPlace(),
                                   program=main)
    else:
        for n, v in init.items():
            scope.set_var(n, v)
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                       scope=scope)[0])) for f in feeds]
    state = {v.name: np.array(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    return losses, state, init


def _pooled_fc(fluid, optimizer, vocab=50, dim=8, clip=None):
    """tests/test_sparse_training.py's _build: a sparse embedding,
    mean-pooled, an fc, square error; `clip` sets a gradient clip."""
    def build(fluid):
        L = fluid.layers
        ids = L.data(name='ids', shape=[4], dtype='int64')
        label = L.data(name='label', shape=[1], dtype='float32')
        emb = L.embedding(ids, size=[vocab, dim], is_sparse=True,
                          param_attr=fluid.ParamAttr(name='emb_w'))
        pred = L.fc(L.reduce_mean(emb, dim=1), size=1,
                    param_attr=fluid.ParamAttr(name='fc_w'))
        avg = L.mean(L.square_error_cost(pred, label))
        if clip is not None:
            fluid.clip.set_gradient_clip(clip(fluid),
                                         program=avg.block.program)
        optimizer(fluid).minimize(avg)
        return avg
    return build


def _pooled_feeds(seed, steps=5, vocab=50, high=None):
    rng = np.random.RandomState(seed)
    return [{'ids': rng.randint(0, high or vocab, (16, 4)).astype('int64'),
             'label': rng.rand(16, 1).astype('float32')}
            for _ in range(steps)]


OPTIMIZERS = {
    'sgd': lambda f: f.optimizer.SGD(0.1),
    'adam': lambda f: f.optimizer.Adam(0.05),
    'adam_lazy': lambda f: f.optimizer.Adam(0.05, lazy_mode=True),
    'adagrad': lambda f: f.optimizer.Adagrad(0.1),
    'momentum': lambda f: f.optimizer.Momentum(0.1, momentum=0.9),
}


def _close(tstate, jstate, tlosses, jlosses):
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert sorted(tstate) == sorted(jstate)
    for n, want in jstate.items():
        np.testing.assert_allclose(tstate[n], want, rtol=TOL, atol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize('opt', sorted(OPTIMIZERS))
def test_sparse_embedding_steps_match_jax(opt):
    """5 steps of each optimizer on the sparse grad in both packages.
    The ids come from 0-39 of a 50-row table: under lazy Adam and
    Adagrad rows 40-49 keep their initial bits, table and accumulators
    (the untouched rows' moments stay 0)."""
    build = _pooled_fc(tfluid, OPTIMIZERS[opt])
    feeds = _pooled_feeds(3, high=40)
    jl, js, _ = _train(jfluid, build, feeds)
    tl, ts, init = _train(tfluid, build, feeds)
    _close(ts, js, tl, jl)
    assert tl[-1] < tl[0]
    if opt in ('adam_lazy', 'adagrad'):
        np.testing.assert_array_equal(ts['emb_w'][40:], init['emb_w'][40:])
        for n in ts:
            if n.startswith('emb_w_moment'):
                np.testing.assert_array_equal(ts[n][40:], 0.0)


@pytest.mark.parametrize('opt', ['sgd', 'adam', 'momentum'])
def test_sparse_steps_are_the_dense_steps_bits_in_the_port(opt):
    """In the port a sparse embedding's step is the dense one's, bit for
    bit, under SGD (a repeated row's parts merged first, in the dense
    grad's order), default Adam and Momentum (the grad densified): the
    ids repeat rows within a step."""
    feeds = _pooled_feeds(8, steps=3, high=12)
    got = {}
    for sparse in (False, True):
        def build(fluid, sparse=sparse):
            L = fluid.layers
            ids = L.data(name='ids', shape=[4], dtype='int64')
            label = L.data(name='label', shape=[1], dtype='float32')
            emb = L.embedding(ids, size=[50, 8], is_sparse=sparse,
                              param_attr=fluid.ParamAttr(name='emb_w'))
            pred = L.fc(L.reduce_mean(emb, dim=1), size=1,
                        param_attr=fluid.ParamAttr(name='fc_w'))
            avg = L.mean(L.square_error_cost(pred, label))
            OPTIMIZERS[opt](fluid).minimize(avg)
            return avg
        got[sparse] = _train(tfluid, build, feeds)
    assert got[True][0] == got[False][0]
    for n, v in got[False][1].items():
        np.testing.assert_array_equal(got[True][1][n], v, err_msg=n)


def test_shared_table_fan_out_sums_selected_rows_like_jax():
    """Two lookups into one table: backward's fan-out sum concatenates
    the two SelectedRows (tests/test_sparse_training.py's case), SGD."""
    def build(fluid):
        L = fluid.layers
        a = L.data(name='a', shape=[3], dtype='int64')
        b = L.data(name='b', shape=[3], dtype='int64')
        attr = fluid.ParamAttr(name='shared_w')
        ea = L.embedding(a, size=[30, 6], is_sparse=True, param_attr=attr)
        eb = L.embedding(b, size=[30, 6], is_sparse=True, param_attr=attr)
        avg = L.mean(L.elementwise_add(L.reduce_mean(ea, dim=1),
                                       L.reduce_mean(eb, dim=1)))
        fluid.optimizer.SGD(0.1).minimize(avg)
        return avg
    rng = np.random.RandomState(2)
    feeds = [{'a': rng.randint(0, 30, (8, 3)).astype('int64'),
              'b': rng.randint(0, 30, (8, 3)).astype('int64')}
             for _ in range(3)]
    jl, js, _ = _train(jfluid, build, feeds)
    tl, ts, _ = _train(tfluid, build, feeds)
    _close(ts, js, tl, jl)
    main, _, _ = _program(tfluid, build, 7)
    sums = [op for op in main.global_block().ops if op.type == 'sum']
    assert len(sums) == 1 and len(sums[0].input('X')) == 2
    assert sums[0].output('Out') == ['shared_w@GRAD']


CLIPS = {
    'global_norm': lambda f: f.clip.GradientClipByGlobalNorm(0.01),
    'by_norm': lambda f: f.clip.GradientClipByNorm(0.01),
    'by_value': lambda f: f.clip.GradientClipByValue(1e-3),
}


@pytest.mark.parametrize('clip', sorted(CLIPS))
def test_clipped_sparse_grad_steps_match_jax(clip):
    """tests/test_sparse_training.py's clip cases: each clip kind on the
    sparse grad under SGD(0.5), 4 steps."""
    build = _pooled_fc(tfluid, lambda f: f.optimizer.SGD(0.5), vocab=40,
                       clip=CLIPS[clip])
    feeds = _pooled_feeds(21, steps=4, vocab=40)
    jl, js, _ = _train(jfluid, build, feeds)
    tl, ts, _ = _train(tfluid, build, feeds)
    _close(ts, js, tl, jl)


def test_l2_decay_on_a_sparse_grad_matches_jax():
    """The regularizer's sum of a SelectedRows grad and the dense decay
    term takes the grad's dense form, in both packages."""
    build = _pooled_fc(tfluid, lambda f: f.optimizer.Momentum(
        0.1, momentum=0.9, regularization=f.regularizer.L2Decay(1e-2)))
    feeds = _pooled_feeds(4, steps=3)
    jl, js, _ = _train(jfluid, build, feeds)
    tl, ts, _ = _train(tfluid, build, feeds)
    _close(ts, js, tl, jl)


def _grad_program(fluid, padding_idx):
    def build(fluid):
        L = fluid.layers
        ids = L.data(name='ids', shape=[4, 1], dtype='int64')
        emb = L.embedding(ids, size=[10, 3], is_sparse=True,
                          padding_idx=padding_idx,
                          param_attr=fluid.ParamAttr(name='w'))
        loss = L.mean(L.square(emb))
        fluid.backward.append_backward(loss)
        return loss
    return _program(fluid, build, 3)


@pytest.mark.parametrize('padding_idx', [None, 2])
def test_lookup_table_grad_selected_rows_match_jax(padding_idx):
    """One lookup_table_grad's W@GRAD in both packages: a SelectedRows
    of height 10 whose rows are the step's ids in order (repeats kept)
    and whose values are the upstream rows, padding_idx's rows zero; a
    fetch gives a 0-d object array holding it (arrays on the host), and
    return_numpy=False the SelectedRows itself."""
    ids = np.array([[1, 2, 2, 3], [1, 5, 2, 7]], 'int64')[..., None]
    got = {}
    for fluid in (jfluid, tfluid):
        main, startup, _ = _grad_program(fluid, padding_idx)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        scope.set_var('w', (torch.tensor if fluid is tfluid else np.asarray)(
            np.arange(30, dtype='float32').reshape(10, 3) / 10))
        fetched, = exe.run(main, feed={'ids': ids}, fetch_list=['w@GRAD'],
                           scope=scope)
        assert isinstance(fetched, np.ndarray) and fetched.dtype == object \
            and fetched.shape == ()
        sr = fetched[()]
        raw, = exe.run(main, feed={'ids': ids}, fetch_list=['w@GRAD'],
                       scope=scope, return_numpy=False)
        assert type(raw).__name__ == 'SelectedRows'
        assert scope.find_var('w@GRAD') is None
        got[fluid] = (np.asarray(sr.rows), np.asarray(sr.values), sr.height,
                      np.asarray(sr.to_dense()), sr.merged())
    (jr, jv, jh, jd, jm), (tr, tv, th, td, tm) = got[jfluid], got[tfluid]
    assert th == jh == 10
    assert tr.dtype == np.int32
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tr, ids.reshape(-1))
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tm.rows, jm.rows)
    np.testing.assert_allclose(tm.values, jm.values, rtol=TOL, atol=TOL)
    if padding_idx is not None:
        assert (tv[tr == padding_idx] == 0).all()
        assert (tv[tr != padding_idx] != 0).all()


def test_check_nan_inf_names_lookup_table_grad_for_a_nan_in_its_values():
    """A lookup_table_grad op fed a cotangent with one NaN: its
    SelectedRows values are the first output to hold it, and both
    packages name that op and W@GRAD, in the same words."""
    msgs = []
    cot = np.ones((2, 4, 3), 'float32')
    cot[1, 2, 0] = np.nan
    for fluid, err in ((jfluid, JOpExecutionError),
                       (tfluid, OpExecutionError)):
        prog = fluid.Program()
        block = prog.global_block()
        ids = block.create_var(name='ids', shape=(2, 4), dtype='int64',
                               is_data=True)
        w = block.create_var(name='w', shape=(10, 3), dtype='float32',
                             persistable=True)
        g = block.create_var(name='out@GRAD', shape=(2, 4, 3),
                             dtype='float32', is_data=True)
        wg = block.create_var(name='w@GRAD')
        block.append_op(type='lookup_table_grad',
                        inputs={'Ids': [ids], 'W': [w], 'Out@GRAD': [g]},
                        outputs={'W@GRAD': [wg]},
                        attrs={'is_sparse': True, 'padding_idx': -1})
        scope = fluid.Scope()
        scope.set_var('w', (torch.zeros if fluid is tfluid else np.zeros)(
            (10, 3)))
        exe = fluid.Executor(fluid.CPUPlace())
        fluid.set_flags({'FLAGS_check_nan_inf': True})
        try:
            with pytest.raises(err) as ei:
                exe.run(prog, feed={'ids': np.ones((2, 4), 'int64'),
                                    'out@GRAD': cot}, scope=scope)
        finally:
            fluid.set_flags({'FLAGS_check_nan_inf': False})
        msgs.append(str(ei.value))
        # without the flag the NaN flows into the values
        got, = exe.run(prog, feed={'ids': np.ones((2, 4), 'int64'),
                                   'out@GRAD': cot},
                       fetch_list=['w@GRAD'], scope=scope)
        assert np.isnan(np.asarray(got[()].values)).sum() == 1
    assert msgs[1] == msgs[0]
    assert msgs[1].startswith("NaN/Inf detected in output 'w@GRAD'") and \
        "'lookup_table_grad'" in msgs[1]


def _split_program(fluid):
    """_pooled_fc under Adagrad with a Print host step between backward
    and the optimizer, so the SelectedRows grad is one segment's output
    and the next one's input."""
    def build(fluid):
        L = fluid.layers
        ids = L.data(name='ids', shape=[4], dtype='int64')
        label = L.data(name='label', shape=[1], dtype='float32')
        emb = L.embedding(ids, size=[50, 8], is_sparse=True,
                          param_attr=fluid.ParamAttr(name='emb_w'))
        pred = L.fc(L.reduce_mean(emb, dim=1), size=1,
                    param_attr=fluid.ParamAttr(name='fc_w'))
        avg = L.mean(L.square_error_cost(pred, label))
        opt = fluid.optimizer.Adagrad(0.1)
        params_grads = sorted(fluid.backward.append_backward(avg),
                              key=lambda pg: pg[0].name)
        L.Print(label, first_n=1)
        opt.apply_gradients(avg, params_grads)
        return avg
    return build


def test_a_selected_rows_grad_crosses_segments_and_reads_nothing_back(
        monkeypatch):
    """The SelectedRows leaves the first device segment, passes the
    Print host step and feeds the second segment's adagrad: the steps
    match the JAX package's, and every second run of a segment (what
    the card captures) reads nothing back to the host and builds no
    tensor from host data."""
    build = _split_program(tfluid)
    main, _, _ = _program(tfluid, build, 7)
    prepared = texecutor.PreparedProgram(main, 0, ['ids', 'label'], [])
    segs = [s for s in prepared.steps
            if isinstance(s, texecutor._DeviceSegment)]
    assert len(segs) == 2
    assert 'emb_w@GRAD' in segs[0].out_names
    assert 'emb_w@GRAD' in segs[1].in_names
    runs = {'n': 0}
    run_ops = texecutor.Executor._run_ops

    def guarded(step, ctx, drop, checked=False):
        runs['n'] += 1
        if runs['n'] > 3:           # the startup's, then 2 segments a step
            with _NoHostData():
                return run_ops(step, ctx, drop, checked)
        return run_ops(step, ctx, drop, checked)
    monkeypatch.setattr(texecutor.Executor, '_run_ops',
                        staticmethod(guarded))
    feeds = _pooled_feeds(6, steps=3)
    jl, js, _ = _train(jfluid, build, feeds)
    tl, ts, _ = _train(tfluid, build, feeds)
    assert runs['n'] == 1 + 2 * len(feeds)
    _close(ts, js, tl, jl)


def test_capture_helpers_take_a_selected_rows():
    """What a captured segment does with a run-local SelectedRows: its
    signature carries both tensors' shapes and the height; the static
    clone is a new pair; a replay copies the next step's pair into it;
    the streams recorded cover both tensors; a stale pair of another
    height is refused by a while body's copy-back."""
    sr = SelectedRows(torch.randn(6, 3), torch.tensor([1, 4, 4, 0, 2, 9],
                                                      dtype=torch.int32), 10)
    sig = texecutor.value_signature(sr)
    assert sig == ('rows', ((6, 3), torch.float32), ((6,), torch.int32), 10)
    assert texecutor.value_signature(SelectedRows(
        torch.randn(6, 3), sr.rows, 11)) != sig
    static = texecutor._clone_value(sr)
    assert static.values is not sr.values and static.rows is not sr.rows
    assert torch.equal(static.values, sr.values)
    nxt = SelectedRows(torch.randn(6, 3), torch.tensor(
        [3, 3, 3, 5, 6, 7], dtype=torch.int32), 10)
    values, rows = static.values, static.rows
    texecutor._copy_value(static, nxt)
    assert static.values is values and static.rows is rows
    assert torch.equal(values, nxt.values) and torch.equal(rows, nxt.rows)
    assert list(texecutor._tensors_of([static])) == [values, rows]
    texecutor._copy_back('g', static, sr)
    assert torch.equal(values, sr.values)
    with pytest.raises(OpExecutionError, match='SelectedRows'):
        texecutor._copy_back('g', static, SelectedRows(sr.values, sr.rows,
                                                       11))
    dense = sr.to_dense()
    want = torch.zeros(10, 3).index_put_((sr.rows.long(),), sr.values,
                                         accumulate=True)
    assert torch.equal(dense, want)
    assert sr.dense_shape == (10, 3) and sr.dtype == torch.float32
    np.testing.assert_array_equal(sr.numpy(), want.numpy())


def test_scatter_adds_are_deterministic_on_the_cpu():
    """A repeated row's parts add in their order on the CPU (index_add_,
    numpy's np.add.at order), not with index_put_'s atomics: to_dense,
    sparse SGD's merge and the dense lookup_table_grad give the same bits
    on every run."""
    import torch
    from paddle_tpu_torch.ops.optimizer_ops import _merged
    from paddle_tpu_torch.selected_rows import (SelectedRows,
                                                scatter_add_rows)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 500, (60000,), generator=gen)
    vals = torch.randn(60000, 10, generator=gen)
    want = np.zeros((500, 10), 'float32')
    np.add.at(want, rows.numpy(), vals.numpy())
    sr = SelectedRows(vals, rows.to(torch.int32), 500)
    for _ in range(4):
        assert np.array_equal(sr.to_dense().numpy(), want)
        got = scatter_add_rows(torch.zeros(500, 10), rows, vals)
        assert np.array_equal(got.numpy(), want)
    merged = [_merged(sr, torch.float32)[1] for _ in range(4)]
    assert all(torch.equal(m, merged[0]) for m in merged)
