"""The evaluation ops (paddle_tpu/ops/eval_ops.py's 4 types), their
layers, `metrics` and `evaluator`, the port against the JAX package on
the CPU.

- chunk_eval under its four schemes (plain, IOB, IOE, IOBES), with
  ragged lengths and excluded chunk types: the six outputs equal.
- auc (ROC and PR) over three runs of one program: the AUC and the
  TP/FP/TN/FN state after each run within 1e-5 (the counts equal).
- precision_recall with weights and fed states, unweighted with empty
  classes, and out-of-range ids (NaN metrics): within 1e-5.
- positive_negative_pair with a column, weights, accumulators and score
  ties, and over 700 rows (three row blocks): within 1e-5.
- Oracles as tests/test_extra_ops.py:444-600 and
  tests/test_parity_modules.py:25-70, 217 hold the JAX package.
- metrics.* fed the same numbers in both packages: the same results.
- evaluator.Accuracy, ChunkEvaluator, PrecisionRecall, EditDistance and
  DetectionMAP over three batches, with a reset: the same eval() as the
  JAX package's.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_extra_ops import _np_pnpair

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


def _runs(fluid, build, feeds):
    """build() in a fresh program of `fluid`; its startup, then one run a
    feed: [[fetched numpy arrays] a run]."""
    prog, startup = fluid.Program(), fluid.Program()
    with UNIQUE[fluid].guard(), fluid.program_guard(prog, startup):
        fetch = build(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return [[np.asarray(v) for v in exe.run(prog, feed=f, fetch_list=fetch,
                                            scope=scope)] for f in feeds]


def _same(build, feeds, tol=TOL):
    want = _runs(jfluid, build, feeds)
    got = _runs(tfluid, build, feeds)
    for run_w, run_g in zip(want, got):
        for w, g in zip(run_w, run_g):
            assert g.shape == w.shape and g.dtype.kind == w.dtype.kind
            if np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
    return got


SCHEMES = {'plain': 1, 'IOB': 2, 'IOE': 2, 'IOBES': 4}


@pytest.mark.parametrize('excluded', [None, [1]], ids=['all', 'excluded'])
@pytest.mark.parametrize('scheme', sorted(SCHEMES))
def test_chunk_eval_matches_jax(scheme, excluded):
    n_types, B, T = 3, 6, 9
    n_tags = n_types * SCHEMES[scheme] + 1       # the last one is "other"
    r = np.random.RandomState(1)
    lab = r.randint(0, n_tags, (B, T)).astype('int64')
    inf = lab.copy()
    flip = r.rand(B, T) < 0.3
    inf[flip] = r.randint(0, n_tags, flip.sum())
    lens = np.array([9, 1, 4, 7, 9, 2], 'int32')

    def build(fluid):
        L = fluid.layers
        i = L.data(name='inf', shape=[B, T], dtype='int64',
                   append_batch_size=False)
        l = L.data(name='lab', shape=[B, T], dtype='int64',
                   append_batch_size=False)
        i.seq_lens = L.data(name='lens', shape=[B], dtype='int32',
                            append_batch_size=False)
        return list(L.chunk_eval(i, l, chunk_scheme=scheme,
                                 num_chunk_types=n_types,
                                 excluded_chunk_types=excluded))
    got, = _same(build, [{'inf': inf, 'lab': lab, 'lens': lens}])
    assert got[3][0] > 0 and got[5][0] > 0


def _auc_feed(seed, n=64):
    r = np.random.RandomState(seed)
    labels = r.randint(0, 2, (n, 1)).astype('int64')
    score = np.clip(0.5 * labels[:, 0] + 0.6 * r.rand(n), 0, 1)
    score[:4] = [0.0, 1.0, 0.5, 0.25]            # bucket edges
    return {'p': np.stack([1 - score, score], 1).astype('float32'),
            'y': labels}


@pytest.mark.parametrize('curve', ['ROC', 'PR'])
def test_auc_state_over_three_runs_matches_jax(curve):
    def build(fluid):
        L = fluid.layers
        p = L.data(name='p', shape=[2], dtype='float32')
        y = L.data(name='y', shape=[1], dtype='int64')
        a = L.auc(p, y, curve=curve, num_thresholds=50)
        return [a] + ['auc_0.%s' % s for s in ('tp', 'fp', 'tn', 'fn')]
    got = _same(build, [_auc_feed(s) for s in (2, 3, 4)])
    # the state built up: three batches of 64
    assert got[2][1][0] + got[2][4][0] == sum(
        _auc_feed(s)['y'].sum() for s in (2, 3, 4))
    assert got[0][1][0] < got[1][1][0] < got[2][1][0]


def test_precision_recall_matches_jax():
    r = np.random.RandomState(0)
    cls = 5
    feed = {'ids': r.randint(0, cls, (16, 1)).astype('int64'),
            'labels': r.randint(0, cls, (16, 1)).astype('int64'),
            'w': r.rand(16, 1).astype('float32'),
            'states': (r.rand(cls, 4) * 3).astype('float32')}

    def build(fluid):
        L = fluid.layers
        i = L.data(name='ids', shape=[1], dtype='int64')
        lab = L.data(name='labels', shape=[1], dtype='int64')
        w = L.data(name='w', shape=[1], dtype='float32')
        s = L.data(name='states', shape=[cls, 4], dtype='float32',
                   append_batch_size=False)
        return list(L.precision_recall(i, lab, cls, weights=w,
                                       states_info=s))
    _same(build, [feed])


@pytest.mark.parametrize('ids', [[[0], [0], [1]], [[5], [0], [1]]],
                         ids=['empty-classes', 'out-of-range'])
def test_precision_recall_defaults_and_poison_match_jax(ids):
    feed = {'ids': np.array(ids, 'int64'),
            'labels': np.array([[0], [1], [1]], 'int64')}

    def build(fluid):
        L = fluid.layers
        i = L.data(name='ids', shape=[1], dtype='int64')
        lab = L.data(name='labels', shape=[1], dtype='int64')
        return list(L.precision_recall(i, lab, 4))
    got, = _same(build, [feed])
    assert np.isnan(got[0]).all() == (ids[0][0] == 5)


@pytest.mark.parametrize('B', [24, 700])
def test_positive_negative_pair_matches_jax(B):
    r = np.random.RandomState(1)
    score = r.rand(B, 3).astype('float32')
    score[3, 1] = score[5, 1]                    # a tie
    feed = {'s': score, 'l': r.randint(0, 3, (B, 1)).astype('float32'),
            'q': r.randint(0, 4, (B, 1)).astype('int64'),
            'w': r.rand(B, 1).astype('float32'),
            'acc': np.array([2.0, 3.0, 0.5], 'float32')}

    def build(fluid):
        L = fluid.layers
        s = L.data(name='s', shape=[3], dtype='float32')
        lab = L.data(name='l', shape=[1], dtype='float32')
        q = L.data(name='q', shape=[1], dtype='int64')
        w = L.data(name='w', shape=[1], dtype='float32')
        acc = L.data(name='acc', shape=[3], dtype='float32',
                     append_batch_size=False)
        ap, an, au = L.split(acc, 3)
        return list(L.positive_negative_pair(s, lab, q, weight=w,
                                             accum=(ap, an, au), column=1))
    got, = _same(build, [feed])
    want = _np_pnpair(score, feed['l'].ravel(), feed['q'].ravel(),
                      feed['w'].ravel(), column=1)
    np.testing.assert_allclose([g[0] for g in got],
                               np.asarray(want) + feed['acc'], rtol=1e-4)


def test_metrics_match_jax():
    """The numpy accumulators, fed the same numbers."""
    r = np.random.RandomState(5)
    results = {}
    for fluid in (jfluid, tfluid):
        M = fluid.metrics
        prec, rec, acc = M.Precision(), M.Recall(), M.Accuracy()
        chunk, edit, auc = M.ChunkEvaluator(), M.EditDistance('e'), \
            M.Auc('auc', num_thresholds=64)
        dmap = M.DetectionMAP()
        comp = M.CompositeMetric()
        comp.add_metric(M.Precision())
        comp.add_metric(M.Recall())
        rs = np.random.RandomState(5)
        for _ in range(3):
            preds = rs.rand(20, 1).astype('float32')
            labels = rs.randint(0, 2, (20, 1)).astype('int64')
            prec.update(preds, labels)
            rec.update(preds, labels)
            comp.update(preds, labels)
            acc.update(value=float(rs.rand()), weight=int(rs.randint(1, 9)))
            chunk.update(*rs.randint(1, 20, 3))
            edit.update(rs.randint(0, 4, (6, 1)).astype('float32'), 6)
            auc.update(np.concatenate([1 - preds, preds], 1), labels)
            dmap.update(np.array([rs.rand()], 'float32'), weight=2)
        results[fluid] = [prec.eval(), rec.eval(), acc.eval(), chunk.eval(),
                          edit.eval(), auc.eval(), dmap.eval(), comp.eval()]
    del r
    for w, g in zip(results[jfluid], results[tfluid]):
        np.testing.assert_allclose(np.asarray(g, 'float64'),
                                   np.asarray(w, 'float64'), rtol=1e-12)


def _evaluators(fluid):
    L = fluid.layers
    E = fluid.evaluator
    x = L.data(name='x', shape=[4], dtype='float32')
    lab = L.data(name='lab', shape=[1], dtype='int64')
    inf = L.data(name='inf', shape=[2, 7], dtype='int64',
                 append_batch_size=False)
    tags = L.data(name='tags', shape=[2, 7], dtype='int64',
                  append_batch_size=False)
    hyp = L.data(name='hyp', shape=[3, 5], dtype='int64',
                 append_batch_size=False)
    ref = L.data(name='ref', shape=[3, 5], dtype='int64',
                 append_batch_size=False)
    dets = L.data(name='dets', shape=[5, 6], dtype='float32')
    gl = L.data(name='gl', shape=[3, 1], dtype='float32')
    gb = L.data(name='gb', shape=[3, 4], dtype='float32')
    return [E.Accuracy(input=x, label=lab),
            E.ChunkEvaluator(input=inf, label=tags, chunk_scheme='IOB',
                             num_chunk_types=3),
            E.PrecisionRecall(L.argmax(x, axis=1), lab, 4),
            E.EditDistance(hyp, ref),
            E.DetectionMAP(dets, gl, gb, class_num=3,
                           overlap_threshold=0.5, ap_version='11point')]


def _eval_feed(seed):
    r = np.random.RandomState(seed)
    gb = np.sort(r.rand(2, 3, 4).astype('float32').reshape(2, 3, 2, 2),
                 axis=2).reshape(2, 3, 4)
    gl = r.randint(1, 3, (2, 3, 1)).astype('float32')
    dets = np.full((2, 5, 6), -1.0, 'float32')
    dets[:, :3, 0] = gl[..., 0]
    dets[:, :3, 1] = r.rand(2, 3)
    dets[:, :3, 2:] = gb + 0.02 * r.randn(2, 3, 4)
    dets[:, 3, :] = [1, 0.9, 0.1, 0.1, 0.3, 0.3]
    return {'x': r.randn(6, 4).astype('float32'),
            'lab': r.randint(0, 4, (6, 1)).astype('int64'),
            'inf': r.randint(0, 7, (2, 7)).astype('int64'),
            'tags': r.randint(0, 7, (2, 7)).astype('int64'),
            'hyp': r.randint(0, 4, (3, 5)).astype('int64'),
            'ref': r.randint(0, 4, (3, 5)).astype('int64'),
            'dets': dets, 'gl': gl, 'gb': gb}


def _eval_runs(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with UNIQUE[fluid].guard(), fluid.program_guard(prog, startup):
        evs = _evaluators(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    out = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for ev in evs:
            ev.reset(exe)
        fetch = [m for ev in evs for m in ev.metrics]
        for rnd in range(2):
            for seed in range(3):
                exe.run(prog, feed=_eval_feed(10 * rnd + seed),
                        fetch_list=fetch)
            out.append([ev.eval(exe) for ev in evs])
            for ev in evs:
                ev.reset(exe)
    return out


def test_evaluators_match_jax():
    want = _eval_runs(jfluid)
    got = _eval_runs(tfluid)
    for rw, rg in zip(want, got):
        for w, g in zip(rw, rg):
            np.testing.assert_allclose(np.asarray(g, 'float64'),
                                       np.asarray(w, 'float64'),
                                       atol=TOL, rtol=TOL)
    # the two rounds saw other batches: reset() cleared the first round
    assert any(not np.allclose(np.asarray(a, 'float64'),
                               np.asarray(b, 'float64'))
               for a, b in zip(got[0], got[1]))
