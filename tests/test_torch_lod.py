"""LoD feeds in the port against the JAX package on the CPU.

- LoDTensor, create_lod_tensor and create_random_int_lodtensor, and the
  exports fluid.LoDTensor / fluid.Tensor / core.LoDTensor.
- layers.data(lod_level=1): the `<name>@SEQ_LEN` companion, the same
  Program text; the companion carried through the layers.
- The Executor's feed expansion: a LoDTensor, a (padded, lengths)
  tuple, a padded array of rank declared + 1, each to the JAX package's
  padded tensor and lengths; its errors; the one-device
  ParallelExecutor.
- DataFeeder's LoD branch: the same LoDTensors as the JAX package's.
- The synthetic imdb, sentiment, movielens and conll05: every sample
  and table bit for bit.
- The declared-rank rule: an fc over a sequence at T == D and at T == 1
  keeps the time axis and adds its bias over the features, and an
  elementwise bias `axis` on a sequence var lines up as in the JAX
  package.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dataset as jdataset
import paddle_tpu_torch as tfluid
from paddle_tpu import executor as jexecutor
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import executor as texecutor
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_torch_book import _same_samples


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


def _same_lod_tensor(got, want):
    assert type(got).__name__ == type(want).__name__ == 'LoDTensor'
    assert got.lod() == want.lod()
    assert got.recursive_sequence_lengths() == \
        want.recursive_sequence_lengths()
    assert got.numpy().dtype == want.numpy().dtype
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- LoDTensor ----------------------------------------------------------------

def _lod_script(fluid):
    """The LoDTensor API driven the same way in a package."""
    t = fluid.LoDTensor()
    t.set(np.arange(12, dtype='float32').reshape(6, 2), fluid.CPUPlace())
    t.set_recursive_sequence_lengths([[2, 3, 1]])
    u = fluid.LoDTensor(np.arange(5), [[0, 2, 5]])
    bad = fluid.LoDTensor(np.arange(4), [[0, 3, 2]])
    short = fluid.LoDTensor(np.arange(4), [[0, 3]])
    u2 = fluid.LoDTensor()
    u2.set_lod([[0, 1, 4]])
    return dict(
        t=t, lod=t.lod(), lens=t.recursive_sequence_lengths(),
        valid=[x.has_valid_recursive_sequence_lengths()
               for x in (t, u, bad, short, u2, fluid.LoDTensor())],
        arr=np.asarray(t), arr64=np.asarray(t, dtype='float64'),
        shape=t.shape(), u_lens=u.recursive_sequence_lengths(),
        u2_lod=u2.lod(), repr=repr(t),
        from_list=fluid.create_lod_tensor([[1, 2, 3], [4], [5, 6]], None),
        from_array=fluid.create_lod_tensor(
            np.ones((4, 3), 'f4'), [[1, 3]], fluid.CPUPlace()),
        from_lod=fluid.create_lod_tensor(t, [[3, 3]]))


def test_lod_tensor_api_matches_jax():
    want, got = _lod_script(jfluid), _lod_script(tfluid)
    for key in ('t', 'from_list', 'from_array', 'from_lod'):
        _same_lod_tensor(got[key], want[key])
    for key in ('lod', 'lens', 'valid', 'shape', 'u_lens', 'u2_lod', 'repr'):
        assert got[key] == want[key], key
    for key in ('arr', 'arr64'):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert tfluid.Tensor is tfluid.LoDTensor
    assert tfluid.core.LoDTensor is tfluid.LoDTensor
    for name in ('LoDTensor', 'create_lod_tensor',
                 'create_random_int_lodtensor'):
        assert name in tfluid.__all__ and name in jfluid.__all__


def test_create_lod_tensor_refuses_lengths_that_miss_the_rows():
    with pytest.raises(AssertionError):
        jfluid.create_lod_tensor(np.ones((4, 2)), [[1, 2]])
    with pytest.raises(ValueError, match='do not cover the 4 rows'):
        tfluid.create_lod_tensor(np.ones((4, 2)), [[1, 2]])


def test_random_int_lodtensor_draws_as_jax():
    for seed in (0, 7):
        np.random.seed(seed)
        want = jfluid.create_random_int_lodtensor([[2, 4, 1]], [3],
                                                  jfluid.CPUPlace(), 1, 9)
        np.random.seed(seed)
        got = tfluid.create_random_int_lodtensor([[2, 4, 1]], [3],
                                                 tfluid.CPUPlace(), 1, 9)
        _same_lod_tensor(got, want)
        assert got.numpy().shape == (7, 3)
        assert got.numpy().min() >= 1 and got.numpy().max() <= 9


# -- layers.data and the feed expansion ---------------------------------------

def _seq_program(fluid, unique_name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[4], dtype='float32',
                                  lod_level=1)
            y = fluid.layers.relu(fluid.layers.scale(x, scale=2.0))
            pooled = fluid.layers.sequence_pool(y, 'sum')
            last = fluid.layers.sequence_last_step(y)
    return main, startup, x, y, [pooled, last]


def test_lod_data_var_and_its_companion_match_jax():
    jmain, _, jx, jy, _ = _seq_program(jfluid, junique_name)
    tmain, _, tx, ty, touts = _seq_program(tfluid, tunique_name)
    assert tmain.to_string() == jmain.to_string()
    assert tx.seq_lens.name == jx.seq_lens.name == 'x@SEQ_LEN'
    assert tuple(tx.seq_lens.shape) == (-1,)
    assert tx.seq_lens.dtype == 'int32'
    assert ty.seq_lens is tx.seq_lens and ty.lod_level == 1
    assert all(o.seq_lens is None and o.lod_level == 0 for o in touts)


def _feed_forms():
    r = np.random.RandomState(3)
    flat = r.randn(7, 4).astype('float32')
    padded = np.zeros((3, 4, 4), 'float32')
    lens = np.array([4, 1, 2], 'int32')
    off = 0
    for b, n in enumerate(lens):
        padded[b, :n] = flat[off:off + n]
        off += n
    return {'lod_tensor': lambda f: f.create_lod_tensor(flat, [[4, 1, 2]]),
            'tuple': lambda f: (padded, lens),
            'tuple-list-lengths': lambda f: (padded, [4, 1, 2]),
            'padded-array': lambda f: padded}


@pytest.mark.parametrize('form', sorted(_feed_forms()))
def test_each_feed_form_expands_as_in_jax(form):
    jmain, _, _, _, jouts = _seq_program(jfluid, junique_name)
    tmain, _, _, _, touts = _seq_program(tfluid, tunique_name)
    make = _feed_forms()[form]
    want_feed = jexecutor._expand_sequence_feeds(jmain, {'x': make(jfluid)})
    got_feed = texecutor._expand_sequence_feeds(tmain, {'x': make(tfluid)})
    assert sorted(got_feed) == sorted(want_feed) == ['x', 'x@SEQ_LEN']
    for name in want_feed:
        w, g = np.asarray(want_feed[name]), np.asarray(got_feed[name])
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed={'x': make(jfluid)}, fetch_list=jouts,
        scope=jfluid.Scope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={'x': make(tfluid)}, fetch_list=touts,
        scope=tfluid.Scope())
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


def test_pad_lod_to_batch_matches_jax():
    flat = np.arange(30, dtype='int64').reshape(10, 3)
    for offsets in ([0, 3, 3, 10], [0, 10], [0, 1, 2], [0]):
        w = jexecutor.pad_lod_to_batch(flat, offsets)
        g = texecutor.pad_lod_to_batch(flat, offsets)
        for a, b in zip(w, g):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_feed_expansion_errors_match_jax():
    jmain, _, _, _, _ = _seq_program(jfluid, junique_name)
    tmain, _, _, _, _ = _seq_program(tfluid, tunique_name)
    two = dict(data=np.ones((3, 4), 'f4'), lod=[[0, 1, 2], [0, 1, 3]])
    for main, fluid, mod in ((jmain, jfluid, jexecutor),
                             (tmain, tfluid, texecutor)):
        with pytest.raises(NotImplementedError,
                           match="only lod_level=1 feeds are supported"):
            mod._expand_sequence_feeds(main, {'x': fluid.LoDTensor(**two)})
    msgs = []
    for main, mod in ((jmain, jexecutor), (tmain, texecutor)):
        with pytest.raises(ValueError) as e:
            mod._expand_sequence_feeds(main, {'x': np.ones((3, 4), 'f4')})
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert 'padded array of rank 3 (got rank 2)' in msgs[1]
    # a dense var's feed, and a LoDTensor with no lod, pass as they are
    out = texecutor._expand_sequence_feeds(
        tmain, {'y': 5, 'x': tfluid.LoDTensor(np.ones((2, 3, 4), 'f4'))})
    assert out['y'] == 5 and 'x@SEQ_LEN' in out


def test_parallel_executor_takes_a_lod_feed():
    main, startup, _, _, outs = _seq_program(tfluid, tunique_name)
    feed = {'x': _feed_forms()['lod_tensor'](tfluid)}
    with tfluid.scope_guard(tfluid.Scope()):
        pe = tfluid.ParallelExecutor(use_cuda=False, main_program=main)
        got = pe.run(fetch_list=[o.name for o in outs], feed=feed)
    want = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=outs, scope=tfluid.Scope())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


# -- DataFeeder ---------------------------------------------------------------

def _feeder_feed(fluid):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        vecs = fluid.layers.data(name='vecs', shape=[3], dtype='float32',
                                 lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
    feeder = fluid.DataFeeder(feed_list=[words, vecs, label],
                              place=fluid.CPUPlace(), program=main)
    r = np.random.RandomState(5)
    batch = [([1, 2, 3], r.randn(3, 3).tolist(), 0),
             ([4], r.randn(1, 3).tolist(), 1),
             ([5, 6], r.randn(2, 3).tolist(), 1)]
    return feeder.feed(batch), list(feeder.feed_parallel(batch, 2))


def test_data_feeder_lod_slots_match_jax():
    want, jparts = _feeder_feed(jfluid)
    got, tparts = _feeder_feed(tfluid)
    assert sorted(got) == sorted(want)
    for name in ('words', 'vecs'):
        _same_lod_tensor(got[name], want[name])
    assert got['words'].numpy().shape == (6, 1)
    assert got['vecs'].numpy().shape == (6, 3)
    np.testing.assert_array_equal(got['label'], want['label'])
    assert len(tparts) == len(jparts) == 2
    for t, j in zip(tparts, jparts):
        _same_lod_tensor(t['words'], j['words'])


# -- the four datasets --------------------------------------------------------

READERS = {
    'imdb.train': lambda d: d.imdb.train(d.imdb.word_dict()),
    'imdb.test': lambda d: d.imdb.test(),
    'sentiment.train': lambda d: d.sentiment.train(),
    'sentiment.test': lambda d: d.sentiment.test(),
    'movielens.train': lambda d: d.movielens.train(),
    'movielens.test': lambda d: d.movielens.test(),
    'conll05.test': lambda d: d.conll05.test(),
}


@pytest.mark.parametrize('name', sorted(READERS))
def test_sequence_dataset_yields_the_jax_samples(name):
    _same_samples(READERS[name](jdataset)(), READERS[name](tfluid.dataset)())


def test_sequence_dataset_tables_match_jax(tmp_path):
    t, j = tfluid.dataset, jdataset
    assert t.imdb.word_dict() == j.imdb.word_dict()
    assert t.imdb.build_dict('*', 5) == j.imdb.build_dict('*', 5)
    assert t.sentiment.get_word_dict() == j.sentiment.get_word_dict()
    assert t.conll05.get_dict() == j.conll05.get_dict()
    emb = t.conll05.get_embedding()
    assert emb.dtype == np.float32 and emb.shape == (7477, 32)
    np.testing.assert_array_equal(emb, j.conll05.get_embedding())
    ml_t, ml_j = t.movielens, j.movielens
    for fn in ('max_user_id', 'max_movie_id', 'max_job_id',
               'movie_categories', 'get_movie_title_dict'):
        assert getattr(ml_t, fn)() == getattr(ml_j, fn)(), fn
    assert ml_t.age_table == ml_j.age_table
    for fn in ('movie_info', 'user_info'):
        want, got = getattr(ml_j, fn)(), getattr(ml_t, fn)()
        assert sorted(got) == sorted(want)
        for k in (1, 17, max(want)):
            assert got[k].value() == want[k].value()
            assert repr(got[k]) == repr(want[k])
    for name in ('imdb', 'sentiment', 'movielens', 'conll05'):
        tdir, jdir = tmp_path / ('t' + name), tmp_path / ('j' + name)
        getattr(t, name).convert(str(tdir))
        getattr(j, name).convert(str(jdir))
        files = sorted(os.listdir(tdir))
        assert files and files == sorted(os.listdir(jdir))
        for f in files:
            assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f


# -- the declared-rank rule ---------------------------------------------------

def _fc_program(fluid, unique_name, size, bias_value):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[2], dtype='float32',
                                  lod_level=1)
            out = fluid.layers.fc(
                input=x, size=size,
                bias_attr=fluid.ParamAttr(
                    initializer=fluid.initializer.Constant(bias_value)))
            h, _ = fluid.layers.dynamic_lstm(
                fluid.layers.fc(input=out, size=12), size=12,
                use_peepholes=False)
    return main, startup, [out, h]


def _run_both(jprog, tprog, data, lens):
    """Both programs' outputs from the JAX package's startup values,
    each fed its own package's LoDTensor of `data`."""
    jmain, jstartup, jouts = jprog
    tmain, _, touts = tprog
    assert tmain.to_string() == jmain.to_string()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jstartup.list_vars() if v.persistable}
    want = jexe.run(jmain, feed={'x': jfluid.create_lod_tensor(data, [lens])},
                    fetch_list=jouts, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tmain)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={'x': tfluid.create_lod_tensor(data, [lens])},
        fetch_list=touts, scope=tscope)
    return [np.asarray(w) for w in want], [np.asarray(g) for g in got]


@pytest.mark.parametrize('lens', [[3, 2], [1, 1], [2, 1, 2]],
                         ids=['T-equals-size', 'T-is-1', 'T-is-2'])
def test_fc_over_a_sequence_keeps_the_time_axis(lens):
    """fc of size 3 over [B, T, 2]: at T == 3 the bias still adds over
    the features, at T == 1 the time axis stays (the LSTM after it sees
    rank 3)."""
    flat = np.random.RandomState(9).randn(sum(lens), 2).astype('f4')
    zeros = np.zeros_like(flat)
    for data in (flat, zeros):
        want, got = _run_both(_fc_program(jfluid, junique_name, 3, 7.0),
                              _fc_program(tfluid, tunique_name, 3, 7.0),
                              data, lens)
        T = max(lens)
        assert got[0].shape == (len(lens), T, 3)
        assert got[1].shape == (len(lens), T, 3)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # zero input: every valid position is exactly the bias
    np.testing.assert_array_equal(got[0][0, :lens[0]], 7.0)


def _axis_program(fluid, unique_name, axis):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[3, 2], dtype='float32',
                                  lod_level=1)
            bias = fluid.layers.create_parameter(
                shape=[3] if axis == 1 else [2], dtype='float32',
                default_initializer=fluid.initializer.Constant(0.5))
            out = fluid.layers.elementwise_add(x, bias, axis=axis)
            scaled = fluid.layers.elementwise_mul(out, bias, axis=axis)
    return main, startup, [out, scaled]


@pytest.mark.parametrize('axis', [1, 2, -1])
def test_bias_axis_on_a_sequence_var_matches_jax(axis):
    """x declared [-1, 3, 2] runs as [B, T, 3, 2]: axis 1 names the 3 of
    the declared shape, which sits at runtime axis 2."""
    lens = [3, 1, 3]       # T == 3 == the bias length at axis 1
    flat = np.random.RandomState(axis + 5).randn(7, 3, 2).astype('f4')
    want, got = _run_both(_axis_program(jfluid, junique_name, axis),
                          _axis_program(tfluid, tunique_name, axis),
                          flat, lens)
    for w, g in zip(want, got):
        assert g.shape == (3, 3, 3, 2)
        np.testing.assert_allclose(g, w, rtol=1e-6)
