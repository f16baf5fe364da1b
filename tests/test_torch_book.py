"""The four dense book chapters and their feeding, the port against the
JAX package on the CPU.

- Feeding: fluid.batch, DataFeeder's dense branch, the reader creators
  and decorators, and the synthetic datasets (uci_housing / housing,
  mnist, cifar, imikolov), which must yield the JAX package's samples
  bit for bit.
- nets (simple_img_conv_pool, img_conv_group, glu,
  scaled_dot_product_attention) and models (mnist, vgg, alexnet,
  googlenet): the same Program text, and forward outputs within 1e-5
  from the same parameters.
- The chapters fit_a_line, recognize_digits, image_classification
  (resnet_cifar10 at depth 8 and a narrowed VGG at 32 px) and word2vec: each is
  built in both packages, the JAX package's initial persistables are
  copied into the port (io.load_numpy_params), both are fed the same
  batches through fluid.batch + DataFeeder, and 3 steps' losses must
  agree within 1e-4 relative in fp32. fit_a_line and
  image_classification also round-trip save_inference_model /
  load_inference_model: the loaded program's outputs within 1e-5 of the
  trained program's, the saved files the JAX package's.
"""
import os
import random
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dataset as jdataset
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import mnist as jmnist, resnet as jresnet, \
    vgg as jvgg, alexnet as jalexnet, googlenet as jgooglenet
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import mnist as tmnist, resnet as tresnet, \
    vgg as tvgg, alexnet as talexnet, googlenet as tgooglenet
from paddle_tpu_torch.reader import pipeline as tpipeline

J = dict(fluid=jfluid, unique_name=junique_name, mnist=jmnist,
         resnet=jresnet, vgg=jvgg, alexnet=jalexnet, googlenet=jgooglenet)
T = dict(fluid=tfluid, unique_name=tunique_name, mnist=tmnist,
         resnet=tresnet, vgg=tvgg, alexnet=talexnet, googlenet=tgooglenet)
LOSS_RTOL = 1e-4
STEPS = 3


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


def _same_sample(w, g):
    """Two samples (tuples or batches of them), equal bit for bit."""
    if isinstance(w, (tuple, list)):
        assert type(g) is type(w) and len(g) == len(w)
        for a, b in zip(w, g):
            _same_sample(a, b)
        return
    assert type(g) is type(w)
    a, b = np.asarray(w), np.asarray(g)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(b, a)


def _same_samples(want, got):
    """Two sample streams, equal bit for bit."""
    want, got = list(want), list(got)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        _same_sample(w, g)


# -- datasets ------------------------------------------------------------------

READERS = {
    'uci_housing.train': lambda d: d.uci_housing.train(),
    'uci_housing.test': lambda d: d.uci_housing.test(),
    'housing.train': lambda d: d.housing.train(),
    'mnist.train': lambda d: d.mnist.train(),
    'mnist.test': lambda d: d.mnist.test(),
    'cifar.train10': lambda d: d.cifar.train10(),
    'cifar.test10': lambda d: d.cifar.test10(),
    'cifar.train100': lambda d: d.cifar.train100(),
    'cifar.test100': lambda d: d.cifar.test100(),
    'imikolov.train': lambda d: d.imikolov.train(d.imikolov.build_dict()),
    'imikolov.test-n3': lambda d: d.imikolov.test(d.imikolov.build_dict(), 3),
}


@pytest.mark.parametrize('name', sorted(READERS))
def test_dataset_reader_yields_the_jax_samples(name):
    _same_samples(READERS[name](jdataset)(), READERS[name](tfluid.dataset)())


def test_dataset_common_matches_jax(tmp_path):
    tcommon, jcommon = tfluid.dataset.common, jdataset.common
    for mod, split in (('mnist', 'train'), ('cifar10', 'means'),
                       ('imikolov', 'test')):
        np.testing.assert_array_equal(
            tcommon.synthetic_rng(mod, split).randint(0, 1 << 30, 8),
            jcommon.synthetic_rng(mod, split).randint(0, 1 << 30, 8))
    assert tfluid.dataset.imikolov.build_dict() == \
        jdataset.imikolov.build_dict()
    assert tfluid.dataset.uci_housing.feature_names == \
        jdataset.uci_housing.feature_names
    for common in (tcommon, jcommon):
        with pytest.raises(IOError, match='not cached'):
            common.download('http://example.invalid/x.tgz', 'probe', 'md5')
    # convert: the same shard files, byte for byte
    shards = tfluid.reader.firstn(tfluid.dataset.uci_housing.test(), 25)
    tcommon.convert(str(tmp_path / 'trio'), shards, 10, 'uci')
    jcommon.convert(str(tmp_path / 'jrio'), shards, 10, 'uci')
    names = sorted(os.listdir(tmp_path / 'trio'))
    assert names == sorted(os.listdir(tmp_path / 'jrio')) == \
        ['uci-00000', 'uci-00001', 'uci-00002']
    for n in names:
        assert (tmp_path / 'trio' / n).read_bytes() == \
            (tmp_path / 'jrio' / n).read_bytes()
    path = tmp_path / 'f.bin'
    path.write_bytes(b'abc' * 1000)
    assert tcommon.md5file(str(path)) == jcommon.md5file(str(path))
    # split + cluster_files_reader: the same files and samples
    reader = tfluid.reader.firstn(tfluid.dataset.uci_housing.test(), 25)
    for pkg, common in (('t', tcommon), ('j', jcommon)):
        common.split(reader, 10, suffix=str(tmp_path / (pkg + '-%05d.pkl')))
    for trainer in (0, 1):
        _same_samples(
            jcommon.cluster_files_reader(str(tmp_path / 'j-*.pkl'), 2,
                                         trainer)(),
            tcommon.cluster_files_reader(str(tmp_path / 't-*.pkl'), 2,
                                         trainer)())


# -- batch, creators, decorators -------------------------------------------------

def _decorated(fluid, dataset):
    """name -> reader, the same decorators over the same seeded readers."""
    r = fluid.reader
    base = r.firstn(dataset.uci_housing.train(), 37)
    ids = r.creator.np_array(np.arange(37, dtype='int64'))
    return {
        'batch': fluid.batch(base, 8),
        'batch-drop_last': fluid.batch(base, 8, drop_last=True),
        'map_readers': r.map_readers(lambda s, i: (s[0] * i, s[1]), base,
                                     ids),
        'chain': r.chain(base, r.firstn(dataset.mnist.test(), 5)),
        'compose': r.compose(base, ids),
        'compose-unchecked': r.compose(base, r.firstn(ids, 30),
                                       check_alignment=False),
        'buffered': r.buffered(base, 4),
        'firstn': r.firstn(base, 11),
        'cache': r.cache(base),
        'xmap-ordered': r.xmap_readers(lambda s: (s[0] + 1.0, s[1]), base,
                                       3, 4, order=True),
        'np_array-2d': r.creator.np_array(np.arange(12.).reshape(4, 3)),
    }


@pytest.mark.parametrize('name', sorted(_decorated(jfluid, jdataset)))
def test_decorator_yields_the_jax_samples(name):
    before = tpipeline.leaked_threads()
    threads = threading.active_count()
    want = list(_decorated(jfluid, jdataset)[name]())
    got = _decorated(tfluid, tfluid.dataset)[name]
    _same_samples(want, got())
    _same_samples(want, got())          # a reader runs again from the start
    assert tpipeline.leaked_threads() == before
    assert threading.active_count() <= threads


def test_shuffle_with_one_seed_matches_jax():
    out = {}
    for key, fluid, dataset in (('j', jfluid, jdataset),
                                ('t', tfluid, tfluid.dataset)):
        random.seed(17)
        out[key] = list(fluid.reader.shuffle(
            fluid.reader.firstn(dataset.uci_housing.train(), 30), 8)())
    _same_samples(out['j'], out['t'])


@pytest.mark.parametrize('kind', ['xmap', 'multiprocess'])
def test_unordered_workers_give_the_jax_multiset(kind):
    def build(fluid, dataset):
        r = fluid.reader
        parts = [r.firstn(dataset.mnist.test(), 20),
                 r.firstn(dataset.mnist.train(), 15)]
        if kind == 'xmap':
            return r.xmap_readers(lambda s: (s[0] * 2.0, s[1]),
                                  r.chain(*parts), 4, 2)
        return r.multiprocess_reader(parts, queue_size=3)

    def key(s):
        return (s[1], np.asarray(s[0]).tobytes())
    before = tpipeline.leaked_threads()
    want = sorted(build(jfluid, jdataset)(), key=key)
    got = sorted(build(tfluid, tfluid.dataset)(), key=key)
    _same_samples(want, got)
    assert tpipeline.leaked_threads() == before


def test_workers_stop_when_the_consumer_stops_early():
    """Closing a decorated reader early joins its worker threads."""
    r = tfluid.reader
    endless = lambda: iter(lambda: (np.ones(3, 'f4'), 1), None)  # noqa: E731
    before = tpipeline.leaked_threads()
    threads = threading.active_count()
    for reader in (r.buffered(endless, 2),
                   r.xmap_readers(lambda s: s, endless, 3, 2, order=True),
                   r.multiprocess_reader([endless, endless], queue_size=2)):
        it = reader()
        assert [next(it) for _ in range(5)][-1][1] == 1
        it.close()
    assert threading.active_count() <= threads
    assert tpipeline.leaked_threads() == before


def test_reader_errors_reach_the_consumer():
    def broken():
        yield (np.zeros(2, 'f4'), 0)
        raise RuntimeError('source failed')
    r = tfluid.reader
    for reader in (r.buffered(broken, 2), r.xmap_readers(
            lambda s: s, broken, 2, 2), r.multiprocess_reader([broken])):
        with pytest.raises(RuntimeError, match='source failed'):
            list(reader())
    with pytest.raises(r.decorator.ComposeNotAligned):
        list(r.compose(r.creator.np_array(np.arange(3)),
                       r.creator.np_array(np.arange(4)))())


def test_text_file_and_pipe_reader_match_jax(tmp_path):
    from paddle_tpu.reader import creator as jcreator
    from paddle_tpu.reader import decorator as jdecorator
    path = tmp_path / 'lines.txt'
    path.write_text('alpha\nbeta gamma\n\ndelta\n')
    assert list(tfluid.reader.creator.text_file(str(path))()) == \
        list(jcreator.text_file(str(path))())
    cmd = 'cat %s' % path
    assert list(tfluid.reader.PipeReader(cmd).get_line()) == \
        list(jdecorator.PipeReader(cmd).get_line())
    # recordio over shards the JAX package's convert wrote
    shards = [(np.arange(3, dtype='f4') + i, i) for i in range(12)]
    jdataset.common.convert(str(tmp_path / 'rio'), lambda: iter(shards), 5,
                            'part')
    paths = sorted(str(p) for p in (tmp_path / 'rio').iterdir())
    got = list(tfluid.reader.creator.recordio(','.join(paths))())
    want = list(jcreator.recordio(paths)())
    assert len(got) == len(want) == 12
    for (ga, gi), (wa, wi) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        assert gi == wi


def _feeder_script(fluid, dataset):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        img = fluid.layers.data(name='img', shape=[1, 28, 28],
                                dtype='float32')
        lbl = fluid.layers.data(name='lbl', shape=[1], dtype='int64')
        words = fluid.layers.data(name='w', shape=[1], dtype='int64')
    feeder = fluid.DataFeeder(feed_list=[img, 'lbl'], place=fluid.CPUPlace(),
                              program=main)
    batch = next(fluid.batch(dataset.mnist.train(), 6)())
    parts = list(feeder.feed_parallel(batch, num_places=2))
    return feeder.feed(batch), parts, words


def test_data_feeder_matches_jax():
    want, jparts, _ = _feeder_script(jfluid, jdataset)
    got, tparts, _ = _feeder_script(tfluid, tfluid.dataset)
    assert sorted(got) == sorted(want) == ['img', 'lbl']
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
    assert got['img'].shape == (6, 1, 28, 28)
    assert got['lbl'].dtype == np.int64
    assert len(tparts) == len(jparts) == 2
    for t, j in zip(tparts, jparts):
        np.testing.assert_array_equal(t['img'], j['img'])


def test_data_feeder_refuses_lod_slots():
    """A LoD slot was refused until the port had LoD feeds; it now gives
    the JAX package's LoDTensor (tests/test_torch_lod.py holds the
    rest)."""
    got = {}
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            v = fluid.layers.data(name='w', shape=[1], dtype='int64')
        v.lod_level = 1
        feeder = fluid.DataFeeder(feed_list=[v], place=fluid.CPUPlace(),
                                  program=main)
        got[fluid] = feeder.feed([([1, 2, 3],), ([4],)])['w']
    assert got[tfluid].lod() == got[jfluid].lod() == [[0, 3, 4]]
    np.testing.assert_array_equal(got[tfluid].numpy(),
                                  got[jfluid].numpy())


# -- ops the chapters reach beside the sweep ----------------------------------------

def _random_bsl(seed):
    prog = tfluid.Program()
    prog.random_seed = seed
    with tfluid.program_guard(prog, tfluid.Program()):
        x = tfluid.layers.data(name='x', shape=[7], dtype='float32')
        u = tfluid.layers.uniform_random_batch_size_like(
            x, shape=[-1, 300], min=-2.0, max=3.0)
        g = tfluid.layers.gaussian_random_batch_size_like(
            x, shape=[200, -1], input_dim_idx=1, output_dim_idx=1,
            mean=1.0, std=0.5)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed={'x': np.zeros((64, 7), 'f4')}, fetch_list=[u, g],
        scope=tfluid.Scope())


def test_random_batch_size_like_draws():
    u, g = _random_bsl(3)
    u2, g2 = _random_bsl(3)
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(g, g2)
    assert u.shape == (64, 300) and g.shape == (200, 7)
    assert u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 0.05 and abs(u.std() - 5 / 12 ** 0.5) < 0.05
    assert abs(g.mean() - 1.0) < 0.02 and abs(g.std() - 0.5) < 0.02


def _deconv_net(fluid, unique_name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[3, 5, 5], dtype='float32')
            up = fluid.layers.conv2d_transpose(
                x, num_filters=3, filter_size=4, stride=2, padding=1,
                param_attr=fluid.ParamAttr(
                    initializer=fluid.initializer.Bilinear()),
                bias_attr=False)
            sized = fluid.layers.conv2d_transpose(x, num_filters=2,
                                                  output_size=9)
    return main, startup, up, sized


def test_bilinear_conv2d_transpose_matches_jax():
    jmain, jstartup, jup, jsized = _deconv_net(jfluid, junique_name)
    tmain, tstartup, tup, tsized = _deconv_net(tfluid, tunique_name)
    assert tmain.to_string() == jmain.to_string()
    assert tuple(tup.shape) == (-1, 3, 10, 10)
    assert tuple(tsized.shape) == (-1, 2, 9, 9)
    x = np.random.RandomState(2).rand(2, 3, 5, 5).astype('f4')
    want, got = _forward_from_jax(jmain, jstartup, [jup, jsized], tmain,
                                  [tup, tsized], {'x': x})
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # a bilinear filter doubles a constant image's interior exactly
    ones = np.ones((1, 3, 5, 5), 'f4')
    out, _ = _forward_from_jax(jmain, jstartup, [jup], tmain, [tup],
                               {'x': ones})
    np.testing.assert_allclose(got[0].shape, (2, 3, 10, 10))
    assert np.allclose(out[0][0, :, 2:-2, 2:-2], 3.0)


# -- nets and models --------------------------------------------------------------

def _forward_from_jax(jmain, jstartup, jouts, tmain, touts, feed):
    """Forward outputs of both programs from the JAX package's startup."""
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jstartup.list_vars() if v.persistable}
    want = jexe.run(jmain, feed=feed, fetch_list=jouts, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tmain)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=touts, scope=tscope)
    return [np.asarray(w) for w in want], [np.asarray(g) for g in got]


NETS = {
    'simple_img_conv_pool': lambda f, x: f.nets.simple_img_conv_pool(
        input=x, num_filters=4, filter_size=3, pool_size=2, pool_stride=2,
        act='relu'),
    'img_conv_group': lambda f, x: f.nets.img_conv_group(
        input=x, conv_num_filter=[4, 6], pool_size=2, pool_stride=2,
        conv_act='relu', conv_with_batchnorm=[True, False]),
    'glu': lambda f, x: f.nets.glu(f.layers.reshape(x, [-1, 3, 8, 4]),
                                   dim=2),
    'scaled_dot_product_attention': lambda f, x: (
        lambda q: f.nets.scaled_dot_product_attention(q, q, q, num_heads=4))(
            f.layers.reshape(x, [-1, 8, 12])),
    'scaled_dot_product_attention-1head': lambda f, x: (
        lambda q: f.nets.scaled_dot_product_attention(q, q, q))(
            f.layers.reshape(x, [-1, 12, 8])),
}


def _net_program(fluid, unique_name, name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[3, 8, 4], dtype='float32')
            out = NETS[name](fluid, x)
    return main, startup, out


@pytest.mark.parametrize('name', sorted(NETS))
def test_nets_match_jax(name):
    jmain, jstartup, jout = _net_program(jfluid, junique_name, name)
    tmain, tstartup, tout = _net_program(tfluid, tunique_name, name)
    assert tmain.to_string() == jmain.to_string()
    x = np.random.RandomState(4).randn(2, 3, 8, 4).astype('f4')
    (want,), (got,) = _forward_from_jax(jmain, jstartup, [jout], tmain,
                                        [tout], {'x': x})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sequence_conv_pool_waits_for_sequences():
    """sequence_conv_pool raised until the port had the sequence layers;
    it now builds the JAX package's Program (its steps:
    tests/test_torch_book_seq.py)."""
    progs = []
    for fluid, unique_name in ((jfluid, junique_name),
                               (tfluid, tunique_name)):
        with unique_name.guard():
            main = fluid.Program()
            with fluid.program_guard(main, fluid.Program()):
                x = fluid.layers.data(name='x', shape=[6], dtype='float32',
                                      lod_level=1)
                out = fluid.nets.sequence_conv_pool(x, 4, 3)
        assert tuple(out.shape) == (-1, 4) and out.lod_level == 0
        progs.append(main.to_string())
    assert progs[1] == progs[0]


MODELS = {
    'mnist-conv': (28, 1, lambda m, i, l: m['mnist'].train_network(i, l)),
    'mnist-mlp': (28, 1, lambda m, i, l: m['mnist'].train_network(
        i, l, nn_type='mlp')),
    'vgg16': (32, 3, lambda m, i, l: m['vgg'].train_network(
        i, l, class_dim=10)),
    'vgg19': (32, 3, lambda m, i, l: m['vgg'].train_network(
        i, l, class_dim=4, is_test=True, depth=19)),
    'alexnet': (67, 3, lambda m, i, l: m['alexnet'].train_network(
        i, l, class_dim=4)),
    'googlenet': (112, 3, lambda m, i, l: m['googlenet'].train_network(
        i, l, class_dim=4)),
    'googlenet-test': (64, 3, lambda m, i, l: m['googlenet'].train_network(
        i, l, class_dim=4, is_test=True)),
}


def _model_program(m, name):
    hw, ch, build = MODELS[name]
    fluid = m['fluid']
    with m['unique_name'].guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data(name='img', shape=[ch, hw, hw],
                                    dtype='float32')
            lbl = fluid.layers.data(name='lbl', shape=[1], dtype='int64')
            build(m, img, lbl)
    return main, startup


@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_programs_match_jax(name):
    jmain, jstartup = _model_program(J, name)
    tmain, tstartup = _model_program(T, name)
    assert tmain.to_string() == jmain.to_string()
    assert tstartup.to_string() == jstartup.to_string()


# -- the four chapters ------------------------------------------------------------

def _fit_a_line(m):
    L = m['fluid'].layers
    x = L.data(name='x', shape=[13], dtype='float32')
    y = L.data(name='y', shape=[1], dtype='float32')
    pred = L.fc(input=x, size=1, act=None)
    loss = L.mean(L.square_error_cost(input=pred, label=y))
    m['fluid'].optimizer.SGD(learning_rate=0.01).minimize(loss)
    return ['x', 'y'], pred, loss, \
        lambda d: d.uci_housing.train(), 16


def _recognize_digits(m):
    L = m['fluid'].layers
    img = L.data(name='img', shape=[1, 28, 28], dtype='float32')
    lbl = L.data(name='label', shape=[1], dtype='int64')
    pred, loss, _ = m['mnist'].train_network(img, lbl)
    m['fluid'].optimizer.Adam(learning_rate=0.001).minimize(loss)
    return ['img', 'label'], pred, loss, lambda d: d.mnist.train(), 8


def _narrow_vgg(fluid, img):
    """vgg.vgg_net's layers at 1/8 of its widths, two conv groups, and
    its head without the dropouts (the packages draw different masks)."""
    net = img
    for width in (8, 16):
        net = fluid.nets.img_conv_group(
            input=net, pool_size=2, pool_stride=2,
            conv_num_filter=[width] * 2, conv_filter_size=3,
            conv_act='relu', conv_with_batchnorm=True, pool_type='max')
    fc1 = fluid.layers.fc(input=net, size=64, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act='relu')
    fc2 = fluid.layers.fc(input=bn, size=64, act=None)
    return fluid.layers.fc(input=fc2, size=10, act='softmax')


def _image_classification(net):
    def chapter(m):
        L = m['fluid'].layers
        img = L.data(name='pixel', shape=[3, 32, 32], dtype='float32')
        lbl = L.data(name='label', shape=[1], dtype='int64')
        if net == 'resnet':
            pred = m['resnet'].resnet_cifar10(img, class_dim=10, depth=8)
        else:
            pred = _narrow_vgg(m['fluid'], img)
        loss = L.mean(L.cross_entropy(input=pred, label=lbl))
        m['fluid'].optimizer.Adam(learning_rate=0.001).minimize(loss)
        return ['pixel', 'label'], pred, loss, \
            lambda d: d.cifar.train10(), 4
    return chapter


def _word2vec(m):
    L = m['fluid'].layers
    dict_size = len(jdataset.imikolov.build_dict())
    names = ['firstw', 'secondw', 'thirdw', 'forthw', 'nextw']
    words = [L.data(name=n, shape=[1], dtype='int64') for n in names]
    embs = [L.embedding(input=w, size=[dict_size, 32],
                        param_attr=m['fluid'].ParamAttr(name='shared_w'))
            for w in words[:4]]
    concat = L.reshape(L.concat(input=embs, axis=-1), shape=[-1, 4 * 32])
    hidden = L.fc(input=concat, size=64, act='sigmoid')
    pred = L.fc(input=hidden, size=dict_size, act='softmax')
    loss = L.mean(L.cross_entropy(input=pred, label=words[4]))
    m['fluid'].optimizer.Adam(learning_rate=0.005).minimize(loss)
    return names, pred, loss, \
        lambda d: d.imikolov.train(d.imikolov.build_dict(), 5), 32


CHAPTERS = {'fit_a_line': _fit_a_line,
            'recognize_digits': _recognize_digits,
            'image_classification-resnet': _image_classification('resnet'),
            'image_classification-vgg': _image_classification('vgg'),
            'word2vec': _word2vec}


def _chapter(m, dataset, name, model_dir=None):
    """Build the chapter, feed STEPS batches through fluid.batch +
    DataFeeder; returns init persistables, losses, feeds, and the
    inference round trip's outputs when model_dir is given."""
    fluid = m['fluid']
    with m['unique_name'].guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 42
        with fluid.program_guard(main, startup):
            feed_names, pred, loss, reader, bs = CHAPTERS[name](m)
    return dict(main=main, startup=startup, feed_names=feed_names,
                pred=pred, loss=loss,
                batches=fluid.batch(reader(dataset), bs, drop_last=True),
                feeder=fluid.DataFeeder(feed_list=feed_names,
                                        place=fluid.CPUPlace(),
                                        program=main))


def _run_chapter(c, fluid, scope, init=None, model_dir=None):
    exe = fluid.Executor(fluid.CPUPlace())
    if init is None:
        exe.run(c['startup'], scope=scope)
        init = {v.name: np.array(scope.find_var(v.name))
                for v in c['startup'].list_vars() if v.persistable}
    else:
        fluid.io.load_numpy_params(scope, init, fluid.CPUPlace(),
                                   program=c['main'])
    losses, feeds = [], []
    for i, data in enumerate(c['batches']()):
        if i == STEPS:
            break
        feed = c['feeder'].feed(data)
        feeds.append(feed)
        l, = exe.run(c['main'], feed=feed, fetch_list=[c['loss']],
                     scope=scope)
        losses.append(float(np.asarray(l)))
    out = None
    if model_dir is not None:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(model_dir, [c['feed_names'][0]],
                                          [c['pred']], exe,
                                          main_program=c['main'])
            if fluid is tfluid:
                out = _round_trip(c, exe, model_dir, feeds[0])
    return init, losses, feeds, out


def _round_trip(c, exe, model_dir, feed):
    """The loaded inference program's outputs and the trained program's
    (cloned for test) on the first rows of a batch."""
    prog, feed_names, fetch = tfluid.io.load_inference_model(model_dir, exe)
    rows = {n: v[:3] for n, v in feed.items()}
    first = c['feed_names'][0]
    loaded = exe.run(prog, feed={feed_names[0]: rows[first]},
                     fetch_list=fetch)[0]
    direct = exe.run(c['main'].clone(for_test=True), feed=rows,
                     fetch_list=[c['pred']])[0]
    return np.asarray(loaded), np.asarray(direct)


@pytest.mark.parametrize('name', sorted(CHAPTERS))
def test_chapter_steps_match_jax(name, tmp_path):
    jc = _chapter(J, jdataset, name)
    tc = _chapter(T, tfluid.dataset, name)
    assert tc['main'].to_string() == jc['main'].to_string()
    round_trip = name in ('fit_a_line', 'image_classification-resnet')
    init, want, jfeeds, _ = _run_chapter(
        jc, jfluid, jfluid.Scope(),
        model_dir=str(tmp_path / 'j') if round_trip else None)
    _, got, tfeeds, tout = _run_chapter(
        tc, tfluid, tfluid.Scope(), init=init,
        model_dir=str(tmp_path / 't') if round_trip else None)
    assert len(got) == len(want) == STEPS
    for jf, tf in zip(jfeeds, tfeeds):
        for n in jf:
            np.testing.assert_array_equal(tf[n], jf[n])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.isfinite(got).all()
    if round_trip:
        loaded, direct = tout
        assert loaded.shape[0] == 3 and np.isfinite(loaded).all()
        np.testing.assert_allclose(loaded, direct, rtol=1e-5, atol=1e-6)
        assert sorted(os.listdir(str(tmp_path / 't'))) == \
            sorted(os.listdir(str(tmp_path / 'j')))


# -- flowers, voc2012, mq2007, image -------------------------------------------

LATER_READERS = {
    'flowers.train': (lambda d: d.flowers.train(), 24),
    'flowers.test': (lambda d: d.flowers.test(), 24),
    'flowers.valid': (lambda d: d.flowers.valid(use_xmap=False), 24),
    'voc2012.train': (lambda d: d.voc2012.train(), None),
    'voc2012.test': (lambda d: d.voc2012.test(), None),
    'voc2012.val': (lambda d: d.voc2012.val(), None),
    'mq2007.train-pairwise': (lambda d: d.mq2007.train(), None),
    'mq2007.test-pointwise': (lambda d: d.mq2007.test('pointwise'), None),
    'mq2007.train-listwise': (lambda d: d.mq2007.train('listwise'), None),
}


@pytest.mark.parametrize('name', sorted(LATER_READERS))
def test_later_dataset_reader_yields_the_jax_samples(name):
    """The same seeded synthetic samples bit for bit (flowers' first 24 of
    its 224 x 224 images)."""
    import itertools
    make, n = LATER_READERS[name]
    _same_samples(itertools.islice(make(jdataset)(), n),
                  itertools.islice(make(tfluid.dataset)(), n))


def test_image_transforms_match_jax():
    """dataset.image's transforms on a seeded image: the same arrays
    (random_crop from the same numpy generator; resize_short through
    Pillow)."""
    from paddle_tpu.dataset import image as jimage
    from paddle_tpu_torch.dataset import image as timage
    im = np.random.RandomState(3).randint(0, 256, (37, 53, 3)).astype(
        'uint8')
    for fn in (lambda m: m.to_chw(im), lambda m: m.center_crop(im, 20),
               lambda m: m.left_right_flip(im),
               lambda m: m.random_crop(im, 16,
                                       rng=np.random.RandomState(4)),
               lambda m: m.resize_short(im, 24),
               lambda m: m.simple_transform(im, 30, 24, True,
                                            mean=[1.0, 2.0, 3.0],
                                            rng=np.random.RandomState(5))):
        w, g = fn(jimage), fn(timage)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)
