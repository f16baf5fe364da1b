"""RecordIO in the port (paddle_tpu_torch/recordio.py, native/*.cc,
layers.open_files and friends) against the JAX package's, on the CPU:
- tests/test_recordio.py's tests, run on the port: round trips, both
  compressors, corruption, sharding, py_reader training, the parallel
  scanner (multiset, per-file order, errors, loop mode) and the native
  image decode (numerics, the wrong record format, open_files training);
- a file the port writes is the JAX package's file for the same samples
  and chunk size, byte for byte; each package reads the other's files
  and verify_file agrees, also on a damaged file;
- open_files(thread_num=1) feeding 3 SGD steps of a small net matches
  the JAX package fed the same shards, within 1e-5; thread_num=4 with and
  without image_norm gives the same set of samples as the JAX package;
  a seeded shuffle gives the JAX package's order;
- the datasets' convert writes the JAX package's shards byte for byte
  (cifar, imikolov, mnist here; imdb, sentiment, movielens and conll05 in
  test_torch_lod.py; wmt14 and wmt16 in test_torch_book_mt.py);
- the native libraries build under build/paddle_tpu_torch/native/, and a
  build that fails raises.
"""
import collections
import os
import random

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import recordio as jrecordio
from paddle_tpu import unique_name as junique_name
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import native
from paddle_tpu_torch import recordio
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.reader.pipeline import EOFException


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


def _samples(n=25):
    rng = np.random.RandomState(0)
    for i in range(n):
        yield (rng.rand(4, 3).astype('float32'),
               np.asarray([i], 'int64'))


# -- tests/test_recordio.py, on the port ---------------------------------------

def test_write_scan_roundtrip(tmp_path):
    path = str(tmp_path / 'data.recordio')
    n = recordio.convert_reader_to_recordio_file(
        path, lambda: _samples(), max_num_records=10)
    assert n == 25
    got = list(recordio.reader(path)())
    want = list(_samples())
    assert len(got) == 25
    for (gx, gi), (wx, wi) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gi, wi)
        assert gx.dtype == wx.dtype and gi.dtype == wi.dtype


def test_no_compress_and_deflate_agree(tmp_path):
    p0 = str(tmp_path / 'raw.recordio')
    p1 = str(tmp_path / 'defl.recordio')
    recordio.convert_reader_to_recordio_file(
        p0, lambda: _samples(8), compressor=recordio.Compressor.NoCompress)
    recordio.convert_reader_to_recordio_file(
        p1, lambda: _samples(8), compressor=recordio.Compressor.Deflate)
    for a, b in zip(recordio.reader(p0)(), recordio.reader(p1)()):
        np.testing.assert_array_equal(a[0], b[0])


def test_compression_shrinks_compressible_data(tmp_path):
    p0 = str(tmp_path / 'raw.recordio')
    p1 = str(tmp_path / 'defl.recordio')

    def zeros():
        for _ in range(20):
            yield (np.zeros((64, 64), 'float32'),)
    recordio.convert_reader_to_recordio_file(
        p0, zeros, compressor=recordio.Compressor.NoCompress)
    recordio.convert_reader_to_recordio_file(
        p1, zeros, compressor=recordio.Compressor.Deflate)
    assert os.path.getsize(p1) < os.path.getsize(p0) / 10


def test_corruption_detected(tmp_path):
    path = str(tmp_path / 'data.recordio')
    recordio.convert_reader_to_recordio_file(
        path, lambda: _samples(5),
        compressor=recordio.Compressor.NoCompress)
    blob = bytearray(open(path, 'rb').read())
    blob[40] ^= 0xFF
    open(path, 'wb').write(bytes(blob))
    with pytest.raises(IOError, match='crc|corrupt|inflate'):
        list(recordio.reader(path)())


def test_not_a_recordio_file(tmp_path):
    path = str(tmp_path / 'junk')
    open(path, 'wb').write(b'this is not a recordio file at all')
    with pytest.raises(IOError, match='magic'):
        list(recordio.reader(path)())


def test_sharded_files_and_glob(tmp_path):
    base = str(tmp_path / 'shard.recordio')
    counts = recordio.convert_reader_to_recordio_files(
        base, 10, lambda: _samples(25))
    assert counts == [10, 10, 5]
    got = list(recordio.reader(base + '-*')())
    assert [int(s[1][0]) for s in got] == list(range(25))


def test_recordio_feeds_py_reader_training(tmp_path):
    path = str(tmp_path / 'train.recordio')
    rng = np.random.RandomState(1)
    w = rng.randn(8, 1).astype('float32')

    def samples():
        for _ in range(48):
            x = rng.randn(8).astype('float32')
            yield (x, (x @ w).astype('float32'))
    recordio.convert_reader_to_recordio_file(path, samples)
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        rd = tfluid.layers.py_reader(capacity=4, shapes=[[-1, 8], [-1, 1]],
                                     dtypes=['float32', 'float32'],
                                     name='rio_r', use_double_buffer=True)
        x, y = tfluid.layers.read_file(rd)
        pred = tfluid.layers.fc(input=x, size=1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    rd.decorate_paddle_reader(tfluid.batch(recordio.reader(path),
                                           batch_size=16))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    losses = []
    for _ in range(12):
        rd.start()
        while True:
            try:
                l, = exe.run(prog, fetch_list=[loss])
                losses.append(float(np.asarray(l)))
            except EOFException:
                rd.reset()
                break
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def _record_shards(tmp_path, n_files=6, n_rec=23, per_chunk=7):
    rng = np.random.RandomState(0)
    expected = collections.Counter()
    paths = []
    for i in range(n_files):
        p = str(tmp_path / ('shard-%d' % i))
        paths.append(p)
        with recordio.RecordIOWriter(p, max_num_records=per_chunk) as w:
            for r in range(n_rec):
                rec = ('f%d-r%03d-' % (i, r)).encode() + \
                    rng.bytes(rng.randint(1, 200))
                w.append_record(rec)
                expected[rec] += 1
    return paths, expected


def test_parallel_scanner_reads_all_shards(tmp_path):
    paths, expected = _record_shards(tmp_path)
    got = collections.Counter()
    per_file_order = collections.defaultdict(list)
    with recordio.ParallelRecordIOScanner(paths, n_threads=3) as sc:
        for rec in sc:
            got[rec] += 1
            per_file_order[rec.split(b'-')[0]].append(rec[:8])
    assert got == expected
    for i in range(6):
        tags = per_file_order[('f%d' % i).encode()]
        assert tags == sorted(tags), tags[:5]


def test_parallel_reader_decodes_samples(tmp_path):
    path = str(tmp_path / 'samples')
    rng = np.random.RandomState(1)
    samples = [(rng.rand(3, 4).astype('f4'), np.array([i], 'int64'))
               for i in range(10)]
    recordio.convert_reader_to_recordio_file(path, lambda: iter(samples))
    seen = {}
    for x, y in recordio.parallel_reader([path], n_threads=2)():
        seen[int(y[0])] = x
    assert len(seen) == 10
    for i, (x, _) in enumerate(samples):
        np.testing.assert_allclose(seen[i], x)


def test_parallel_scanner_error_paths(tmp_path):
    with pytest.raises(IOError):
        with recordio.ParallelRecordIOScanner(
                [str(tmp_path / 'nope')]) as sc:
            next(iter(sc))
    bad = tmp_path / 'bad'
    bad.write_bytes(b'Z' * 64)
    with pytest.raises(IOError):
        with recordio.ParallelRecordIOScanner([str(bad)]) as sc:
            for _ in sc:
                pass


def test_parallel_scanner_loop_mode_continues_past_one_epoch(tmp_path):
    p = str(tmp_path / 'loop-shard')
    with recordio.RecordIOWriter(p, max_num_records=4) as w:
        for r in range(10):
            w.append_record(b'rec-%03d' % r)
    sc = recordio.ParallelRecordIOScanner([p], n_threads=2, loop=True)
    got = [next(sc) for _ in range(35)]
    sc.close()
    assert sum(1 for g in got if g == b'rec-000') >= 3


def image_shards(dirname, writer, n_files=2, n_rec=64, shape=(3, 8, 8),
                 per_chunk=16, seed=0):
    """u8 CHW images with int64 labels unique across files (the labels
    double as record ids), written with `writer` (either package's
    RecordIOWriter). Returns (paths, {label: u8 image})."""
    rng = np.random.RandomState(seed)
    paths, images = [], {}
    for f in range(n_files):
        p = os.path.join(dirname, 'img%d.recordio' % f)
        with writer(p, max_num_records=per_chunk) as w:
            imgs = rng.randint(0, 256, (n_rec,) + shape, dtype='uint8')
            labels = (np.arange(n_rec) + f * n_rec).astype('int64')
            for i in range(n_rec):
                w.append_sample([imgs[i], labels[i:i + 1]])
                images[int(labels[i])] = imgs[i]
        paths.append(p)
    return paths, images


MEAN, STD = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]


def normalize(u8, mean=MEAN, std=STD):
    m = np.asarray(mean, 'f4').reshape(-1, 1, 1)
    s = np.asarray(std, 'f4').reshape(-1, 1, 1)
    return (u8.astype('f4') / 255.0 - m) / s


def test_native_decode_matches_python_normalize(tmp_path):
    shape = (3, 8, 8)
    paths, images = image_shards(str(tmp_path), recordio.RecordIOWriter,
                                 shape=shape)
    got = {}
    with recordio.ParallelImageScanner(paths, shape, mean=MEAN, std=STD,
                                       n_threads=2, capacity=4) as sc:
        for imgs, labels in sc:
            for i in range(imgs.shape[0]):
                got[int(labels[i])] = imgs[i].copy()
    assert sorted(got) == sorted(images)
    for label, u8 in images.items():
        np.testing.assert_allclose(got[label], normalize(u8), rtol=1e-5,
                                   atol=1e-6)


def test_native_decode_rejects_the_wrong_record_format(tmp_path):
    p = str(tmp_path / 'bad.recordio')
    with recordio.RecordIOWriter(p) as w:
        w.append_sample([np.zeros((3, 4, 4), 'f4'), np.zeros((1,), 'int64')])
    with pytest.raises(IOError):
        with recordio.ParallelImageScanner([p], (3, 4, 4)) as sc:
            list(sc)


def test_open_files_image_norm_trains(tmp_path):
    shape = (3, 8, 8)
    paths, _ = image_shards(str(tmp_path), recordio.RecordIOWriter,
                            shape=shape)
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        rdr = tfluid.layers.open_files(
            paths, shapes=[(-1,) + shape, (-1, 1)],
            dtypes=['float32', 'int64'], thread_num=2, pass_num=2,
            image_norm=dict(mean=[0.5, 0.5, 0.5], std=[0.25, 0.25, 0.25]))
        rdr = tfluid.layers.batch(rdr, batch_size=16)
        img, label = tfluid.layers.read_file(rdr)
        c = tfluid.layers.conv2d(img, 4, 3, padding=1)
        pool = tfluid.layers.pool2d(c, pool_type='avg', global_pooling=True)
        pred = tfluid.layers.fc(pool, size=128, act='softmax')
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, label))
        tfluid.optimizer.SGD(0.01).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    rdr.start()
    losses = []
    try:
        for _ in range(6):
            l, = exe.run(prog, fetch_list=[loss])
            losses.append(float(np.asarray(l)))
    finally:
        rdr.reset()
    assert np.isfinite(losses).all()


def test_open_files_image_norm_needs_threads(tmp_path):
    with pytest.raises(ValueError, match='thread_num > 1'):
        tfluid.layers.open_files([str(tmp_path / 'x')],
                                 shapes=[(-1, 3, 8, 8), (-1, 1)],
                                 dtypes=['float32', 'int64'],
                                 image_norm=dict(mean=MEAN, std=STD))


# -- the two packages' files ----------------------------------------------------

@pytest.mark.parametrize('compressor', ['NoCompress', 'Deflate'])
@pytest.mark.parametrize('per_chunk', [1, 7, 1000])
def test_the_ports_file_is_the_jax_packages(tmp_path, compressor, per_chunk):
    t_path, j_path = str(tmp_path / 't.rio'), str(tmp_path / 'j.rio')
    recordio.convert_reader_to_recordio_file(
        t_path, lambda: _samples(25),
        getattr(recordio.Compressor, compressor), per_chunk)
    jrecordio.convert_reader_to_recordio_file(
        j_path, lambda: _samples(25),
        getattr(jrecordio.Compressor, compressor), per_chunk)
    assert open(t_path, 'rb').read() == open(j_path, 'rb').read()
    base = str(tmp_path / 'shards')
    assert recordio.convert_reader_to_recordio_files(
        base + 't', 10, lambda: _samples(25)) == \
        jrecordio.convert_reader_to_recordio_files(
            base + 'j', 10, lambda: _samples(25)) == [10, 10, 5]
    for i in range(3):
        assert open('%st-%05d' % (base, i), 'rb').read() == \
            open('%sj-%05d' % (base, i), 'rb').read()


def test_each_package_reads_the_others_files(tmp_path):
    t_path, j_path = str(tmp_path / 't.rio'), str(tmp_path / 'j.rio')
    with recordio.RecordIOWriter(t_path, max_num_records=4) as w:
        for s in _samples(10):
            w.append_sample(s)
        w.append_record(b'raw bytes')
    with jrecordio.RecordIOWriter(j_path, max_num_records=4) as w:
        for s in _samples(10):
            w.append_sample(s)
        w.append_record(b'raw bytes')
    for path in (t_path, j_path):
        assert list(recordio.RecordIOScanner(path)) == \
            list(jrecordio.RecordIOScanner(path))
        assert recordio.verify_file(path) == jrecordio.verify_file(path) \
            == (3, 11)
    # (the samples first: zip stops before the reader meets the raw
    # record, which is no sample)
    for want, got in zip(_samples(10), recordio.reader(j_path)()):
        np.testing.assert_array_equal(got[0], want[0])
    # a damaged file: both auditors name the same chunk
    blob = bytearray(open(t_path, 'rb').read())
    blob[-3] ^= 0x55
    open(t_path, 'wb').write(bytes(blob))
    msgs = []
    for mod in (recordio, jrecordio):
        with pytest.raises(IOError) as e:
            mod.verify_file(t_path)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _sgd_net(fluid, paths, thread_num):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        rdr = fluid.layers.open_files(paths, shapes=[(-1, 8), (-1, 1)],
                                      dtypes=['float32', 'float32'],
                                      thread_num=thread_num)
        rdr = fluid.layers.batch(rdr, batch_size=6)
        x, y = fluid.layers.read_file(rdr)
        h = fluid.layers.fc(input=x, size=16, act='tanh')
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, rdr, loss


def test_open_files_trains_three_sgd_steps_like_jax(tmp_path):
    rng = np.random.RandomState(3)
    w = rng.randn(8, 1).astype('f4')
    paths = []
    for f in range(2):
        p = str(tmp_path / ('xy%d.rio' % f))
        xs = rng.randn(9, 8).astype('f4')
        jrecordio.convert_reader_to_recordio_file(
            p, lambda xs=xs: ((x, (x @ w).astype('f4')) for x in xs),
            max_num_records=4)
        paths.append(p)
    results = {}
    for fluid, un in ((jfluid, junique_name), (tfluid, tunique_name)):
        with un.guard():
            prog, startup, rdr, loss = _sgd_net(fluid, paths, 1)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            params = [v.name for v in startup.list_vars() if v.persistable]
            if fluid is tfluid:
                tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace())
            else:
                init = {n: np.asarray(scope.find_var(n)) for n in params}
            rdr.start()
            losses = [float(np.asarray(exe.run(prog, fetch_list=[loss])[0]))
                      for _ in range(3)]
            with pytest.raises(Exception, match='EOF|pass end'):
                exe.run(prog, fetch_list=[loss])
            rdr.reset()
            results[fluid] = (losses, {n: np.asarray(scope.find_var(n))
                                       for n in params})
    (jl, jp), (tl, tp) = results[jfluid], results[tfluid]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-5)


def _sample_set(batches, n_slots=2):
    out = collections.Counter()
    for b in batches:
        for i in range(len(b[0])):
            out[tuple(np.asarray(b[s][i]).tobytes()
                      for s in range(n_slots))] += 1
    return out


def test_threaded_readers_give_the_jax_packages_samples(tmp_path):
    # plain samples: four threads or one, either package
    paths = []
    for f in range(4):
        p = str(tmp_path / ('s%d.rio' % f))
        jrecordio.convert_reader_to_recordio_file(
            p, lambda f=f: ((np.full(3, 10 * f + i, 'f4'),
                             np.asarray([10 * f + i], 'int64'))
                            for i in range(9)), max_num_records=4)
        paths.append(p)
    sets = []
    for fluid in (jfluid, tfluid):
        for threads in (1, 4):
            with fluid.program_guard(fluid.Program(), fluid.Program()):
                rdr = fluid.layers.open_files(
                    paths, shapes=[(-1, 3), (-1, 1)],
                    dtypes=['float32', 'int64'], thread_num=threads)
                rdr = fluid.layers.batch(rdr, batch_size=4, drop_last=False)
            sets.append(_sample_set(rdr._source()))
    assert all(s == sets[0] for s in sets) and sum(sets[0].values()) == 36
    # u8 images under image_norm: the native decode of both packages
    shape = (3, 8, 8)
    ipaths, images = image_shards(str(tmp_path), recordio.RecordIOWriter,
                                  n_files=3, n_rec=40, shape=shape,
                                  per_chunk=8)
    want = _sample_set([[np.stack([normalize(u) for u in images.values()]),
                         np.asarray(list(images), 'int64').reshape(-1, 1)]])
    for fluid in (jfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            rdr = fluid.layers.open_files(
                ipaths, shapes=[(-1,) + shape, (-1, 1)],
                dtypes=['float32', 'int64'], thread_num=4,
                image_norm=dict(mean=MEAN, std=STD))
            rdr = fluid.layers.batch(rdr, batch_size=16, drop_last=False)
        batches = list(rdr._source())
        assert [len(b[0]) for b in batches] == [16] * 7 + [8]
        got = _sample_set(batches)
        assert sorted(got) == sorted(want) or _close_sets(got, want)


def _close_sets(got, want):
    """The normalised images within 1e-6 of numpy's, matched by label."""
    def by_label(s):
        return {np.frombuffer(k[1], 'int64')[0]: np.frombuffer(k[0], 'f4')
                for k in s}
    g, w = by_label(got), by_label(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)
    return True


def test_seeded_shuffle_gives_the_jax_packages_order(tmp_path):
    path = str(tmp_path / 'order.rio')
    jrecordio.convert_reader_to_recordio_file(
        path, lambda: ((np.asarray([i], 'int64'),) for i in range(50)),
        max_num_records=8)
    orders = []
    for fluid in (jfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            rdr = fluid.layers.open_recordio_file(
                path, shapes=[(-1, 1)], dtypes=['int64'], pass_num=2)
            rdr = fluid.layers.shuffle(rdr, buffer_size=16)
            rdr = fluid.layers.batch(rdr, batch_size=5)
        random.seed(1234)
        orders.append([int(v) for b in rdr._source() for v in b[0].ravel()])
    assert orders[0] == orders[1]
    assert len(orders[1]) == 100 and orders[1] != list(range(50)) * 2
    assert sorted(orders[1]) == sorted(list(range(50)) * 2)


def test_random_data_generator_draws_as_the_jax_package():
    draws = []
    for fluid in (jfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            rdr = fluid.layers.random_data_generator(
                -1.0, 2.0, shapes=[(2, 3), (4,)])
            rdr = fluid.layers.batch(rdr, batch_size=3)
        np.random.seed(7)
        src = rdr._source()
        draws.append([next(src) for _ in range(2)])
    for jb, tb in zip(*draws):
        for ja, ta in zip(jb, tb):
            np.testing.assert_array_equal(ta, ja)
            assert ta.dtype == np.float32 and ta.shape[0] == 3


@pytest.mark.parametrize('name', ['cifar', 'imikolov', 'mnist'])
def test_dataset_convert_writes_the_jax_packages_shards(tmp_path, name):
    tdir, jdir = tmp_path / 't', tmp_path / 'j'
    getattr(tfluid.dataset, name).convert(str(tdir))
    getattr(jfluid.dataset, name).convert(str(jdir))
    files = sorted(os.listdir(tdir))
    assert files and files == sorted(os.listdir(jdir))
    for f in files:
        assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f
    # and reads back through reader.creator.recordio
    first = str(tdir / files[0])
    got = list(tfluid.reader.creator.recordio(first)())
    want = list(jfluid.reader.creator.recordio(first)())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# -- exports, the build ---------------------------------------------------------

def test_exports_match_the_jax_package():
    for name in ('recordio', 'recordio_writer', 'make_channel', 'Go',
                 'convert_reader_to_recordio_file',
                 'convert_reader_to_recordio_files'):
        assert hasattr(jfluid, name) and hasattr(tfluid, name), name
    assert set(recordio.__all__) == set(jrecordio.__all__)
    assert set(tfluid.recordio_writer.__all__) == \
        set(jfluid.recordio_writer.__all__)
    for name in ('ParallelImageScanner', 'parallel_image_reader'):
        assert callable(getattr(recordio, name))


def test_native_libraries_build_in_the_checkouts_build_dir():
    recordio._lib()
    recordio._prefetch_lib()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, 'build', 'paddle_tpu_torch', 'native')
    assert os.path.samefile(str(native.BUILD_DIR), want)
    built = sorted(f for f in os.listdir(want) if f.endswith('.so'))
    assert any(f.startswith('recordio_') for f in built)
    assert any(f.startswith('prefetcher_') for f in built)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'broken.cc'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, '_DIR', tmp_path)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='broken.*failed'):
        native.load_library('broken')
    assert 'broken' not in native._loaded
