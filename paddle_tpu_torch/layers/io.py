"""Data-input layers (counterpart of paddle_tpu/layers/io.py: data :14,
py_reader :46, read_file :73, double_buffer :91, the file and random
readers :112-306, load :309)."""
from __future__ import annotations

from .. import unique_name
from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ['data', 'py_reader', 'read_file', 'double_buffer',
           'open_recordio_file', 'open_files', 'random_data_generator',
           'shuffle', 'batch', 'load', 'Send', 'Recv']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=None, stop_gradient=True):
    """Declare a feed variable. With append_batch_size=True a leading -1
    batch dim is added. A sequence var (lod_level > 0) is fed as a
    padded [B, T, ...] tensor, its runtime rank the declared rank plus
    one (the time axis at position 1), with a [B] int32 lengths
    companion `<name>@SEQ_LEN` attached as var.seq_lens; Executor.run
    expands a LoDTensor or a (padded, lengths) feed into the pair."""
    LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    main_block = default_main_program().global_block()
    if main_block.has_var(name):
        return main_block.var(name)
    var = main_block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        is_data=True, stop_gradient=stop_gradient)
    if lod_level > 0:
        var.seq_lens = main_block.create_var(
            name=name + '@SEQ_LEN', shape=[-1], dtype='int32',
            is_data=True, stop_gradient=True)
    return var


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Async Python-fed reader: a feeder thread pushes batches from a
    Python generator into a bounded queue; with use_double_buffer=True a
    placer thread copies them to the card ahead of the step
    (reader/pipeline.py). Call `decorate_tensor_provider(...)`, then
    `.start()`; catch
    fluid.core.EOFException from Executor.run at pass end and
    `.reset()`. Wire it into the program with read_file(reader)."""
    from ..reader.pipeline import PyReader
    if name is None:
        name = unique_name.generate('py_reader')
    block = default_main_program().global_block()
    # the reader appears in the program as a var; the runtime object
    # lives in the reader registry
    if not block.has_var(name):
        block.create_var(name=name, shape=(), dtype='float32',
                         persistable=False, stop_gradient=True)
    return PyReader(name, shapes, dtypes, lod_levels=lod_levels,
                    capacity=capacity, use_double_buffer=use_double_buffer)


def read_file(reader):
    """Pop one batch from a py_reader into fresh variables (the read op).
    Returns one Variable per slot."""
    block = default_main_program().global_block()
    outs = []
    for i, (shape, dtype, lod) in enumerate(
            zip(reader.shapes, reader.dtypes, reader.lod_levels)):
        v = block.create_var(
            name=unique_name.generate('%s_slot%d' % (reader.name, i)),
            shape=tuple(shape), dtype=dtype, lod_level=lod,
            is_data=True, stop_gradient=True)
        outs.append(v)
    block.append_op(type='read', inputs={},
                    outputs={'Out': [v.name for v in outs]},
                    attrs={'reader_name': reader.name})
    return outs if len(outs) > 1 else outs[0]


def double_buffer(reader, place=None, name=None):
    """Switch on the reader's ahead-of-step device copy; a place pins the
    target device."""
    reader.use_double_buffer = True
    if place is not None:
        reader.device = place.device
    return reader


# ---------------------------------------------------------------------------
# File and random readers (reference layers/io.py open_recordio_file,
# open_files, random_data_generator, shuffle, batch). The reference builds
# a chain of C++ reader ops; here the chain is a sample-generator pipeline
# that feeds the same PyReader queue and ahead-of-step device copy as
# py_reader, through its _source.
# ---------------------------------------------------------------------------

def _file_reader(sample_gen_creator, shapes, dtypes, lod_levels, name_hint,
                 pass_num=1):
    from ..reader.pipeline import PyReader
    name = unique_name.generate(name_hint)
    block = default_main_program().global_block()
    if not block.has_var(name):
        block.create_var(name=name, shape=(), dtype='float32',
                         persistable=False, stop_gradient=True)
    r = PyReader(name, shapes, dtypes, lod_levels=lod_levels)

    def multi_pass():
        for _ in range(pass_num) if pass_num > 0 else iter(int, 1):
            for s in sample_gen_creator():
                yield s
    r._sample_gen = multi_pass
    # the native decode readers hand whole chunks: batches are then array
    # slices instead of per-sample stacks (_set_batched_source)
    chunk_gen = getattr(sample_gen_creator, '_chunk_gen', None)
    r._chunk_gen = None
    if chunk_gen is not None:
        def multi_pass_chunks():
            for _ in range(pass_num) if pass_num > 0 else iter(int, 1):
                for c in chunk_gen():
                    yield c
        r._chunk_gen = multi_pass_chunks
    # a batch of 1 until batch() re-decorates
    _set_batched_source(r, 1)
    return r


def _set_batched_source(reader, batch_size, drop_last=True):
    from ..reader.pipeline import stack_samples
    reader._batch_size = batch_size
    reader._drop_last = drop_last
    chunk_gen = reader._chunk_gen

    if chunk_gen is not None and batch_size > 1:
        # chunk-level batching: a batch is a slice of a chunk's arrays
        # (a view where one chunk covers it, one concatenation where it
        # spans chunks), never a stack of per-sample copies
        import numpy as np

        def source():
            rem = None
            for slots in chunk_gen():
                slots = list(slots)
                if rem is not None:
                    slots = [np.concatenate([r, c])
                             for r, c in zip(rem, slots)]
                    rem = None
                n = slots[0].shape[0]
                off = 0
                while n - off >= batch_size:
                    yield [c[off:off + batch_size] for c in slots]
                    off += batch_size
                if off < n:
                    rem = [c[off:] for c in slots]
            if rem is not None and not drop_last:
                yield rem
        reader._source = source
        return

    def source():
        buf = []
        for sample in reader._sample_gen():
            buf.append(sample)
            if len(buf) == batch_size:
                yield stack_samples(buf, reader.dtypes)
                buf = []
        if buf and not drop_last:
            yield stack_samples(buf, reader.dtypes)
    reader._source = source


def open_recordio_file(filename, shapes, dtypes, lod_levels=None,
                       pass_num=1, for_parallel=None):
    """A reader over one RecordIO file (samples written by
    recordio.convert_reader_to_recordio_file)."""
    from .. import recordio as _recordio
    return _file_reader(_recordio.reader(filename), shapes, dtypes,
                        lod_levels, 'recordio_reader', pass_num)


def open_files(filenames, shapes, dtypes, lod_levels=None, pass_num=1,
               thread_num=1, buffer_size=None, for_parallel=None,
               image_norm=None):
    """A reader over many RecordIO files. thread_num > 1 reads through
    the native prefetcher (native/prefetcher.cc: file workers, chunk
    decode off the interpreter lock, one bounded queue); thread_num == 1
    scans the files in turn. pass_num <= 0 loops for ever.

    image_norm (thread_num > 1 only): dict(mean=[...], std=[...]) for
    shards whose records are (uint8 CHW image, int64 label): the native
    decode stage normalises the image to float32, (x/255 - mean) / std,
    on its workers, and batches are slices of its chunks. shapes[0] is
    the image shape [-1, C, H, W]. There is no Python decode to fall
    back to: a record of another form raises."""
    from .. import recordio as _recordio
    if image_norm is not None and not (thread_num and thread_num > 1):
        raise ValueError(
            'image_norm requires thread_num > 1 (the native decode '
            'stage); with thread_num=1 the u8 records would pass through '
            'unnormalised')
    if image_norm is not None:
        img_shape = tuple(int(d) for d in shapes[0][-3:])
        # buffer_size counts samples, as in the reference; the native
        # queue counts chunks (~1000 records each at the writer's
        # default), and decoded float chunks are large, so at most 16
        if buffer_size:
            capacity = max(2, min(16, -(-int(buffer_size) // 1000)))
        else:
            capacity = 8
        sample_gen = _recordio.parallel_image_reader(
            list(filenames), img_shape,
            mean=image_norm.get('mean'), std=image_norm.get('std'),
            n_threads=int(thread_num), capacity=capacity,
            loop=pass_num <= 0)
        return _file_reader(sample_gen, shapes, dtypes,
                            lod_levels, 'multi_file_reader',
                            1 if pass_num <= 0 else pass_num)
    if thread_num and thread_num > 1:
        # buffer_size in samples -> chunks, at the writer's default of
        # ~1000 records a chunk
        if buffer_size:
            capacity = max(2, min(256, -(-int(buffer_size) // 1000)))
        else:
            capacity = 64
        sample_gen = _recordio.parallel_reader(
            list(filenames), n_threads=int(thread_num),
            capacity=capacity)
    else:
        sample_gen = _recordio.reader(list(filenames))
    return _file_reader(sample_gen, shapes, dtypes,
                        lod_levels, 'multi_file_reader', pass_num)


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=None):
    """A reader of uniform random float32 samples, drawn from numpy's
    global generator as in the JAX package (a test fixture reader)."""
    import numpy as np
    dtypes = ['float32'] * len(shapes)

    def gen():
        while True:
            yield tuple(np.random.uniform(low, high, s).astype('float32')
                        for s in shapes)
    return _file_reader(gen, shapes, dtypes, lod_levels,
                        'random_data_reader', pass_num=1)


def shuffle(reader, buffer_size):
    """Shuffle a file reader's samples in buffers of `buffer_size`,
    drawing from Python's `random` as the JAX package does."""
    import random as _random
    inner = reader._sample_gen

    def gen():
        buf = []
        for s in inner():
            buf.append(s)
            if len(buf) >= buffer_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        _random.shuffle(buf)
        for b in buf:
            yield b
    reader._sample_gen = gen
    # the chunk fast path serves batches in file order: a shuffled reader
    # drops it
    reader._chunk_gen = None
    _set_batched_source(reader, reader._batch_size, reader._drop_last)
    return reader


def batch(reader, batch_size, drop_last=True):
    """Batch a file reader's samples (reference create_batch_reader)."""
    _set_batched_source(reader, batch_size, drop_last)
    return reader


def load(out, file_path, load_as_fp16=None):
    """Append a load op that restores `out` from a tensor file written
    by io.save_vars (a host step)."""
    helper = LayerHelper('load')
    attrs = {'file_path': file_path}
    if load_as_fp16 is not None:
        attrs['load_as_fp16'] = bool(load_as_fp16)
    helper.append_op(type='load', inputs={}, outputs={'Out': [out]},
                     attrs=attrs)
    return out


def Send(endpoints, send_vars, dummy_output=None, sync=True):
    """Ship variables to parameter servers (reference layers/io.py:212
    Send -> send_op): one epmap entry per var, optional send barrier."""
    if not isinstance(send_vars, list):
        raise TypeError('send_vars must be a list')
    helper = LayerHelper('Send')
    eps = endpoints.split(',') if isinstance(endpoints, str) \
        else list(endpoints)
    epmap = (eps * ((len(send_vars) + len(eps) - 1) // len(eps)))[
        :len(send_vars)]
    helper.append_op(type='send',
                     inputs={'X': [v for v in send_vars]},
                     outputs={},
                     attrs={'epmap': epmap})
    if sync:
        helper.append_op(type='send_barrier', inputs={}, outputs={},
                         attrs={'endpoints': sorted(set(epmap))})


def Recv(endpoints, get_vars, dummy_input=None, sync=True):
    """Pull variables from parameter servers (reference layers/io.py:256
    Recv -> recv_op). Returns get_vars."""
    if not isinstance(get_vars, list):
        raise TypeError('get_vars must be a list')
    helper = LayerHelper('Recv')
    eps = endpoints.split(',') if isinstance(endpoints, str) \
        else list(endpoints)
    epmap = (eps * ((len(get_vars) + len(eps) - 1) // len(eps)))[
        :len(get_vars)]
    helper.append_op(type='recv', inputs={},
                     outputs={'Out': [v for v in get_vars]},
                     attrs={'epmap': epmap})
    if sync:
        helper.append_op(type='fetch_barrier', inputs={}, outputs={},
                         attrs={'endpoints': sorted(set(epmap))})
    return get_vars
