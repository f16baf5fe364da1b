"""Data-input layers (counterpart of paddle_tpu/layers/io.py: data :14,
py_reader :46, read_file :73, double_buffer :91, load :309)."""
from __future__ import annotations

from .. import unique_name
from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ['data', 'py_reader', 'read_file', 'double_buffer', 'load']


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
