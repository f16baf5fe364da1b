"""Data-input layers (counterpart of paddle_tpu/layers/io.py:14)."""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ['data']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=None, stop_gradient=True):
    """Declare a feed variable. With append_batch_size=True a leading -1
    batch dim is added. Sequence (lod_level > 0) feeds are not ported."""
    if lod_level:
        raise NotImplementedError('lod_level > 0 feeds are not ported')
    LayerHelper('data', name=name)
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    main_block = default_main_program().global_block()
    if main_block.has_var(name):
        return main_block.var(name)
    return main_block.create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        is_data=True, stop_gradient=stop_gradient)
