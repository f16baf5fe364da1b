"""Readers (counterpart of paddle_tpu/reader/): the py_reader queue and
its device prefetch (pipeline.py), the reader decorators (decorator.py)
and the reader creators (creator.py)."""
from .pipeline import (PyReader, get_reader, EOFException,  # noqa: F401
                       leaked_threads)
from .decorator import (map_readers, buffered, shuffle, chain,  # noqa: F401
                        compose, firstn, xmap_readers, cache,
                        multiprocess_reader, PipeReader)
from . import creator  # noqa: F401

__all__ = ['map_readers', 'buffered', 'shuffle', 'chain', 'compose',
           'firstn', 'xmap_readers', 'cache', 'multiprocess_reader',
           'PipeReader', 'creator']
