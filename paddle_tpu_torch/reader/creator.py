"""Reader creators (counterpart of paddle_tpu/reader/creator.py): build
readers from in-memory arrays, text files and the RecordIO shards that
dataset.common.convert() writes."""
from __future__ import annotations

__all__ = ['np_array', 'text_file', 'recordio']


def np_array(x):
    """Reader over a numpy array: yields scalars of a vector, rows of
    a matrix — any sub-hyperplane indexed by the leading dim."""

    def reader():
        if x.ndim < 1:
            yield x
            return
        for e in x:
            yield e

    return reader


def text_file(path):
    """Reader yielding the file's lines with the trailing newline
    stripped."""

    def reader():
        with open(path, 'r') as f:
            for line in f:
                yield line.rstrip('\n')

    return reader


def recordio(paths, buf_size=100):
    """Reader over RecordIO files written by dataset.common.convert():
    yields the unpickled samples, read ahead `buf_size` deep
    (reader.decorator.buffered). `paths` is a path, a comma-separated
    list of paths or a sequence of paths."""
    import pickle

    from ..recordio import RecordIOScanner
    from .decorator import buffered

    if isinstance(paths, str):
        path_list = paths.split(',')
    else:
        path_list = list(paths)

    def reader():
        for path in path_list:
            with RecordIOScanner(path) as s:
                for rec in s:
                    yield pickle.loads(rec)

    return buffered(reader, buf_size)
