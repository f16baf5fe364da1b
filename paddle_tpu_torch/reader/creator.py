"""Reader creators (counterpart of paddle_tpu/reader/creator.py): build
readers from in-memory arrays and text files. Readers over RecordIO
files wait for the port's recordio module (ROADMAP.md Queue 1 item 7)."""
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
    raise NotImplementedError(
        'reader.creator.recordio needs the RecordIO files, which the port '
        'does not read yet (ROADMAP.md Queue 1 item 7)')
