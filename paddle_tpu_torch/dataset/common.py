"""Dataset plumbing (counterpart of paddle_tpu/dataset/common.py): the
cache dir, md5 checks, and the synthetic-data convention of every
dataset module. synthetic_rng hashes the same '<module>/<split>' strings
as the JAX package, so both packages serve the same samples. convert()
writes a reader's samples to RecordIO shards, as the JAX package's does."""
from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = ['DATA_HOME', 'md5file', 'synthetic_rng',
           'split', 'cluster_files_reader', 'convert']

DATA_HOME = os.path.expanduser('~/.cache/paddle_tpu/dataset')


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)
    return path


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, 'rb') as f:
        for chunk in iter(lambda: f.read(4096), b''):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """A file placed under DATA_HOME by hand is used; nothing is fetched,
    so anything else raises and the dataset modules serve synthetic
    data."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name or url.split('/')[-1])
    if os.path.exists(filename):
        return filename
    raise IOError(
        'no network egress: %s not cached under %s (synthetic data is '
        'served instead by the dataset module)' % (url, dirname))


def synthetic_rng(module_name, split):
    """Deterministic per-(dataset, split) generator."""
    seed = int(hashlib.md5(
        ('%s/%s' % (module_name, split)).encode()).hexdigest()[:8], 16)
    return np.random.RandomState(seed)


def split(reader, line_count, suffix='%05d.pickle', dumper=None):
    """Chunk a reader's samples into pickled files of `line_count`
    samples each. `suffix` must contain a %d-style slot for the chunk
    index."""
    import pickle
    dumper = dumper if dumper is not None else pickle.dump
    if not callable(dumper):
        raise TypeError('dumper should be callable.')
    lines = []
    indx_f = 0

    def flush():
        nonlocal lines, indx_f
        with open(suffix % indx_f, 'wb') as f:
            dumper(lines, f)
        lines = []
        indx_f += 1

    for d in reader():
        lines.append(d)
        if len(lines) >= line_count:
            flush()
    if lines:
        flush()


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Reader over the chunk files written by split(), taking every
    trainer_count-th file starting at trainer_id."""
    import glob
    import pickle
    loader = loader if loader is not None else pickle.load

    def reader():
        if not callable(loader):
            raise TypeError('loader should be callable.')
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count == trainer_id:
                with open(fn, 'rb') as f:
                    for line in loader(f):
                        yield line

    return reader


def convert(output_path, reader, line_count, name_prefix):
    """Write a reader's samples to RecordIO shard files of `line_count`
    pickled records each, `<output_path>/<name_prefix>-00000`, ...
    (every dataset module's convert(path) comes here). Read them back
    with reader.creator.recordio(paths)."""
    import pickle
    from ..recordio import RecordIOWriter
    if line_count < 1:
        raise ValueError('line_count must be at least 1')
    must_mkdirs(output_path)
    indx_f = 0
    lines = []

    def write_chunk():
        nonlocal lines, indx_f
        filename = '%s/%s-%05d' % (output_path, name_prefix, indx_f)
        with RecordIOWriter(filename) as w:
            for line in lines:
                w.append_record(pickle.dumps(
                    line, protocol=pickle.HIGHEST_PROTOCOL))
        lines = []
        indx_f += 1

    for d in reader():
        lines.append(d)
        if len(lines) >= line_count:
            write_chunk()
    if lines:
        write_chunk()
