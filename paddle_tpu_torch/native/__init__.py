"""Native (C++) runtime pieces of the port: the RecordIO chunk engine
(`recordio.cc`: framing, CRC32, deflate) and the multi-threaded
prefetcher with its image-decode stage (`prefetcher.cc`), copies of
paddle_tpu/native/'s sources, bound with ctypes.

Each library is compiled with g++ at first use into
`build/paddle_tpu_torch/native/<name>_<hash>.so` at the root of the
checkout, keyed by a hash of its source, so an edited source rebuilds
and an unchanged one is reused. Several processes (pytest workers) may
build at once: each compiles to its own temporary file and renames it
into place, which is atomic. A failed build raises; nothing falls back
to a Python reader. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ['load_library', 'BUILD_DIR']

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / 'build' / 'paddle_tpu_torch' / 'native'

_EXTRA_LIBS = {'recordio': ['-lz'],
               'prefetcher': ['-lz', '-pthread']}

_lock = threading.Lock()
_loaded = {}


def load_library(name):
    """Compile (if needed) and load native/<name>.cc; returns the CDLL."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = _DIR / (name + '.cc')
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so_path = BUILD_DIR / ('%s_%s.so' % (name, digest))
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix('.so.%d.tmp' % os.getpid())
            cmd = ['g++', '-O2', '-shared', '-fPIC', '-std=c++17', str(src),
                   '-o', str(tmp)] + _EXTRA_LIBS.get(name, [])
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError('building native library %r failed:\n%s'
                                   % (name, e.stderr)) from e
            except FileNotFoundError as e:
                raise RuntimeError('building native library %r needs g++, '
                                   'which is not on PATH' % name) from e
            os.replace(tmp, so_path)   # atomic: concurrent builds race safely
        lib = _loaded[name] = ctypes.CDLL(str(so_path))
        return lib
