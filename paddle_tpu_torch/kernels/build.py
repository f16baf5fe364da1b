"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its
own, at first use, into `build/paddle_tpu_torch/<name>-<hash>.so` at the
root of the checkout. The hash covers the source and the flags, so an
edited source rebuilds and an unchanged one is reused. Nothing here runs
when the module is imported: the CPU tests import every module, and a
machine without nvcc never reaches a build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ['build', 'library', 'build_logs', 'CSRC_DIR', 'BUILD_DIR']

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR.parent / 'build' / 'paddle_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs = {}
# name -> nvcc's stderr (ptxas register / shared-memory / spill report)
build_logs = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found on PATH or under CUDA_HOME (%s); '
                       'the CUDA kernels need the CUDA toolkit' % home)


def _target(name):
    src = CSRC_DIR / (name + '.cu')
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS)
                            .encode()).hexdigest()[:16]
    return src, BUILD_DIR / ('%s-%s.so' % (name, digest))


def build(*names):
    """Compile every named source that is not built yet: one nvcc
    process per source, all started together. Returns {name: path}."""
    out, procs = {}, []
    with _lock:
        for name in names:
            src, so = _target(name)
            out[name] = so
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix('.so.tmp%d' % os.getpid())
            cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
            procs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, so, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append('%s (exit %d):\n%s'
                              % (name, proc.returncode, log))
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return out


def library(name):
    """The loaded shared library of csrc/<name>.cu, built if needed."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        path = build(name)[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib
