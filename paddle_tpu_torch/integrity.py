"""One CRC32 definition for every layer of the port (counterpart of
paddle_tpu/integrity.py, copied: it is plain Python).

The native recordio writer (`native/recordio.cc`) checksums each chunk
with zlib's crc32 over the raw payload; the pure-Python recordio auditor
(`recordio.verify_file`), the checkpoint digests
(`checkpoint/manifest.py`) and the statefile sidecars
(`distributed/statefile.py`) use the same definition, so there is one
answer to "which checksum?".
"""
from __future__ import annotations

import zlib

__all__ = ['crc32', 'crc32_file']

_CHUNK = 1 << 20


def crc32(data, value=0):
    """zlib.crc32 as an unsigned 32-bit int. `value` chains calls:
    crc32(b, crc32(a)) == crc32(a + b)."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def crc32_file(path):
    """Streaming crc32 over a file's bytes -> (crc, size)."""
    crc, size = 0, 0
    with open(path, 'rb') as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                return crc, size
            crc = crc32(block, crc)
            size += len(block)
