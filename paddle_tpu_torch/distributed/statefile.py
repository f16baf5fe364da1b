"""Atomic on-disk state files, digests and quarantine (counterpart of
paddle_tpu/distributed/statefile.py, copied: it is plain Python).

A durable state file is written the same way everywhere: the full new
state goes to a temp file in the destination directory, is fsynced, then
`os.replace`d over the target. A reader therefore always sees either the
previous complete state or the new complete state, never a torn file,
and a crash mid-write leaves the previous state intact.

Atomicity protects against *torn* files; it does nothing against
*corrupt* ones (a bad disk, a truncating copy, a stray write). For that
a payload gets a content-digest sidecar (`<path>.crc`: crc32 + size,
written after the payload lands) that `verify_digest` checks before a
load, and `quarantine` renames a file that fails verification aside
(`<path>.corrupt`), loudly, leaving the bytes on disk for post-mortem,
so recovery falls back to an older generation instead of loading
garbage. `quarantine_dir` does the same for a whole checkpoint
directory (the Trainer's resume). The crc32 is the port's one
definition (integrity.py `crc32_file`, the JAX package's).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

from ..integrity import crc32_file


@contextlib.contextmanager
def atomic_replace(path, mode='wb'):
    """Context manager yielding an open temp-file handle; on clean exit
    the temp file is fsynced and atomically renamed onto `path`, on
    exception it is removed and `path` is untouched.

    The temp name carries the pid so two processes racing to snapshot
    the same path (a restarted role overlapping its zombie) cannot
    interleave writes; last `os.replace` wins with a complete file.
    """
    tmp = '%s.%d.tmp' % (path, os.getpid())
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path, obj):
    with atomic_replace(path, 'w') as f:
        json.dump(obj, f)


def read_json(path, default=None):
    """Load a JSON state file; `default` if it does not exist yet."""
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# content digests + quarantine
# ---------------------------------------------------------------------------

def digest_path(path):
    return path + '.crc'


def write_digest(path):
    """Write `<path>.crc` = {"crc32", "size"} for the current contents
    of `path`. Written AFTER the payload is in place: a crash in the
    window leaves a payload without a sidecar, which verify_digest
    reports as 'missing' (accepted with a warning), never 'mismatch'."""
    crc, size = crc32_file(path)
    atomic_write_json(digest_path(path), {'crc32': crc, 'size': size})


def verify_digest(path):
    """-> 'ok' | 'missing' (no sidecar — pre-digest file or a crash
    between payload and sidecar writes) | 'mismatch' (the payload does
    not match its recorded digest: corrupt, quarantine it)."""
    want = read_json(digest_path(path))
    if not isinstance(want, dict) or 'crc32' not in want:
        return 'missing'
    crc, size = crc32_file(path)
    if crc != int(want['crc32']) or size != int(want.get('size', size)):
        return 'mismatch'
    return 'ok'


def move_with_digest(src, dst):
    """os.replace `src` -> `dst`, carrying its digest sidecar along (or
    removing a stale sidecar at `dst` if `src` has none)."""
    os.replace(src, dst)
    sp, dp = digest_path(src), digest_path(dst)
    if os.path.exists(sp):
        os.replace(sp, dp)
    else:
        try:
            os.remove(dp)
        except OSError:
            pass


def quarantine_dir(path, reason):
    """Directory flavor of `quarantine`: rename a corrupt checkpoint
    directory aside to `<path>.corrupt` (suffixed `-N` if that name is
    taken) so recovery can fall back to an older generation while the
    bytes stay on disk for post-mortem. Returns the quarantine path, or
    None if the dir vanished underneath us."""
    qpath = path + '.corrupt'
    n = 0
    while os.path.exists(qpath):
        n += 1
        qpath = '%s.corrupt-%d' % (path, n)
    try:
        os.replace(path, qpath)
    except OSError as e:
        sys.stderr.write('WARNING: could not quarantine dir %s (%s): %s\n'
                         % (path, reason, e))
        return None
    from ..obs import telemetry
    telemetry.counter('ps.snapshot.quarantines').inc()
    sys.stderr.write('WARNING: quarantined corrupt checkpoint dir %s -> %s '
                     '(%s); kept for post-mortem\n' % (path, qpath, reason))
    sys.stderr.flush()
    return qpath


def quarantine(path, reason):
    """Rename a corrupt file (and its sidecar) aside to `<path>.corrupt`
    — loudly. The bytes stay on disk for post-mortem; the original name
    is freed so recovery can rebuild it. Returns the quarantine path,
    or None if the file vanished underneath us."""
    qpath = path + '.corrupt'
    try:
        move_with_digest(path, qpath)
    except OSError as e:
        sys.stderr.write('WARNING: could not quarantine %s (%s): %s\n'
                         % (path, reason, e))
        return None
    from ..obs import telemetry
    telemetry.counter('ps.snapshot.quarantines').inc()
    sys.stderr.write('WARNING: quarantined corrupt file %s -> %s (%s); '
                     'kept for post-mortem\n' % (path, qpath, reason))
    sys.stderr.flush()
    return qpath
