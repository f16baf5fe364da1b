"""The digest manifest of a checkpoint directory (counterpart of
paddle_tpu/checkpoint/manifest.py, the same file format).

`CHECKPOINT_DIGESTS` is a flat JSON map

    {"<relpath>": [crc32, size], ...}

over the payload files of the directory, written after they land. A
later load checks the files it reads against it, and so tells silent
corruption (a bad disk, a truncating copy, a stray write) from a clean
save. A failure raises CheckpointCorruptError naming the file and, when
the caller can say, the var it holds.
"""
from __future__ import annotations

import json
import os

from ..integrity import crc32_file

__all__ = ['DIGESTS_FILE', 'CheckpointCorruptError', 'crc32_file',
           'write_digests', 'read_digests', 'verify_digests',
           'verify_or_raise']

DIGESTS_FILE = 'CHECKPOINT_DIGESTS'

# never digested: commit markers and the manifest itself
_MARKERS = (DIGESTS_FILE, '_SUCCESS', 'COMMIT', 'OWNER')


class CheckpointCorruptError(RuntimeError):
    """A checkpoint payload does not match its recorded digest (or is
    missing). Carries the checkpoint dir, the offending relpath and, when
    the caller can name it, the var the file holds."""

    def __init__(self, reason, path=None, file=None, var=None):
        super(CheckpointCorruptError, self).__init__(reason)
        self.path = path
        self.file = file
        self.var = var


def _walk_payload_files(dirname):
    out = []
    for root, _dirs, files in os.walk(dirname):
        for fn in files:
            if fn in _MARKERS or fn.endswith('.crc'):
                continue
            out.append(os.path.relpath(os.path.join(root, fn), dirname))
    return out


def write_digests(dirname, files=None, merge=False):
    """Write (or, with merge=True, update) `<dirname>/CHECKPOINT_DIGESTS`
    over `files` (relpaths; default: every payload file of the dir).
    merge keeps the entries of files not in this batch, so
    save_inference_model's persistables and a later save into the same
    dir share one manifest."""
    if files is None:
        files = _walk_payload_files(dirname)
    digests = {}
    if merge:
        digests = read_digests(dirname) or {}
    for rel in files:
        crc, size = crc32_file(os.path.join(dirname, rel))
        digests[rel] = [crc, size]
    with open(os.path.join(dirname, DIGESTS_FILE), 'w') as f:
        json.dump(digests, f)
    return digests


def read_digests(dirname):
    """The manifest dict, or None when the dir has none."""
    path = os.path.join(dirname, DIGESTS_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def verify_digests(dirname, files=None, var_of=None):
    """None if every covered file matches its digest, else a reason
    naming the file (and its var, when `var_of(relpath)` can). `files`
    restricts the check to the files a load reads. A dir with no
    manifest verifies clean; a file the manifest never recorded is
    skipped."""
    try:
        digests = read_digests(dirname)
    except (OSError, ValueError) as e:
        return 'unreadable digest manifest: %r' % e
    if digests is None:
        return None

    def _name(rel):
        var = var_of(rel) if var_of is not None else None
        return '%s (var %s)' % (rel, var) if var else rel

    if files is None:
        files = sorted(digests)
    for rel in files:
        if rel not in digests:
            continue
        crc, size = digests[rel]
        fp = os.path.join(dirname, rel)
        if not os.path.exists(fp):
            return 'missing payload file %s' % _name(rel)
        got_crc, got_size = crc32_file(fp)
        if got_crc != int(crc) or got_size != int(size):
            return 'digest mismatch on %s' % _name(rel)
    return None


def verify_or_raise(dirname, files=None, var_of=None):
    """verify_digests, raising CheckpointCorruptError on failure."""
    reason = verify_digests(dirname, files=files, var_of=var_of)
    if reason is not None:
        file = var = None
        for rel in (files if files is not None
                    else sorted(read_digests(dirname) or {})):
            if rel in reason:
                file = rel
                var = var_of(rel) if var_of is not None else None
                break
        raise CheckpointCorruptError(
            'corrupt checkpoint %s: %s' % (dirname, reason),
            path=dirname, file=file, var=var)
