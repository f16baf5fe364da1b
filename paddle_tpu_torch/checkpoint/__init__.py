"""Checkpoint integrity (counterpart of paddle_tpu/checkpoint/): the
CHECKPOINT_DIGESTS manifest that io.save_vars writes and io.load_vars
verifies under FLAGS_ckpt_verify. The JAX package's sharded, elastic and
restore paths are multi-device work (ROADMAP.md, Queue 1 item 8)."""
from .manifest import CheckpointCorruptError, verify_digests, write_digests

__all__ = ['CheckpointCorruptError', 'verify_digests', 'write_digests']
