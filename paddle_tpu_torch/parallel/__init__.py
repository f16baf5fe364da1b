"""Parallelism, one-device forms: the sharding annotations (api.py) and
the tensor- and sequence-parallel layers (layers.py)."""
from .api import shard_tensor, sharding_constraint  # noqa: F401
from . import layers  # noqa: F401
