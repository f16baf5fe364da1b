"""Parallelism: only the single-device sharding_constraint is ported."""
from .api import sharding_constraint  # noqa: F401
