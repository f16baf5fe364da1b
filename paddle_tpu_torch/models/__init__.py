"""Model builders: only the transformer LM is ported so far."""
from . import transformer  # noqa: F401
