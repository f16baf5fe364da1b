"""contrib.decoder (counterpart of paddle_tpu/contrib/decoder/)."""
from . import beam_search_decoder  # noqa: F401
