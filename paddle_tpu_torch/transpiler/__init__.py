"""Program transpilers: the decode transpiler (serving) and the
inference transpiler (batch-norm folding)."""
from .decode_transpiler import (DecodeTranspileError, DecodePair,  # noqa: F401
                                DecodeTranspiler, extract_decode_spec)
from .inference_transpiler import InferenceTranspiler  # noqa: F401
