"""Program transpilers: only the decode transpiler is ported so far."""
from .decode_transpiler import (DecodeTranspileError, DecodePair,  # noqa: F401
                                DecodeTranspiler, extract_decode_spec)
