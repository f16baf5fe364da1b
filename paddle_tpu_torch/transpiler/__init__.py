"""Program transpilers: the distribute transpiler (parameter-server
trainer and pserver programs), the decode transpiler (serving), the
inference transpiler (batch-norm folding) and the memory-optimization
transpiler (the reuse plan and release_memory's delete_var ops)."""
from .distribute_transpiler import (DistributeTranspiler,  # noqa: F401
                                    DistributeTranspilerConfig)
from .ps_dispatcher import PSDispatcher, RoundRobin, HashName  # noqa: F401
from .decode_transpiler import (DecodeTranspileError, DecodePair,  # noqa: F401
                                DecodeTranspiler, extract_decode_spec)
from .inference_transpiler import InferenceTranspiler  # noqa: F401
from .memory_optimization_transpiler import (  # noqa: F401
    ControlFlowGraph, memory_optimize, release_memory)

__all__ = ['DistributeTranspiler', 'DistributeTranspilerConfig',
           'PSDispatcher', 'RoundRobin', 'HashName',
           'InferenceTranspiler', 'DecodeTranspiler',
           'DecodeTranspileError', 'DecodePair', 'extract_decode_spec',
           'memory_optimize', 'release_memory']
