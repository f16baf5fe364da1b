"""Device memory introspection (counterpart of paddle_tpu/memory.py).

The statistics half of the JAX package's module: live and peak device
memory, and an analytic pre-run estimator so an out-of-memory can be
predicted before a Program runs. On a CUDA device the live numbers come
from the caching allocator (torch.cuda.memory_stats: allocated bytes,
current and peak) and the card's total from torch.cuda.mem_get_info; on
the CPU, which keeps no such statistics, they are the framework-tracked
footprint of the scope, as the JAX package's are where PJRT has none.

`device` is a torch.device, a Place, a device string or None (the first
card when one is present, else the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['memory_stats', 'memory_allocated', 'max_memory_allocated',
           'memory_limit', 'scope_footprint', 'hbm_snapshot',
           'dtype_bytes', 'estimate_program_memory',
           'estimate_peak_memory']

_DTYPE_BYTES = {
    'float64': 8, 'int64': 8, 'uint64': 8,
    'float32': 4, 'int32': 4, 'uint32': 4,
    'bfloat16': 2, 'float16': 2, 'int16': 2, 'uint16': 2,
    'int8': 1, 'uint8': 1, 'bool': 1,
}


def dtype_bytes(dtype, default=4):
    """Bytes per element for a dtype name (the one shared size table)."""
    return _DTYPE_BYTES.get(str(dtype), default)


def _device(device=None):
    if device is None:
        return torch.device('cuda', 0) if torch.cuda.is_available() \
            else torch.device('cpu')
    if isinstance(device, torch.device):
        return device
    place_device = getattr(device, 'device', None)
    if isinstance(place_device, torch.device):
        return place_device
    return torch.device(device)


def memory_stats(device=None):
    """The allocator's statistics in the JAX package's vocabulary
    (bytes_in_use, peak_bytes_in_use, bytes_limit; bytes_reserved and
    peak_bytes_reserved beside them) for a CUDA device, or None for the
    CPU, which keeps none."""
    dev = _device(device)
    if dev.type != 'cuda':
        return None
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    return {'bytes_in_use': int(stats.get('allocated_bytes.all.current', 0)),
            'peak_bytes_in_use': int(stats.get('allocated_bytes.all.peak',
                                               0)),
            'bytes_reserved': int(stats.get('reserved_bytes.all.current',
                                            0)),
            'peak_bytes_reserved': int(stats.get('reserved_bytes.all.peak',
                                                 0)),
            'bytes_limit': int(total)}


def memory_allocated(device=None):
    """Live bytes on the device; the global scope's footprint where the
    device keeps no allocator statistics (the CPU)."""
    stats = memory_stats(device)
    if stats and 'bytes_in_use' in stats:
        return int(stats['bytes_in_use'])
    return scope_footprint()


def max_memory_allocated(device=None):
    stats = memory_stats(device)
    if stats and 'peak_bytes_in_use' in stats:
        return int(stats['peak_bytes_in_use'])
    return scope_footprint()


def memory_limit(device=None):
    """Total device memory, or None if unknown (the CPU)."""
    stats = memory_stats(device)
    if stats and 'bytes_limit' in stats:
        return int(stats['bytes_limit'])
    return None


def scope_footprint(scope=None):
    """Bytes held by the tensors and arrays a Scope (default the global
    scope) binds: the framework's own view of persistable state."""
    from .executor import global_scope
    scope = scope if scope is not None else global_scope()
    total = 0
    for val in scope._vars.values():
        if isinstance(val, torch.Tensor):
            total += val.numel() * val.element_size()
        elif isinstance(val, np.ndarray):
            total += val.nbytes
    return total


def hbm_snapshot(device=None, scope=None):
    """One consistent dict of the live device-memory numbers for the obs
    layer's hbm.* gauges: bytes_in_use / peak_bytes from the allocator
    (the scope footprint where the device keeps no statistics: the CPU),
    bytes_limit (0 if unknown), and the framework-tracked scope_bytes
    beside them either way."""
    stats = memory_stats(device) or {}
    scope_bytes = scope_footprint(scope)
    in_use = int(stats.get('bytes_in_use', scope_bytes))
    peak = int(stats.get('peak_bytes_in_use', in_use))
    limit = stats.get('bytes_limit')
    return {'bytes_in_use': in_use,
            'peak_bytes': max(peak, in_use),
            'bytes_limit': int(limit) if limit is not None else 0,
            'scope_bytes': scope_bytes}


def _liveness(block):
    """(uses, defs, live_out) per op of `block`: the vars each op reads
    and writes, and the vars live after it (the backward dataflow
    fixpoint of the JAX package's ControlFlowGraph,
    paddle_tpu/transpiler/memory_optimization_transpiler.py:29-54)."""
    uses = [{n for ns in op.inputs.values() for n in ns} for op in block.ops]
    defs = [{n for ns in op.outputs.values() for n in ns}
            for op in block.ops]
    live_out = [set() for _ in block.ops]
    live = set()
    for i in range(len(block.ops) - 1, -1, -1):
        live_out[i] = set(live)
        live = (live - defs[i]) | uses[i]
    return uses, defs, live_out


def _var_bytes(var):
    if var.shape is None:
        return 0
    n = 1
    for d in var.shape:
        n *= max(int(d), 1)   # batch dim -1 counted as 1 per sample
    return n * _DTYPE_BYTES.get(str(var.dtype), 4)


def _params_bytes(program):
    """Persistable-parameter footprint, deduped by name across blocks
    (shared by both analytic estimators)."""
    params = 0
    seen = set()
    for block in program.blocks:
        for var in block.vars.values():
            if var.name in seen:
                continue
            seen.add(var.name)
            if getattr(var, 'persistable', False):
                params += _var_bytes(var)
    return params


def estimate_program_memory(program, batch_size=1):
    """Analytic HBM estimate for one run of `program`: persistable
    parameters + every non-persistable activation held at once (the sum
    of all activation outputs: an upper bound; freeing a value after its
    last reader only improves on it).
    Returns a dict with 'params', 'activations', 'total' in bytes:
    'will this fit?', answered before the program runs."""
    params = _params_bytes(program)
    acts = 0
    seen = set()
    for block in program.blocks:
        for var in block.vars.values():
            if var.name in seen:
                continue
            seen.add(var.name)
            if getattr(var, 'persistable', False):
                continue
            # non-persistables scale with the fed batch
            has_batch = var.shape and int(var.shape[0]) in (-1, 0)
            acts += _var_bytes(var) * (batch_size if has_batch else 1)
    return {'params': params, 'activations': acts,
            'total': params + acts}


def estimate_peak_memory(program, batch_size=1, amp_bf16=False):
    """Liveness-aware peak-memory estimate for one run of `program`:
    persistable parameters + the MAXIMUM over program points of the
    live activation set (_liveness: the analysis the JAX package's
    memory-optimize transpiler runs; amp_bf16 halves float32 activation
    bytes, the AMP emitters' bf16 stream). A much tighter bound than
    estimate_program_memory's sum of all activations: forward
    activations count only while a later (backward) op still reads
    them. Control-flow sub-blocks run while their parent op's live set
    is held, so a sub-block op's cost is its block's own peak ON TOP of
    the parent live set (vars resolve up the parent chain). Still an
    upper bound: the executor drops a run-local value after its last
    reader, and rematerialization only improves on it. Returns bytes."""
    params = _params_bytes(program)

    def var_cost(block, name, outer_priced, hoisted):
        # no double count against the enclosing live set: a name that
        # resolves up the parent chain is the same buffer, and so is a
        # sub-block-local var the control-flow op HOISTS into the
        # parent under the same name (layers.recompute outputs — one
        # buffer in two var tables). A local var that merely shadows an
        # outer name (user-chosen names bypass unique_name) is a
        # distinct buffer and still priced.
        if name in outer_priced and (name not in block.vars
                                     or name in hoisted):
            return 0
        var, b = None, block
        while b is not None:
            if name in b.vars:
                var = b.vars[name]
                break
            b = b.parent_block
        if var is None or getattr(var, 'persistable', False):
            return 0
        nbytes = _var_bytes(var)
        # under AMP the ACTIVATION stream moves as bf16 even though the
        # IR declares float32 (emitters cast at the boundary)
        if amp_bf16 and str(var.dtype) == 'float32':
            nbytes //= 2
        has_batch = var.shape and int(var.shape[0]) in (-1, 0)
        return nbytes * (batch_size if has_batch else 1)

    visited = set()

    def block_peak(block, outer_priced=frozenset(),
                   hoisted=frozenset()):
        visited.add(block.idx)
        uses, defs, live_out = _liveness(block)
        peak = 0
        for i, op in enumerate(block.ops):
            live = live_out[i] | uses[i] | defs[i]
            total = sum(var_cost(block, n, outer_priced, hoisted)
                        for n in live)
            sub_idx = op.attr('sub_block')
            if sub_idx is not None:
                # only the DIRECT parent op's outputs hoist into its
                # own sub-block; deeper levels are covered by the
                # parent-chain-resolution clause (accumulating would
                # zero-price a deeper local var shadowing an ancestor's
                # hoisted name)
                total += block_peak(
                    program.blocks[sub_idx], outer_priced | live,
                    set(op.output_arg_names()))
            peak = max(peak, total)
        return peak

    peak = block_peak(program.blocks[0])
    # blocks referenced OUTSIDE the sub_block attr chain (pserver
    # programs wire optimize/LR blocks via lr_block_id /
    # grad_to_block_id string attrs) still run; keep the upper-bound
    # contract by folding their standalone peaks in
    for block in program.blocks:
        if block.idx not in visited:
            peak = max(peak, block_peak(block))
    return params + peak
