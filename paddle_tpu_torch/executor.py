"""Executor: prepares a program block into device segments and host
steps; on a CUDA place it captures each device segment once as a CUDA
graph and replays it, on the CPU it runs the ops eagerly.

Counterpart of paddle_tpu/executor.py. The JAX package jit-compiles each
device segment of a block into one XLA computation and replays it; here:
- PreparedProgram splits the block on the registry's `host` flag (read,
  save, load, ...), with each segment's inputs and live outputs
  computed as the JAX package computes them, and is cached on (program
  uid and version, AMP, feed signature, fetch names, scope,
  run_time_switches(): the flash arms and the FLAGS_ values that
  emitters read when they run), the least recently run dropped past
  PREPARED_LIMIT; Executor.close() drops them all;
- on a CUDA place a segment's first run with a signature of its
  run-local inputs is eager (the warm-up: cuBLAS and cuDNN handles, the
  kernels' builds), its second run captures it into a
  torch.cuda.CUDAGraph (all the executor's graphs share one memory
  pool), and later runs copy the run-local inputs into the graph's
  static tensors and replay it. Host steps run eagerly between
  segments. A capture that fails raises OpExecutionError;
- on the CPU, and with use_program_cache=False anywhere, every op runs
  eagerly, and nothing is captured (jit_cache_stats: the JAX package's
  four keys; compiled_segments counts captures);
- under FLAGS_check_nan_inf every device segment runs op by op, eagerly
  and never captured, and each floating output (bf16 included) is read
  back and scanned: the first NaN or Inf raises OpExecutionError naming
  the op and the output, with the JAX package's message. These per-op
  host reads happen in this mode only.
Each run reports into obs/perf.py when telemetry is on: step latency,
MFU and device memory around Executor.run (step_begin / step_end), a
hit or a miss per segment dispatch, an `xla.compile` span around each
warm-up and capture, and the segment's FLOPs counted during its warm-up
(PreparedProgram.cost_flops).
Each host step runs inside profiler.RecordEvent('host_op:<type>') and
each device segment's run inside RecordEvent('device_segment:<i>(<n>
ops)'), as in the JAX package; while fluid.profiler's torch.profiler
session is on (profiler.tracing), each op run eagerly is a
record_function('<type>.<idx>') range and each segment run a
`segment@<key>:<phase>` range, from which the profiler names the
kernels, a replay's through the op map of its segment's warm-up.
A sparse gradient (selected_rows.SelectedRows) is a run-local value
like a tensor: it crosses segments, a graph's static inputs and outputs
and the prepared-program cache as its (values, rows) pair with a static
height, check_nan_inf scans its values, and a fetch gives it as the JAX
package does (a 0-d object array holding it, its arrays on the host;
itself with return_numpy=False).
Each op's emitter (registry.py) computes with PyTorch on the place's
tensors. Feeds go numpy -> tensor on the place; fetches come back as
numpy unless return_numpy=False (then, on the captured path, a copy: the
next replay writes the graph's tensors).

Training blocks: a forward op whose grad op is in the block runs
under torch.enable_grad() and leaves a record that the grad op consumes
(registry.py, "recorded forward"); every other op runs under
torch.no_grad(). A run-local value is dropped right after the last op
that reads it, unless it is fetched, so activations and grads live only
as long as the step needs them.

A captured graph reads and writes the addresses it captured, so:
persistables a segment writes out of place (the step counter, batch-norm
running statistics) are copied back into their scope tensors inside the
graph (rebound_persistables); a scope tensor replaced after the capture
(Scope.set_var, io.load_*) is copied into the captured one before the
next replay, and the scope binds the captured tensor again; the kernel
wrappers' launch counts that the capture added on its stream are added
again at each replay (kernels.recording, kernels.count_add); generators
a segment draws from are registered with its graph, and those of ops
with a seed attr are re-seeded before every replay (the same draw on
every run, as in an eager run).

Places: CUDAPlace(i) is the default. With no place given and no card
present, Executor() raises instead of quietly running on the CPU; the
CPU is used only when the caller passes CPUPlace().
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time

import numpy as np
import torch

from . import kernels, profiler as _prof, registry
from .flags import get_flag, get_flags
from .framework import default_main_program, Program, Variable
from .obs import perf as _perf
from .obs import trace as _trace
from .reader.pipeline import EOFException
from .selected_rows import SelectedRows

__all__ = ['Executor', 'Scope', 'global_scope', 'scope_guard',
           'CPUPlace', 'CUDAPlace', 'TPUPlace', 'XLAPlace',
           'CUDAPinnedPlace', 'fetch_var', 'OpExecutionError',
           'torch_dtype', 'PreparedProgram', 'rebound_persistables',
           'run_time_switches', 'pad_lod_to_batch']


class OpExecutionError(RuntimeError):
    """An op failed while running, annotated with the op's identity and
    its declared inputs and outputs."""


def _describe_op(op, block, pos=None):
    def slot_str(mapping):
        parts = []
        for slot, names in mapping.items():
            descs = []
            for n in names:
                try:
                    v = block.var_recursive(n)
                    descs.append('%s%s' % (n, list(v.shape)
                                           if v.shape is not None else ''))
                except KeyError:
                    descs.append(n)
            parts.append('%s=[%s]' % (slot, ', '.join(descs)))
        return '; '.join(parts)
    where = ('op #%d ' % pos) if pos is not None else 'op '
    return ('%s%r in block %d\n  inputs:  %s\n  outputs: %s'
            % (where, op.type, block.idx, slot_str(op.inputs),
               slot_str(op.outputs)))


_TORCH_DTYPES = {
    'float16': torch.float16, 'bfloat16': torch.bfloat16,
    'float32': torch.float32, 'float64': torch.float64,
    'int8': torch.int8, 'uint8': torch.uint8, 'int16': torch.int16,
    'int32': torch.int32, 'int64': torch.int64, 'bool': torch.bool,
}


def torch_dtype(name):
    """Canonical dtype string (framework.convert_np_dtype) -> torch dtype."""
    return _TORCH_DTYPES[name]


# ---------------------------------------------------------------------------
# Places
# ---------------------------------------------------------------------------

class Place(object):
    def __init__(self, device_id=0):
        self.device_id = device_id

    @property
    def device(self):
        raise NotImplementedError

    def __repr__(self):
        return '%s(%d)' % (type(self).__name__, self.device_id)

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    @property
    def device(self):
        return torch.device('cpu')


class CUDAPlace(Place):
    @property
    def device(self):
        return torch.device('cuda', self.device_id)


# the JAX package's place names: its accelerator place is TPUPlace, with
# XLAPlace and CUDAPlace as aliases, and CUDAPinnedPlace is its host
# place; here the accelerator place is CUDAPlace (a divergence by
# design), so scripts written as fluid.Executor(fluid.TPUPlace()) run on
# the card unchanged
TPUPlace = CUDAPlace
XLAPlace = CUDAPlace
CUDAPinnedPlace = CPUPlace


def _resolve_place(place):
    """The caller's place, or CUDAPlace(0). A CUDA place without a card
    raises: nothing falls back to the CPU unless CPUPlace() was asked."""
    if place is None:
        place = CUDAPlace(0)
    if isinstance(place, CUDAPlace) and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available for %r; pass place=CPUPlace() '
            'to run on the CPU' % (place,))
    return place


# ---------------------------------------------------------------------------
# Scope: name -> runtime value (a torch.Tensor on the executor's place)
# ---------------------------------------------------------------------------

class Scope(object):
    def __init__(self, parent=None):
        self._vars = {}
        self.parent = parent
        self._kids = []

    def var(self, name):
        """Find-or-create."""
        if name not in self._vars:
            self._vars[name] = None
        return self._vars.get(name)

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def set_var(self, name, value):
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def new_scope(self):
        """A child scope: it reads its parent's vars and keeps its own."""
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []

    def local_var_names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


def _switch_scope(scope):
    global _global_scope
    prev, _global_scope = _global_scope, scope
    return prev


@contextlib.contextmanager
def scope_guard(scope):
    prev = _switch_scope(scope)
    try:
        yield
    finally:
        _switch_scope(prev)


def fetch_var(name, scope=None, return_numpy=True):
    scope = scope or global_scope()
    val = scope.find_var(name)
    if val is None:
        raise KeyError('var %r not found in scope' % name)
    return _to_numpy(val) if return_numpy else val


def pad_lod_to_batch(flat, lod_level0_offsets):
    """Flat LoD rows [N, ...] and level-0 offsets -> (padded [B, T, ...],
    lengths [B] int32), T the longest sequence (at least 1). The lengths
    carry the raggedness, so the device sees static shapes."""
    offs = list(lod_level0_offsets)
    lens = np.diff(offs).astype('int32')
    B, T = len(lens), (int(lens.max()) if len(lens) else 0)
    padded = np.zeros((B, max(T, 1)) + flat.shape[1:], dtype=flat.dtype)
    for b in range(B):
        padded[b, :lens[b]] = flat[offs[b]:offs[b + 1]]
    return padded, lens


def _expand_sequence_feeds(program, feed):
    """Each feed of a lod_level > 0 var becomes the padded tensor and its
    `<name>@SEQ_LEN` lengths. A var takes a LoDTensor (one level), a
    (padded, lengths) tuple, or a padded array of rank declared + 1 (all
    lengths T). Torch tensors pass as they are."""
    from .lod_tensor import LoDTensor
    out = {}
    for name, value in feed.items():
        var = program.global_block().vars.get(name)
        if var is None or var.lod_level == 0:
            out[name] = value
            continue
        lens_name = name + '@SEQ_LEN'
        if isinstance(value, LoDTensor) and value.lod():
            lod = value.lod()
            if len(lod) != 1:
                raise NotImplementedError(
                    'only lod_level=1 feeds are supported (got %d levels '
                    'for %r)' % (len(lod), name))
            padded, lens = pad_lod_to_batch(value.numpy(), lod[0])
            out[name] = padded
            out.setdefault(lens_name, lens)
        elif isinstance(value, tuple) and len(value) == 2:
            padded, lens = value
            out[name] = padded if isinstance(padded, torch.Tensor) \
                else np.asarray(padded)
            out.setdefault(lens_name, lens.to(torch.int32)
                           if isinstance(lens, torch.Tensor)
                           else np.asarray(lens, dtype='int32'))
        else:
            arr = value if isinstance(value, torch.Tensor) \
                else np.asarray(value)
            declared = len(var.shape or ())
            if arr.ndim != declared + 1:
                raise ValueError(
                    'feed %r is a lod_level=%d var: feed a LoDTensor, a '
                    '(padded, lengths) tuple, or a padded array of rank %d '
                    '(got rank %d)' % (name, var.lod_level, declared + 1,
                                       arr.ndim))
            out[name] = arr
            out.setdefault(lens_name,
                           np.full((arr.shape[0],), arr.shape[1], 'int32'))
    return out


def _to_numpy(value):
    """A fetch on the host; a bf16 tensor comes back as fp32 (numpy has
    no bf16, and every bf16 value is exact in fp32); a SelectedRows as a
    0-d object array holding it with its arrays on the host, as
    np.asarray gives it in the JAX package."""
    if isinstance(value, SelectedRows):
        out = np.empty((), dtype=object)
        out[()] = value.map(_to_numpy)
        return out
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


# ---------------------------------------------------------------------------
# Emit context
# ---------------------------------------------------------------------------

class EmitContext(object):
    """What an op emitter sees: the run-local values, the scope behind
    them, the block (for declared var metadata), the device, the random
    generators, whether the program runs under AMP or for test
    (Program.clone(for_test=True): batch norm reads its running
    statistics), the forward records of this run (registry.py) and the
    record keys the block's grad ops will take (`wanted`).

    `capturing` is True while the ops run into a CUDA graph: an emitter
    must then launch work only, never read a value back to the host.
    `graphs` is True where this run's device work is captured and
    replayed (the card's default path): a while op's host step then
    captures its body (Executor.run_loop).
    A sub-block's context (sub_context) writes only its own values,
    never the scope, and draws from its own generator (`rng`); it keeps
    the parent's mesh, so a sub-block re-run for a gradient stays on
    the mesh (the JAX package's registry._SandboxCtx.mesh)."""

    __slots__ = ('local', 'scope', 'block', 'device', 'amp', 'is_test',
                 'records', 'overrides', 'wanted', 'capturing', 'graphs',
                 'rng', 'generators', 'op_generators', 'writes_scope',
                 'mesh', 'bn_local_stats', 'dist', '_executor', '_program')

    def __init__(self, executor, program, block, scope, local):
        self._executor = executor
        self._program = program
        self.block = block
        self.scope = scope
        self.local = local
        self.device = executor.device
        self.amp = bool(getattr(program, '_use_bf16', False))
        self.is_test = bool(getattr(program, '_is_test', False))
        self.records = {}
        # name -> tensor served in place of the stored value while a
        # forward op is recorded (its detached, grad-requiring inputs)
        self.overrides = None
        self.wanted = frozenset()
        self.capturing = False
        self.graphs = False
        self.rng = None
        # generator -> its op's seed (0: not re-seeded): every generator
        # the current segment draws from, registered with its graph
        self.generators = {}
        # id(op) -> the generator of an op with its own seed attr
        self.op_generators = {}
        self.writes_scope = True
        # a mesh run (ParallelExecutor over ranks): the Mesh, the
        # executor's batch-norm override (None: FLAGS_bn_local_stats),
        # and the run's layouts (parallel/layout.py DistState), through
        # which every op is emitted; None on one device
        self.mesh = getattr(executor, 'mesh', None)
        self.bn_local_stats = getattr(executor, '_bn_local_stats', None)
        self.dist = None

    def sub_context(self, block, local, rng):
        """The context of a control-flow sub-block run on `local`."""
        sub = EmitContext.__new__(EmitContext)
        for name in EmitContext.__slots__:
            setattr(sub, name, getattr(self, name))
        sub.block, sub.local, sub.rng = block, local, rng
        sub.records, sub.overrides = {}, None
        sub.wanted = frozenset()
        sub.writes_scope = False
        return sub

    def get(self, name):
        if self.overrides and name in self.overrides:
            return self.overrides[name]
        if name in self.local:
            return self.local[name]
        val = self.scope.find_var(name)
        if val is None:
            raise RuntimeError(
                'var %r used before initialization -- did you run the '
                'startup program?' % name)
        if not isinstance(val, (torch.Tensor, SelectedRows)):
            # a host value put in the scope by hand: move it to the place
            # once, in the scope that holds it
            val = torch.as_tensor(np.asarray(val), device=self.device)
            _rebind(self.scope, name, val)
        return val

    def set(self, name, value):
        """Persistable outputs (parameters, K/V caches) go to the scope;
        everything else stays run-local."""
        self.local[name] = value
        if self.writes_scope and self.is_persistable(name):
            self.scope.set_var(name, value)

    def var(self, name):
        return self.block.var_recursive(name)

    def is_persistable(self, name):
        try:
            return bool(self.block.var_recursive(name).persistable)
        except KeyError:
            return False

    def take_record(self, key):
        """The forward record a grad op consumes; it is dropped here."""
        rec = self.records.pop(key, None)
        if rec is None:
            raise RuntimeError(
                'the forward op %r with outputs %s was not recorded in '
                'this run: a grad op needs its forward op to run earlier '
                'in the same Executor.run (the port never replays a '
                'forward)' % (key[0], dict(key[1])))
        return rec

    def generator(self, op):
        """torch.Generator for a random op: a sub-block's own generator
        (rng), else the op's own seed attr when it has one (the same
        draw on every run), else the executor's generator seeded from
        Program.random_seed."""
        if self.rng is not None:
            gen, seed = self.rng, 0
        else:
            seed = int(op.attr('seed', 0) or 0)
            if seed:
                gen = self.op_generators.get(id(op))
                if gen is None:
                    gen = self.op_generators[id(op)] = torch.Generator(
                        device=self.device)
                if not self.capturing:
                    # under capture: before each replay (_reseed)
                    gen.manual_seed(seed)
            else:
                gen = self._executor._generator(self._program)
        self.generators[gen] = seed
        return gen

    def remat_generators(self, op):
        """(forward, recompute) generators of a remat_block op."""
        return self._executor._remat_generators(self._program, op)


def _detached(value, copy):
    """A fetch returned as tensors: detached, and a copy with `copy`
    (the next replay writes a graph's tensors)."""
    if isinstance(value, SelectedRows):
        return value.map(lambda t: _detached(t, copy))
    if isinstance(value, torch.Tensor):
        return value.detach().clone() if copy else value.detach()
    return value


def _rebind(scope, name, value):
    """Set `name` in the scope of the chain that holds it (or `scope`)."""
    s = scope
    while s is not None and name not in s._vars:
        s = s.parent
    (s or scope).set_var(name, value)


def _recorded_keys(block):
    """Record keys of the forward ops that the block's grad ops consume."""
    keys = set()
    for op in block.ops:
        if op.type.endswith('_grad'):
            key = registry.grad_record_key(op)
            if key is not None:
                keys.add(key)
    return frozenset(keys)


def drop_plan(block, keep):
    """op index -> run-local names whose last reader (or producer) is
    that op; names in `keep` (fetches) are never dropped."""
    last = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names():
            last[n] = i
        for n in op.output_arg_names():
            last[n] = i
    plan = {}
    for n, i in last.items():
        if n not in keep:
            plan.setdefault(i, []).append(n)
    return plan


def _run_recorded(ctx, opdef, op):
    """Run a forward op with autograd on, local to this op: its float
    inputs in the differentiable slots become detached leaves."""
    in_slots, _ = opdef.vjp_slots
    leaves = {}
    for n in registry.diff_input_names(op.inputs, in_slots):
        t = ctx.get(n)
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            leaves[n] = t.detach().requires_grad_()
    ctx.overrides = leaves
    try:
        with torch.enable_grad():
            _call_emit(ctx, opdef, op)
    finally:
        ctx.overrides = None
    outs = {n: ctx.local[n] for n in op.output_arg_names() if n in ctx.local}
    ctx.records[registry.record_key(op.type, op.outputs)] = (leaves, outs)


def check_finite(ctx, op, pos):
    """FLAGS_check_nan_inf: raise OpExecutionError naming the op and the
    first of its floating outputs that holds a NaN or an Inf (one host
    read per output)."""
    for name in op.output_arg_names():
        val = ctx.local.get(name)
        if isinstance(val, SelectedRows):
            val = val.values
        if isinstance(val, torch.Tensor) and val.is_floating_point() and \
                not bool(torch.isfinite(val).all()):
            raise OpExecutionError(
                'NaN/Inf detected in output %r of %s'
                % (name, _describe_op(op, ctx.block, pos)))


def _call_emit(ctx, opdef, op):
    """The op's emitter; on a mesh through its layout rule."""
    if ctx.dist is not None:
        ctx.dist.emit(ctx, opdef, op)
    else:
        opdef.emit(ctx, op)


def _emit(ctx, opdef, op):
    if opdef.vjp_slots is not None and ctx.wanted and \
            registry.record_key(op.type, op.outputs) in ctx.wanted:
        _run_recorded(ctx, opdef, op)
    else:
        _call_emit(ctx, opdef, op)


def run_op(ctx, op, pos):
    """Run one op's emitter (recorded where a grad op of the block takes
    its record); any failure becomes an OpExecutionError naming the op."""
    opdef = registry.get_op(op.type)
    if opdef.emit is None:
        raise KeyError('op %r has no emitter registered' % op.type)
    try:
        if _prof.tracing:
            # the op's label on what it launches (profiler.py)
            with _prof.op_range(op.type, pos):
                _emit(ctx, opdef, op)
        else:
            _emit(ctx, opdef, op)
    except (OpExecutionError, EOFException):
        raise
    except Exception as e:
        raise OpExecutionError(
            'Error running %s\n  cause: %s: %s'
            % (_describe_op(op, ctx.block, pos), type(e).__name__,
               e)) from e


# ---------------------------------------------------------------------------
# Prepared program: segments + metadata (paddle_tpu/executor.py:355-478)
# ---------------------------------------------------------------------------

class _DeviceSegment(object):
    """A maximal run of device ops between host steps. On a CUDA place
    it is captured once for each signature of its run-local inputs (a
    reader's last, partial batch has its own), as the JAX package's jit
    traces once for each shape: `runs` counts the runs of each
    signature, `graphs` holds each one's _Graph, `generators` the
    generators its ops draw from (-> an op's seed)."""

    __slots__ = ('ops', 'op_offsets', 'in_names', 'out_names', 'runs',
                 'graphs', 'generators', 'op_generators', 'warm_s',
                 'op_maps', 'pp_runner')

    def __init__(self, ops, op_offsets):
        self.ops = ops
        self.op_offsets = op_offsets  # indices in the block
        self.in_names = []
        self.out_names = []
        self.runs = {}
        self.graphs = {}
        self.generators = {}
        self.op_generators = {}
        # signature -> seconds its warm-up took (obs/perf.py's compile
        # latency on the card is warm-up + capture)
        self.warm_s = {}
        # profiler key -> the op map of its kernels, built from an eager
        # run under the profiler and applied to the graph's replays
        self.op_maps = {}
        # a pipelined segment's runner (parallel/pp_lowering.py), built
        # at its first run on a pp mesh
        self.pp_runner = None

    def signature(self, local):
        """(name, shape, dtype) of each run-local input."""
        return tuple((n,) + value_signature(local[n])
                     for n in self.in_names if n in local)


def value_signature(v):
    """(shape, dtype) of a tensor; of a tensor array (a list), its
    elements' signatures; of a SelectedRows, its values' and rows' and
    its height."""
    if isinstance(v, list):
        return ('array', tuple(value_signature(x) for x in v))
    if isinstance(v, SelectedRows):
        return ('rows', value_signature(v.values), value_signature(v.rows),
                v.height)
    return (tuple(getattr(v, 'shape', ())), getattr(v, 'dtype', None))


def _clone_value(v):
    if isinstance(v, list):
        return [_clone_value(x) for x in v]
    if isinstance(v, SelectedRows):
        return v.map(torch.Tensor.clone)
    return v.clone()


def _copy_value(dst, src):
    """Copy src into the static tensor(s) dst (a no-op where src is dst)."""
    if isinstance(dst, list):
        for d, x in zip(dst, src):
            _copy_value(d, x)
    elif isinstance(dst, SelectedRows):
        _copy_value(dst.values, src.values)
        _copy_value(dst.rows, src.rows)
    elif dst is not src:
        dst.copy_(src)


def _tensors_of(values):
    for v in values:
        if isinstance(v, list):
            yield from _tensors_of(v)
        elif isinstance(v, SelectedRows):
            yield from _tensors_of((v.values, v.rows))
        elif isinstance(v, torch.Tensor):
            yield v


class _Graph(object):
    """A segment captured as a CUDA graph, and what its replay needs:
      static_in  run-local inputs (feeds, a host step's or an earlier
                 segment's values), copied in before each replay;
      scope_in   the scope tensors the graph read at capture;
      scope_out  the persistables it writes, bound in the scope after
                 each replay (those written out of place are copied back
                 into these tensors inside the graph:
                 rebound_persistables);
      outs       its run-local outputs (tensors of the graph's pool);
      counts     what the capture added to the kernel wrappers' counts,
                 added again at each replay (kernels.recording)."""

    __slots__ = ('graph', 'static_in', 'scope_in', 'scope_out', 'outs',
                 'counts')

    def __init__(self, graph, static_in, scope_in, scope_out, outs, counts):
        self.graph = graph
        self.static_in = static_in
        self.scope_in = scope_in
        self.scope_out = scope_out
        self.outs = outs
        self.counts = counts


class _LoopBody(object):
    """A while op's body on the captured path (Executor.run_loop): the
    trips run of each input signature, the graph of each, and the
    generators its random ops draw from (-> an op's seed)."""

    __slots__ = ('runs', 'graphs', 'generators', 'op_generators')

    def __init__(self):
        self.runs = {}
        self.graphs = {}
        self.generators = {}
        self.op_generators = {}


class _BodyGraph(object):
    """A while body captured as a CUDA graph: its static carried values
    (which each replay updates in place), its static external inputs and
    the kernel launches of one trip."""

    __slots__ = ('graph', 'carried', 'ext', 'counts')

    def __init__(self, graph, carried, ext, counts):
        self.graph = graph
        self.carried = carried
        self.ext = ext
        self.counts = counts


def _copy_back(name, static, new):
    """A trip's new value of a carried var into its static tensor(s),
    inside the body's graph; the var keeps its shape and dtype."""
    if isinstance(static, list):
        if not isinstance(new, list) or len(new) != len(static):
            raise OpExecutionError('while-loop array %r changed its length '
                                   'in the body' % name)
        for s_, x in zip(static, new):
            _copy_back(name, s_, x)
        return
    if isinstance(static, SelectedRows):
        if not isinstance(new, SelectedRows) or new.height != static.height:
            raise OpExecutionError('while-loop var %r changed from '
                                   'SelectedRows in the body' % name)
        _copy_back(name, static.values, new.values)
        _copy_back(name, static.rows, new.rows)
        return
    _same_layout(name, new, static, 'while-loop var')
    if new is not static:
        static.copy_(new)


class _HostStep(object):
    __slots__ = ('op', 'op_offset')

    def __init__(self, op, op_offset):
        self.op = op
        self.op_offset = op_offset


class PreparedProgram(object):
    """A block split into device segments and host steps, with each
    segment's inputs and live outputs: the JAX package's PreparedProgram
    (paddle_tpu/executor.py:376-478), segmenting on the registry's
    `host` flag, plus the recorded-forward keys and the drop plan of the
    block."""

    def __init__(self, program, block_id, feed_names, fetch_names):
        self.program = program
        self.block = program.blocks[block_id]
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        # obs/perf.py: the fingerprint tags this program's xla.compile
        # spans; cost_flops sums the FLOPs of each segment's warm-up (the
        # first signature of each), the work model behind perf.mfu
        self.fingerprint = None
        self.cost_flops = 0.0
        self.steps = []          # list of _DeviceSegment | _HostStep
        self._build_segments()
        self._analyze_dataflow()
        self.wanted = _recorded_keys(self.block)
        self.drop = drop_plan(self.block, set(self.fetch_names))

    def _build_segments(self):
        cur_ops, cur_offsets = [], []
        for idx, op in enumerate(self.block.ops):
            if op.type in ('feed', 'fetch'):
                continue
            opdef = registry._REGISTRY.get(op.type)
            if opdef is None or opdef.emit is None:
                raise KeyError('op %r has no emitter registered' % op.type)
            if opdef.host:
                if cur_ops:
                    self.steps.append(_DeviceSegment(cur_ops, cur_offsets))
                    cur_ops, cur_offsets = [], []
                self.steps.append(_HostStep(op, idx))
            else:
                cur_ops.append(op)
                cur_offsets.append(idx)
        if cur_ops:
            self.steps.append(_DeviceSegment(cur_ops, cur_offsets))

    def _analyze_dataflow(self):
        """Per-segment inputs (read-before-write) and live outputs
        (written and needed by later steps, fetches or persistable
        state), computed as the JAX package computes them."""
        persistable = {name for name, var in self.block.vars.items()
                       if var.persistable}
        b = self.block
        while b.parent_block is not None:
            b = b.parent_block
            persistable |= {n for n, v in b.vars.items() if v.persistable}

        step_reads, step_writes = [], []
        for step in self.steps:
            if isinstance(step, _DeviceSegment):
                reads, writes = set(), set()
                for op in step.ops:
                    for n in op.input_arg_names():
                        if n not in writes:
                            reads.add(n)
                    writes.update(op.output_arg_names())
                step_reads.append(reads)
                step_writes.append(writes)
            else:
                step_reads.append(set(step.op.input_arg_names()))
                step_writes.append(set(step.op.output_arg_names()))

        fetch_set = set(self.fetch_names)
        for i, step in enumerate(self.steps):
            if not isinstance(step, _DeviceSegment):
                continue
            later_reads = set()
            for j in range(i + 1, len(self.steps)):
                later_reads |= step_reads[j]
            step.in_names = sorted(step_reads[i])
            step.out_names = sorted(
                step_writes[i] & (later_reads | fetch_set | persistable))


def rebound_persistables(before, scope):
    """The names in `before` (name -> the scope's tensor before a
    segment ran) that the scope no longer binds to that tensor: the
    persistables the segment wrote out of place. A graph reads and
    writes the addresses it captured, so each of these is copied back
    into its old tensor inside the graph."""
    return [n for n, t in before.items()
            if t is not None and scope.find_var(n) is not t]


def _reseed(step):
    """Seed the generators of the segment's ops that have a seed attr
    (EmitContext.generator) before its graph replays: such an op draws
    the same numbers on every run, as it does eagerly."""
    for gen, seed in step.generators.items():
        if seed:
            gen.manual_seed(seed)


def _same_layout(name, new, old, what):
    if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
        raise OpExecutionError(
            '%s %r changed from %s %s to %s %s: a captured segment takes '
            'fixed shapes and dtypes' % (what, name, tuple(old.shape),
                                         old.dtype, tuple(new.shape),
                                         new.dtype))


# one CUDA graph capture at a time in the process (serving workers each
# own an Executor, and may reach their second run together)
_CAPTURE_LOCK = threading.Lock()
# prepared programs an Executor keeps (each with its captured graphs);
# past it the least recently run one is dropped
PREPARED_LIMIT = 64


def run_time_switches():
    """The values an emitter reads when it runs, not when the program is
    built: the flash arms (kernels/flash_attention.py fwd_arm, bwd_arm)
    and every FLAGS_ value. They key the prepared programs, so switching
    one between runs prepares (and captures) anew."""
    return (tuple(os.environ.get(n, '').strip().lower()
                  for n in ('PADDLE_FLASH_FWD', 'PADDLE_FLASH_BWD')),
            tuple(sorted(get_flags().items())))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class Executor(object):
    def __init__(self, place=None):
        self.place = _resolve_place(place)
        self.device = self.place.device
        self._gen = None
        self._gen_seed = None
        # (program uid, sub_block) -> (forward, recompute) generators of
        # a remat_block
        self._remat_rng = {}
        self._prepared_cache = {}
        self._stream = None
        # the memory pool of every graph this executor captures: its
        # graphs replay one at a time on its stream, and no pool tensor
        # outlives a run but a segment's outputs, which its replay
        # writes before a later segment of that run reads them, so one
        # program's feed shapes and flag settings reuse one step's
        # activations
        self._pool = None
        # device segments captured by this executor (monotonic), and
        # every segment dispatch as a hit (a prepared segment ran again)
        # or a miss (its first run: the warm-up)
        self._compile_count = 0
        self._segment_hits = 0
        self._segment_misses = 0
        # the while bodies of run_loop, and the memory pool of their
        # graphs (apart from the segments': a body replays inside a run
        # after segments captured later than it)
        self._loops = {}
        self._loop_pool = None
        # every while op's trips and condition reads (trips + 1 a loop)
        self._loop_trips = 0
        self._loop_reads = 0

    def jit_cache_stats(self):
        """{'prepared_programs', 'compiled_segments', 'segment_hits',
        'segment_misses'}: the JAX package's four keys. A segment is
        compiled when it is captured as a CUDA graph (never on the
        CPU); compiled_segments is monotonic, so a steady serving loop
        shows it constant."""
        return {'prepared_programs': len(self._prepared_cache),
                'compiled_segments': self._compile_count,
                'segment_hits': self._segment_hits,
                'segment_misses': self._segment_misses}

    def close(self):
        """Drop every prepared program with its captured graphs, and the
        memory pool they hold (returned to the card by the caching
        allocator when it needs the room, or by torch.cuda.empty_cache);
        the next run of a program prepares it again. The counts of
        jit_cache_stats() go on. Tells every parameter server this
        process talked to that its trainer is done (COMPLETE) and drops
        the connections (reference executor.cc:48 Executor::Close ->
        SendComplete)."""
        from .distributed.rpc import close_all_clients
        self._prepared_cache.clear()
        self._pool = None
        self._loops.clear()
        self._loop_pool = None
        close_all_clients(send_complete=True)

    def run_block(self, program, block_id, scope, fetch_names=()):
        """Run one block (no feeds) against `scope` -- the nested-executor
        entry of host ops that run sub-blocks themselves (listen_and_serv's
        optimize blocks; reference listen_and_serv_op.cc:148
        ParallelExecuteBlocks). Its prepared program is cached under a
        'block_run' key, which never shares an entry with run()'s.
        Returns the fetched values (tensors)."""
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_names]
        key = ('block_run', program._uid, program._version, block_id,
               tuple(fetch_names), scope, run_time_switches())
        prepared = self._prepared_cache.pop(key, None)
        if prepared is None:
            prepared = PreparedProgram(program, block_id, (), fetch_names)
            prepared.fingerprint = hashlib.md5(repr(
                key[:5]).encode()).hexdigest()[:12]
        self._prepared_cache[key] = prepared
        while len(self._prepared_cache) > PREPARED_LIMIT:
            del self._prepared_cache[next(iter(self._prepared_cache))]
        return self._run_prepared(prepared, {}, scope, program,
                                  self.device.type == 'cuda')

    def loop_stats(self):
        """{'trips', 'host_reads'}: the while trips this executor ran and
        the condition values they read back to the host (each loop reads
        one more than its trips)."""
        return {'trips': self._loop_trips, 'host_reads': self._loop_reads}

    def _generator(self, program):
        seed = program.random_seed
        if self._gen is None or seed != self._gen_seed:
            self._gen = torch.Generator(device=self.device)
            if seed:
                self._gen.manual_seed(int(seed))
            else:
                self._gen.seed()
            self._gen_seed = seed
        return self._gen

    def _remat_generators(self, program, op):
        """Two generators with one state: the remat block's forward draws
        from the first, its recompute from the second, so both draw the
        same numbers (dropout the same mask). Eager runs copy the
        forward's state into the second (ops/control_flow_ops.py);
        under capture both are registered with the graph and advance
        alike at every replay."""
        key = (program._uid, op.attr('sub_block'))
        pair = self._remat_rng.get(key)
        if pair is None:
            fwd = torch.Generator(device=self.device)
            if program.random_seed:
                fwd.manual_seed((int(program.random_seed) * 1000003 +
                                 int(op.attr('rng_tag', 0))) % (2 ** 63))
            else:
                fwd.seed()
            bwd = torch.Generator(device=self.device)
            bwd.set_state(fwd.get_state())
            pair = self._remat_rng[key] = (fwd, bwd)
        return pair

    def _feed_tensor(self, program, name, value):
        var = program.global_block().vars.get(name)
        if isinstance(value, torch.Tensor):
            t = value.to(self.device)
        else:
            arr = np.asarray(value)
            if var is not None and var.dtype is not None and \
                    var.dtype != 'bfloat16' and \
                    arr.dtype != np.dtype(var.dtype):
                arr = arr.astype(var.dtype)
            # (np.ascontiguousarray turns a 0-d array into shape (1,))
            t = torch.from_numpy(np.ascontiguousarray(arr).reshape(
                arr.shape)).to(self.device)
        if var is not None and var.dtype is not None and \
                t.dtype != torch_dtype(var.dtype):
            t = t.to(torch_dtype(var.dtype))
        return t

    def _cache_key(self, program, local, fetch_names, scope):
        feed_sig = tuple(sorted((n, tuple(t.shape), str(t.dtype))
                                for n, t in local.items()))
        return (program._uid, program._version, program._use_bf16,
                feed_sig, tuple(fetch_names), scope, run_time_switches())

    def _cached_prepared(self, program, local, fetch_names, scope):
        """The prepared program of a mesh run's key: prepared at its first
        run, then cached (the newest PREPARED_LIMIT kept)."""
        key = self._cache_key(program, local, fetch_names, scope)
        prepared = self._prepared_cache.pop(key, None)
        if prepared is None:
            prepared = PreparedProgram(program, 0, local.keys(), fetch_names)
            prepared.fingerprint = hashlib.md5(repr(key[:4]).encode()
                                               ).hexdigest()[:12]
        self._prepared_cache[key] = prepared
        while len(self._prepared_cache) > PREPARED_LIMIT:
            del self._prepared_cache[next(iter(self._prepared_cache))]
        return prepared

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        """Run the program's global block. With use_program_cache (the
        default) the prepared program is cached, and on a CUDA place its
        device segments run eagerly once, are captured as CUDA graphs on
        the next run and replayed from then on. use_program_cache=False
        runs every op eagerly and keeps nothing."""
        t0_perf = _perf.step_begin()
        program = program or default_main_program()
        if not isinstance(program, Program):
            raise TypeError('Executor.run expects a Program')
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]

        feed = _expand_sequence_feeds(program, feed)
        local = {name: self._feed_tensor(program, name, value)
                 for name, value in feed.items()}
        prepared = None
        if use_program_cache:
            key = self._cache_key(program, local, fetch_names, scope)
            # popped and put back: the dict's order is the runs' order
            prepared = self._prepared_cache.pop(key, None)
        if prepared is None:
            prepared = PreparedProgram(program, 0, local.keys(), fetch_names)
            prepared.fingerprint = hashlib.md5(repr(
                (program._uid, program._version, sorted(
                    (n, tuple(t.shape), str(t.dtype))
                    for n, t in local.items()), fetch_names)).encode()
            ).hexdigest()[:12]
        if use_program_cache:
            self._prepared_cache[key] = prepared
            while len(self._prepared_cache) > PREPARED_LIMIT:
                del self._prepared_cache[next(iter(self._prepared_cache))]
        captured = use_program_cache and self.device.type == 'cuda'
        results = self._run_prepared(prepared, local, scope, program,
                                     captured)
        if return_numpy:
            # the host copy is the sync: stamp the step after it
            results = [_to_numpy(r) for r in results]
            _perf.step_end(t0_perf, prepared, device=self.device,
                           scope=scope)
            return results
        # detached: a fetch carries no autograd record of the step; on
        # the captured path a copy, as the next replay writes the
        # graph's tensors
        results = [_detached(r, captured) for r in results]
        _perf.step_end(t0_perf, prepared, device=self.device, scope=scope,
                       sync=results)
        return results

    def _run_prepared(self, prepared, local, scope, program, captured,
                      dist=None):
        ctx = EmitContext(self, program, prepared.block, scope, local)
        ctx.dist = dist
        ctx.wanted = prepared.wanted
        drop = prepared.drop
        check_nan_inf = get_flag('check_nan_inf')
        ctx.graphs = captured and not check_nan_inf
        with torch.no_grad():
            for step_idx, step in enumerate(prepared.steps):
                if isinstance(step, _HostStep):
                    with _prof.RecordEvent('host_op:%s' % step.op.type):
                        run_op(ctx, step.op, step.op_offset)
                    for name in drop.get(step.op_offset, ()):
                        local.pop(name, None)
                    continue
                with _prof.RecordEvent('device_segment:%d(%d ops)'
                                       % (step_idx, len(step.ops))):
                    self._run_segment(prepared, step_idx, step, ctx, drop,
                                      captured, check_nan_inf)
        results = []
        for name in prepared.fetch_names:
            if name in local:
                val = local[name]
            else:
                val = scope.find_var(name)
                if val is None:
                    raise KeyError('fetch var %r was not produced' % name)
            results.append(val)
        return results

    def _run_segment(self, prepared, step_idx, step, ctx, drop, captured,
                     check_nan_inf):
        """One run of a device segment: op by op under check_nan_inf,
        else its replay, its capture, its warm-up (its first run of a
        signature on the card) or, on the CPU, its ops. While the
        profiler traces, the run is a `segment@<key>:<phase>` range."""
        local = ctx.local
        if check_nan_inf:
            # op by op, never captured, as the JAX package runs the
            # segment eagerly in this mode
            with self._segment_range(prepared, step_idx, step,
                                     step.signature(local), 'eager'):
                self._run_ops(step, ctx, drop, checked=True)
            return
        ctx.generators = step.generators
        ctx.op_generators = step.op_generators
        sig = step.signature(local)
        runs = step.runs.get(sig, 0)
        if runs:
            self._segment_hits += 1
            _perf.jit_cache_hit()
        else:
            self._segment_misses += 1
            _perf.jit_cache_miss()
        if sig in step.graphs:
            with self._segment_range(prepared, step_idx, step, sig,
                                     'replay'):
                self._replay(step, step.graphs[sig], ctx)
        elif runs and captured:
            with self._segment_range(prepared, step_idx, step, sig,
                                     'capture'):
                step.graphs[sig] = self._compiled(
                    prepared, step_idx, step, sig, 'capture',
                    lambda: self._capture(step, ctx, drop))
        else:
            with self._segment_range(prepared, step_idx, step, sig,
                                     'eager'):
                if runs:
                    self._run_ops(step, ctx, drop)
                else:
                    run = (lambda: self._warm_up(step, ctx, drop)) \
                        if captured else \
                        (lambda: self._run_ops(step, ctx, drop))
                    self._compiled(prepared, step_idx, step, sig,
                                   'warm_up' if captured else 'compile',
                                   run)
        step.runs[sig] = runs + 1

    @staticmethod
    def _segment_range(prepared, step_idx, step, sig, phase):
        if not _prof.tracing:
            return contextlib.nullcontext()
        return _prof.segment_range(
            _prof.segment_key(prepared.fingerprint, step_idx, sig), phase,
            step)

    def _compiled(self, prepared, step_idx, step, sig, phase, run):
        """run() a segment's warm-up or capture and return what it
        returns, inside an xla.compile span when telemetry or tracing is
        on (obs/perf.py). The first signature's warm-up counts the
        segment's FLOPs into prepared.cost_flops. The compile latency is
        observed once a signature: at the capture on the card (warm-up +
        capture), at the first run elsewhere."""
        if not (_perf.enabled() or _trace.enabled()):
            return run()
        out = None
        t0 = time.perf_counter()
        with _perf.compile_span(prepared.fingerprint, step_idx,
                                len(step.ops), phase=phase):
            if phase != 'capture' and not step.runs and _perf.enabled():
                prepared.cost_flops += _perf.segment_cost(run)
            else:
                out = run()
        dt = time.perf_counter() - t0
        if phase == 'warm_up':
            step.warm_s[sig] = dt
        else:
            _perf.record_compile(dt + step.warm_s.pop(sig, 0.0))
        return out

    @staticmethod
    def _run_ops(step, ctx, drop, checked=False):
        local = ctx.local
        for op, pos in zip(step.ops, step.op_offsets):
            run_op(ctx, op, pos)
            if checked:
                check_finite(ctx, op, pos)
            for name in drop.get(pos, ()):
                local.pop(name, None)

    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm_up(self, step, ctx, drop):
        """A segment's first run: eager, on the stream it will be
        captured on, so that first-use work (cuBLAS and cuDNN handles
        and workspaces, the kernels' builds, the generators it draws
        from) is done before its capture."""
        stream = self._capture_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for t in _tensors_of(ctx.local.get(n) for n in step.in_names):
                if t.device.type == 'cuda':
                    t.record_stream(stream)
            self._run_ops(step, ctx, drop)
        current.wait_stream(stream)

    def _capture(self, step, ctx, drop):
        """Capture the segment's ops into a CUDA graph, replay it once
        for this run and return its _Graph. Run-local inputs become
        static tensors; persistables written out of place are copied back
        into the tensors the scope held (rebound_persistables)."""
        local, scope = ctx.local, ctx.scope
        static_in = {}
        for n in step.in_names:
            if n in local:
                static_in[n] = local[n] = _clone_value(local[n])
        scope_in = {n: ctx.get(n) for n in step.in_names if n not in local}
        before = {n: scope.find_var(n) for n in step.out_names
                  if ctx.is_persistable(n)}
        graph = torch.cuda.CUDAGraph()
        for gen in step.generators:
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream()
        error = None
        ctx.capturing = True
        try:
            with _CAPTURE_LOCK, \
                    kernels.recording(self.device,
                                      stream.cuda_stream) as counts, \
                    torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                     capture_error_mode='thread_local'):
                try:
                    self._run_ops(step, ctx, drop)
                    for n in rebound_persistables(before, scope):
                        new, old = scope.find_var(n), before[n]
                        _same_layout(n, new, old, 'persistable')
                        old.copy_(new)
                        _rebind(scope, n, old)
                        if n in local:
                            local[n] = old
                except Exception as e:     # noqa: BLE001 — raised below
                    error = e
        except Exception as e:             # noqa: BLE001 — raised below
            if error is None:
                error = e
        finally:
            ctx.capturing = False
        if error is not None:
            if isinstance(error, OpExecutionError):
                raise error
            first, last = step.op_offsets[0], step.op_offsets[-1]
            raise OpExecutionError(
                'capturing the device segment of ops #%d..#%d (%r..%r) '
                'as a CUDA graph failed\n  cause: %s: %s'
                % (first, last, step.ops[0].type, step.ops[-1].type,
                   type(error).__name__, error)) from error
        self._compile_count += 1
        _reseed(step)
        graph.replay()
        return _Graph(graph, static_in, scope_in,
                      {n: scope.find_var(n) for n in before},
                      {n: local[n] for n in step.out_names if n in local},
                      counts)

    def run_loop(self, ctx, op, sub_block, carried, vals, ext):
        """A while op's trips on the captured path. Each input signature
        of its body runs eagerly on its first trip (on the capture
        stream), is captured as a CUDA graph on its next and replayed on
        every later trip, of this run and of later runs. The graph copies
        each trip's carried values back into its static inputs, so a
        replayed trip is one launch and one host read of the condition.
        A body that fails to capture raises. Returns (the carried
        values, the trips)."""
        from .ops.control_flow_ops import _loop_trip, cond_value
        program = ctx._program
        key = (program._uid, program._version, op.attr('sub_block'),
               run_time_switches())
        body = self._loops.get(key)
        if body is None:
            body = self._loops[key] = _LoopBody()

        def trip(v, e, capturing):
            return _loop_trip(ctx, sub_block, carried, v, e,
                              (body.generators, body.op_generators),
                              capturing)
        bound, trips = None, 0
        while cond_value(vals[carried[0]]):
            sig = tuple((n,) + value_signature(v) for n, v in vals.items()) \
                + tuple((n,) + value_signature(v) for n, v in ext.items())
            g = body.graphs.get(sig)
            if g is None and body.runs.get(sig):
                g = body.graphs[sig] = self._capture_body(body, op, trip,
                                                          vals, ext)
                bound = g
            if g is not None:
                if bound is not g:
                    for n, v in vals.items():
                        _copy_value(g.carried[n], v)
                    for n, v in ext.items():
                        _copy_value(g.ext[n], v)
                    bound = g
                _reseed(body)
                g.graph.replay()
                kernels.count_add(g.counts)
                vals = dict(g.carried)
            else:
                vals = self._warm_up_body(trip, vals, ext)
            body.runs[sig] = body.runs.get(sig, 0) + 1
            trips += 1
        if bound is not None:
            # the static inputs are the next run's: hand out copies
            vals = {n: _clone_value(v) for n, v in vals.items()}
        return vals, trips

    def _warm_up_body(self, trip, vals, ext):
        stream = self._capture_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for t in _tensors_of(list(vals.values()) + list(ext.values())):
                if t.device.type == 'cuda':
                    t.record_stream(stream)
            new = trip(vals, ext, False)
        current.wait_stream(stream)
        return new

    def _capture_body(self, body, op, trip, vals, ext):
        carried = {n: _clone_value(v) for n, v in vals.items()}
        ext_in = {n: _clone_value(v) for n, v in ext.items()}
        graph = torch.cuda.CUDAGraph()
        for gen in body.generators:
            graph.register_generator_state(gen)
        if self._loop_pool is None:
            self._loop_pool = torch.cuda.graph_pool_handle()
        stream = self._capture_stream()
        error = None
        try:
            with _CAPTURE_LOCK, \
                    kernels.recording(self.device,
                                      stream.cuda_stream) as counts, \
                    torch.cuda.graph(graph, pool=self._loop_pool,
                                     stream=stream,
                                     capture_error_mode='thread_local'):
                try:
                    for n, v in trip(carried, ext_in, True).items():
                        _copy_back(n, carried[n], v)
                except Exception as e:     # noqa: BLE001 — raised below
                    error = e
        except Exception as e:             # noqa: BLE001 — raised below
            if error is None:
                error = e
        if error is not None:
            if isinstance(error, OpExecutionError):
                raise error
            raise OpExecutionError(
                'capturing the body of the while op (sub_block %d) as a '
                'CUDA graph failed\n  cause: %s: %s'
                % (op.attr('sub_block'), type(error).__name__,
                   error)) from error
        self._compile_count += 1
        return _BodyGraph(graph, carried, ext_in, counts)

    def _replay(self, step, g, ctx):
        local, scope = ctx.local, ctx.scope
        for n, static in g.static_in.items():
            _copy_value(static, local[n])
        for n, captured in g.scope_in.items():
            cur = scope.find_var(n)
            if cur is not captured:
                # the scope was changed behind the graph (Scope.set_var,
                # io.load_*): the graph reads the captured tensor, so the
                # new value goes there
                if cur is None:
                    raise OpExecutionError('var %r left the scope after '
                                           'its segment was captured' % n)
                cur = torch.as_tensor(cur)
                _same_layout(n, cur, captured, 'scope var')
                captured.copy_(cur)
                _rebind(scope, n, captured)
        _reseed(step)
        g.graph.replay()
        kernels.count_add(g.counts)
        local.update(g.outs)
        for n, t in g.scope_out.items():
            if scope.find_var(n) is not t:
                _rebind(scope, n, t)
