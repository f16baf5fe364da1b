"""Executor: runs program blocks eagerly, op by op, with PyTorch.

Counterpart of paddle_tpu/executor.py. The JAX package compiles a whole
block into one XLA computation; here each op's emitter (registry.py)
runs as soon as it is reached, on tensors that live on the Executor's
place. There is no jit and no segment split: save/load ops are emitters
like any other. Feeds go numpy -> tensor on the place; fetches come back
as numpy unless return_numpy=False.

Places: CUDAPlace(i) is the default. With no place given and no card
present, Executor() raises instead of quietly running on the CPU; the
CPU is used only when the caller passes CPUPlace().
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import registry
from .framework import default_main_program, Program, Variable

__all__ = ['Executor', 'Scope', 'global_scope', 'scope_guard',
           'CPUPlace', 'CUDAPlace', 'fetch_var', 'OpExecutionError',
           'torch_dtype']


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


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


# ---------------------------------------------------------------------------
# Emit context
# ---------------------------------------------------------------------------

class EmitContext(object):
    """What an op emitter sees: the run-local values, the scope behind
    them, the block (for declared var metadata), the device and the
    executor's random generator."""

    __slots__ = ('local', 'scope', 'block', 'device', '_executor',
                 '_program')

    def __init__(self, executor, program, block, scope, local):
        self._executor = executor
        self._program = program
        self.block = block
        self.scope = scope
        self.local = local
        self.device = executor.device

    def get(self, name):
        if name in self.local:
            return self.local[name]
        val = self.scope.find_var(name)
        if val is None:
            raise RuntimeError(
                'var %r used before initialization -- did you run the '
                'startup program?' % name)
        if not isinstance(val, torch.Tensor):
            # a host value put in the scope by hand: move it to the place
            # once, in the scope that holds it
            val = torch.as_tensor(np.asarray(val), device=self.device)
            s = self.scope
            while name not in s._vars:
                s = s.parent
            s.set_var(name, val)
        return val

    def set(self, name, value):
        """Persistable outputs (parameters, K/V caches) go to the scope;
        everything else stays run-local."""
        self.local[name] = value
        try:
            var = self.block.var_recursive(name)
        except KeyError:
            var = None
        if var is not None and var.persistable:
            self.scope.set_var(name, value)

    def var(self, name):
        return self.block.var_recursive(name)

    def generator(self, op):
        """torch.Generator for a random op: the op's own seed attr when
        it has one, else the executor's generator seeded from
        Program.random_seed."""
        seed = op.attr('seed', 0)
        if seed:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(seed))
            return g
        return self._executor._generator(self._program)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class Executor(object):
    def __init__(self, place=None):
        self.place = _resolve_place(place)
        self.device = self.place.device
        self._gen = None
        self._gen_seed = None

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
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if var is not None and var.dtype is not None and \
                t.dtype != torch_dtype(var.dtype):
            t = t.to(torch_dtype(var.dtype))
        return t

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name='feed', fetch_var_name='fetch', scope=None,
            return_numpy=True, use_program_cache=True):
        program = program or default_main_program()
        if not isinstance(program, Program):
            raise TypeError('Executor.run expects a Program')
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]

        local = {name: self._feed_tensor(program, name, value)
                 for name, value in feed.items()}
        block = program.global_block()
        ctx = EmitContext(self, program, block, scope, local)
        with torch.no_grad():
            for pos, op in enumerate(block.ops):
                if op.type in ('feed', 'fetch'):
                    continue
                opdef = registry.get_op(op.type)
                if opdef.emit is None:
                    raise KeyError('op %r has no emitter registered'
                                   % op.type)
                try:
                    opdef.emit(ctx, op)
                except OpExecutionError:
                    raise
                except Exception as e:
                    raise OpExecutionError(
                        'Error running %s\n  cause: %s: %s'
                        % (_describe_op(op, block, pos), type(e).__name__,
                           e)) from e

        results = []
        for name in fetch_names:
            if name in local:
                val = local[name]
            else:
                val = scope.find_var(name)
                if val is None:
                    raise KeyError('fetch var %r was not produced' % name)
            results.append(_to_numpy(val) if return_numpy else val)
        return results
