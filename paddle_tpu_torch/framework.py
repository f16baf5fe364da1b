"""Graph IR: Program / Block / Operator / Variable.

PyTorch counterpart of paddle_tpu/framework.py. The IR is the same
lightweight Python object graph, serialised to the same JSON program
desc, so a model directory saved by either package loads in the other.
What differs is only what runs it: executor.py walks a block op by op
and calls each op's PyTorch emitter eagerly.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import json

import numpy as np

from . import unique_name

__all__ = [
    'Program', 'Block', 'Operator', 'Variable', 'Parameter',
    'default_main_program', 'default_startup_program', 'program_guard',
    'switch_main_program', 'switch_startup_program',
    'convert_np_dtype', 'get_var', 'grad_var_name', 'GRAD_VAR_SUFFIX',
    'name_scope',
]

GRAD_VAR_SUFFIX = '@GRAD'


def grad_var_name(var_name):
    """Name of the gradient var of `var_name` (reference framework.py)."""
    return var_name + GRAD_VAR_SUFFIX

_DTYPE_ALIASES = {
    'float': 'float32', 'double': 'float64', 'half': 'float16',
    'int': 'int32', 'long': 'int64', 'bool_': 'bool',
    'bfloat16': 'bfloat16', 'fp32': 'float32', 'fp16': 'float16',
    'bf16': 'bfloat16', 'fp64': 'float64',
}
_VALID_DTYPES = frozenset([
    'float16', 'bfloat16', 'float32', 'float64',
    'int8', 'uint8', 'int16', 'int32', 'int64', 'bool',
])


def convert_np_dtype(dtype):
    """Normalise any dtype spec (np.dtype, type, str) to a canonical string."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = _DTYPE_ALIASES.get(dtype, dtype)
    else:
        name = np.dtype(dtype).name
        name = _DTYPE_ALIASES.get(name, name)
    if name not in _VALID_DTYPES:
        raise ValueError('unsupported dtype: %r' % (dtype,))
    return name


class VarType:
    """Variable kinds (the JAX package's subset of the reference's)."""
    LOD_TENSOR = 'lod_tensor'
    SELECTED_ROWS = 'selected_rows'
    LOD_TENSOR_ARRAY = 'lod_tensor_array'
    READER = 'reader'
    RAW = 'raw'
    STEP_SCOPES = 'step_scopes'
    LOD_RANK_TABLE = 'lod_rank_table'


class Variable(object):
    """A typed symbolic value in a Block. Runtime values live in a Scope
    (executor.py) keyed by name."""

    def __init__(self, block, name=None, shape=None, dtype=None, lod_level=None,
                 persistable=False, stop_gradient=False, type=VarType.LOD_TENSOR,
                 is_data=False, is_cache=False, initializer=None,
                 error_clip=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_np_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level if lod_level is not None else 0
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        # runtime-state var (serving KV cache): persistable so the
        # executor writes it back to the Scope across run() calls, but
        # excluded from save/load_persistables (io.py predicate)
        self.is_cache = is_cache
        # taken as the JAX package's Variable takes them: the initializer
        # is not run here (LayerHelper.set_variable_initializer does that),
        # and any other keyword (capacity=, ...) is taken and ignored
        self.error_clip = error_clip
        # a sequence var's [B] int32 lengths companion (set for
        # lod_level > 0 feeds; layers carry it through the ops that keep
        # the time axis, LayerHelper._propagate_seq_lens)
        self.seq_lens = None

    def to_string(self):
        flags = []
        if self.persistable:
            flags.append('persistable')
        if self.stop_gradient:
            flags.append('stop_gradient')
        if self.is_data:
            flags.append('data')
        extra = (' [' + ', '.join(flags) + ']') if flags else ''
        return 'var %s : %s shape=%s lod_level=%d%s' % (
            self.name, self.dtype, list(self.shape or ()), self.lod_level, extra)

    __repr__ = to_string
    __str__ = to_string

    def astype(self, dtype):
        from .layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    @property
    def grad_name(self):
        return grad_var_name(self.name)


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError('Parameter must have shape and dtype')
        kwargs.setdefault('persistable', True)
        self.trainable = kwargs.pop('trainable', True)
        self.optimize_attr = kwargs.pop('optimize_attr', {'learning_rate': 1.0})
        self.regularizer = kwargs.pop('regularizer', None)
        self.gradient_clip_attr = kwargs.pop('gradient_clip_attr', None)
        self.do_model_average = kwargs.pop('do_model_average', None)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype, **kwargs)


class Operator(object):
    """One op invocation: type + named input/output var lists + attrs.
    inputs/outputs map slot name -> list of variable names."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.attrs = dict(attrs) if attrs else {}

        def _canon(mapping):
            out = collections.OrderedDict()
            for slot, vars_ in (mapping or {}).items():
                if vars_ is None:
                    out[slot] = []
                    continue
                if not isinstance(vars_, (list, tuple)):
                    vars_ = [vars_]
                names = []
                for v in vars_:
                    if isinstance(v, Variable):
                        names.append(v.name)
                    elif isinstance(v, str):
                        names.append(v)
                    else:
                        raise TypeError(
                            'op %s: expected Variable or str, got %r' % (type, v))
                out[slot] = names
            return out

        self.inputs = _canon(inputs)
        self.outputs = _canon(outputs)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def single_input(self, slot):
        names = self.input(slot)
        if len(names) != 1:
            raise ValueError('op %s slot %s: expected one input, got %r'
                             % (self.type, slot, names))
        return names[0]

    def single_output(self, slot):
        names = self.output(slot)
        if len(names) != 1:
            raise ValueError('op %s slot %s: expected one output, got %r'
                             % (self.type, slot, names))
        return names[0]

    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns if n]

    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns if n]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def has_attr(self, name):
        return name in self.attrs

    def set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def rename_input(self, old, new):
        for slot, names in self.inputs.items():
            self.inputs[slot] = [new if n == old else n for n in names]

    def rename_output(self, old, new):
        for slot, names in self.outputs.items():
            self.outputs[slot] = [new if n == old else n for n in names]

    def to_string(self):
        ins = ', '.join('%s=%s' % (k, v) for k, v in self.inputs.items())
        outs = ', '.join('%s=%s' % (k, v) for k, v in self.outputs.items())
        attrs = {k: v for k, v in self.attrs.items()
                 if not k.startswith('op_')}
        sattrs = ', '.join(
            '%s=%s' % (k, _short(v)) for k, v in sorted(attrs.items()))
        return '{%s} = %s(%s)%s' % (
            outs, self.type, ins, (' attrs(%s)' % sattrs) if sattrs else '')

    __repr__ = to_string
    __str__ = to_string


def _short(v):
    s = repr(v)
    return s if len(s) <= 60 else s[:57] + '...'


class Block(object):
    """Ordered op list + var table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()   # name -> Variable
        self.ops = []                            # list[Operator]

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs):
        var = Variable(self, **kwargs)
        if var.name in self.vars:
            raise ValueError('duplicate var %s in block %d' % (var.name, self.idx))
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        # parameters always live in the program's global block
        global_block = self.program.global_block()
        param = Parameter(global_block, **kwargs)
        if param.name in global_block.vars:
            raise ValueError('duplicate parameter %s' % param.name)
        global_block.vars[param.name] = param
        self.program._bump_version()
        return param

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent_block
        return False

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError('var %r not in block %d' % (name, self.idx))
        return v

    def var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise KeyError('var %r not found in block %d or ancestors' % (name, self.idx))

    def all_parameters(self):
        return [v for v in self.program.global_block().vars.values()
                if isinstance(v, Parameter)]

    def rename_var(self, old, new):
        v = self.vars.pop(old)
        v.name = new
        self.vars[new] = v
        for op in self.ops:
            op.rename_input(old, new)
            op.rename_output(old, new)
        self.program._bump_version()
        return v

    def remove_var(self, name):
        self.vars.pop(name, None)
        self.program._bump_version()

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self._insert_op(len(self.ops), type, inputs, outputs, attrs,
                               stamp=True)

    def _prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        """An op that runs first in the block (the step counter's
        increment, layers.autoincreased_step_counter)."""
        return self._insert_op(0, type, inputs, outputs, attrs)

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None,
                   stamp=False):
        op = Operator(self, type, inputs, outputs, attrs)
        # pipeline-stage annotation (parallel.api.pipeline_stage_guard):
        # an appended op built under an active guard carries its stage id
        stage = getattr(self.program, '_pp_stage', None) if stamp else None
        if stage is not None and 'pp_stage' not in op.attrs:
            op.attrs['pp_stage'] = stage
        self.ops.insert(index, op)
        self.program._bump_version()
        from . import registry
        registry.infer_shape(op, self)
        return op

    def remove_op(self, index):
        self.ops.pop(index)
        self.program._bump_version()

    def to_string(self):
        lines = ['-- block %d (parent %d) --' % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append('    ' + v.to_string())
        for i, op in enumerate(self.ops):
            lines.append('  op%-3d %s' % (i, op.to_string()))
        return '\n'.join(lines)

    __repr__ = to_string
    __str__ = to_string


class Program(object):
    """A whole computation: list of blocks, block 0 is global."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._uid = next(Program._uid_counter)
        # bumped on every mutation; keys the Executor's prepared programs
        self._version = 0
        self._is_test = False
        # AMP (contrib/mixed_precision.py): bf16 compute, fp32 master
        # weights; read by the Executor as EmitContext.amp
        self._use_bf16 = False
        # seeds the Executor's torch.Generator for the startup program's
        # random ops (0 = a fresh random seed per Executor)
        self.random_seed = 0

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    def _create_block(self, parent_idx=None):
        """Append a sub-block of the current block (or of `parent_idx`)
        and make it current: layers then build into it until
        _rollback."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def block(self, idx):
        return self.blocks[idx]

    def clone(self, for_test=False):
        """Deep-copy the program. With for_test=True, backward/optimize
        ops are stripped and dropout/batch_norm switch to is_test."""
        p = copy.deepcopy(self)
        p._uid = next(Program._uid_counter)
        if for_test:
            for block in p.blocks:
                kept = []
                for op in block.ops:
                    if op.attr('op_role', 'forward') in ('backward', 'optimize'):
                        continue
                    if op.type in ('dropout', 'batch_norm'):
                        op.attrs['is_test'] = True
                    kept.append(op)
                block.ops[:] = kept
            p._is_test = True
        return p

    def _prune(self, targets, feeds=()):
        """A new program keeping only the ops needed to compute targets.
        Vars in `feeds` are graph boundaries: their producers are cut."""
        target_names = {t.name if isinstance(t, Variable) else t
                        for t in targets}
        feed_names = {f.name if isinstance(f, Variable) else f
                      for f in feeds}
        p = copy.deepcopy(self)
        p._uid = next(Program._uid_counter)
        block = p.global_block()
        needed = set(target_names) - feed_names
        kept = []
        for op in reversed(block.ops):
            if op.type == 'fetch':
                continue
            if set(op.output_arg_names()) & needed:
                kept.append(op)
                needed.update(op.input_arg_names())
                needed -= feed_names
        kept.reverse()
        block.ops[:] = kept
        used = set(target_names)
        for op in block.ops:
            used.update(op.input_arg_names())
            used.update(op.output_arg_names())
        for name in list(block.vars):
            if name not in used:
                del block.vars[name]
        return p

    def list_vars(self):
        for block in self.blocks:
            for var in block.vars.values():
                yield var

    def to_string(self, throw_on_error=False):
        return '\n'.join(b.to_string() for b in self.blocks)

    __repr__ = to_string
    __str__ = to_string

    # -- (de)serialization: the JSON program desc of paddle_tpu ------------
    def to_json(self):
        def var_d(v):
            return {
                'name': v.name, 'shape': list(v.shape) if v.shape else None,
                'dtype': v.dtype, 'lod_level': v.lod_level,
                'persistable': v.persistable, 'stop_gradient': v.stop_gradient,
                'type': v.type, 'is_data': v.is_data,
                'is_cache': v.is_cache,
                'is_parameter': isinstance(v, Parameter),
                'trainable': getattr(v, 'trainable', None),
            }

        def op_d(op):
            return {'type': op.type, 'inputs': op.inputs,
                    'outputs': op.outputs, 'attrs': _json_attrs(op.attrs)}

        return json.dumps({
            'version': 1,
            'blocks': [{
                'idx': b.idx, 'parent_idx': b.parent_idx,
                'vars': [var_d(v) for v in b.vars.values()],
                'ops': [op_d(o) for o in b.ops],
            } for b in self.blocks],
        })

    @staticmethod
    def from_json(s):
        d = json.loads(s)
        p = Program()
        p.blocks = []
        for bd in d['blocks']:
            b = Block(p, bd['idx'], bd['parent_idx'])
            for vd in bd['vars']:
                cls = Parameter if vd.get('is_parameter') else Variable
                kwargs = dict(name=vd['name'], shape=vd['shape'],
                              dtype=vd['dtype'], lod_level=vd['lod_level'],
                              persistable=vd['persistable'],
                              stop_gradient=vd['stop_gradient'],
                              type=vd['type'], is_data=vd['is_data'],
                              is_cache=vd.get('is_cache', False))
                if vd.get('is_parameter'):
                    kwargs['trainable'] = vd.get('trainable', True)
                v = cls(b, **kwargs)
                b.vars[v.name] = v
            for od in bd['ops']:
                b.ops.append(Operator(b, od['type'], od['inputs'],
                                      od['outputs'], od['attrs']))
            p.blocks.append(b)
        return p


def _json_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# default programs + guards
# ---------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


_name_scope_stack = []


@contextlib.contextmanager
def name_scope(prefix=None):
    """Op-name scoping for debugging and drawing; names nothing."""
    _name_scope_stack.append(prefix or '')
    try:
        yield
    finally:
        _name_scope_stack.pop()


def get_var(name, program=None):
    """Variable lookup in a program's global block."""
    if program is None:
        program = default_main_program()
    return program.global_block().var(name)
