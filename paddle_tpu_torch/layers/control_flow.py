"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py):
the comparisons (:89-105), increment (:108), is_empty (:113), Print
(:122), the tensor arrays (:130-180), the rematerialization scope
recompute (:28-90), the block-building helpers (:186-237), While
(:239), Switch and ConditionalBlock (:278-356), IfElse (:359), StaticRNN
(:413), DynamicRNN (:572), lod_rank_table and
reorder_lod_tensor_by_rank (:618-652), with the JAX package's error
types and messages.

Each construct builds a sub-block and one op over it
(ops/control_flow_ops.py): While a while op (a host step between
captured segments), Switch a chain of conditional_blocks (selects on
the device), StaticRNN and DynamicRNN a recurrent op (a loop of the
step over T, its grad from the forward's record). DynamicRNN runs over
a padded batch and its lengths, masking a finished row's state, as in
the JAX package; IfElse computes both branches on the whole batch and
selects row by row.
"""
from __future__ import annotations

import contextlib

from ..framework import VarType, default_main_program
from ..layer_helper import LayerHelper
from .. import unique_name

__all__ = ['While', 'Switch', 'IfElse', 'StaticRNN',
           'DynamicRNN', 'array_write', 'array_read', 'array_length',
           'create_array', 'less_than', 'less_equal', 'greater_than',
           'greater_equal', 'equal', 'not_equal', 'increment', 'is_empty',
           'max_sequence_len', 'Print', 'recompute', 'lod_rank_table',
           'reorder_lod_tensor_by_rank']


def _compare(op_type):
    def layer(x, y, cond=None, force_cpu=None, name=None):
        from .nn import binary_bool_op
        return binary_bool_op(op_type, x, y, out=cond, name=name)
    layer.__name__ = op_type
    return layer


less_than = _compare('less_than')
less_equal = _compare('less_equal')
greater_than = _compare('greater_than')
greater_equal = _compare('greater_equal')
equal = _compare('equal')
not_equal = _compare('not_equal')


def increment(x, value=1.0, in_place=True):
    from . import ops as _ops
    return _ops.increment(x, value=value, in_place=in_place)


def is_empty(x, cond=None):
    helper = LayerHelper('is_empty')
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool')
    helper.append_op(type='is_empty', inputs={'X': [x]},
                     outputs={'Out': [cond]})
    return cond


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase='both'):
    """A print host op over `input` (writes its value to stderr at each
    run, the first `first_n` runs when first_n > 0); returns `input`."""
    helper = LayerHelper('print')
    helper.append_op(
        type='print', inputs={'In': [input]}, outputs={'Out': [input]},
        attrs={'first_n': first_n, 'message': message or '',
               'summarize': summarize})
    return input


def recompute(build_fn, *inputs, **kwargs):
    """Rematerialization scope: build `build_fn(*inputs)` into a
    sub-block run by one remat_block op. Only the returned variables
    (and the outer vars the scope writes) outlive the forward; the
    gradient pass runs the scope again to rebuild the rest
    (ops/control_flow_ops.py). policy='dots' also keeps the outputs of
    the matrix products (mul, matmul), as
    jax.checkpoint_policies.checkpoint_dots does in the JAX package:
    less recompute, more memory. Returns the output Variable(s), usable
    after the scope like any other var.

        y = layers.recompute(lambda h: transformer_block(h), x)
    """
    policy = kwargs.pop('policy', 'nothing')
    if kwargs:
        raise TypeError('recompute: unknown kwargs %r' % list(kwargs))
    program = default_main_program()
    parent_block = program.current_block()
    with BlockGuard(program) as sub_block:
        outs = build_fn(*inputs)
    single = not isinstance(outs, (list, tuple))
    out_list = [outs] if single else list(outs)
    x_names = _external_deps(sub_block)
    out_names = [v.name for v in out_list]
    # writes to OUTER vars (batch-norm running statistics, accumulators)
    # leave the scope too, beside the returned outputs
    for op in sub_block.ops:
        for n in op.output_arg_names():
            if n not in sub_block.vars and n not in out_names:
                out_names.append(n)
    # hoist the outputs' descs into the parent block, so later layers
    # (and shape inference) resolve them outside the scope
    hoisted = []
    for v in out_list:
        if v.name in sub_block.vars:
            hoisted.append(parent_block.create_var(
                name=v.name, shape=v.shape, dtype=v.dtype))
        else:
            hoisted.append(v)
    # rng_tag: a build-time key for the scope's random draws (the JAX
    # package folds it into the key; the port seeds the scope's
    # generators from it)
    parent_block.append_op(
        type='remat_block',
        inputs={'X': x_names},
        outputs={'Out': out_names},
        attrs={'sub_block': sub_block.idx, 'policy': policy,
               'rng_tag': 7919 + sub_block.idx})
    return hoisted[0] if single else hoisted


class BlockGuard(object):
    """Enter a fresh sub-block of the main program on __enter__ and roll
    back on __exit__."""

    def __init__(self, main_program=None):
        self.main_program = main_program or default_main_program()

    def __enter__(self):
        self.block = self.main_program._create_block()
        return self.block

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program._rollback()
        return False


def _external_deps(sub_block):
    """Vars a sub-block reads but does not itself define: the
    control-flow op's X inputs, so dataflow analysis sees them."""
    defined = set(sub_block.vars)
    written = set()
    reads = []
    for op in sub_block.ops:
        for n in op.input_arg_names():
            if n not in defined and n not in written and n not in reads:
                reads.append(n)
        written.update(op.output_arg_names())
    return reads


def _sub_block_io(sub_block):
    """(x_names, out_names) of a control-flow op over sub_block. The Out
    vars (the outer vars the body writes) are inputs too: a while carries
    them from their values before the loop, and a conditional_block
    keeps them where its condition is false, so dataflow must route them
    in, also where they live only in the scope (a persistable learning
    rate set by the startup program)."""
    x_names = _external_deps(sub_block)
    out_names = []
    for op in sub_block.ops:
        for n in op.output_arg_names():
            if n not in sub_block.vars and n not in out_names:
                out_names.append(n)
    for n in out_names:
        if n not in x_names:
            x_names.append(n)
    return x_names, out_names


@contextlib.contextmanager
def _in_block(program, block):
    """Build into `block` for the body, then return to the current one."""
    prev_idx = program.current_block_idx
    program.current_block_idx = block.idx
    try:
        yield
    finally:
        program.current_block_idx = prev_idx


# -- tensor arrays ---------------------------------------------------------------

def create_array(dtype):
    helper = LayerHelper('array')
    return helper.main_program.current_block().create_var(
        name=unique_name.generate('array'), type=VarType.LOD_TENSOR_ARRAY,
        dtype=dtype)


def array_write(x, i, array=None):
    helper = LayerHelper('array_write')
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type='write_to_array', inputs={'X': [x], 'I': [i]},
                     outputs={'Out': [array]})
    return array


def array_read(array, i):
    helper = LayerHelper('array_read')
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type='read_from_array',
                     inputs={'X': [array], 'I': [i]},
                     outputs={'Out': [out]})
    return out


def array_length(array):
    helper = LayerHelper('array_length')
    out = helper.create_variable_for_type_inference(dtype='int64')
    out.shape = (1,)
    helper.append_op(type='lod_array_length', inputs={'X': [array]},
                     outputs={'Out': [out]})
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper('max_sequence_len')
    out = helper.create_variable_for_type_inference(dtype='int64')
    out.shape = (1,)
    helper.append_op(type='max_sequence_len',
                     inputs={'RankTable': [rank_table]},
                     outputs={'Out': [out]})
    return out


# -- While -----------------------------------------------------------------------

class While(object):
    """
        cond = layers.less_than(i, limit)
        while_op = layers.While(cond)
        with while_op.block():
            ...the body, which must re-assign cond...
    """

    def __init__(self, cond, name=None):
        if cond.dtype != 'bool':
            raise TypeError('While condition must be bool')
        self.cond_var = cond
        self.helper = LayerHelper('while', name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        with BlockGuard(program) as sub_block:
            yield
        x_names, out_names = _sub_block_io(sub_block)
        step_scope = parent_block.create_var(
            name=unique_name.generate('while_scope'),
            type=VarType.STEP_SCOPES)
        parent_block.append_op(
            type='while',
            inputs={'X': x_names, 'Condition': [self.cond_var]},
            outputs={'Out': out_names, 'StepScopes': [step_scope]},
            attrs={'sub_block': sub_block.idx})


# -- Switch and ConditionalBlock ---------------------------------------------------

class Switch(object):
    """
        with layers.Switch() as switch:
            with switch.case(cond1): ...assign...
            with switch.default(): ...assign...

    The first matching case wins: each case's condition is conjoined
    with the negation of every earlier one, and each case becomes a
    conditional_block."""

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self.pre_not_conditions = []
        self.inside = False

    @contextlib.contextmanager
    def case(self, condition):
        from .nn import logical_and, logical_not
        if self.pre_not_conditions:
            cond = logical_and(x=self.pre_not_conditions[-1], y=condition)
        else:
            cond = condition
        not_cond = logical_not(x=condition)
        if self.pre_not_conditions:
            not_cond = logical_and(x=self.pre_not_conditions[-1], y=not_cond)
        self.pre_not_conditions.append(not_cond)
        with ConditionalBlock(cond).block():
            yield

    @contextlib.contextmanager
    def default(self):
        if not self.pre_not_conditions:
            raise ValueError('default case must follow at least one case')
        with ConditionalBlock(self.pre_not_conditions[-1]).block():
            yield

    def __enter__(self):
        self.inside = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside = False
        return False


class ConditionalBlock(object):
    """A sub-block run where its condition holds (the reference's
    ConditionalBlock)."""

    def __init__(self, condition, is_scalar_condition=True, name=None):
        self.cond_vars = condition if isinstance(condition, (list, tuple)) \
            else [condition]
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper('conditional_block', name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        with BlockGuard(program) as sub_block:
            yield
        x_names, out_names = _sub_block_io(sub_block)
        scope_var = parent_block.create_var(
            name=unique_name.generate('cond_block_scope'),
            type=VarType.STEP_SCOPES)
        parent_block.append_op(
            type='conditional_block',
            inputs={'Cond': list(self.cond_vars), 'X': x_names},
            outputs={'Out': out_names, 'Scope': [scope_var]},
            attrs={'sub_block': sub_block.idx,
                   'is_scalar_condition': self.is_scalar_condition})


_ConditionalBlock = ConditionalBlock


# -- IfElse ------------------------------------------------------------------------

class IfElse(object):
    """Both branches compute on the whole batch; each output is selected
    row by row by the [B, 1] bool condition (the reference partitions
    the rows between the branches instead)."""
    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper('ifelse', name=name)
        self._true_outs = None
        self._false_outs = None
        self._in_true = False

    @contextlib.contextmanager
    def true_block(self):
        self._in_true = True
        yield
        self._in_true = False

    @contextlib.contextmanager
    def false_block(self):
        self._in_true = False
        yield

    def input(self, x):
        return x

    def output(self, *outs):
        if self._in_true:
            self._true_outs = list(outs)
        else:
            self._false_outs = list(outs)

    def __call__(self):
        if self._true_outs is None or self._false_outs is None:
            raise ValueError('both branches must call output()')
        from .nn import where_select
        return [where_select(self.cond, t, f)
                for t, f in zip(self._true_outs, self._false_outs)]


# -- StaticRNN -----------------------------------------------------------------------

class StaticRNN(object):
    """
        rnn = layers.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x_seq)        # x_seq: [T, B, D]
            prev = rnn.memory(shape=[B, H]) or rnn.memory(init=h0)
            hidden = layers.fc(input=[word, prev], size=H)
            rnn.update_memory(prev, hidden)
            rnn.step_output(hidden)
        outs = rnn()                             # [T, B, H]
    """

    def __init__(self, name=None, seq_lens=None, reverse=False):
        self.helper = LayerHelper('static_rnn', name=name)
        self.seq_lens = seq_lens       # optional [B] int lengths: masking
        self.reverse = reverse
        self.seq_inputs = []           # (outer var, in-block var)
        self.memories = []
        self.outputs = []              # in-block vars
        self.sub_block = None
        self._status = 'outside'

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self.parent_block = program.current_block()
        with BlockGuard(program) as sub_block:
            self.sub_block = sub_block
            self._status = 'inside'
            yield
            self._status = 'after'
        self._complete_op()

    def step_input(self, x):
        if self._status != 'inside':
            raise RuntimeError('step_input must be called inside step()')
        ipt = self.sub_block.create_var(
            name=unique_name.generate('rnn_input'),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self.seq_inputs.append((x, ipt))
        return ipt

    def memory(self, init=None, shape=None, value=0.0, dtype='float32',
               batch_ref=None, ref_batch_dim_idx=0, init_batch_dim_idx=0):
        if self._status != 'inside':
            raise RuntimeError('memory must be called inside step()')
        if init is None:
            if shape is None:
                raise ValueError('memory needs init var or shape')
            from . import tensor as tensor_layers
            # the initial value is built in the PARENT block
            with _in_block(self.helper.main_program, self.parent_block):
                init = tensor_layers.fill_constant(
                    shape=list(shape), dtype=dtype, value=value)
        pre_mem = self.sub_block.create_var(
            name=unique_name.generate('rnn_mem'),
            shape=tuple(init.shape), dtype=init.dtype)
        self.memories.append({'init': init, 'pre': pre_mem, 'new': None})
        return pre_mem

    def update_memory(self, mem, var):
        for m in self.memories:
            if m['pre'] is mem:
                m['new'] = var
                return
        raise ValueError('update_memory: unknown memory var')

    def step_output(self, o):
        if self._status != 'inside':
            raise RuntimeError('step_output must be called inside step()')
        self.outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete_op(self):
        for m in self.memories:
            if m['new'] is None:
                raise ValueError('memory %s never updated' % m['pre'].name)
        T = self.seq_inputs[0][0].shape[0] if self.seq_inputs else None
        out_vars = [self.parent_block.create_var(
            name=unique_name.generate('rnn_out'),
            shape=(T,) + tuple(o.shape or ()), dtype=o.dtype)
            for o in self.outputs]
        final_vars = [self.parent_block.create_var(
            name=unique_name.generate('rnn_final'),
            shape=tuple(m['init'].shape), dtype=m['init'].dtype)
            for m in self.memories]
        # the step block's external reads, without the placeholders the
        # recurrence itself feeds
        fed = {v.name for _, v in self.seq_inputs}
        fed |= {m['pre'].name for m in self.memories}
        params = [n for n in _external_deps(self.sub_block) if n not in fed]
        attrs = {
            'sub_block': self.sub_block.idx,
            'step_input_names': [v.name for _, v in self.seq_inputs],
            'ex_states': [m['pre'].name for m in self.memories],
            'states': [m['new'].name for m in self.memories],
            'output_names': [o.name for o in self.outputs],
            'reverse': self.reverse,
            'seq_lens_name': self.seq_lens.name
            if self.seq_lens is not None else '',
        }
        inputs = {
            'inputs': [x for x, _ in self.seq_inputs],
            'initial_states': [m['init'] for m in self.memories],
            'parameters': params,
        }
        if self.seq_lens is not None:
            inputs['parameters'] = params + [self.seq_lens.name]
        self.parent_block.append_op(
            type='recurrent', inputs=inputs,
            outputs={'outputs': out_vars, 'final_states': final_vars},
            attrs=attrs)
        self._out_vars = out_vars
        self._final_vars = final_vars

    def __call__(self, *args, **kwargs):
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars

    def final_states(self):
        if len(self._final_vars) == 1:
            return self._final_vars[0]
        return self._final_vars


# -- DynamicRNN ----------------------------------------------------------------------

class DynamicRNN(object):
    """A variable-length RNN over a padded batch and its lengths. The
    reference shrinks the batch as sequences finish (lod_rank_table,
    shrink_rnn_memory); here the batch stays whole and a finished row's
    state is masked, which gives the same final states and outputs in
    static shapes. block() runs over time-major [T, B, ...] views of
    batch-major [B, T, ...] inputs: step_input transposes them."""

    def __init__(self, name=None):
        self.helper = LayerHelper('dynamic_rnn', name=name)
        self._rnn = None
        self._lens = None
        self._outputs = []

    @contextlib.contextmanager
    def block(self, seq_lens=None):
        self._rnn = StaticRNN(seq_lens=seq_lens)
        self._lens = seq_lens
        with self._rnn.step():
            yield

    def step_input(self, x, batch_major=True):
        from . import nn as nn_layers
        if batch_major:
            # the transpose goes in the PARENT block: this is the step's
            with _in_block(self.helper.main_program, self._rnn.parent_block):
                x = nn_layers.transpose(
                    x, perm=[1, 0] + list(range(2, len(x.shape))))
        return self._rnn.step_input(x)

    def memory(self, **kwargs):
        return self._rnn.memory(**kwargs)

    def update_memory(self, mem, var):
        return self._rnn.update_memory(mem, var)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self, batch_major=True):
        from . import nn as nn_layers
        outs = self._rnn()
        single = not isinstance(outs, (list, tuple))
        outs_list = [outs] if single else list(outs)
        if batch_major:
            outs_list = [nn_layers.transpose(
                o, perm=[1, 0] + list(range(2, len(o.shape))))
                for o in outs_list]
        return outs_list[0] if single else outs_list

    def final_states(self):
        return self._rnn.final_states()


def lod_rank_table(x, level=0):
    """The batch permutation that sorts rows by descending sequence length
    (the padded contract's RankTable)."""
    helper = LayerHelper('lod_rank_table')
    out = helper.create_variable_for_type_inference('int32')
    inputs = {'X': [x]}
    lens = getattr(x, 'seq_lens', None)
    if lens is not None:
        inputs['SeqLens'] = [lens]
    helper.append_op(type='lod_rank_table', inputs=inputs,
                     outputs={'Out': [out]})
    out.stop_gradient = True
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """x's batch rows gathered into rank-table order (its lengths too)."""
    helper = LayerHelper('reorder_lod_tensor_by_rank')
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {'X': [x], 'RankTable': [rank_table]}
    outputs = {'Out': [out]}
    lens = getattr(x, 'seq_lens', None)
    if lens is not None:
        out_lens = helper.create_variable_for_type_inference('int32')
        inputs['SeqLens'] = [lens]
        outputs['OutLens'] = [out_lens]
        out.seq_lens = out_lens
        out.lod_level = max(1, x.lod_level)
    helper.append_op(type='reorder_lod_tensor_by_rank', inputs=inputs,
                     outputs=outputs)
    return out
