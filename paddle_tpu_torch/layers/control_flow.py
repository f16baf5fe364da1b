"""Control-flow layers (counterpart of paddle_tpu/layers/control_flow.py):
the comparisons (:89-105), increment (:108), Print (:122), the
rematerialization scope recompute (:28-90) and the block-building
helpers BlockGuard and _external_deps (:186-215). While, Switch, IfElse,
StaticRNN and the rest wait (ROADMAP.md, Queue 1)."""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = ['less_than', 'less_equal', 'greater_than', 'greater_equal',
           'equal', 'not_equal', 'increment', 'Print', 'recompute']


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
