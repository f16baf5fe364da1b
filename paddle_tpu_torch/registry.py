"""Op registry: shape/dtype inference, PyTorch emitters, grad makers.

Counterpart of paddle_tpu/registry.py:41-339. Every op registers an
*emitter*, fn(ctx, op), that reads its inputs from the context as
tensors, computes with PyTorch and writes its outputs back; the
Executor (executor.py) calls the emitters of a block one by one. Grad
makers (OpDef.grad) append grad ops to the Program at build time
(backward.py), exactly as in the JAX package, so the Program text after
`minimize` is the same in both packages.

Gradients of most ops come from a *recorded forward* instead of a
replay. The JAX package's register_vjp_grad re-traces the forward
emitter under jax.vjp inside every grad op and leaves it to XLA to merge
that replay with the live forward; eager PyTorch has no such merge, so
a replay would run every forward twice. Here:

- when a block holds `<type>_grad` ops, the Executor runs each forward
  op that one of them names (its `__fwd_outputs__` attr) under
  torch.enable_grad(), on `detach().requires_grad_()` copies of its
  differentiable inputs, so each op's autograd graph stays local to it;
- the grad op takes that record (inputs and outputs of one op in this
  run), calls torch.autograd.grad on it with the incoming cotangents,
  writes the grads to its actual output names and drops the record;
- a grad op whose forward was not recorded in the same run raises: the
  port never replays a forward, with one exception by design:
  `remat_block_grad` (ops/control_flow_ops.py), the rematerialization
  scope's grad, re-runs its sub-block from the recorded inputs under
  torch.enable_grad() and differentiates that; its forward runs under
  torch.no_grad() and records only its inputs, outputs and random
  state.

Ops with hand-written grad makers (lookup_table, reshape2, transpose2)
keep them, with plain emitters for their grad ops.
"""
from __future__ import annotations

import torch

from .framework import grad_var_name

__all__ = ['OpDef', 'register_op', 'get_op', 'infer_shape',
           'op_emitter', 'same_shape_infer', 'simple_grad_maker',
           'elementwise_unary_grad', 'register_vjp_grad', 'vjp_grad_maker',
           'input_grads', 'write_input_grads', 'record_key', 'amp_cast']


class OpDef(object):
    __slots__ = ('type', 'infer_shape', 'emit', 'grad', 'host', 'no_grad',
                 'vjp_slots')

    def __init__(self, type):
        self.type = type
        self.infer_shape = None   # fn(op, block) -> None (fills output vars)
        self.emit = None          # fn(ctx, op) -> None (reads/writes ctx)
        self.grad = None          # fn(op, block) -> list[op-spec dict]
        self.host = False         # True: a host op (read, save, load)
        self.no_grad = False      # True: terminal for backward
        # (in_slots, out_slots) of a forward op whose grad op consumes a
        # recorded forward (register_vjp_grad); None otherwise
        self.vjp_slots = None


_REGISTRY = {}


def register_op(type, infer_shape=None, emit=None, grad=None, host=False,
                no_grad=False):
    opdef = _REGISTRY.get(type)
    if opdef is None:
        opdef = _REGISTRY[type] = OpDef(type)
    if infer_shape is not None:
        opdef.infer_shape = infer_shape
    if emit is not None:
        opdef.emit = emit
    if grad is not None:
        opdef.grad = grad
    opdef.host = opdef.host or host
    opdef.no_grad = opdef.no_grad or no_grad
    return opdef


def get_op(type):
    opdef = _REGISTRY.get(type)
    if opdef is None:
        raise KeyError('op %r is not registered' % type)
    return opdef


def op_emitter(type, host=False):
    def deco(fn):
        register_op(type, emit=fn, host=host)
        return fn
    return deco


def infer_shape(op, block):
    """Run shape/dtype inference for one op, if registered."""
    opdef = _REGISTRY.get(op.type)
    if opdef is not None and opdef.infer_shape is not None:
        opdef.infer_shape(op, block)


def same_shape_infer(in_slot='X', out_slot='Out'):
    """Output has the same shape/dtype as the input."""
    def fn(op, block):
        x = block.var_recursive(op.single_input(in_slot))
        out = block.var_recursive(op.single_output(out_slot))
        out.shape = x.shape
        if out.dtype is None:
            out.dtype = x.dtype
        out.lod_level = x.lod_level
    return fn


def simple_grad_maker(grad_type, in_slots=('X',), fwd_in=True, fwd_out=False,
                      out_slots=('Out',), extra_attrs=None):
    """A standard grad maker: the grad op consumes (optionally) forward
    inputs/outputs plus Out@GRAD and produces X@GRAD."""
    def maker(op, block):
        inputs = {}
        if fwd_in:
            for s in in_slots:
                inputs[s] = list(op.input(s))
        for s in out_slots:
            if fwd_out:
                inputs[s] = list(op.output(s))
            inputs[s + '@GRAD'] = [grad_var_name(n) for n in op.output(s)]
        outputs = {s + '@GRAD': [grad_var_name(n) for n in op.input(s)]
                   for s in in_slots}
        attrs = dict(op.attrs)
        if extra_attrs:
            attrs.update(extra_attrs)
        return [dict(type=grad_type, inputs=inputs, outputs=outputs,
                     attrs=attrs)]
    return maker


def elementwise_unary_grad(fwd_type, needs=('X',)):
    """Grad maker for unary elementwise ops: Out@GRAD (+X and/or Out) ->
    X@GRAD."""
    return simple_grad_maker(fwd_type + '_grad', in_slots=('X',),
                             fwd_in='X' in needs, fwd_out='Out' in needs)


# -- recorded-forward grads ---------------------------------------------------

def record_key(fwd_type, fwd_outputs):
    """Key of one forward op's record in a run: its type and its output
    wiring, which the grad op carries as `__fwd_outputs__`."""
    return (fwd_type, tuple((slot, tuple(names))
                            for slot, names in sorted(fwd_outputs.items())))


def diff_input_names(inputs, in_slots):
    """The distinct names fed to the differentiable slots: a var in two
    slots (mul(x, x)) is ONE input with one total gradient."""
    names = []
    for s in in_slots:
        for n in inputs.get(s, []):
            if n and n not in names:
                names.append(n)
    return names


def vjp_grad_maker(in_slots=('X',), out_slots=('Out',), nondiff_slots=()):
    """The JAX package's register_vjp_grad maker: the grad op takes the
    forward's inputs and its outputs' grads, produces one grad per
    DISTINCT forward input and carries `__fwd_inputs__` and
    `__fwd_outputs__`; the grad op text is the same in both packages."""
    def maker(op, block):
        grad_type = op.type + '_grad'
        inputs = {}
        for s in list(in_slots) + list(nondiff_slots):
            if op.input(s):
                inputs[s] = list(op.input(s))
        for s in out_slots:
            inputs[s + '@GRAD'] = [grad_var_name(n) for n in op.output(s)]
        # one grad output per DISTINCT forward input; repeats get blank
        # placeholders so the fan-out sum does not count the total twice
        outputs = {}
        seen = set()
        for s in in_slots:
            if not op.input(s):
                continue
            names = []
            for n in op.input(s):
                if n in seen:
                    names.append('')
                else:
                    seen.add(n)
                    names.append(grad_var_name(n))
            outputs[s + '@GRAD'] = names
        attrs = dict(op.attrs)
        attrs['__fwd_inputs__'] = {k: list(v) for k, v in op.inputs.items()}
        attrs['__fwd_outputs__'] = {k: list(v)
                                    for k, v in op.outputs.items()}
        return [dict(type=grad_type, inputs=inputs, outputs=outputs,
                     attrs=attrs)]
    return maker


def input_grads(ctx, op, out_names, outs, leaves):
    """torch.autograd.grad of the forward outputs `outs` (name ->
    tensor) with respect to `leaves` (name -> leaf), the cotangents read
    from the grad op's `<name>@GRAD` inputs; an unused leaf gets zeros.
    Returns {input name: grad}."""
    ys, cots = [], []
    for n in out_names:
        y = outs[n]
        if not y.requires_grad:
            continue
        ys.append(y)
        cots.append(ctx.get(grad_var_name(n)).to(y.dtype))
    xs = list(leaves.values())
    grads = [None] * len(xs)
    if ys and xs:
        grads = torch.autograd.grad(ys, xs, grad_outputs=cots,
                                    allow_unused=True)
    return {n: (g if g is not None else torch.zeros_like(x))
            for (n, x), g in zip(leaves.items(), grads)}


def write_input_grads(ctx, op, in_slots, grad_by_input):
    """Write each forward input's grad to the grad op's ACTUAL output
    name: backward.py may have renamed it (fan-out) or blanked it
    (no-grad inputs). FLAGS_amp_bf16_param_grads: under AMP, an fp32
    PARAMETER grad is rounded to bf16 where this op is its sole
    producer (the canonical @GRAD name); fan-out parts stay fp32 until
    their sum."""
    fwd_inputs = op.attr('__fwd_inputs__')
    bf16_param_grads = False
    if ctx.amp:
        from .flags import get_flag
        bf16_param_grads = bool(get_flag('amp_bf16_param_grads'))
    for s in in_slots:
        for fwd_n, out_n in zip(fwd_inputs.get(s, []),
                                op.output(s + '@GRAD')):
            if not out_n or fwd_n not in grad_by_input:
                continue
            g = grad_by_input[fwd_n]
            if (bf16_param_grads and g.dtype == torch.float32
                    and out_n == grad_var_name(fwd_n)
                    and ctx.is_persistable(fwd_n)):
                g = g.to(torch.bfloat16)
            ctx.set(out_n, g)


def register_vjp_grad(fwd_type, in_slots=('X',), out_slots=('Out',),
                      nondiff_slots=()):
    """Register `<fwd_type>_grad`. The grad maker is the JAX package's
    (vjp_grad_maker); the emitter differentiates the forward recorded
    earlier in the same run (module docstring) and never re-runs the
    forward."""
    def emit(ctx, op):
        fwd_outputs = op.attr('__fwd_outputs__')
        leaves, outs = ctx.take_record(record_key(fwd_type, fwd_outputs))
        out_names = [n for s in out_slots for n in fwd_outputs.get(s, [])]
        write_input_grads(ctx, op, in_slots,
                          input_grads(ctx, op, out_names, outs, leaves))

    opdef = register_op(fwd_type, grad=vjp_grad_maker(in_slots, out_slots,
                                                      nondiff_slots))
    opdef.vjp_slots = (tuple(in_slots), tuple(out_slots))
    register_op(fwd_type + '_grad', emit=emit)


# -- mixed precision ---------------------------------------------------------

def amp_cast(ctx, *tensors):
    """Under AMP (program._use_bf16), cast fp32 operands of the matrix
    ops to bf16. Master weights stay fp32 in the Scope; autograd through
    the cast gives fp32 parameter grads, as jax.vjp does in the JAX
    package. No loss scaling: bf16 keeps fp32's exponent range."""
    if not ctx.amp:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(torch.bfloat16)
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32
                else t for t in tensors)
    return out if len(out) > 1 else out[0]
