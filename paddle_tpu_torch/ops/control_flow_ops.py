"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow_ops.py):
the sub-block runner (:29-66), while (:72-134), conditional_block
(:146-183), recurrent and its grad (:200-370), remat_block, the
rematerialization scope (:373-416), and is_empty (:423).

while is a host step (registry `host`): the Executor's segments before
and after it stay captured, and the loop reads its condition back once
before the first trip and once after each. On the card's captured path
its body runs eagerly on its first trip of an input signature, is
captured as a CUDA graph on the next and replayed on every later trip,
of this run and the next (Executor.run_loop); on the CPU, and on the
eager path, it runs op by op. A body that fails to capture raises. The
JAX package lowers while to lax.while_loop, so its trip count never
leaves the device. Its rules are kept: only initialised vars are
carried, a carried var keeps its shape and dtype, and while has no grad.
A while inside a control-flow body raises (it would be a host step
inside a device body).

conditional_block runs its sub-block whatever the condition and writes
each Out as where(cond, new, old): the JAX package's lax.cond with an
identity false branch, kept on the device so its segment captures; a
random op inside the block draws even when the condition is false.

recurrent (the StaticRNN engine) is a Python loop of the sub-block over
T, like the sequence recurrences, with the JAX package's masking (a row
past its length keeps its states) and reverse order. Its grad takes the
forward's autograd record (registry.py) and differentiates the outputs
and the final states.

Random ops inside a while or recurrent body draw from the Executor's
generator, which advances every trip; the JAX package folds the trip
index into the body's key. Both give each trip its own draw.

remat_block's sub-block is built by layers.recompute. The JAX package
runs it through jax.checkpoint; here:
- the forward runs the sub-block under torch.no_grad(): no autograd
  graph, so nothing inside the scope outlives it but its outputs. Its
  record holds only X (the inputs), the generator state its random ops
  start from and, under policy 'dots', the outputs of its matrix
  products (mul, matmul: what jax.checkpoint_policies.checkpoint_dots
  keeps; the flash op is not one);
- remat_block_grad re-runs the sub-block from detached X leaves under
  torch.enable_grad() and differentiates it: the one grad op that
  re-runs its forward (registry.py). Under 'dots' each saved product is
  served back instead of recomputed, with the product's own backward
  (_ServedProduct);
- dropout inside the scope draws the same mask in the recompute: the
  block's random ops draw from its own pair of generators
  (Executor._remat_generators), the forward from the first and the
  recompute from the second. Eager runs copy the forward's starting
  state into the second; under a CUDA graph both are registered with
  the graph (their graph-safe state) and advance alike at every replay,
  so they stay in step without a host read. The JAX package keys the
  same draws on the op's rng_tag.
"""
from __future__ import annotations

import torch

from .. import registry
from ..registry import register_op, op_emitter, record_key
from .math_ops import dot_operands

# the matrix products the 'dots' policy saves
DOT_OPS = ('mul', 'matmul')


def run_sub_block(ctx, sub_block, env, rng, keep, saved=None, served=None):
    """Run every op of `sub_block` on `env` (name -> tensor), which it
    fills; a value is dropped after its last use unless it is in `keep`.
    rng: the generator its random ops draw from. saved: a dict that
    receives the outputs of its DOT_OPS; served: such a dict, whose
    products are served instead of recomputed. A host op raises."""
    return run_block_ops(ctx.sub_context(sub_block, env, rng), keep,
                         saved=saved, served=served)


def run_block_ops(sub_ctx, keep, saved=None, served=None):
    """run_sub_block's loop over the ops of sub_ctx's block, on its
    local values."""
    from ..executor import OpExecutionError, _describe_op, drop_plan
    sub_block, env = sub_ctx.block, sub_ctx.local
    drop = drop_plan(sub_block, set(keep))
    for i, sop in enumerate(sub_block.ops):
        opdef = registry._REGISTRY.get(sop.type)
        if opdef is None or opdef.emit is None:
            raise KeyError('op %r inside control-flow sub-block has no '
                           'emitter' % sop.type)
        if sop.type == 'while':
            raise RuntimeError(
                'a while inside a control-flow body is not supported: the '
                'port runs while as a host step between device segments, '
                'and a body is one device segment (ROADMAP Queue 3)')
        if opdef.host:
            raise RuntimeError('host op %r cannot run inside a device '
                               'control-flow body' % sop.type)
        try:
            if served is not None and sop.type in DOT_OPS and \
                    sop.single_output('Out') in served:
                _serve_product(sub_ctx, sop, served[sop.single_output('Out')])
            else:
                opdef.emit(sub_ctx, sop)
        except OpExecutionError:
            raise
        except Exception as e:
            raise OpExecutionError(
                'Error running %s\n  cause: %s: %s'
                % (_describe_op(sop, sub_block, i), type(e).__name__,
                   e)) from e
        if saved is not None and sop.type in DOT_OPS:
            name = sop.single_output('Out')
            saved[name] = env[name]
        for n in drop.get(i, ()):
            env.pop(n, None)
    return env


class _ServedProduct(torch.autograd.Function):
    """Out = a @ b · alpha, served from the value the forward saved; the
    backward is the product's own: ga = g·alpha @ bᵀ, gb = aᵀ @ g·alpha
    (summed over broadcast batch dims)."""

    @staticmethod
    def forward(ctx, a, b, alpha, box):
        ctx.save_for_backward(a, b)
        ctx.alpha = alpha
        return box[0].detach()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if ctx.alpha != 1.0:
            g = g * ctx.alpha
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.transpose(-1, -2)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.transpose(-1, -2), g).sum_to_size(b.shape)
        return ga, gb, None, None


def _serve_product(ctx, op, saved):
    a, b, alpha, shape = dot_operands(ctx, op)
    if a.dim() < 2 or b.dim() < 2:
        # torch.matmul's vector cases: recompute
        registry.get_op(op.type).emit(ctx, op)
        return
    product_shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + \
        (a.shape[-2], b.shape[-1])
    out = _ServedProduct.apply(a, b, alpha, [saved.reshape(product_shape)])
    ctx.set(op.single_output('Out'),
            out.reshape(shape) if shape is not None else out)


# ---------------------------------------------------------------------------
# remat_block: inputs X (the external vars the sub-block reads), outputs
# Out (the vars built in the scope and used after it, then the outer
# vars it writes); attrs sub_block, policy ('nothing' | 'dots'), rng_tag
# ---------------------------------------------------------------------------

class _RematRecord(object):
    __slots__ = ('xs', 'rng_state', 'saved')

    def __init__(self, xs, rng_state, saved):
        self.xs = xs                # X name -> the input tensor
        self.rng_state = rng_state  # forward generator state (eager runs)
        self.saved = saved          # 'dots': product name -> output


def _sub_block(ctx, op):
    return ctx.block.program.blocks[op.attr('sub_block')]


def _has_value(ctx, name):
    return name in ctx.local or ctx.scope.find_var(name) is not None


def _ordered_outputs(block):
    names = []
    for sop in block.ops:
        for n in sop.output_arg_names():
            if n not in names:
                names.append(n)
    return names


# ---------------------------------------------------------------------------
# while: inputs X (the external vars the body reads, and the outer vars it
# writes), Condition (a bool var the body re-assigns); outputs Out (the
# outer vars the body writes), StepScopes; attr sub_block
# ---------------------------------------------------------------------------

def _loop_trip(ctx, sub_block, carried_names, vals, ext, generators=None,
               capturing=False):
    """One trip of a while body: the new carried values."""
    env = dict(ext)
    env.update(vals)
    sub = ctx.sub_context(sub_block, env, None)
    if generators is not None:
        sub.generators, sub.op_generators = generators
    sub.capturing = capturing
    run_block_ops(sub, carried_names)
    return {n: env[n] for n in carried_names}


def cond_value(cond):
    """The loop condition read back to the host (the first element, as
    the JAX package's cond_fn reads it)."""
    return bool(cond.reshape(-1)[0])


@op_emitter('while', host=True)
def _while_emit(ctx, op):
    sub_block = _sub_block(ctx, op)
    cond_name = op.single_input('Condition')
    body_writes = _ordered_outputs(sub_block)
    out_set = set(op.output('Out'))
    body_reads = set()
    for sop in sub_block.ops:
        body_reads.update(sop.input_arg_names())
    # loop state: the condition and every body-written var that already
    # has a value and is an Out or read again by the body; the body's
    # temporaries are made anew each trip and not carried
    carried = [cond_name]
    for n in body_writes:
        if n != cond_name and (n in out_set or n in body_reads) and \
                _has_value(ctx, n):
            carried.append(n)
    for n in out_set:
        if not _has_value(ctx, n) and n not in body_writes:
            raise RuntimeError(
                'while-loop var %r must be initialized before the loop '
                '(XLA loop carries need a fixed initial value)' % n)
    carried_set = set(carried)
    ext = {n: ctx.get(n) for n in op.input('X')
           if n not in carried_set and _has_value(ctx, n)}
    vals = {n: ctx.get(n) for n in carried}
    exe = ctx._executor
    if ctx.graphs:
        vals, trips = exe.run_loop(ctx, op, sub_block, carried, vals, ext)
    else:
        trips = 0
        while cond_value(vals[cond_name]):
            vals = _loop_trip(ctx, sub_block, carried, vals, ext)
            trips += 1
    exe._loop_trips += trips
    exe._loop_reads += trips + 1
    for n in carried:
        ctx.set(n, vals[n])
    for n in out_set - carried_set - {cond_name}:
        if not _has_value(ctx, n):
            raise RuntimeError(
                'while Out var %r was never initialized before the loop' % n)


register_op('while', infer_shape=lambda op, block: None, no_grad=True)


# ---------------------------------------------------------------------------
# conditional_block: inputs Cond (bool), X (the external reads and the
# outer vars it writes); outputs Out, Scope; attrs sub_block,
# is_scalar_condition
# ---------------------------------------------------------------------------

@op_emitter('conditional_block')
def _cond_block_emit(ctx, op):
    cond_names = op.input('Cond')
    cond = torch.all(ctx.get(cond_names[0]))
    for extra in cond_names[1:]:
        cond = cond & torch.all(ctx.get(extra))
    out_names = list(op.output('Out'))
    for n in out_names:
        if not _has_value(ctx, n):
            raise RuntimeError(
                'conditional_block output %r must be initialized before the '
                'block (XLA cond branches must return the same structure)'
                % n)
    env = {n: ctx.get(n) for n in op.input('X') if _has_value(ctx, n)}
    old = {n: env[n] for n in out_names}
    run_sub_block(ctx, _sub_block(ctx, op), env, None, out_names)
    for n in out_names:
        ctx.set(n, torch.where(cond, env[n], old[n]))


register_op('conditional_block', infer_shape=lambda op, block: None,
            no_grad=True)


# ---------------------------------------------------------------------------
# recurrent (the StaticRNN engine)
#   inputs:  inputs (step inputs [T, ...], sliced along dim 0 each step),
#            initial_states, parameters (the external vars the step reads)
#   outputs: outputs (the stacked step outputs [T, ...]), final_states
#   attrs:   sub_block, states / ex_states (the in-block names of each
#            state's new and previous value), step_input_names,
#            output_names, reverse, seq_lens_name ('' or an [B] int var)
# ---------------------------------------------------------------------------

RECURRENT_SLOTS = ('inputs', 'initial_states', 'parameters')


def _recurrent_fwd(ctx, op):
    sub_block = _sub_block(ctx, op)
    step_input_names = op.attr('step_input_names')
    ex_state_names = op.attr('ex_states')
    state_names = op.attr('states')
    step_output_names = op.attr('output_names')
    reverse = bool(op.attr('reverse', False))
    seq_inputs = [ctx.get(n) for n in op.input('inputs')]
    states = [ctx.get(n) for n in op.input('initial_states')]
    params = {n: ctx.get(n) for n in op.input('parameters')}
    seq_lens = ctx.get(op.attr('seq_lens_name')) \
        if op.attr('seq_lens_name', '') else None
    T = seq_inputs[0].shape[0] if seq_inputs else op.attr('max_len')
    keep = list(state_names) + list(step_output_names)
    outs = []
    for i in range(T):
        t = T - 1 - i if reverse else i
        env = dict(params)
        env.update(zip(ex_state_names, states))
        env.update(zip(step_input_names, [x[t] for x in seq_inputs]))
        run_sub_block(ctx, sub_block, env, None, keep)
        new_states = [env[n] for n in state_names]
        if seq_lens is not None:
            # a row past its length keeps its states; the JAX package
            # masks on the trip count, reversed or not
            active = i < seq_lens
            new_states = [torch.where(
                active.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
                for old, new in zip(states, new_states)]
        states = new_states
        outs.append([env[n] for n in step_output_names])
    if reverse:
        outs = outs[::-1]
    stacked = [torch.stack([o[k] for o in outs], dim=0)
               for k in range(len(step_output_names))]
    return stacked, states


@op_emitter('recurrent')
def _recurrent_emit(ctx, op):
    stacked, final_states = _recurrent_fwd(ctx, op)
    for n, v in zip(op.output('outputs'), stacked):
        ctx.set(n, v)
    for n, v in zip(op.output('final_states'), final_states):
        ctx.set(n, v)


def _recurrent_grad_maker(op, block):
    """The JAX package's recurrent_grad op: the cotangents of outputs and
    final_states in, a grad for each distinct input of every slot out."""
    from ..framework import grad_var_name
    inputs = {slot: list(op.input(slot)) for slot in RECURRENT_SLOTS}
    for slot in ('outputs', 'final_states'):
        for n in op.output(slot):
            inputs.setdefault(slot + '@GRAD', []).append(grad_var_name(n))
    outputs = {}
    seen = set()
    for slot in RECURRENT_SLOTS:
        names = []
        for n in op.input(slot):
            if n in seen:
                names.append('')
            else:
                seen.add(n)
                names.append(grad_var_name(n))
        outputs[slot + '@GRAD'] = names
    return [dict(type='recurrent_grad', inputs=inputs, outputs=outputs,
                 attrs=dict(op.attrs))]


def _recurrent_fwd_outputs(grad_op):
    """The forward's output wiring, read off the cotangent names (the
    forward's outputs with @GRAD appended)."""
    return {slot: [n[:-len('@GRAD')] for n in grad_op.input(slot + '@GRAD')]
            for slot in ('outputs', 'final_states')}


def _recurrent_grad_emit(ctx, op):
    fwd_outputs = _recurrent_fwd_outputs(op)
    leaves, outs = ctx.take_record(record_key('recurrent', fwd_outputs))
    out_names = fwd_outputs['outputs'] + fwd_outputs['final_states']
    registry.write_input_grads(
        ctx, op, RECURRENT_SLOTS,
        registry.input_grads(ctx, op, out_names, outs, leaves),
        fwd_inputs={slot: op.input(slot) for slot in RECURRENT_SLOTS})


register_op('recurrent', grad=_recurrent_grad_maker,
            infer_shape=lambda op, block: None).vjp_slots = (
    RECURRENT_SLOTS, ('outputs', 'final_states'))
register_op('recurrent_grad', emit=_recurrent_grad_emit)
registry._FWD_OUTPUTS_OF['recurrent_grad'] = _recurrent_fwd_outputs


# -- is_empty ------------------------------------------------------------------

@op_emitter('is_empty')
def _is_empty_emit(ctx, op):
    from .tensor_ops import device_constant
    empty = ctx.get(op.single_input('X')).numel() == 0
    ctx.set(op.single_output('Out'), device_constant(
        ctx, op, empty, lambda: torch.tensor(empty)))


def _is_empty_infer(op, block):
    out = block.var_recursive(op.single_output('Out'))
    out.shape = ()
    out.dtype = 'bool'


register_op('is_empty', infer_shape=_is_empty_infer, no_grad=True)


@op_emitter('remat_block')
def _remat_block_emit(ctx, op):
    sub_block = _sub_block(ctx, op)
    xs = {n: ctx.get(n) for n in op.input('X')}
    out_names = list(op.output('Out'))
    fwd_rng, _ = ctx.remat_generators(op)
    if torch.is_grad_enabled():
        # inside an enclosing scope's recompute: differentiate through
        env = run_sub_block(ctx, sub_block, dict(xs), fwd_rng, out_names)
    else:
        key = record_key('remat_block', op.outputs)
        record = key in ctx.wanted
        # a CUDA graph cannot read the state back: under capture the two
        # generators are in step already (module docstring)
        state = (fwd_rng.get_state()
                 if record and not ctx.capturing else None)
        saved = ({} if record and op.attr('policy', 'nothing') == 'dots'
                 else None)
        env = run_sub_block(ctx, sub_block, dict(xs), fwd_rng, out_names,
                            saved=saved)
        if record:
            ctx.records[key] = _RematRecord(xs, state, saved)
    for n in out_names:
        ctx.set(n, env[n])


def _remat_block_grad_emit(ctx, op):
    fwd_outputs = op.attr('__fwd_outputs__')
    rec = ctx.take_record(record_key('remat_block', fwd_outputs))
    _, bwd_rng = ctx.remat_generators(op)
    if rec.rng_state is not None:
        bwd_rng.set_state(rec.rng_state)
    leaves = {n: (t.detach().requires_grad_() if t.is_floating_point()
                  else t) for n, t in rec.xs.items()}
    out_names = list(fwd_outputs.get('Out', []))
    with torch.enable_grad():
        env = run_sub_block(ctx, _sub_block(ctx, op), dict(leaves),
                            bwd_rng, out_names, served=rec.saved)
        grads = registry.input_grads(
            ctx, op, out_names, {n: env[n] for n in out_names},
            {n: t for n, t in leaves.items() if t.requires_grad})
    registry.write_input_grads(ctx, op, ('X',), grads)


register_op('remat_block', infer_shape=lambda op, block: None,
            grad=registry.vjp_grad_maker(('X',), ('Out',)))
register_op('remat_block_grad', emit=_remat_block_grad_emit)
