"""Control-flow ops (counterpart of paddle_tpu/ops/control_flow_ops.py):
the sub-block runner (:29-66) and remat_block, the rematerialization
scope (:373-416). While, conditional_block and recurrent are not ported
(ROADMAP.md, Queue 1 item 5).

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
    from ..executor import OpExecutionError, _describe_op, drop_plan
    sub_ctx = ctx.sub_context(sub_block, env, rng)
    drop = drop_plan(sub_block, set(keep))
    for i, sop in enumerate(sub_block.ops):
        opdef = registry._REGISTRY.get(sop.type)
        if opdef is None or opdef.emit is None:
            raise KeyError('op %r inside control-flow sub-block has no '
                           'emitter' % sop.type)
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
