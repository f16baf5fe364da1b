"""Pipeline-parallel lowering of a Program training step (counterpart of
paddle_tpu/parallel/pp_lowering.py:1-242).

Under `DistributedStrategy(pp=K, micro_batches=M)` a device segment
whose ops carry `pp_stage` attrs (parallel.api.pipeline_stage_guard)
runs as

    pre ops -> pipeline_apply(uniform stages over 'pp') -> post ops
    -> torch.autograd over that forward -> optimizer ops

instead of op by op. The program's backward ops are not run: under
pipelining the backward interleaves with the schedule, so one autograd
pass over the pipelined forward gives every gradient, as the JAX
package's one jax.value_and_grad does. The port's forward emitters are
differentiable (its grad emitters re-run them under autograd), and on a
mesh they run through their layout rules (parallel/layout.py), whose
collectives have autograd forms.

The checks are the JAX package's, with its messages: the stages must be
uniform (the same op types and attrs apart from pp_stage, op_role and
op_namescope), hold no random op, carry one activation each and read
parameters of the same shapes; clip ops, a gradient the optimizer reads
under another name than grad_var_name(param) (clipping,
regularization), a missing loss_name and a batch the microbatches do
not divide are refused.

One process a rank: the rank at pp coordinate s runs the pre ops, stage
s on each of its microbatches and the post ops. Every rank keeps every
parameter, and the optimizer updates it there, as the JAX package's
scope does. Gradients across 'pp':
- a stage's parameters (and the pre ops', the embedding's) get their
  gradient only on the rank that ran them: they are summed over 'pp'
  with zeros elsewhere, one flat all-reduce a dtype;
- the post ops (the head and the loss) run on every pp rank from the
  same outputs, so each rank's gradient of a head parameter is already
  whole and is not summed (a parameter read by both is split into two
  leaves, and only the first part is summed);
- then the sums over the data axes (dp, sp) are the layouts' own
  (DistState.partial, one bucket per axis set), before the optimizer ops.
With dp each dp rank splits its own rows into the microbatches.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from . import collectives as C
from .layout import normalize, redistribute
from .pipeline import pipeline_apply, finish_backward

__all__ = ['segment_has_pp', 'build_pp_segment_fn']


def segment_has_pp(segment):
    return any(op.attr('pp_stage', None) is not None for op in segment.ops)


def _reads_writes(ops):
    reads, writes = [], set()
    for op, _off in ops:
        for n in op.input_arg_names():
            if n not in writes and n not in reads:
                reads.append(n)
        writes.update(op.output_arg_names())
    return reads, writes


def _partition(segment):
    """Split segment ops into pre / stages / post forward ops, plus
    optimizer ops; backward ops are dropped (whole-graph grad)."""
    pre, stages, post, opt = [], OrderedDict(), [], []
    for op, off in zip(segment.ops, segment.op_offsets):
        role = op.attr('op_role', 'forward')
        if role == 'optimize':
            opt.append((op, off))
            continue
        if role == 'backward':
            if op.type in ('squared_l2_norm', 'clip', 'clip_by_norm'):
                raise NotImplementedError(
                    'gradient clipping is not supported under pipeline '
                    'parallelism (grads come from whole-graph autodiff)')
            continue
        st = op.attr('pp_stage', None)
        if st is None:
            (post if stages else pre).append((op, off))
        else:
            stages.setdefault(int(st), []).append((op, off))
    return pre, stages, post, opt


def _sig_attrs(op):
    """Attrs that must match across stages for uniformity: everything
    except the stage id itself."""
    return {k: v for k, v in op.attrs.items()
            if k not in ('pp_stage', 'op_role', 'op_namescope')
            and not k.startswith('__')}


def _validate_stages(stages, block):
    keys = sorted(stages)
    sigs = [[op.type for op, _ in stages[k]] for k in keys]
    if any(s != sigs[0] for s in sigs[1:]):
        raise ValueError('pipeline stages must be uniform (same op '
                         'sequence per stage); got %s' %
                         {k: len(stages[k]) for k in keys})
    for k in keys[1:]:
        for (op0, _), (opk, _) in zip(stages[keys[0]], stages[k]):
            if _sig_attrs(op0) != _sig_attrs(opk):
                raise ValueError(
                    'pipeline stages not uniform: op %r attrs differ '
                    'between stage %d and stage %d (%s vs %s)'
                    % (op0.type, keys[0], k, _sig_attrs(op0),
                       _sig_attrs(opk)))
    from ..registry import _REGISTRY
    for op, _ in stages[keys[0]]:
        if _REGISTRY[op.type].stateful:
            raise NotImplementedError(
                'RNG op %r inside a pipeline stage' % op.type)
    return keys


def _stage_io(stages, keys, block):
    """Per-stage (param_names, x_in, x_out). Params = persistable reads;
    the single non-persistable read is the carried activation."""
    infos = []
    for k in keys:
        reads, writes = _reads_writes(stages[k])
        params, acts = [], []
        for n in reads:
            var = block.var_recursive(n)
            (params if var.persistable else acts).append(n)
        if len(acts) != 1:
            raise ValueError(
                'pipeline stage %d must carry exactly one activation '
                '(got inputs %s)' % (k, acts))
        infos.append({'params': params, 'x_in': acts[0], 'writes': writes})
    for i, k in enumerate(keys):
        nxt = infos[i + 1]['x_in'] if i + 1 < len(keys) else None
        if nxt is not None and nxt in infos[i]['writes']:
            infos[i]['x_out'] = nxt
        else:
            infos[i]['x_out'] = stages[k][-1][0].output_arg_names()[-1]
    shapes0 = [tuple(block.var_recursive(n).shape)
               for n in infos[0]['params']]
    for info in infos[1:]:
        shapes = [tuple(block.var_recursive(n).shape)
                  for n in info['params']]
        if shapes != shapes0:
            raise ValueError('pipeline stage parameter shapes differ: '
                             '%s vs %s' % (shapes0, shapes))
    return infos


def _grad_names(opt):
    """param -> grad var name, from the optimizer ops; a transformed
    gradient (clipping, weight decay) is refused, as in the JAX
    package."""
    from ..framework import grad_var_name
    grad_of = {}
    for op, _ in opt:
        if op.input('Param'):
            p = op.single_input('Param')
            g = op.single_input('Grad')
            if g != grad_var_name(p):
                raise NotImplementedError(
                    'pipeline parallelism: optimizer consumes a '
                    'transformed gradient %r for param %r (gradient '
                    'clipping / regularization are not supported under '
                    'pp — grads come from whole-graph autodiff)' % (g, p))
            grad_of[p] = g
    return grad_of


class PPStats(object):
    """What the last pipelined step moved: activation and cotangent
    bytes sent over 'pp', the bytes of the pp gradient sum, and the
    seconds this rank waited in pp receives."""

    def __init__(self):
        self.act_bytes = self.cot_bytes = self.grad_bytes = 0
        self.recv_wait_s = 0.0


def build_pp_segment_fn(pe, segment, block, program):
    """The runner of a pp-annotated device segment: run(ctx) runs the
    segment on this rank through ctx (the mesh run's EmitContext,
    whose `dist` holds the layouts) and leaves its outputs in ctx.local
    and the scope."""
    from ..executor import run_op
    strategy = pe._strategy
    mesh = pe.mesh
    n_micro = max(int(strategy.micro_batches or 0), strategy.pp)
    loss_name = pe._loss_name
    if not loss_name:
        raise ValueError('pipeline parallelism needs '
                         'ParallelExecutor(loss_name=...)')

    pre, stages, post, opt = _partition(segment)
    keys = _validate_stages(stages, block)
    infos = _stage_io(stages, keys, block)
    grad_of = _grad_names(opt)
    pp = mesh.shape.get('pp', 1)
    if len(keys) != pp:
        raise ValueError('the program has %d pipeline stages, the mesh\'s '
                         'pp axis %d: one stage a pp rank'
                         % (len(keys), pp))
    region_in = infos[0]['x_in']
    region_out = infos[-1]['x_out']
    # the parameters whose gradient is summed over 'pp' (read by the pre
    # ops or a stage), and those the post ops read (their own leaves)
    pp_summed = [p for p in sorted(grad_of)
                 if any(p in op.input_arg_names()
                        for op, _ in pre + [o for k in keys
                                             for o in stages[k]])]
    post_read = [p for p in sorted(grad_of)
                 if any(p in op.input_arg_names() for op, _ in post)]
    pre_params = set(n for op, _ in pre for n in op.input_arg_names()
                     if n in grad_of)
    # a stage parameter's index in its stage (the same in every stage)
    stage_pos = {}
    for info in infos:
        for i, n in enumerate(info['params']):
            stage_pos[n] = i

    def emit_all(ctx, op_list):
        for op, off in op_list:
            run_op(ctx, op, off)

    def run(ctx):
        st = ctx.dist
        rank_stage = C.axis(mesh, 'pp').index
        mine = infos[rank_stage]
        scope_val = {p: ctx.get(p) for p in grad_of}
        main = {p: scope_val[p].detach().requires_grad_()
                for p in pp_summed
                if p in pre_params or p in mine['params']}
        postl = {p: scope_val[p].detach().requires_grad_()
                 for p in post_read}
        wanted, ctx.wanted = ctx.wanted, frozenset()
        before = set(ctx.local)
        stats = PPStats()
        try:
            with torch.enable_grad(), C.recording() as recs:
                ctx.overrides = main
                emit_all(ctx, pre)
                x = ctx.local[region_in]
                spec = st.spec_of(region_in, ctx)
                rows = x.shape[0]
                if rows % n_micro != 0:
                    dp = mesh.shape.get('dp', 1)
                    if rows * dp % n_micro:
                        raise ValueError('batch %d not divisible by %d '
                                         'microbatches' % (rows * dp,
                                                           n_micro))
                    raise ValueError(
                        'batch %d: a dp rank\'s %d rows are not divisible '
                        'by %d microbatches' % (rows * dp, rows, n_micro))

                def stage_fn(_params, xm):
                    ctx.local[mine['x_in']] = xm
                    st.set_spec(mine['x_in'], spec)
                    emit_all(ctx, stages[keys[rank_stage]])
                    y = ctx.local[mine['x_out']]
                    return redistribute(y, st.spec_of(mine['x_out'], ctx),
                                        spec, mesh)

                out = pipeline_apply(stage_fn, mesh, n_micro, None,
                                     list(x.chunk(n_micro, 0)))
                ctx.local[region_out] = out.reshape(x.shape)
                st.set_spec(region_out, spec)
                ctx.overrides = postl
                emit_all(ctx, post)
                ctx.overrides = None
                n_fwd = len(recs)
                ctx.local[loss_name].backward()
                finish_backward()
            for i, r in enumerate(recs):
                if r['kind'] != 'collective-permute' or r['axis'] != 'pp':
                    continue
                if r['dir'] == 'recv':
                    stats.recv_wait_s += r['seconds']
                elif i < n_fwd:
                    stats.act_bytes += r['bytes']
                else:
                    stats.cot_bytes += r['bytes']
        finally:
            ctx.overrides = None
            ctx.wanted = wanted
        # the forward's values, detached; the gradients
        for n in set(ctx.local) - before:
            v = ctx.local[n]
            if isinstance(v, torch.Tensor) and v.requires_grad:
                ctx.local[n] = v.detach()
        partial = {}
        for d in st.fwd_partial.values():
            for p, axes in d.items():
                partial.setdefault(p, set()).update(axes)
        st.fwd_partial.clear()
        own = {stage_pos[n]: n for n in mine['params']}
        grads = {}
        for p in pp_summed:
            leaf = main.get(p)
            g = None if leaf is None else leaf.grad
            grads[p] = torch.zeros_like(scope_val[p]) if g is None else g
        stats.grad_bytes = _sum_over_pp(grads, pp_summed, mesh)
        for p in post_read:
            g = postl[p].grad
            if g is None:
                continue
            grads[p] = grads[p] + g if p in grads else g
        for p in sorted(grad_of):
            g = grads.get(p)
            if g is None:
                continue
            gname = grad_of[p]
            ctx.local[gname] = g
            st.set_spec(gname, normalize(st.storage.get(p), g.ndim, mesh))
            axes = partial.get(p)
            if axes is None and p in stage_pos:
                axes = partial.get(own.get(stage_pos[p]))
            axes = tuple(sorted(a for a in (axes or ()) if a != 'pp'))
            if axes:
                st.partial[gname] = axes
        pe._pp_stats = stats
        emit_all(ctx, opt)

    return run


def _sum_over_pp(grads, names, mesh):
    """Sum the gradients `names` over 'pp' in place of `grads`: one flat
    all-reduce a dtype, every rank in the same order. Returns the bytes
    summed."""
    if mesh.shape.get('pp', 1) <= 1 or not names:
        return 0
    ax = C.axis(mesh, 'pp')
    buckets = OrderedDict()
    for n in names:
        buckets.setdefault(grads[n].dtype, []).append(n)
    total = 0
    for ns in buckets.values():
        flat = torch.cat([grads[n].reshape(-1) for n in ns])
        flat = C._all_reduce(flat, ax)
        total += flat.numel() * flat.element_size()
        off = 0
        for n in ns:
            k = grads[n].numel()
            grads[n] = flat[off:off + k].view(grads[n].shape)
            off += k
    return total
