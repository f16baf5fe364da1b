"""Layouts on a mesh: the port's answer to GSPMD.

The JAX package compiles a block over a jax Mesh and lets GSPMD place
every value and insert the collectives. Here each rank runs the block's
emitters on its own shards, and this module keeps, for every value of a
run, its layout: a spec in the JAX package's tuple form normalised to one
tuple of mesh axes per dim (() = replicated on that dim). DTensor's
placements over the mesh (mesh.named_sharding) are the same information
seen per axis.

Every op of a mesh run goes through `DistState.emit`:
- an op whose inputs are all replicated runs as it is;
- an op with a rule below runs by it: the rule moves its inputs to the
  layouts it can take (parallel/collectives.py's autograd forms, so a
  recorded forward's gradient comes back through the inverse
  collective), runs the op's emitter on the shards, and names its
  outputs' layouts;
- a pointwise op (POINTWISE) takes its operands' layout, sharded dims
  winning over replicated ones;
- any other op with a sharded input runs replicated: its inputs are
  gathered first. That is always exact; the audit shows what it costs.

Gradients: the grad op of a recorded forward is torch.autograd over the
shards, so every gradient comes out in its var's layout, complete,
except a parameter's: where a replicated parameter meets data sharded
over an axis, its gradient on each rank is that rank's part of a sum.
`DistState` notes those axes when the forward runs and sums the parts
(one bucket per axis set and dtype) before the first op that reads a
parameter gradient for anything but accumulating it: the reference's
all-reduce before the optimizer ops. With the optimizer state sharded
(ZeRO-1) the sum over dp is a reduce-scatter into the state's shard,
and the optimizer op all-gathers the parameter it updates.

The ops that run on their shards with explicit collectives (and why
DTensor does not carry them) are listed in CHANGES.md; in short, the
hand-written kernels (flash_attention, ring_attention) take plain
tensors, and under gloo on a shared card DTensor's own collectives
would run on CUDA tensors the send/recv path cannot take.
"""
from __future__ import annotations

import numpy as np
import torch

from . import collectives as C
from .mesh import spec_axes

__all__ = ['normalize', 'local_part', 'global_shape', 'DistState',
           'POINTWISE', 'RULES']

REPL = ()


# -- specs --------------------------------------------------------------------

def normalize(spec, ndim, mesh):
    """A spec (JAX tuple form, or None) as one tuple of live mesh axes
    per dim; a short spec is padded with replicated dims at the end."""
    spec = tuple(spec or ())
    out = [spec_axes(e, mesh) for e in spec[:ndim]]
    out += [REPL] * (ndim - len(out))
    return tuple(out)


def factor(axes, mesh):
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def spec_axes_set(spec):
    return set(a for e in spec for a in e)


def global_shape(shape, spec, mesh):
    return tuple(int(s) * factor(e, mesh) for s, e in zip(shape, spec))


def local_part(t, spec, mesh, rank):
    """The rank's shard of a full value under a normalised spec."""
    coord = mesh.coordinate(rank)
    for d, axes in enumerate(spec):
        for a in axes:
            n = mesh.shape[a]
            if t.shape[d] % n:
                raise ValueError('dim %d of size %d does not divide over %r'
                                 % (d, t.shape[d], a))
            t = t.chunk(n, d)[coord[a]]
    return t


def _is_tensor(v):
    return isinstance(v, torch.Tensor)


def grad_base(name):
    i = name.find('@GRAD')
    return name[:i] if i >= 0 else None


class LayoutError(RuntimeError):
    pass


# -- redistribution -----------------------------------------------------------

def redistribute(t, src, dst, mesh, summed=False):
    """Move `t` from layout src to dst: gather the dims whose axes
    change, then chunk them. summed: a gathered shard's gradient comes
    back reduce-scattered (it feeds sharded work) instead of chunked."""
    if src == dst:
        return t
    for d in range(len(src)):
        if src[d] != dst[d]:
            for a in reversed(src[d]):
                ax = C.axis(mesh, a)
                t = (C.gather_summed if summed else C.gather)(t, d, ax)
    for d in range(len(src)):
        if src[d] != dst[d]:
            for a in dst[d]:
                t = C.chunk(t, d, C.axis(mesh, a))
    return t


# -- one op's view ------------------------------------------------------------

class OpIO(object):
    """What a rule sees of one op: the inputs' values and layouts, the
    redistributions it asks for, and the outputs' layouts it names."""

    def __init__(self, st, ctx, op, opdef):
        self.st, self.ctx, self.op, self.opdef = st, ctx, op, opdef
        self.mesh = st.mesh
        self._over = {}
        self.sliced = {}          # input name -> axes it was chunked over
        self.out_specs = {}
        self.partial_of = {}      # param name -> axes (a rule's own word)
        self._attrs = {}

    def val(self, name):
        if name in self._over:
            return self._over[name]
        return self.ctx.get(name)

    def spec(self, name):
        if name in self._over:
            return self._spec_over[name]
        return self.st.spec_of(name, self.ctx)

    def inputs(self):
        """(slot, name) of every tensor input, in slot order."""
        out = []
        for slot, names in self.op.inputs.items():
            for n in names:
                if n and _is_tensor(self._safe_get(n)):
                    out.append((slot, n))
        return out

    def _safe_get(self, name):
        try:
            return self.val(name)
        except Exception:
            return None

    def use(self, name, spec, summed=False, out_axes=()):
        """Redistribute input `name` to `spec` for this op. out_axes: the
        axes the op's outputs stay sharded over; an input gathered over
        one of them feeds work that stays split there, so its gradient
        arrives in parts and is reduce-scattered (summed)."""
        src = self.spec(name)
        spec = tuple(spec)
        if src == spec:
            return self.val(name)
        gathered = set(a for d in range(len(src)) if src[d] != spec[d]
                       for a in src[d])
        summed = summed or bool(gathered & set(out_axes))
        if gathered and name in self.st.params:
            self.st.param_gathers.append((name, tuple(sorted(gathered))))
        v = redistribute(self.val(name), src, spec, self.mesh, summed)
        added = set(a for d in range(len(spec)) if src[d] != spec[d]
                    for a in spec[d])
        self.sliced.setdefault(name, set()).update(added)
        self.set_in(name, v, spec)
        return v

    def set_in(self, name, value, spec):
        if not hasattr(self, '_spec_over'):
            self._spec_over = {}
        self._over[name] = value
        self._spec_over[name] = tuple(spec)

    def copy_in(self, name, axes):
        """Megatron's f on input `name` over `axes` (identity forward,
        all-reduce backward): a replicated input of sharded work."""
        v = self.val(name)
        for a in axes:
            v = C.copy_in(v, C.axis(self.mesh, a))
        self.set_in(name, v, self.spec(name))
        return v

    def patch(self, **attrs):
        self._attrs.update(attrs)

    def emit(self):
        ctx, op = self.ctx, self.op
        prev = ctx.overrides
        if self._over:
            ctx.overrides = dict(prev or {})
            ctx.overrides.update(self._over)
        saved = {}
        for k, v in self._attrs.items():
            saved[k] = op.attrs.get(k, _MISSING)
            op.attrs[k] = v
        try:
            self.opdef.emit(ctx, op)
        finally:
            ctx.overrides = prev
            for k, v in saved.items():
                if v is _MISSING:
                    op.attrs.pop(k, None)
                else:
                    op.attrs[k] = v

    def out(self, name, spec):
        self.out_specs[name] = tuple(spec)

    def result(self, name):
        return self.ctx.local[name]

    def replace(self, name, value):
        self.ctx.set(name, value)

    def ax(self, name):
        return C.axis(self.mesh, name)


_MISSING = object()


# -- the per-run state --------------------------------------------------------

class DistState(object):
    """The layouts and pending gradient sums of one ParallelExecutor run.

    storage: persistable var name -> the spec it has in the scope;
    params: trainable parameter names; gathered: ZeRO-3 parameters
    (gathered where read); state_specs: ZeRO-1 parameter -> the spec of
    its optimizer state (its gradient is reduce-scattered to it);
    bn_local: batch_norm keeps per-rank statistics."""

    def __init__(self, mesh, rank, storage, params, gathered=(),
                 state_specs=None, bn_local=False):
        self.mesh, self.rank = mesh, rank
        self.storage = storage
        self.params = set(params)
        self.gathered = set(gathered)
        self.state_specs = state_specs or {}
        self.bn_local = bool(bn_local)
        self.layouts = {}
        self.fwd_partial = {}
        self.partial = {}
        self.bn_reduce = None
        # (parameter, axes) of every gather of a stored parameter shard
        self.param_gathers = []
        # fn(name, value) -> the spec of a fed or read batch
        self.feed_spec = None
        # True: a fed or read batch is this rank's part already
        self.feed_is_local = False

    # layouts
    def spec_of(self, name, ctx):
        sp = self.layouts.get(name)
        if sp is not None:
            return self.spec_for(name, None)
        return self.spec_for(name, ctx.get(name))

    def spec_for(self, name, v):
        """The layout of `name`, whose value is v."""
        sp = self.layouts.get(name)
        if sp is not None:
            if sp == _UNREADABLE:
                raise LayoutError(
                    '%r holds per-rank values with no global layout (an '
                    'output that flattens several sharded dims)' % name)
            return sp
        nd = v.ndim if _is_tensor(v) else 0
        if name in self.storage:
            return normalize(self.storage[name], nd, self.mesh)
        base = grad_base(name)
        if base is not None and base != name:
            if base in self.layouts:
                return self.layouts[base]
            if base in self.storage:
                return normalize(self.storage[base], nd, self.mesh)
        return (REPL,) * nd

    def set_spec(self, name, spec):
        self.layouts[name] = tuple(spec)

    # the gradient sums
    def sync_partials(self, local, names=None):
        """Sum the pending parameter-gradient parts (all of them, or
        `names`): one flat all-reduce per (axes, dtype) bucket, and a
        reduce-scatter over dp for a ZeRO-1 parameter."""
        todo = [n for n in (names or list(self.partial)) if n in self.partial]
        buckets = {}
        for n in todo:
            axes = self.partial.pop(n)
            if n not in local:
                continue
            g = local[n]
            base = grad_base(n)
            st = self.state_specs.get(base)
            if st is not None and 'dp' in axes:
                spec = normalize(st, g.ndim, self.mesh)
                d = next(i for i, e in enumerate(spec) if 'dp' in e)
                g = C.reduce_scatter(g, d, C.axis(self.mesh, 'dp'))
                self.layouts[n] = spec
                axes = tuple(a for a in axes if a != 'dp')
                local[n] = g
                if not axes:
                    continue
            key = (tuple(sorted(axes)), g.dtype, g.device)
            buckets.setdefault(key, []).append(n)
        for (axes, _, _), ns in buckets.items():
            flat = torch.cat([local[n].reshape(-1) for n in ns])
            for a in axes:
                flat = C._all_reduce(flat, C.axis(self.mesh, a))
            off = 0
            for n in ns:
                g = local[n]
                k = g.numel()
                local[n] = flat[off:off + k].view(g.shape)
                off += k

    # one op
    def emit(self, ctx, opdef, op):
        from .. import registry
        io = OpIO(self, ctx, op, opdef)
        role = op.attr('op_role', '') if op.has_attr('op_role') else ''
        ins = io.inputs()
        pend = [n for _, n in ins if n in self.partial]
        if pend and not (role == 'backward' and op.type in _ACCUMULATE):
            self.sync_partials(ctx.local)
        if role != 'optimize':
            for _, n in ins:
                if n in self.gathered:
                    io.use(n, (REPL,) * io.val(n).ndim, summed=True)
        is_vjp_grad = False
        if op.type.endswith('_grad') and \
                registry.grad_record_key(op) is not None:
            fwd = registry._REGISTRY.get(op.type[:-len('_grad')])
            is_vjp_grad = fwd is not None and fwd.vjp_slots is not None
        rule = RULES.get(op.type)
        if is_vjp_grad:
            self._vjp_grad(io)
        elif rule is not None:
            rule(io)
        elif all(not any(io.spec(n)) for _, n in ins):
            io.emit()
            for n in op.output_arg_names():
                v = ctx.local.get(n)
                if _is_tensor(v):
                    io.out(n, (REPL,) * v.ndim)
        elif op.type in POINTWISE:
            pointwise(io)
        else:
            replicated(io)
        self._finish(io, role, is_vjp_grad, ins)

    def _vjp_grad(self, io):
        from .. import registry
        op = io.op
        io.emit()
        fwd_inputs = op.attr('__fwd_inputs__') if op.has_attr(
            '__fwd_inputs__') else {}
        key = registry.grad_record_key(op)
        parts = self.fwd_partial.pop(key, {})
        for slot in op.outputs:
            if not slot.endswith('@GRAD'):
                continue
            fwd = fwd_inputs.get(slot[:-len('@GRAD')], [])
            for fn, gn in zip(fwd, op.output(slot)):
                if not gn:
                    continue
                v = io.ctx.local.get(gn)
                if not _is_tensor(v):
                    continue
                io.out(gn, self.spec_of(fn, io.ctx) if fn else
                       (REPL,) * v.ndim)
                if parts.get(fn):
                    self.partial[gn] = parts[fn]

    def _finish(self, io, role, is_vjp_grad, ins):
        ctx, op = io.ctx, io.op
        for n, sp in io.out_specs.items():
            self.layouts[n] = sp
        # a persistable output goes back to its stored layout, and an
        # accumulated gradient part keeps its parts' pending sums
        for n in op.output_arg_names():
            v = ctx.local.get(n)
            if not _is_tensor(v):
                continue
            sp = self.layouts.get(n)
            if sp is None:
                sp = (REPL,) * v.ndim
                self.layouts[n] = sp
            if ctx.is_persistable(n):
                want = normalize(self.storage.get(n), v.ndim, self.mesh)
                if want != sp:
                    ctx.set(n, redistribute(v, sp, want, self.mesh))
                    self.layouts[n] = want
            elif role == 'backward' and not is_vjp_grad:
                base = grad_base(n)
                if base is not None and (base in self.layouts or
                                         base in self.storage):
                    want = self.spec_of(base, ctx)
                    if len(want) == v.ndim and want != sp and \
                            n not in self.partial:
                        ctx.local[n] = redistribute(v, sp, want, self.mesh)
                        self.layouts[n] = want
        if role == 'backward' and op.type in _ACCUMULATE:
            axes = set()
            for _, n in ins:
                if n in self.partial:
                    axes |= set(self.partial.pop(n))
            if axes:
                for n in op.output_arg_names():
                    self.partial[n] = tuple(sorted(axes))
        # the parameter-gradient parts this op's grad will produce
        if not is_vjp_grad:
            self._note_partials(io, ins)

    def _note_partials(self, io, ins):
        from .. import registry
        op = io.op
        params = [n for _, n in ins if n in self.params]
        if not params:
            return
        data = set()
        for _, n in ins:
            if n not in self.params:
                data |= spec_axes_set(io.spec(n))
        for n in op.output_arg_names():
            sp = self.layouts.get(n)
            if sp:
                data |= spec_axes_set(sp)
        found = {}
        for p in params:
            if p in io.partial_of:
                axes = set(io.partial_of[p])
            else:
                own = spec_axes_set(normalize(
                    self.storage.get(p), io.ctx.get(p).ndim, self.mesh))
                axes = data - own - io.sliced.get(p, set())
            if axes:
                found[p] = tuple(sorted(axes))
        if not found:
            return
        if op.type.endswith('_grad'):
            # a hand-written grad op: its outputs are the parts
            for slot in op.outputs:
                if slot.endswith('@GRAD'):
                    for fn, gn in zip(op.input(slot[:-len('@GRAD')]),
                                      op.output(slot)):
                        if gn and fn in found:
                            self.partial[gn] = found[fn]
        else:
            self.fwd_partial[registry.record_key(op.type, op.outputs)] = \
                found


# ops that add parameter-gradient parts (their output stays pending)
_ACCUMULATE = frozenset({'sum'})


# -- rules --------------------------------------------------------------------

RULES = {}


def rule(*types):
    def deco(fn):
        for t in types:
            RULES[t] = fn
        return fn
    return deco


def replicated(io):
    """Any op: gather every sharded input, run replicated."""
    for _, n in io.inputs():
        sp = io.spec(n)
        if any(sp):
            io.use(n, (REPL,) * len(sp))
    io.emit()
    for n in io.op.output_arg_names():
        v = io.ctx.local.get(n)
        if _is_tensor(v):
            io.out(n, (REPL,) * v.ndim)


POINTWISE = frozenset({
    'elementwise_add', 'elementwise_sub', 'elementwise_mul',
    'elementwise_div', 'elementwise_max', 'elementwise_min',
    'elementwise_pow', 'relu', 'gelu', 'sigmoid', 'tanh', 'exp', 'log',
    'sqrt', 'rsqrt', 'square', 'abs', 'scale', 'cast', 'sum',
    'leaky_relu', 'softplus', 'softsign', 'elu', 'relu6', 'brelu', 'swish',
    'hard_sigmoid', 'square_error_cost', 'assign', 'clip', 'sign',
    'sgd', 'momentum', 'adam', 'adamax', 'adagrad', 'rmsprop', 'ftrl',
    'decayed_adagrad', 'adadelta', 'lars_momentum', 'dropout', 'pow',
    'fill_zeros_like', 'logical_and', 'logical_or', 'logical_not',
    'equal', 'less_than', 'greater_than', 'less_equal', 'greater_equal',
    'not_equal', 'floor', 'ceil', 'round', 'reciprocal', 'cos', 'sin',
    'stanh', 'thresholded_relu', 'hard_shrink', 'soft_relu', 'log_sigmoid',
    'tanh_shrink', 'softshrink', 'silu'})


def _aligned(io, ref_nd):
    """(name, value, offset) of the op's tensor inputs, each aligned to
    the output rank: elementwise ops by their axis attr, others at the
    trailing dims."""
    op = io.op
    out = []
    ins = io.inputs()
    x_nd = None
    for slot, n in ins:
        if slot == 'X':
            x_nd = io.val(n).ndim
    for slot, n in ins:
        v = io.val(n)
        off = ref_nd - v.ndim
        if op.type.startswith('elementwise_') and slot == 'Y' and \
                x_nd is not None:
            axis = op.attr('axis', -1) if op.has_attr('axis') else -1
            off = (x_nd - v.ndim) if axis == -1 else axis
        out.append((n, v, off))
    return out


def pointwise(io):
    ins = io.inputs()
    ref_nd = max(io.val(n).ndim for _, n in ins)
    al = _aligned(io, ref_nd)
    gshape = [1] * ref_nd
    target = [REPL] * ref_nd
    for n, v, off in al:
        sp = io.spec(n)
        gs = global_shape(v.shape, sp, io.mesh)
        for i, s in enumerate(gs):
            gshape[off + i] = max(gshape[off + i], s)
    for n, v, off in al:
        sp = io.spec(n)
        gs = global_shape(v.shape, sp, io.mesh)
        for i, e in enumerate(sp):
            if e and gs[i] == gshape[off + i] and not target[off + i]:
                target[off + i] = e
    for n, v, off in al:
        sp = io.spec(n)
        gs = global_shape(v.shape, sp, io.mesh)
        want = tuple(target[off + i] if gs[i] == gshape[off + i] else REPL
                     for i in range(v.ndim))
        if want != sp:
            io.use(n, want, out_axes=spec_axes_set(target))
        # broadcast along a sharded dim: the gradient arrives in parts
        bcast = set()
        for j in range(ref_nd):
            i = j - off
            if target[j] and (i < 0 or i >= v.ndim or
                              gs[i] != gshape[j]):
                bcast |= set(target[j])
        if bcast and n not in io.st.params and v.requires_grad:
            io.copy_in(n, sorted(bcast))
    io.emit()
    lshape = [g // factor(e, io.mesh) for g, e in zip(gshape, target)]
    for n in io.op.output_arg_names():
        r = io.ctx.local.get(n)
        if not _is_tensor(r):
            continue
        k = r.ndim
        if k <= ref_nd and list(r.shape) == lshape[ref_nd - k:]:
            io.out(n, tuple(target[ref_nd - k:]))
        elif k <= ref_nd and not any(target[ref_nd - k:]):
            io.out(n, (REPL,) * k)
        else:
            io.out(n, (REPL,) * k)


def leading(io, trailing, params=()):
    """A batch-local op: the inputs of `trailing` (slot -> k) act row by
    row over their leading dims (which align), their last k dims whole;
    the inputs of `params` are replicated."""
    op = io.op
    names, target = [], None
    for slot, k in trailing.items():
        for n in op.input(slot):
            if not n:
                continue
            v = io.val(n)
            names.append((n, k))
            sp = io.spec(n)[:v.ndim - k]
            target = list(sp) if target is None else \
                [t if t else s for t, s in zip(target, sp)]
    target = tuple(target or ())
    out_axes = spec_axes_set(target)
    for n, k in names:
        nl = io.val(n).ndim - k
        want = tuple(target[:nl]) + (REPL,) * (nl - len(target)) + \
            (REPL,) * k
        if io.spec(n) != want:
            io.use(n, want, out_axes=out_axes)
    for slot in params:
        for n in op.input(slot):
            if n and any(io.spec(n)):
                io.use(n, (REPL,) * len(io.spec(n)))
    io.emit()
    lead_shape = None
    if names:
        v0 = io.val(names[0][0])
        lead_shape = tuple(v0.shape[:len(target)])
    for n in op.output_arg_names():
        r = io.ctx.local.get(n)
        if not _is_tensor(r):
            continue
        if not any(target):
            io.out(n, (REPL,) * r.ndim)
        elif r.ndim >= len(target) and \
                tuple(r.shape[:len(target)]) == lead_shape:
            io.out(n, tuple(target) + (REPL,) * (r.ndim - len(target)))
        elif r.ndim >= 1 and r.shape[0] == int(np.prod(lead_shape)) and \
                not any(target[1:]):
            io.out(n, (target[0],) + (REPL,) * (r.ndim - 1))
        else:
            io.out(n, _UNREADABLE)


_UNREADABLE = ('<per-rank>',)


def _lead_rule(trailing, params=()):
    def fn(io):
        leading(io, trailing, params)
    return fn


rule('layer_norm')(lambda io: leading(
    io, {'X': io.val(io.op.single_input('X')).ndim -
         io.op.attr('begin_norm_axis', 1)}, ('Scale', 'Bias')))
rule('softmax', 'log_softmax')(_lead_rule({'X': 1}))
rule('causal_mask_bias')(_lead_rule({'X': 2}))
rule('flash_attention')(_lead_rule({'Q': 2, 'K': 2, 'V': 2}))
rule('cross_entropy')(_lead_rule({'X': 1, 'Label': 1}))
rule('softmax_with_cross_entropy')(_lead_rule({'Logits': 1, 'Label': 1}))
rule('fused_softmax_cross_entropy')(_lead_rule(
    {'X': 1, 'Label': 1}, ('W', 'Bias')))
rule('conv2d', 'depthwise_conv2d')(_lead_rule({'Input': 3},
                                              ('Filter', 'Bias')))
rule('pool2d')(_lead_rule({'X': 3}))


@rule('sharding_constraint')
def _constraint(io):
    op = io.op
    x = op.single_input('X')
    v = io.val(x)
    role = op.attr('op_role', '') if op.has_attr('op_role') else ''
    base = grad_base(op.single_output('Out'))
    if role == 'backward' and base is not None:
        want = io.st.spec_of(base, io.ctx)
    else:
        spec = tuple(op.attr('spec'))
        if len(spec) < v.ndim:
            spec = (spec[0],) + (None,) * (v.ndim - len(spec)) + spec[1:]
        elif len(spec) > v.ndim:
            raise ValueError(
                'sharding_constraint: spec %s has rank %d but value has '
                'rank %d' % (spec, len(spec), v.ndim))
        want = normalize(spec, v.ndim, io.mesh)
        gs = global_shape(v.shape, io.spec(x), io.mesh)
        # an axis that does not divide its dim is dropped (fit_spec)
        want = tuple(e if gs[d] % factor(e, io.mesh) == 0 else REPL
                     for d, e in enumerate(want))
    out = redistribute(v, io.spec(x), want, io.mesh)
    io.ctx.set(op.single_output('Out'), out)
    io.out(op.single_output('Out'), want)


@rule('mul')
def _mul(io):
    """fc's product. W [K, N] sharded on N (column parallel): X is
    replicated over those axes and its gradient summed over them
    (copy_in); the output is sharded on N. W sharded on K (row
    parallel): X's last dim is sharded like W's rows and the partial
    products are summed (all-reduce); the output is replicated there."""
    op = io.op
    xn, yn = op.single_input('X'), op.single_input('Y')
    x, y = io.val(xn), io.val(yn)
    xc = op.attr('x_num_col_dims', 1)
    if y.ndim != 2 or op.attr('y_num_col_dims', 1) != 1:
        return replicated(io)
    xs, ys = io.spec(xn), io.spec(yn)
    row, col = ys
    out = op.single_output('Out')
    if row and xc != x.ndim - 1:
        io.use(yn, (REPL, col))
        row = REPL
    if set(row) & set(col):
        io.use(yn, (row, REPL))
        col = REPL
    busy = set(row) | set(col)
    lead = tuple(tuple(a for a in e if a not in busy) for e in xs[:xc])
    want = lead + ((row,) if row else (REPL,) * (x.ndim - xc))
    if want != xs:
        io.use(xn, want)
    if col:
        io.copy_in(xn, col)
    io.emit()
    if row:
        r = io.result(out)
        for a in row:
            r = C.all_reduce_sum(r, io.ax(a))
        io.replace(out, r)
    io.out(out, lead + (col,))


@rule('matmul')
def _matmul(io):
    op = io.op
    xn, yn = op.single_input('X'), op.single_input('Y')
    x, y = io.val(xn), io.val(yn)
    if x.ndim != y.ndim or x.ndim < 2:
        return replicated(io)
    tx, ty = op.attr('transpose_X', False), op.attr('transpose_Y', False)
    xs, ys = list(io.spec(xn)), list(io.spec(yn))
    nb = x.ndim - 2
    batch = [a if a else b for a, b in zip(xs[:nb], ys[:nb])]
    xm, xk = (nb + 1, nb) if tx else (nb, nb + 1)
    yk, yn_ = (nb + 1, nb) if ty else (nb, nb + 1)
    m_sp, n_sp = xs[xm], ys[yn_]
    if set(m_sp) & set(n_sp):
        n_sp = REPL
    wx = batch + [None, None]
    wy = batch + [None, None]
    wx[xm], wx[xk] = m_sp, REPL
    wy[yn_], wy[yk] = n_sp, REPL
    out_axes = spec_axes_set(tuple(batch) + (m_sp, n_sp))
    if tuple(wx) != tuple(xs):
        io.use(xn, tuple(wx), out_axes=out_axes)
    if tuple(wy) != tuple(ys):
        io.use(yn, tuple(wy), out_axes=out_axes)
    io.emit()
    io.out(op.single_output('Out'), tuple(batch) + (m_sp, n_sp))


@rule('slice')
def _slice(io):
    op = io.op
    n = op.single_input('Input')
    sp = list(io.spec(n))
    for a in op.attr('axes'):
        sp[a] = REPL
    if tuple(sp) != io.spec(n):
        io.use(n, tuple(sp))
    io.emit()
    out = io.result(op.single_output('Out'))
    dec = op.attr('decrease_axis', []) if op.has_attr('decrease_axis') \
        else []
    if out.ndim != len(sp) and dec:
        sp = [e for i, e in enumerate(sp) if i not in set(dec)]
    io.out(op.single_output('Out'), tuple(sp[:out.ndim]))


@rule('transpose2', 'transpose')
def _transpose(io):
    op = io.op
    sp = io.spec(op.single_input('X'))
    io.emit()
    io.out(op.single_output('Out'), tuple(sp[a] for a in op.attr('axis')))


def _reshape_plan(in_shape, in_spec, out_shape, mesh):
    """The out spec for reshaping a value of global in_shape and layout
    in_spec to the global out_shape, or None where the shards do not stay
    contiguous: each group of dims whose products match keeps the
    sharding of its first in-dim on its first out-dim."""
    out_spec = [REPL] * len(out_shape)
    i = j = 0
    while i < len(in_shape) or j < len(out_shape):
        gi, gj = [i], [j]
        pi = in_shape[i] if i < len(in_shape) else 1
        pj = out_shape[j] if j < len(out_shape) else 1
        while pi != pj:
            if pi < pj:
                i += 1
                gi.append(i)
                pi *= in_shape[i]
            else:
                j += 1
                gj.append(j)
                pj *= out_shape[j]
        i += 1
        j += 1
        gi = [d for d in gi if d < len(in_shape)]
        gj = [d for d in gj if d < len(out_shape)]
        # size-1 dims carry no sharding; skip them in the group
        gi_live = [d for d in gi if in_shape[d] != 1 or in_spec[d]]
        gj_live = [d for d in gj if out_shape[d] != 1]
        sharded = [d for d in gi if in_spec[d]]
        if not sharded:
            continue
        if not gi_live or not gj_live or sharded != [gi_live[0]]:
            return None
        f = factor(in_spec[sharded[0]], mesh)
        if out_shape[gj_live[0]] % f:
            return None
        out_spec[gj_live[0]] = in_spec[sharded[0]]
    return tuple(out_spec)


def _resolve(shape, numel, src_shape=None):
    shape = [src_shape[i] if (s == 0 and src_shape is not None) else s
             for i, s in enumerate(shape)]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = numel // max(known, 1)
    return shape


def _reshape_to(io, xname, out_global, out_name, attr):
    v = io.val(xname)
    sp = io.spec(xname)
    g_in = global_shape(v.shape, sp, io.mesh)
    plan = _reshape_plan(g_in, sp, out_global, io.mesh)
    if plan is None:
        io.use(xname, (REPL,) * v.ndim)
        plan = (REPL,) * len(out_global)
    local = [s // factor(e, io.mesh) for s, e in zip(out_global, plan)]
    io.patch(**{attr: local})
    io.emit()
    io.out(out_name, plan)
    return plan


@rule('reshape2', 'reshape')
def _reshape(io):
    op = io.op
    x = op.single_input('X')
    v = io.val(x)
    g_in = global_shape(v.shape, io.spec(x), io.mesh)
    out_g = _resolve(list(op.attr('shape')), int(np.prod(g_in)), g_in)
    _reshape_to(io, x, out_g, op.single_output('Out'), 'shape')
    if op.output('XShape'):
        io.out(op.single_output('XShape'), (REPL,) * (v.ndim + 1))


@rule('reshape_grad_helper')
def _reshape_grad(io):
    op = io.op
    g = op.single_input('Out@GRAD')
    v = io.val(g)
    numel = int(np.prod(global_shape(v.shape, io.spec(g), io.mesh)))
    out_g = _resolve(list(op.attr('x_shape')), numel)
    _reshape_to(io, g, out_g, op.single_output('X@GRAD'), 'x_shape')


@rule('lookup_table')
def _lookup(io):
    op = io.op
    idn, wn = op.single_input('Ids'), op.single_input('W')
    ids, w = io.val(idn), io.val(wn)
    ws = io.spec(wn)
    isp = io.spec(idn)
    squeeze = ids.ndim > 1 and ids.shape[-1] == 1
    lead = isp[:-1] if squeeze else isp
    out = op.single_output('Out')
    if not ws[0]:
        if ws[1]:
            io.use(wn, (REPL, REPL))
        io.emit()
        io.out(out, tuple(lead) + (REPL,))
        return
    vocab_axes = ws[0]
    if set(vocab_axes) & set(a for e in isp for a in e):
        io.use(idn, tuple(tuple(a for a in e if a not in vocab_axes)
                          for e in isp))
        ids = io.val(idn)
        isp = io.spec(idn)
        lead = isp[:-1] if squeeze else isp
    if op.attr('padding_idx', -1) != -1:
        raise LayoutError('lookup_table: padding_idx with a vocab-sharded '
                          'table is not supported')
    rows = w.shape[0]
    idx = 0
    for a in vocab_axes:
        ax = io.ax(a)
        idx = idx * ax.size + ax.index
    lo = idx * rows
    flat = (ids.reshape(ids.shape[:-1]) if squeeze else ids).long()
    hit = (flat >= lo) & (flat < lo + rows)
    from ..registry import amp_cast
    r = w[torch.where(hit, flat - lo, torch.zeros_like(flat))]
    r = r * hit.unsqueeze(-1).to(r.dtype)
    for a in vocab_axes:
        r = C.all_reduce_sum(r, io.ax(a))
    io.ctx.set(out, amp_cast(io.ctx, r))
    io.out(out, tuple(lead) + (ws[1],))


@rule('lookup_table_grad')
def _lookup_grad(io):
    op = io.op
    idn, wn = op.single_input('Ids'), op.single_input('W')
    gn = op.single_input('Out@GRAD')
    out = op.single_output('W@GRAD')
    ws = io.spec(wn)
    if op.attr('is_sparse', False) and any(io.spec(idn)):
        raise LayoutError('a sparse lookup_table gradient on a mesh is '
                          'not supported; use is_sparse=False')
    if not ws[0]:
        io.emit()
        io.out(out, ws)
        return
    from ..selected_rows import scatter_add_rows
    ids, w, g = io.val(idn), io.val(wn), io.val(gn)
    vocab_axes = ws[0]
    rows = w.shape[0]
    idx = 0
    for a in vocab_axes:
        ax = io.ax(a)
        idx = idx * ax.size + ax.index
    lo = idx * rows
    squeeze = ids.ndim > 1 and ids.shape[-1] == 1
    flat = (ids.reshape(ids.shape[:-1]) if squeeze else ids).reshape(-1)
    flat = flat.long()
    hit = (flat >= lo) & (flat < lo + rows)
    rows_g = g.reshape((flat.numel(), w.shape[1])).to(w.dtype)
    rows_g = rows_g * hit.unsqueeze(-1).to(w.dtype)
    gw = scatter_add_rows(torch.zeros(w.shape, dtype=w.dtype,
                                      device=w.device),
                          torch.where(hit, flat - lo, torch.zeros_like(flat)),
                          rows_g)
    io.ctx.set(out, gw)
    io.out(out, ws)


@rule('position_embedding')
def _position_embedding(io):
    op = io.op
    xn, pn = op.single_input('X'), op.single_input('Pos')
    x, pos = io.val(xn), io.val(pn)
    xs = io.spec(xn)
    t_axes = xs[1]
    out = op.single_output('Out')
    if any(io.spec(pn)):
        io.use(pn, (REPL, REPL))
        pos = io.val(pn)
    if not t_axes:
        io.emit()
        io.out(out, xs)
        return
    T = x.shape[1] * factor(t_axes, io.mesh)
    p = pos[:T]
    for a in t_axes:
        p = C.chunk(p, 0, io.ax(a))
    io.sliced.setdefault(pn, set()).update(t_axes)
    io.ctx.set(out, p[None].expand(x.shape).to(x.dtype))
    io.out(out, xs)


def _reduce_axes(io, dims):
    n = io.op.single_input('X')
    sp = io.spec(n)
    return [a for d in dims for a in sp[d]], sp


@rule('mean')
def _mean(io):
    op = io.op
    x = io.val(op.single_input('X'))
    axes, _ = _reduce_axes(io, range(x.ndim))
    io.emit()
    out = op.single_output('Out')
    if axes:
        r = io.result(out)
        n = 1
        for a in axes:
            r = C.all_reduce_sum(r, io.ax(a))
            n *= io.mesh.shape[a]
        io.replace(out, r / n)
    io.out(out, ())


def _reduce_rule(mean):
    def fn(io):
        op = io.op
        x = io.val(op.single_input('X'))
        if op.attr('reduce_all', False):
            dims = tuple(range(x.ndim))
        else:
            dims = tuple(sorted(set(d % x.ndim for d in op.attr('dim', [0]))))
        axes, sp = _reduce_axes(io, dims)
        io.emit()
        out = op.single_output('Out')
        keep = op.attr('keep_dim', False)
        r = io.result(out)
        if axes:
            n = 1
            for a in axes:
                r = C.all_reduce_sum(r, io.ax(a))
                n *= io.mesh.shape[a]
            io.replace(out, r / n if mean else r)
        osp = tuple(REPL if d in dims else e for d, e in enumerate(sp)
                    if keep or d not in dims)
        io.out(out, osp[:r.ndim] + (REPL,) * max(0, r.ndim - len(osp)))
    return fn


rule('reduce_sum')(_reduce_rule(False))
rule('reduce_mean')(_reduce_rule(True))


@rule('batch_norm')
def _batch_norm(io):
    op = io.op
    xn = op.single_input('X')
    x = io.val(xn)
    layout = op.attr('data_layout', 'NCHW')
    ch = 1 if layout == 'NCHW' else x.ndim - 1
    sp = list(io.spec(xn))
    if sp[ch]:
        sp[ch] = REPL
        io.use(xn, tuple(sp))
    for slot in ('Scale', 'Bias', 'Mean', 'Variance'):
        n = op.single_input(slot)
        if any(io.spec(n)):
            io.use(n, (REPL,))
    is_test = op.attr('is_test', False) or io.ctx.is_test
    axes = [a for d, e in enumerate(sp) if d != ch for a in e]
    st = io.st
    if axes and not is_test and not st.bn_local:
        mesh = io.mesh

        def reduce(s1, s2, m):
            both = torch.stack([s1, s2])
            for a in axes:
                both = C.sync_sum(both, C.axis(mesh, a))
                m *= mesh.shape[a]
            return both[0], both[1], m
        st.bn_reduce = reduce
    try:
        io.emit()
    finally:
        st.bn_reduce = None
    io.out(op.single_output('Y'), tuple(sp))
    for slot in ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance'):
        if op.output(slot):
            io.out(op.single_output(slot), (REPL,))


@rule('batch_norm_grad')
def _batch_norm_grad(io):
    op = io.op
    fwd = op.attr('__fwd_inputs__')
    xn = fwd['X'][0]
    gn = op.single_input('Y@GRAD')
    x = io.val(xn)
    layout = op.attr('data_layout', 'NCHW')
    ch = 1 if layout == 'NCHW' else x.ndim - 1
    sp = list(io.spec(xn))
    sp[ch] = REPL
    sp = tuple(sp)
    for n in (xn, gn):
        if io.spec(n) != sp:
            io.use(n, sp)
    is_test = op.attr('is_test', False) or io.ctx.is_test
    axes = [a for d, e in enumerate(sp) if d != ch for a in e]
    st = io.st
    if axes and not is_test and not st.bn_local:
        mesh = io.mesh

        def reduce(s1, s2, m):
            both = torch.stack([s1, s2])
            for a in axes:
                both = C._all_reduce(both, C.axis(mesh, a))
                m *= mesh.shape[a]
            return both[0], both[1], m
        st.bn_reduce = reduce
        # the summed Σdy and Σdy·x̂ are whole already
        for slot in ('Scale', 'Bias'):
            io.partial_of[fwd[slot][0]] = ()
    try:
        io.emit()
    finally:
        st.bn_reduce = None
    io.out(op.single_output('X@GRAD'), sp)
    for slot in ('Scale@GRAD', 'Bias@GRAD'):
        if op.output(slot):
            io.out(op.single_output(slot), (REPL,))


@rule('read')
def _read(io):
    """A py_reader's batch is the global batch on every rank: each rank
    keeps its dp rows, as a fed batch (ParallelExecutor._put_feed)."""
    io.emit()
    pe = io.st
    for n in io.op.output('Out'):
        v = io.ctx.local[n]
        spec = pe.feed_spec(n, v)
        if not pe.feed_is_local:
            v = local_part(v, spec, io.mesh, pe.rank)
        io.ctx.set(n, v)
        io.out(n, spec)


@rule('ring_attention')
def _ring(io):
    from . import ring_attention as ra
    op = io.op
    names = [op.single_input(s) for s in ('Q', 'K', 'V')]
    q = io.val(names[0])
    sp = list(io.spec(names[0]))
    sp_size = io.mesh.shape.get('sp', 1)
    T = q.shape[2] * factor(sp[2], io.mesh)
    out = op.single_output('Out')
    if sp_size <= 1 or T % sp_size:
        # no ring: ordinary attention on whole sequences
        sp[2] = REPL
        sp[3] = REPL
        for n in names:
            if io.spec(n) != tuple(sp):
                io.use(n, tuple(sp))
        io.emit()
        io.out(out, tuple(sp))
        return
    sp[2] = ('sp',)
    sp[3] = REPL
    sp[0] = tuple(a for a in sp[0] if a != 'sp')
    sp[1] = tuple(a for a in sp[1] if a != 'sp')
    vals = []
    for n in names:
        if io.spec(n) != tuple(sp):
            io.use(n, tuple(sp))
        vals.append(io.val(n))
    from ..flags import get_flag
    from ..registry import amp_cast
    qv, kv, vv = amp_cast(io.ctx, *vals)
    o = ra.ring_attention_local(
        qv, kv, vv, io.ax('sp'), causal=op.attr('causal', True),
        sm_scale=op.attr('sm_scale', None),
        flash=bool(get_flag('use_flash_attention')))
    io.ctx.set(out, o)
    io.out(out, tuple(sp))


@rule('moe_ffn')
def _moe(io):
    from . import moe
    moe.moe_ffn_rule(io)


@rule('moe_aux_loss')
def _moe_aux(io):
    from . import moe
    moe.moe_aux_rule(io)



# -- the serving ops (ops/attention_ops.py) -----------------------------------
#
# On a serving mesh (serving/mesh.py) the K/V state is sharded on its
# heads dim (dim 2 of a ring [slots, T, H, dh] and of a pool
# [pages, pt, H, dh]) and every feed (tokens, positions, page tables,
# COW plans) is replicated. The cache ops write their rank's heads in
# place, the gathers and the masks keep the heads split, and nothing of
# the state crosses ranks. A state sharded on another dim has no local
# form: such an op runs replicated (the state gathered and written back
# to its layout).

def _local(io, wants, out):
    """Run the op on local shards: each input named in `wants` moved to
    its spec, every other tensor input replicated; every output takes
    `out`."""
    for _, n in io.inputs():
        want = wants.get(n, (REPL,) * len(io.spec(n)))
        if io.spec(n) != tuple(want):
            io.use(n, tuple(want))
    io.emit()
    for n in io.op.output_arg_names():
        if _is_tensor(io.ctx.local.get(n)):
            io.out(n, tuple(out))


def _state_rule(state_slot, x_slot=None):
    def fn(io):
        op = io.op
        sn = op.single_input(state_slot)
        ss = io.spec(sn)
        if any(ss[:2]):
            return replicated(io)
        wants = {sn: ss}
        if x_slot is not None:
            xn = op.single_input(x_slot)
            wants[xn] = (REPL,) * (io.val(xn).ndim - 2) + tuple(ss[2:])
        _local(io, wants, ss)
    return fn


rule('kv_cache_write', 'kv_cache_append')(_state_rule('Cache', 'X'))
rule('kv_page_write', 'kv_page_append')(_state_rule('Pool', 'X'))
rule('kv_page_cow')(_state_rule('Pool'))


@rule('kv_page_gather')
def _page_gather(io):
    pn = io.op.single_input('Pool')
    ss = io.spec(pn)
    if any(ss[:2]):
        return replicated(io)
    _local(io, {pn: ss}, (REPL, REPL) + tuple(ss[2:]))


@rule('decode_mask', 'paged_decode_mask', 'spec_verify_mask',
      'paged_prefill_mask')
def _score_mask(io):
    """Scores [B, H, rows, J] keep their heads split; the positions they
    are masked by are replicated feeds."""
    xn = io.op.single_input('X')
    keep = (REPL, io.spec(xn)[1], REPL, REPL)
    _local(io, {xn: keep}, keep)


@rule('gather_time')
def _gather_time(io):
    xn = io.op.single_input('X')
    xs = io.spec(xn)
    _local(io, {xn: (REPL, REPL) + tuple(xs[2:])}, (REPL,) + tuple(xs[2:]))


@rule('position_embedding_at')
def _position_embedding_at(io):
    pn = io.op.single_input('Pos')
    d = io.spec(pn)[1]
    _local(io, {pn: (REPL, d)}, (REPL, REPL, d))
