"""Static reverse-mode autodiff over the Program IR (counterpart of
paddle_tpu/backward.py: append_backward :154, calc_gradient :196).

Walks the op list in reverse, asks each op's registered grad maker
(registry.py) for grad-op specs, dedups fan-out gradients with sum ops,
fills zero grads for unreached grad inputs (fill_zeros_like), seeds the
loss grad with fill_constant, and materialises grad Variables named
`<var>@GRAD`. The grad ops appended here are the JAX package's, op for
op; what differs is only how they run (registry.py: recorded forwards).
"""
from __future__ import annotations

import collections

from .framework import grad_var_name, GRAD_VAR_SUFFIX, Parameter
from . import registry

__all__ = ['append_backward', 'calc_gradient']


def _find_op_path(block, target_names, no_grad_set):
    """Ops that (transitively) produce the targets; returns indices in
    forward order (reference backward.py _find_op_path_)."""
    relevant = set(target_names)
    path = []
    for idx in reversed(range(len(block.ops))):
        op = block.ops[idx]
        if set(op.output_arg_names()) & relevant:
            path.append(idx)
            for name in op.input_arg_names():
                if name not in no_grad_set:
                    relevant.add(name)
    path.reverse()
    return path


def _collect_no_grad(block, extra=None):
    no_grad = set(extra or ())
    for var in block.vars.values():
        if var.stop_gradient:
            no_grad.add(var.name)
    return no_grad


def _make_grad_ops(block, op_path, no_grad_set, loss_name=None,
                   seeded=None):
    """Generate the reversed grad-op spec list with fan-out dedup and
    zero-fill for missing grads."""
    grad_specs = []
    for idx in reversed(op_path):
        op = block.ops[idx]
        opdef = registry._REGISTRY.get(op.type)
        if opdef is None:
            raise KeyError('op %r has no registration (needed for grad)'
                           % op.type)
        if opdef.no_grad or opdef.grad is None:
            continue
        # skip if every differentiable input is in no_grad_set
        if all(n in no_grad_set for n in op.input_arg_names()):
            continue
        specs = opdef.grad(op, block)
        for spec in specs:
            # blank grad outputs for no-grad inputs, KEEPING positions --
            # emitters match outputs to forward inputs positionally
            # (reference empty-var-name convention, grad_op_desc_maker.h)
            for slot, names in list(spec['outputs'].items()):
                spec['outputs'][slot] = [
                    n if (n[:-len(GRAD_VAR_SUFFIX)]
                          if n.endswith(GRAD_VAR_SUFFIX) else n)
                    not in no_grad_set else ''
                    for n in names]
            if any(n for ns in spec['outputs'].values() for n in ns):
                grad_specs.append(spec)

    # -- fan-out dedup: rename multiple producers, insert sum --------------
    producer_count = collections.Counter()
    for spec in grad_specs:
        for names in spec['outputs'].values():
            for n in names:
                if n:
                    producer_count[n] += 1

    seen = collections.defaultdict(int)
    parts = collections.defaultdict(list)
    out = []
    for spec in grad_specs:
        for slot, names in spec['outputs'].items():
            renamed = []
            for n in names:
                if n and producer_count[n] > 1:
                    newn = '%s@RENAME@%d' % (n, seen[n])
                    seen[n] += 1
                    parts[n].append(newn)
                    renamed.append(newn)
                else:
                    renamed.append(n)
            spec['outputs'][slot] = renamed
        out.append(spec)
        # after the last producer of n, emit the sum op
        for n in list(parts):
            if seen[n] == producer_count[n]:
                out.append(dict(type='sum', inputs={'X': parts.pop(n)},
                                outputs={'Out': [n]}, attrs={}))
                del seen[n]

    # -- zero-fill grads read before being produced ------------------------
    produced = set(seeded or ())
    if loss_name is not None:
        produced.add(grad_var_name(loss_name))
    final = []
    for spec in out:
        for slot, names in spec['inputs'].items():
            for n in names:
                if (n.endswith(GRAD_VAR_SUFFIX) and n not in produced):
                    fwd = n[:-len(GRAD_VAR_SUFFIX)]
                    if block.has_var_recursive(fwd):
                        final.append(dict(
                            type='fill_zeros_like',
                            inputs={'X': [fwd]}, outputs={'Out': [n]},
                            attrs={}))
                        produced.add(n)
        for names in spec['outputs'].values():
            produced.update(n for n in names if n)
        final.append(spec)
    return final


def _create_grad_vars(block, grad_specs):
    """Materialise grad Variables with shape/dtype mirrored from the forward
    var (reference backward.py:393 _append_backward_vars_)."""
    for spec in grad_specs:
        for names in spec['outputs'].values():
            for n in names:
                if not n or block.has_var_recursive(n):
                    continue
                base = n
                for suffix in ('@RENAME@', GRAD_VAR_SUFFIX):
                    pos = base.find(suffix) if suffix == '@RENAME@' \
                        else (len(base) - len(suffix)
                              if base.endswith(suffix) else -1)
                    if pos >= 0:
                        base = base[:pos]
                if block.has_var_recursive(base):
                    fwd = block.var_recursive(base)
                    block.create_var(name=n, shape=fwd.shape, dtype=fwd.dtype,
                                     lod_level=fwd.lod_level)
                else:
                    block.create_var(name=n)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Append backward ops computing d(loss)/d(param) for every trainable
    parameter; returns [(param, grad)] (reference backward.py:469)."""
    block = loss.block
    program = block.program
    if loss.shape not in ((), (1,)):
        raise ValueError('loss must be scalar, got shape %s' % (loss.shape,))

    no_grad = _collect_no_grad(block, no_grad_set)
    op_path = _find_op_path(block, {loss.name}, no_grad)

    # seed: d loss / d loss = 1
    loss_grad_name = grad_var_name(loss.name)
    block.create_var(name=loss_grad_name, shape=loss.shape, dtype=loss.dtype)
    block.append_op(
        type='fill_constant', outputs={'Out': [loss_grad_name]},
        attrs={'shape': list(loss.shape), 'dtype': loss.dtype, 'value': 1.0,
               'op_role': 'backward'})

    grad_specs = _make_grad_ops(block, op_path, no_grad, loss_name=loss.name)
    _create_grad_vars(block, grad_specs)
    for spec in grad_specs:
        attrs = dict(spec['attrs'])
        attrs['op_role'] = 'backward'
        block.append_op(type=spec['type'], inputs=spec['inputs'],
                        outputs=spec['outputs'], attrs=attrs)

    if parameter_list is not None:
        params = [block.program.global_block().var(n) if isinstance(n, str)
                  else n for n in parameter_list]
    else:
        params = [v for v in program.global_block().vars.values()
                  if isinstance(v, Parameter) and v.trainable]
    params_and_grads = []
    for p in params:
        gname = grad_var_name(p.name)
        if block.has_var_recursive(gname):
            params_and_grads.append((p, block.var_recursive(gname)))
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of targets w.r.t. arbitrary inputs
    (reference backward.py calc_gradient)."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    block = targets[0].block
    no_grad = _collect_no_grad(block, no_grad_set)
    op_path = _find_op_path(block, {t.name for t in targets}, no_grad)

    for i, t in enumerate(targets):
        gname = grad_var_name(t.name)
        if target_gradients is not None and target_gradients[i] is not None:
            src = target_gradients[i]
            if not block.has_var_recursive(gname):
                block.create_var(name=gname, shape=t.shape, dtype=t.dtype)
            block.append_op(type='assign', inputs={'X': [src]},
                            outputs={'Out': [gname]},
                            attrs={'op_role': 'backward'})
        else:
            block.create_var(name=gname, shape=t.shape, dtype=t.dtype)
            block.append_op(
                type='fill_constant', outputs={'Out': [gname]},
                attrs={'shape': list(t.shape), 'dtype': t.dtype, 'value': 1.0,
                       'op_role': 'backward'})

    grad_specs = _make_grad_ops(
        block, op_path, no_grad,
        seeded={grad_var_name(t.name) for t in targets})
    _create_grad_vars(block, grad_specs)
    for spec in grad_specs:
        attrs = dict(spec['attrs'])
        attrs['op_role'] = 'backward'
        block.append_op(type=spec['type'], inputs=spec['inputs'],
                        outputs=spec['outputs'], attrs=attrs)

    grads = []
    for v in inputs:
        gname = grad_var_name(v.name)
        grads.append(block.var_recursive(gname)
                     if block.has_var_recursive(gname) else None)
    return grads
