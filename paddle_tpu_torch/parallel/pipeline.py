"""Pipeline parallelism: the GPipe schedule over the 'pp' mesh axis
(counterpart of paddle_tpu/parallel/pipeline.py:32-92).

The JAX package runs one SPMD program: stage weights stacked on a
leading [n_stages, ...] axis and sharded over 'pp', activations rotated
with a ppermute a tick inside a lax.scan of M + S - 1 ticks, and its
autodiff gives the backward. Here every rank is a process
(parallel/distributed.py), so the rank at pp coordinate s runs stage s
only, on each microbatch as it arrives:

  for m in 0..M-1:  x = x_micro[m] (s == 0) or receive from s - 1
                    y = stage_fn(params[s], x)
                    send y to s + 1 (s < S - 1), or keep it (s == S - 1)

which is the same M + S - 1 ticks seen from one rank. The JAX package
runs stage_fn on zeros in its bubble ticks and discards the result;
here a bubble tick computes nothing, which changes no value.

The point-to-point path is parallel/collectives.py's isend/irecv (under
gloo a CUDA tensor goes through a pinned host buffer, as the ring's
does). Each send and receive is a torch.autograd.Function whose backward
moves the cotangent the other way, so torch.autograd over the schedule
is the GPipe backward, as JAX's autodiff is:
- a receive's backward starts sending its cotangent back to s - 1 (the
  sends complete in finish_backward());
- the outputs leave the schedule through one Function on every pp rank:
  forward, the last stage's outputs summed over 'pp' with zeros
  elsewhere (the JAX package's psum); backward, the last rank keeps its
  own cotangent (every rank computes the same loss from the same
  outputs, so adding the others' would count it S times) and every
  other rank receives the cotangents of the activations it sent, all M
  at once. The sends and receives carry the microbatch as their tag, so
  no order of the autograd engine can pair them wrongly.
Nothing keeps a received buffer once its microbatch's backward ran.
"""
from __future__ import annotations

import torch

from . import collectives as C

__all__ = ['pipeline_apply', 'stack_stage_params', 'finish_backward']

# sends started by a backward, completed by finish_backward()
_PENDING = []


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """[{k: tensor}, ...] one pytree a stage -> one pytree with each leaf
    stacked on a leading n_stages axis (the JAX package's layout)."""
    return _tree_map(lambda *leaves: torch.stack(leaves, 0),
                     *per_stage_params)


def finish_backward():
    """Complete the cotangent sends that a backward through
    pipeline_apply started (call after loss.backward())."""
    while _PENDING:
        _PENDING.pop(0).wait()


class _Recv(torch.autograd.Function):
    """Forward: the activation from stage s - 1 (already received).
    Backward: start sending its cotangent back to s - 1."""

    @staticmethod
    def forward(ctx, anchor, x, ax, m):
        ctx.ax, ctx.m = ax, m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _PENDING.append(C.isend(g, ctx.ax, ctx.ax.index - 1, tag=ctx.m))
        return torch.zeros((), dtype=g.dtype, device=g.device), None, \
            None, None


class _PipeOut(torch.autograd.Function):
    """Forward: the last stage's stacked outputs summed over 'pp' (zeros
    elsewhere). Backward: the last rank keeps its cotangent; another
    rank receives the cotangent of each activation it sent from s + 1."""

    @staticmethod
    def forward(ctx, out, ax, *sent):
        ctx.ax, ctx.n = ax, len(sent)
        ctx.meta = [(tuple(y.shape), y.dtype, y.device) for y in sent]
        return C._all_reduce(out.clone(), ax)

    @staticmethod
    def backward(ctx, g):
        if not ctx.n:
            return (g, None)
        hs = [C.irecv(shape, dtype, dev, ctx.ax, ctx.ax.index + 1, tag=m)
              for m, (shape, dtype, dev) in enumerate(ctx.meta)]
        return (None, None) + tuple(h.wait() for h in hs)


def pipeline_apply(stage_fn, mesh, n_micro, params_stacked, x_micro,
                   axis='pp'):
    """Run x_micro ([M, mb, ...], or M tensors [mb, ...]) through the
    n_stages pipelined stages of `axis`; returns [M, mb, ...], the last
    stage's outputs in microbatch order, on every rank of the axis.

    stage_fn(stage_params, x) -> y maps the activation's shape and dtype
    to themselves (a uniform-stage pipeline). params_stacked: a pytree
    whose leaves carry a leading n_stages axis (stack_stage_params); this
    rank's stage reads index s of each leaf. None passes None to
    stage_fn (a stage that reads its parameters by itself, as the
    program lowering's does). Every rank of the axis must call it with
    x_micro of the same shape and dtype; only stage 0 reads its values.
    After a backward through the result, call finish_backward()."""
    ax = C.axis(mesh, axis)
    S, s = ax.size, ax.index
    M = int(n_micro)
    params = None if params_stacked is None else \
        _tree_map(lambda leaf: leaf[s], params_stacked)
    xs = list(x_micro) if not isinstance(x_micro, torch.Tensor) else \
        list(x_micro.unbind(0))
    if len(xs) != M:
        raise ValueError('pipeline_apply: %d microbatches given, n_micro=%d'
                         % (len(xs), M))
    grad = torch.is_grad_enabled()
    anchor = None
    if grad and s > 0:
        anchor = torch.zeros((), dtype=xs[0].dtype, device=xs[0].device,
                             requires_grad=True)
    outs, sent, sends = [], [], []
    for m in range(M):
        if s == 0:
            x = xs[m]
        else:
            x = C.irecv(xs[m].shape, xs[m].dtype, xs[m].device, ax, s - 1,
                        tag=m).wait()
            if anchor is not None:
                x = _Recv.apply(anchor, x, ax, m)
        y = stage_fn(params, x)
        if tuple(y.shape) != tuple(xs[m].shape) or y.dtype != xs[m].dtype:
            raise ValueError(
                'pipeline stage %d maps %s %s to %s %s: a stage must keep '
                'the activation\'s shape and dtype' % (
                    s, tuple(xs[m].shape), xs[m].dtype, tuple(y.shape),
                    y.dtype))
        if s < S - 1:
            sends.append(C.isend(y, ax, s + 1, tag=m))
            sent.append(y)
        else:
            outs.append(y)
    for h in sends:
        h.wait()
    if outs:
        out = torch.stack(outs, 0)
    else:
        out = torch.zeros((M,) + tuple(xs[0].shape), dtype=xs[0].dtype,
                          device=xs[0].device)
    if grad and (out.requires_grad or any(y.requires_grad for y in sent)):
        return _PipeOut.apply(out, ax, *sent)
    return C._all_reduce(out.clone(), ax)
