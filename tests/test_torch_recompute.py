"""layers.recompute, the remat_block op and TransformerConfig(remat=)
against the JAX package on the CPU, at tests/test_recompute.py's size
(vocab 64, dim 32, heads 2, 2 layers, ffn 64, T 8).

- The main and startup Program texts with remat='nothing' and 'dots'
  equal the JAX package's.
- Four Adam steps of the LM under remat None, 'nothing' and 'dots' from
  the JAX package's initial weights (io.load_numpy_params): each
  policy's losses agree with the JAX package's run of the same policy
  within 1e-4, and the three policies' losses with each other within
  1e-5 (the rematerialized gradient is the plain one).
- A dropout inside the scope draws the same mask in the recompute: dL/dw
  read from the recompute equals the mean of the forward's dropout
  output (test_recompute.py:52).
- A scope with two outputs (test_recompute.py:90).
- The forward keeps no autograd record of the scope's ops: after the
  remat_block op ran, the run's records hold one entry (its own) and
  its outputs carry no autograd history.
- A host op in the scope raises (the JAX package's _run_sub_block).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import registry as tregistry
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import transformer as ttransformer

CFG = dict(vocab=64, dim=32, heads=2, layers=2, ffn=64, max_len=8,
           use_tp=False, use_sp=False)
STEPS = 4
JAX_TOL = 1e-4       # the same policy, across the packages
POLICY_TOL = 1e-5    # the three policies, in the port


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _build(fluid, transformer, remat):
    cfg = transformer.TransformerConfig(remat=remat, **CFG)
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='t', shape=[cfg.max_len, 1],
                                 dtype='int64')
        lbls = fluid.layers.data(name='l', shape=[cfg.max_len, 1],
                                 dtype='int64')
        logits = transformer.language_model_logits(toks, cfg)
        cost = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, lbls))
        fluid.optimizer.Adam(1e-3).minimize(cost)
    return prog, startup, cost


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        tb = rng.randint(0, CFG['vocab'], (4, CFG['max_len'], 1))
        out.append({'t': tb.astype('int64'),
                    'l': np.roll(tb, -1, 1).astype('int64')})
    return out


def _params(prog):
    return [v.name for v in prog.global_block().vars.values()
            if getattr(v, 'trainable', False) and v.persistable]


def _jax_train(remat):
    prog, startup, cost = _build(jfluid, jtransformer, remat)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)).copy()
                for n in _params(prog)}
        losses = [float(np.asarray(exe.run(prog, feed=b,
                                           fetch_list=[cost])[0]))
                  for b in _batches()]
    return init, losses


def _torch_train(remat, init):
    prog, startup, cost = _build(tfluid, ttransformer, remat)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace(),
                                program=prog)
    return [float(np.asarray(exe.run(prog, feed=b, fetch_list=[cost],
                                     scope=scope)[0]))
            for b in _batches()]


@pytest.fixture(scope='module')
def jax_runs():
    return {remat: _jax_train(remat) for remat in (None, 'nothing', 'dots')}


@pytest.mark.parametrize('remat', ['nothing', 'dots'])
def test_program_text_equals_the_jax_package(remat):
    jprog, jstart, _ = _build(jfluid, jtransformer, remat)
    tprog, tstart, _ = _build(tfluid, ttransformer, remat)
    assert tprog.to_string() == jprog.to_string()
    assert tstart.to_string() == jstart.to_string()
    assert len(tprog.blocks) == 1 + CFG['layers']
    remats = [op for op in tprog.global_block().ops
              if op.type == 'remat_block']
    assert [op.attr('policy') for op in remats] == [remat] * CFG['layers']


@pytest.mark.parametrize('remat', [None, 'nothing', 'dots'])
def test_adam_steps_match_the_jax_package(jax_runs, remat):
    init, jlosses = jax_runs[remat]
    losses = _torch_train(remat, init)
    np.testing.assert_allclose(losses, jlosses, rtol=JAX_TOL)
    if remat is not None:
        np.testing.assert_allclose(losses, _torch_train(None, init),
                                   rtol=POLICY_TOL)


def _dropout_program(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[16], dtype='float32')

        def body(xv):
            h = fluid.layers.dropout(xv, dropout_prob=0.5)
            y = fluid.layers.fc(input=h, size=1, name='w', bias_attr=False)
            return [h, y]
        h, y = fluid.layers.recompute(body, x)
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.0).minimize(loss)
    return prog, startup, h


def test_dropout_mask_is_the_same_in_the_recompute():
    prog, startup, h = _dropout_program(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    xv = np.random.RandomState(5).rand(8, 16).astype('float32') + 0.5
    exe.run(startup, scope=scope)
    for _ in range(2):      # a fresh mask each step, each one consistent
        hv, g = exe.run(prog, feed={'x': xv}, fetch_list=[h, 'w.w_0@GRAD'],
                        scope=scope)
        # dL/dw = the batch mean of the dropout output: the fetched h
        # has the forward's mask, the grad the recompute's
        np.testing.assert_allclose(g.ravel(), hv.mean(0), rtol=1e-5)
        kept = (hv != 0).mean()
        assert 0.2 < kept < 0.8


def test_multiple_outputs():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')

        def body(xv):
            a = tfluid.layers.fc(input=xv, size=3, name='fa')
            b = tfluid.layers.fc(input=a, size=2, name='fb')
            return [a, b]
        a, b = tfluid.layers.recompute(body, x)
        s = tfluid.layers.elementwise_add(
            tfluid.layers.reduce_sum(a), tfluid.layers.reduce_sum(b))
        tfluid.optimizer.SGD(0.1).minimize(s)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    av, bv = exe.run(prog, feed={'x': np.ones((2, 4), 'f4')},
                     fetch_list=[a, b], scope=scope)
    assert av.shape == (2, 3) and bv.shape == (2, 2)


def test_forward_keeps_no_autograd_record(monkeypatch):
    """The remat forward records X, its random state and (under 'dots')
    the products, never an autograd graph of the scope's ops."""
    prog, startup, cost = _build(tfluid, ttransformer, 'nothing')
    seen = []
    opdef = tregistry.get_op('remat_block')
    emit = opdef.emit

    def spy(ctx, op):
        emit(ctx, op)
        outs = [ctx.local[n] for n in op.output('Out')]
        seen.append((len(ctx.records), [k[0] for k in ctx.records],
                     [o.grad_fn is None and not o.requires_grad
                      for o in outs]))
    monkeypatch.setattr(opdef, 'emit', spy)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(prog, feed=_batches()[0], fetch_list=[cost], scope=scope)
    assert len(seen) == CFG['layers']
    # the embedding and the position add are recorded before the first
    # block; each block adds one record, its own, and nothing inside it
    base = seen[0][0] - 1
    for i, (n, kinds, no_history) in enumerate(seen):
        assert n == base + i + 1
        assert kinds.count('remat_block') == i + 1
        assert all(no_history)


def test_a_host_op_in_the_scope_raises(tmp_path):
    """A sub-block runs inside its device segment: a host op (save) in
    the scope raises, as in the JAX package's _run_sub_block."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')

        def body(xv):
            y = tfluid.layers.fc(input=xv, size=3, name='hs')
            prog.current_block().append_op(
                type='save', inputs={'X': [y.name]},
                attrs={'file_path': str(tmp_path / 'y')})
            return y
        y = tfluid.layers.recompute(body, x)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(tfluid.executor.OpExecutionError,
                       match="host op 'save' cannot run inside"):
        exe.run(prog, feed={'x': np.ones((2, 4), 'f4')}, fetch_list=[y],
                scope=scope)
