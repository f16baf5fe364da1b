"""paddle_tpu_torch training against the JAX package.

- Every grad op of the training slice, one op at a time: the same numpy
  inputs and cotangent go through calc_gradient in both packages'
  executors on the CPU; grads must agree to atol=1e-5 (fp32, sums taken
  in another order).
- momentum and sgd updates, atol=1e-6.
- Three Momentum steps of a small flash LM fed by py_reader in both
  packages (the JAX package's Pallas kernels in interpret mode), weights
  carried across with io.load_numpy_params: per-step losses and every
  parameter's update must agree, fp32 to 1e-4 and bf16 AMP to 2e-2
  (|loss difference|, and ||update difference|| / ||update|| per
  parameter). bf16 rounds at other places in the two frameworks (gelu,
  bias-grad sums), which alone moves AMP updates by ~1e-2 in 3 steps.
  The same for three AMP steps of a small long-context-shaped LM (T=256,
  fused head) under the alternative flash arms: the JAX package forced to
  twopass/onepass, the port under PADDLE_FLASH_FWD=twopass and
  PADDLE_FLASH_BWD=onepass.
- Each forward emitter runs once per step (no replay), a grad op whose
  forward was not recorded in the same run raises, and the fit_a_line
  drive converges.
- FLAGS_amp_bf16_param_grads, and the regularizer and clip ops through
  two SGD steps, against the JAX package.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.pallas import flash_attention as jax_fa
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import registry as tregistry
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import transformer as ttransformer

GRAD_ATOL = 1e-5
LM_CFG = dict(vocab=256, dim=256, heads=2, layers=2, ffn=512, max_len=128,
              use_tp=False, use_sp=False, flash_attention=True)
LM_BATCH, LM_STEPS, LM_CHUNK = 2, 3, 128
LM_TOL = {False: 1e-4, True: 2e-2}     # keyed by AMP
# bench.py's bench_long_context at a CPU size: two layers, T=256, the
# fused head in two chunks (bench.py's 8192 over 2 x 8192 tokens)
LC_CFG = dict(vocab=256, dim=256, heads=2, layers=2, ffn=512, max_len=256,
              use_tp=False, use_sp=False, flash_attention=True)
LC_CHUNK = 256


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The JAX package's fixture (conftest.py) resets only its own
    default programs; reset the port's too."""
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _f(rng, *shape):
    return rng.randn(*shape).astype('float32')


def _grad_cases():
    r = np.random.RandomState(0)
    labels = r.randint(0, 16, (2, 5, 1)).astype('int64')
    labels[0, 1, 0] = labels[1, 3, 0] = 3            # the ignored class
    return [
        ('mul', {'X': _f(r, 2, 3, 4), 'Y': _f(r, 4, 5)},
         {'x_num_col_dims': 2, 'y_num_col_dims': 1}, 'Out'),
        ('elementwise_add', {'X': _f(r, 2, 3, 4), 'Y': _f(r, 3)},
         {'axis': 1}, 'Out'),
        ('layer_norm', {'X': _f(r, 2, 3, 8), 'Scale': _f(r, 8),
                        'Bias': _f(r, 8)},
         {'epsilon': 1e-5, 'begin_norm_axis': 2}, 'Y'),
        ('gelu', {'X': _f(r, 4, 16) * 3}, {}, 'Out'),
        ('lookup_table', {'Ids': r.randint(0, 10, (2, 5, 1)).astype('int64'),
                          'W': _f(r, 10, 4)},
         {'is_sparse': False, 'is_distributed': False, 'padding_idx': 3},
         'Out'),
        ('position_embedding', {'X': _f(r, 2, 5, 4), 'Pos': _f(r, 8, 4)},
         {}, 'Out'),
        ('slice', {'Input': _f(r, 3, 8, 5)},
         {'axes': [1], 'starts': [2], 'ends': [-1]}, 'Out'),
        ('reshape2', {'X': _f(r, 2, 3, 4)}, {'shape': [0, -1]}, 'Out'),
        ('transpose2', {'X': _f(r, 2, 3, 4)}, {'axis': [0, 2, 1]}, 'Out'),
        ('mean', {'X': _f(r, 3, 4)}, {}, 'Out'),
        ('sum', {'X': [_f(r, 3, 4), _f(r, 3, 4)]}, {}, 'Out'),
        ('fused_softmax_cross_entropy',
         {'X': _f(r, 2, 5, 8), 'W': _f(r, 8, 16), 'Bias': _f(r, 16),
          'Label': labels},
         {'chunk': 4, 'ignore_index': 3}, 'Loss'),
        ('flash_attention', {'Q': _f(r, 1, 2, 8, 16), 'K': _f(r, 1, 2, 8, 16),
                             'V': _f(r, 1, 2, 8, 16)},
         {'causal': True, 'sm_scale': None}, 'Out'),
    ]


GRAD_CASES = _grad_cases()
_EXTRA_OUTS = {'layer_norm': ('Mean', 'Variance'), 'reshape2': ('XShape',),
               'transpose2': ('XShape',)}


def _op_grads(fluid, case, cot_seed=1):
    """Build one op, then calc_gradient of its output against a fixed
    cotangent; returns {input name: grad} and the output."""
    op_type, inputs, attrs, out_slot = case
    prog = fluid.Program()
    block = prog.global_block()
    feed, ins, diff = {}, {}, []
    for slot, arrs in inputs.items():
        arrs = arrs if isinstance(arrs, list) else [arrs]
        ins[slot] = []
        for i, arr in enumerate(arrs):
            name = 'in_%s_%d' % (slot.lower(), i)
            float_in = arr.dtype == np.float32 and not (
                op_type == 'position_embedding' and slot == 'X')
            v = block.create_var(name=name, shape=arr.shape,
                                 dtype=arr.dtype.name, is_data=True,
                                 stop_gradient=not float_in)
            ins[slot].append(v)
            feed[name] = arr.copy()
            if float_in:
                diff.append(v)
    outs = {out_slot: [block.create_var(name='out')]}
    for slot in _EXTRA_OUTS.get(op_type, ()):
        outs[slot] = [block.create_var(name='out_' + slot.lower(),
                                       stop_gradient=True)]
    with fluid.program_guard(prog, fluid.Program()):
        block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
        out = outs[out_slot][0]
        cot = block.create_var(name='cot', shape=out.shape, dtype=out.dtype,
                               is_data=True, stop_gradient=True)
        feed['cot'] = np.asarray(np.random.RandomState(cot_seed).randn(
            *out.shape), dtype='float32')
        grads = fluid.backward.calc_gradient([out], diff,
                                             target_gradients=[cot])
    names = [v.name for v in diff]
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=[g.name for g in grads] + ['out'],
        scope=fluid.Scope())
    return dict(zip(names, got[:-1])), got[-1]


@pytest.mark.parametrize('case', GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_op_grad_matches_jax(case):
    want, want_out = _op_grads(jfluid, case)
    got, got_out = _op_grads(tfluid, case)
    np.testing.assert_allclose(got_out, want_out, atol=GRAD_ATOL, rtol=0)
    assert sorted(got) == sorted(want) and got
    for name in want:
        w = np.asarray(want[name], dtype='float32')
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


def _run_update(fluid, op_type, inputs, attrs, outs):
    prog = fluid.Program()
    block = prog.global_block()
    ins = {s: [block.create_var(name='in_' + s.lower(), shape=a.shape,
                                dtype='float32', is_data=True)]
           for s, a in inputs.items()}
    out_vars = {s: [block.create_var(name='out_' + s.lower())] for s in outs}
    block.append_op(type=op_type, inputs=ins, outputs=out_vars, attrs=attrs)
    return fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={v[0].name: inputs[s].copy() for s, v in ins.items()},
        fetch_list=['out_' + s.lower() for s in outs], scope=fluid.Scope())


@pytest.mark.parametrize('op_type,attrs', [
    ('sgd', {}),
    ('momentum', {'mu': 0.9, 'use_nesterov': False}),
    ('momentum', {'mu': 0.9, 'use_nesterov': True}),
])
def test_optimizer_update_matches_jax(op_type, attrs):
    r = np.random.RandomState(7)
    inputs = {'Param': _f(r, 4, 5), 'Grad': _f(r, 4, 5),
              'LearningRate': np.array([0.05], 'float32')}
    outs = ['ParamOut']
    if op_type == 'momentum':
        inputs['Velocity'] = _f(r, 4, 5)
        outs.append('VelocityOut')
    want = _run_update(jfluid, op_type, inputs, attrs, outs)
    got = _run_update(tfluid, op_type, inputs, attrs, outs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)


# -- the flash LM through py_reader, three Momentum steps ----------------------

def _build_train(fluid, unique_name, transformer, amp, cfg=LM_CFG,
                 chunk=LM_CHUNK, reader='lm_reader'):
    """bench.py's _bench_lm program at `cfg`: py_reader, trunk, fused
    head, mean, Momentum (under decorate when amp)."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 5
    cfg = transformer.TransformerConfig(**cfg)
    with unique_name.guard(), fluid.program_guard(prog, startup):
        rdr = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, cfg.max_len, 1), (-1, cfg.max_len, 1)],
            dtypes=['int64', 'int64'], name=reader,
            use_double_buffer=True)
        tokens, labels = fluid.layers.read_file(rdr)
        trunk = transformer.language_model_trunk(tokens, cfg)
        cost = fluid.layers.fused_softmax_cross_entropy(
            trunk, labels, cfg.vocab, chunk=chunk, name='lm_head')
        avg = fluid.layers.mean(cost)
        opt = fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg)
    return prog, startup, rdr, avg


def _batches(cfg=LM_CFG):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(LM_STEPS):
        toks = rng.randint(0, cfg['vocab'],
                           size=(LM_BATCH, cfg['max_len'], 1))
        out.append([toks.astype('int64'),
                    np.roll(toks, -1, axis=1).astype('int64')])
    return out


def _train(run, rdr, avg, fluid, cfg=LM_CFG):
    """Run the reader's pass to its end with run(fetch_list=...); returns
    the per-step losses."""
    batches = _batches(cfg)
    rdr.decorate_tensor_provider(lambda: iter(batches))
    rdr.start()
    losses = []
    try:
        while True:
            losses.append(float(np.asarray(run(fetch_list=[avg.name])[0])))
    except fluid.core.EOFException:
        rdr.reset()
    return losses


def _jax_run(amp, cfg=LM_CFG, chunk=LM_CHUNK, reader='lm_reader'):
    """The JAX package's steps on the CPU: initial params, losses, final
    params and the program text."""
    with jfluid.program_guard(jfluid.Program(), jfluid.Program()):
        prog, startup, rdr, avg = _build_train(
            jfluid, junique_name, jtransformer, amp, cfg, chunk, reader)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        names = [v.name for v in prog.list_vars() if v.persistable
                 and scope.find_var(v.name) is not None]
        init = {n: np.array(scope.find_var(n)) for n in names}
        exe = jfluid.Executor(jfluid.CPUPlace())
        losses = _train(lambda **kw: exe.run(prog, **kw), rdr, avg, jfluid,
                        cfg)
        final = {n: np.array(scope.find_var(n)) for n in names}
    return dict(init=init, losses=losses, final=final,
                text=prog.to_string())


def _port_run_matches(ref, amp, cfg=LM_CFG, chunk=LM_CHUNK,
                      reader='lm_reader'):
    """The port's steps from the JAX package's initial params, through
    ParallelExecutor on the CPU, held to `ref` within LM_TOL[amp]."""
    prog, startup, rdr, avg = _build_train(tfluid, tunique_name,
                                           ttransformer, amp, cfg, chunk,
                                           reader)
    assert prog.to_string() == ref['text']
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, ref['init'], tfluid.CPUPlace(),
                                program=prog)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=avg.name,
                                 main_program=prog, scope=scope)
    losses = _train(pe.run, rdr, avg, tfluid, cfg)
    tol = LM_TOL[amp]
    assert len(losses) == LM_STEPS and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref['losses'], atol=tol, rtol=0)
    params = [v.name for v in prog.global_block().all_parameters()]
    assert len(params) == 6 + 12 * cfg['layers']
    for name in params:
        want = ref['final'][name] - ref['init'][name]
        got = scope.find_var(name).numpy() - ref['init'][name]
        assert np.abs(want).max() > 0, name
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= tol, (name, rel)


@pytest.fixture(scope='module')
def jax_lm_runs():
    """The JAX package's three steps, fp32 and AMP, with its flash
    kernels in Pallas interpret mode."""
    jfluid.set_flags({'pallas_interpret': True})
    try:
        return {amp: _jax_run(amp) for amp in (False, True)}
    finally:
        jfluid.set_flags({'pallas_interpret': False})


@pytest.mark.parametrize('amp', [False, True], ids=['fp32', 'amp_bf16'])
def test_lm_momentum_steps_match_jax(jax_lm_runs, amp):
    _port_run_matches(jax_lm_runs[amp], amp)


def test_long_context_lm_steps_match_jax_under_alternative_arms(
        monkeypatch):
    """Three AMP Momentum steps of a long-context-shaped LM with the
    JAX package's two-pass forward (K4) and onepass backward (K5), in
    interpret mode at 128 x 128 blocks, against the port under
    PADDLE_FLASH_FWD=twopass and PADDLE_FLASH_BWD=onepass."""
    prev = jax_fa._FORCE_FWD_ARM, jax_fa._FORCE_ARM
    jfluid.set_flags({'pallas_interpret': True, 'flash_block_q': 128,
                      'flash_block_k': 128})
    jax_fa._FORCE_FWD_ARM, jax_fa._FORCE_ARM = 'twopass', 'onepass'
    jax_fa._fwd.clear_cache()
    jax_fa._bwd.clear_cache()
    try:
        ref = _jax_run(True, LC_CFG, LC_CHUNK, 'lc_reader')
        assert jax_fa._RESOLVED_FWD_ARM == 'twopass'
        assert jax_fa._RESOLVED_ARM == 'onepass'
    finally:
        jax_fa._FORCE_FWD_ARM, jax_fa._FORCE_ARM = prev
        jax_fa._fwd.clear_cache()
        jax_fa._bwd.clear_cache()
        jfluid.set_flags({'pallas_interpret': False, 'flash_block_q': 0,
                          'flash_block_k': 0})
    monkeypatch.setenv('PADDLE_FLASH_FWD', 'twopass')
    monkeypatch.setenv('PADDLE_FLASH_BWD', 'onepass')
    _port_run_matches(ref, True, LC_CFG, LC_CHUNK, 'lc_reader')


def test_each_forward_emitter_runs_once_per_step(monkeypatch):
    prog, startup, rdr, avg = _build_train(tfluid, tunique_name,
                                           ttransformer, True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    calls = {}
    for op_type in {op.type for op in prog.global_block().ops}:
        opdef = tregistry.get_op(op_type)

        def counted(ctx, op, _emit=opdef.emit, _type=op_type):
            calls[_type] = calls.get(_type, 0) + 1
            return _emit(ctx, op)
        monkeypatch.setattr(opdef, 'emit', counted)
    batches = _batches()[:1]
    rdr.decorate_tensor_provider(lambda: iter(batches))
    rdr.start()
    exe.run(prog, fetch_list=[avg.name])
    rdr.reset()
    want = {}
    for op in prog.global_block().ops:
        want[op.type] = want.get(op.type, 0) + 1
    assert calls == want
    assert calls['flash_attention'] == LM_CFG['layers']
    assert calls['mul'] == 4 * LM_CFG['layers']


def test_grad_op_without_recorded_forward_raises():
    prog = tfluid.Program()
    with tfluid.program_guard(prog, tfluid.Program()):
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32',
                               stop_gradient=False)
        loss = tfluid.layers.mean(x)
        tfluid.backward.calc_gradient([loss], [x])
    block = prog.global_block()
    # drop the forward mean op: its grad op must refuse to replay it
    block.ops[:] = [op for op in block.ops if op.type != 'mean']
    with pytest.raises(tfluid.OpExecutionError, match='not recorded'):
        tfluid.Executor(tfluid.CPUPlace()).run(
            prog, feed={'x': np.ones((2, 4), 'float32')},
            fetch_list=['x@GRAD'])


def test_fit_a_line_converges():
    """The SKILL.md drive, in the port: final loss < 5% of the first."""
    x = tfluid.layers.data(name='x', shape=[13], dtype='float32')
    y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
    pred = tfluid.layers.fc(input=x, size=1)
    loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
    tfluid.optimizer.SGD(0.01).minimize(loss)
    tfluid.default_startup_program().random_seed = 3
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype('f4')
    losses = []
    for _ in range(200):
        xb = rng.randn(32, 13).astype('f4')
        losses.append(float(exe.run(feed={'x': xb, 'y': xb @ w},
                                    fetch_list=[loss])[0]))
    assert losses[-1] < 0.05 * losses[0]


def _arm_q():
    """The arm tests' q, [1, 2, 8, 16] float32 from a seeded stream: an
    unseeded draw depended on which tests ran before in the process."""
    return torch.from_numpy(
        np.random.RandomState(31).randn(1, 2, 8, 16).astype('float32'))


def test_onepass_arm_raises(monkeypatch):
    """PADDLE_FLASH_BWD=onepass (K5) runs: on CPU tensors it takes the
    plain backward and gives the default arm's grads. The raise this
    test checks is an unknown value's; the name is kept from before K5
    was ported, when onepass itself raised NotImplementedError."""
    q = _arm_q().requires_grad_()
    want, = torch.autograd.grad(
        tfluid.kernels.flash_attention.flash_attention(q, q, q).sum(), [q])
    monkeypatch.setenv('PADDLE_FLASH_BWD', 'onepass')
    got, = torch.autograd.grad(
        tfluid.kernels.flash_attention.flash_attention(q, q, q).sum(), [q])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    monkeypatch.setenv('PADDLE_FLASH_BWD', 'bogus')
    with pytest.raises(ValueError, match='PADDLE_FLASH_BWD'):
        tfluid.kernels.flash_attention.flash_attention(q, q, q).sum() \
            .backward()


@pytest.mark.parametrize('value,error', [
    ('', None), ('online', None), ('twopass', None), ('bogus', ValueError)])
def test_flash_fwd_arm_is_read_on_every_call(monkeypatch, value, error):
    """PADDLE_FLASH_FWD, as in the JAX package: online (or unset) runs
    K1, twopass runs K4a then K4b (their plain versions on the CPU, with
    the same result), and a typo raises ValueError with the JAX
    package's message. The twopass plain path (stats, then acc) and the
    one-pass plain version are the same function with the sums taken in
    another order, so they agree to the port's fp32 parity tolerance,
    atol = rtol = 2e-5 (tests/test_torch_flash_attention.py TOL), not to
    the last bits: over 300 seeds they differ by up to 1.4e-6."""
    fa = tfluid.kernels.flash_attention
    q = _arm_q()
    monkeypatch.setenv('PADDLE_FLASH_FWD', value)
    if error is None:
        out = fa.flash_attention(q, q, q)
        assert out.shape == q.shape and torch.isfinite(out).all()
        want, _ = fa.flash_attention_reference(q[0], q[0], q[0], True,
                                               16 ** -0.5)
        np.testing.assert_allclose(out[0].numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-5)
        return
    with pytest.raises(error, match="PADDLE_FLASH_FWD='bogus': expected "
                                    "one of"):
        fa.flash_attention(q, q, q)


def _amp_fc_param_grads(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        y = fluid.layers.data(name='y', shape=[3], dtype='float32')
        # the bf16 fc output meets an fp32 non-parameter: the loss is fp32
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(input=x, size=3), y))
        params_grads = fluid.append_backward(loss)
    prog._use_bf16 = True
    r = np.random.RandomState(9)
    scope = fluid.Scope()
    scope.set_var('fc_0.w_0', r.randn(8, 3).astype('float32'))
    scope.set_var('fc_0.w_1', r.randn(3).astype('float32'))
    grads = [g.name for _, g in params_grads]
    fluid.set_flags({'FLAGS_amp_bf16_param_grads': True})
    try:
        got = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={'x': r.randn(4, 8).astype('float32'),
                        'y': r.randn(4, 3).astype('float32')},
            fetch_list=grads, scope=scope, return_numpy=False)
    finally:
        fluid.set_flags({'FLAGS_amp_bf16_param_grads': False})
    return dict(zip(grads, got))


def test_amp_bf16_param_grads_flag_matches_jax():
    """FLAGS_amp_bf16_param_grads (off by default): under AMP a parameter
    grad with one producer is rounded to bf16, as in the JAX package."""
    want = _amp_fc_param_grads(jfluid)
    got = _amp_fc_param_grads(tfluid)
    assert sorted(got) == sorted(want) == ['fc_0.w_0@GRAD', 'fc_0.w_1@GRAD']
    for name, g in got.items():
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(want[name], dtype='float32'),
                                   atol=2e-2, rtol=2e-2, err_msg=name)


def _fc_two_inputs(fluid, unique_name):
    """fc over two inputs (a mul per input, a sum op, then the bias),
    with seeded numpy parameters: the forward and the grads of both
    weights and the bias of mean((fc - y)^2)."""
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x1 = fluid.layers.data(name='x1', shape=[8], dtype='float32')
        x2 = fluid.layers.data(name='x2', shape=[2, 3], dtype='float32')
        y = fluid.layers.data(name='y', shape=[5], dtype='float32')
        pred = fluid.layers.fc(input=[x1, x2], size=5)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        params_grads = fluid.append_backward(loss)
    assert [op.type for op in prog.global_block().ops][:4] == \
        ['mul', 'mul', 'sum', 'elementwise_add']
    r = np.random.RandomState(21)
    scope = fluid.Scope()
    params = prog.global_block().all_parameters()
    for p in params:
        scope.set_var(p.name, r.randn(*p.shape).astype('float32'))
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'x1': r.randn(4, 8).astype('float32'),
                    'x2': r.randn(4, 2, 3).astype('float32'),
                    'y': r.randn(4, 5).astype('float32')},
        fetch_list=[pred.name] + [g.name for _, g in params_grads],
        scope=scope)
    names = ['pred'] + [g.name for _, g in params_grads]
    return [p.name for p in params], dict(zip(names, got))


def test_fc_over_two_inputs_matches_jax():
    """fc(input=[x1, x2]) sums the two mul results with a sum op before
    the bias, as the JAX package does (the port raised here before)."""
    want_params, want = _fc_two_inputs(jfluid, junique_name)
    got_params, got = _fc_two_inputs(tfluid, tunique_name)
    assert got_params == want_params and len(got_params) == 3
    assert sorted(got) == sorted(want) and len(got) == 4
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def _sgd_regularized_steps(fluid, unique_name, decay, clip, init=None):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        y = fluid.layers.data(name='y', shape=[3], dtype='float32')
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(input=x, size=3), y))
        fluid.clip.set_gradient_clip(
            {'value': fluid.clip.GradientClipByValue(0.05),
             'norm': fluid.clip.GradientClipByNorm(0.1),
             'global_norm': fluid.clip.GradientClipByGlobalNorm(0.1)}[clip],
            program=prog)
        reg = {None: None, 'l1': fluid.regularizer.L1Decay(0.01),
               'l2': fluid.regularizer.L2Decay(0.01)}[decay]
        fluid.optimizer.SGD(0.5, regularization=reg).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if init is None:
        with fluid.scope_guard(scope):
            exe.run(startup)
        init = {n: np.array(scope.find_var(n))
                for n in ('fc_0.w_0', 'fc_0.w_1', 'learning_rate_0')}
    else:
        fluid.io.load_numpy_params(scope, init, fluid.CPUPlace(),
                                   program=prog)
    r = np.random.RandomState(12)
    for _ in range(2):
        exe.run(prog, feed={'x': r.randn(4, 8).astype('float32'),
                            'y': r.randn(4, 3).astype('float32')},
                fetch_list=[loss], scope=scope)
    return init, {n: np.asarray(scope.find_var(n)) for n in init}


@pytest.mark.parametrize('decay,clip', [('l2', 'global_norm'),
                                        ('l1', 'value'), (None, 'norm')])
def test_regularizer_and_clip_match_jax(decay, clip):
    """The ops regularizer.py and clip.py append, through two SGD steps."""
    init, want = _sgd_regularized_steps(jfluid, junique_name, decay, clip)
    _, got = _sgd_regularized_steps(tfluid, tunique_name, decay, clip, init)
    for name in want:
        assert not np.array_equal(want[name], init[name]) or \
            name == 'learning_rate_0'
        np.testing.assert_allclose(np.asarray(got[name]), want[name],
                                   atol=1e-6, rtol=0, err_msg=name)
