"""paddle_tpu_torch's ResNet slice against the JAX package, on the CPU.

- K6's plain version (`matmul_bn_stats_reference`) against the JAX
  package's Pallas kernel in interpret mode and its XLA version, fp32 and
  bf16; the autograd Function's hand-written backward against jax.grad
  through `matmul_bn_stats`.
- Every op the slice adds (conv2d, depthwise_conv2d, pool2d, batch_norm,
  conv2d_bn, relu, top_k, accuracy), forward and grad, as one-op
  programs in both packages' executors: fp32 to atol 1e-5 plus rtol
  1e-6 (a few ulps of the large batch variances).
- The fused conv_bn against the conv2d + batch_norm pair in the port.
- resnet_cifar10(depth=8) with the fused op: three Momentum steps in fp32
  and under bf16 AMP against the JAX package, and one ResNet-50 step at
  32 px.

The JAX side runs with FLAGS_use_pallas_fused_ops and
FLAGS_pallas_interpret set, as its own tests run it (restored in
`finally`). Weights carry across by name with io.load_numpy_params, BN
running statistics included.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.pallas import conv_bn as jconv_bn
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.kernels import conv_bn as tconv_bn
from paddle_tpu_torch.models import resnet as tresnet

OP_ATOL, OP_RTOL = 1e-5, 1e-6


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


@contextlib.contextmanager
def fused_flags(fluid):
    """FLAGS_use_pallas_fused_ops (and, in the JAX package,
    FLAGS_pallas_interpret) set for the block, restored after it."""
    names = ['use_pallas_fused_ops']
    if fluid is jfluid:
        names.append('pallas_interpret')
    prev = fluid.get_flags(names)
    fluid.set_flags({n: True for n in names})
    try:
        yield
    finally:
        fluid.set_flags(prev)


def _f(rng, *shape):
    return rng.randn(*shape).astype('float32')


# -- K6: plain version and backward -------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_plain_matmul_bn_stats_matches_pallas_and_xla(dtype):
    """At a ragged 300 x 70 x 130 (no tile multiple), the tolerances of
    tests/test_pallas_fused.py: y rtol 1e-5 / atol 1e-4 and the sums rtol
    1e-4 / atol 1e-3 (fp32 sums taken in another order). In bf16, y is
    the same fp32 value rounded once, so it may differ by one bf16 step
    (2^-8 relative) where the fp32 sums straddle a rounding boundary."""
    rng = np.random.RandomState(0)
    x, w = _f(rng, 300, 70), _f(rng, 70, 130)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tdt = getattr(torch, dtype)
    y, s, q = tconv_bn.matmul_bn_stats_reference(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert y.dtype == tdt and s.dtype == q.dtype == torch.float32
    y_rtol = 2.0 ** -8 if dtype == 'bfloat16' else 1e-5
    for want in (jconv_bn._pallas_impl(jx, jw, tile_m=128, tile_n=128,
                                       interpret=True),
                 jconv_bn._xla_impl(jx, jw)):
        wy, ws, wq = (np.asarray(a.astype(jnp.float32)) for a in want)
        np.testing.assert_allclose(y.float().numpy(), wy, rtol=y_rtol,
                                   atol=1e-4)
        np.testing.assert_allclose(s.numpy(), ws, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(q.numpy(), wq, rtol=1e-4, atol=1e-3)


def test_matmul_bn_stats_backward_matches_jax_grad():
    """The autograd Function's backward (dy = gy + gs + 2·y·gq, then two
    fp32 products) against jax.grad through the JAX package's custom_vjp,
    at test_pallas_fused.py's loss (relu of the normalised y, squared)."""
    rng = np.random.RandomState(1)
    x, w = _f(rng, 40, 16), _f(rng, 16, 24)

    def jax_loss(x, w):
        y, s, q = jconv_bn.matmul_bn_stats(x, w)
        m = s / x.shape[0]
        v = q / x.shape[0] - m * m
        yh = (y.astype(jnp.float32) - m) * jax.lax.rsqrt(v + 1e-5)
        return jnp.sum(jax.nn.relu(yh + 0.3) ** 2)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y, s, q = tconv_bn.matmul_bn_stats(tx, tw)
    m = s / x.shape[0]
    v = q / x.shape[0] - m * m
    yh = (y.float() - m) * torch.rsqrt(v + 1e-5)
    torch.sum(torch.relu(yh + 0.3) ** 2).backward()
    for got, w_ in zip((tx.grad, tw.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)


def test_cpu_tensors_take_plain_version_and_launch_nothing():
    before = tconv_bn.matmul_bn_stats_kernel.launches
    x, w = torch.randn(9, 5), torch.randn(5, 7)
    y, s, q = tconv_bn.matmul_bn_stats(x, w)
    torch.testing.assert_close(y, x @ w)
    torch.testing.assert_close(s, (x @ w).sum(0))
    assert tconv_bn.matmul_bn_stats_kernel.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA tensor'):
        tconv_bn.matmul_bn_stats_kernel(torch.randn(4, 3), torch.randn(3, 2))


# -- one-op programs: forward and grads ---------------------------------------

def _op_cases():
    r = np.random.RandomState(0)
    pos = lambda *s: np.abs(_f(r, *s)) + 0.5     # noqa: E731
    bn = lambda c: {'Scale': _f(r, c), 'Bias': _f(r, c),   # noqa: E731
                    'Mean': _f(r, c), 'Variance': pos(c)}
    bn_outs = ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance')
    conv = {'strides': [1, 1], 'paddings': [0, 0], 'dilations': [1, 1],
            'groups': 1, 'data_format': 'NCHW'}
    pool = {'pooling_type': 'max', 'ksize': [3, 3], 'strides': [2, 2],
            'paddings': [1, 1], 'global_pooling': False,
            'ceil_mode': False, 'exclusive': True, 'data_format': 'NCHW'}
    cbn = {'strides': [1, 1], 'paddings': [0, 0], 'momentum': 0.9,
           'epsilon': 1e-5, 'act': 'relu', 'is_test': False}
    labels = r.randint(0, 6, (5, 1)).astype('int64')
    return [
        ('conv2d-stride2-pad1', 'conv2d',
         {'Input': _f(r, 2, 4, 9, 9), 'Filter': _f(r, 6, 4, 3, 3)},
         dict(conv, strides=[2, 2], paddings=[1, 1]), 'Output', ()),
        ('conv2d-dilation2', 'conv2d',
         {'Input': _f(r, 2, 4, 9, 9), 'Filter': _f(r, 6, 4, 3, 3)},
         dict(conv, paddings=[2, 1], dilations=[2, 2]), 'Output', ()),
        ('conv2d-groups2', 'conv2d',
         {'Input': _f(r, 2, 4, 8, 8), 'Filter': _f(r, 6, 2, 3, 3)},
         dict(conv, paddings=[1, 1], groups=2), 'Output', ()),
        ('depthwise_conv2d', 'depthwise_conv2d',
         {'Input': _f(r, 2, 4, 7, 7), 'Filter': _f(r, 4, 1, 3, 3)},
         dict(conv, strides=[2, 2], paddings=[1, 1], groups=4), 'Output',
         ()),
        ('pool2d-max', 'pool2d', {'X': _f(r, 2, 3, 9, 9)}, pool, 'Out', ()),
        ('pool2d-avg-exclusive', 'pool2d', {'X': _f(r, 2, 3, 9, 9)},
         dict(pool, pooling_type='avg'), 'Out', ()),
        ('pool2d-avg-inclusive', 'pool2d', {'X': _f(r, 2, 3, 9, 9)},
         dict(pool, pooling_type='avg', exclusive=False), 'Out', ()),
        ('pool2d-max-ceil', 'pool2d', {'X': _f(r, 2, 3, 8, 8)},
         dict(pool, paddings=[0, 0], ceil_mode=True), 'Out', ()),
        ('pool2d-avg-ceil', 'pool2d', {'X': _f(r, 2, 3, 8, 8)},
         dict(pool, pooling_type='avg', paddings=[0, 0], ceil_mode=True),
         'Out', ()),
        ('pool2d-avg-global', 'pool2d', {'X': _f(r, 2, 3, 5, 5)},
         dict(pool, pooling_type='avg', global_pooling=True), 'Out', ()),
        ('batch_norm-train', 'batch_norm', dict({'X': _f(r, 4, 3, 5, 5)},
                                                **bn(3)),
         {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
          'data_layout': 'NCHW'}, 'Y', bn_outs),
        ('batch_norm-test', 'batch_norm', dict({'X': _f(r, 4, 3, 5, 5)},
                                               **bn(3)),
         {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': True,
          'data_layout': 'NCHW'}, 'Y', bn_outs),
        ('conv2d_bn-1x1-s1-relu', 'conv2d_bn',
         dict({'Input': _f(r, 2, 8, 6, 6), 'Filter': _f(r, 12, 8, 1, 1)},
              **bn(12)), cbn, 'Y', bn_outs),
        ('conv2d_bn-1x1-s2-none', 'conv2d_bn',
         dict({'Input': _f(r, 2, 8, 7, 7), 'Filter': _f(r, 12, 8, 1, 1)},
              **bn(12)), dict(cbn, strides=[2, 2], act=None), 'Y', bn_outs),
        ('conv2d_bn-3x3-p1-relu', 'conv2d_bn',
         dict({'Input': _f(r, 2, 8, 6, 6), 'Filter': _f(r, 12, 8, 3, 3)},
              **bn(12)), dict(cbn, paddings=[1, 1]), 'Y', bn_outs),
        ('conv2d_bn-1x1-is_test', 'conv2d_bn',
         dict({'Input': _f(r, 2, 8, 6, 6), 'Filter': _f(r, 12, 8, 1, 1)},
              **bn(12)), dict(cbn, is_test=True), 'Y', bn_outs),
        ('conv2d_bn-3x3-is_test', 'conv2d_bn',
         dict({'Input': _f(r, 2, 8, 6, 6), 'Filter': _f(r, 12, 8, 3, 3)},
              **bn(12)), dict(cbn, paddings=[1, 1], is_test=True), 'Y',
         bn_outs),
        ('relu', 'relu', {'X': _f(r, 4, 6)}, {}, 'Out', ()),
        ('top_k', 'top_k', {'X': _f(r, 5, 6)}, {'k': 2}, 'Out',
         ('Indices',)),
        ('accuracy', 'accuracy',
         {'Indices': np.argsort(-_f(r, 5, 6), axis=1)[:, :2].astype('int64'),
          'Label': labels, 'Out': _f(r, 5, 2)}, {}, 'Accuracy',
         ('Correct', 'Total')),
    ]


OP_CASES = _op_cases()
_NO_GRAD_SLOTS = ('Mean', 'Variance')
_NO_GRAD_OPS = ('top_k', 'accuracy')


def _run_op(fluid, case):
    """Build one op (and, unless it has no grad, calc_gradient of its
    main output against a fixed cotangent); returns {name: value} of the
    outputs and of the grads of every float input."""
    _, op_type, inputs, attrs, out_slot, extra = case
    prog = fluid.Program()
    block = prog.global_block()
    feed, ins, diff = {}, {}, []
    for slot, arr in inputs.items():
        name = 'in_' + slot.lower()
        float_in = arr.dtype == np.float32 and slot not in _NO_GRAD_SLOTS \
            and op_type not in _NO_GRAD_OPS
        v = block.create_var(name=name, shape=arr.shape, dtype=arr.dtype.name,
                             is_data=True, stop_gradient=not float_in)
        ins[slot] = [v]
        feed[name] = arr.copy()
        if float_in:
            diff.append(v)
    outs = {out_slot: [block.create_var(name='out')]}
    for slot in extra:
        outs[slot] = [block.create_var(name='out_' + slot.lower(),
                                       stop_gradient=True)]
    fetch = ['out'] + ['out_' + s.lower() for s in extra]
    with fluid.program_guard(prog, fluid.Program()):
        block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
        if diff:
            out = outs[out_slot][0]
            cot = block.create_var(name='cot', shape=out.shape,
                                   dtype=out.dtype, is_data=True,
                                   stop_gradient=True)
            feed['cot'] = np.asarray(np.random.RandomState(1).randn(
                *out.shape), dtype='float32')
            grads = fluid.backward.calc_gradient([out], diff,
                                                 target_gradients=[cot])
            fetch += [g.name for g in grads]
    with fused_flags(fluid):
        got = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
    return {n: np.asarray(g) for n, g in zip(fetch, got)}


@pytest.mark.parametrize('case', OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_forward_and_grad_match_jax(case):
    want = _run_op(jfluid, case)
    got = _run_op(tfluid, case)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w.astype('float32'),
                                       atol=OP_ATOL, rtol=OP_RTOL,
                                       err_msg=name)


# -- the port's fused op against its own unfused pair -------------------------

def _build_pair(fused, filter_size, stride, padding):
    """test_pallas_fused.py's pair: conv_bn, or conv2d + batch_norm, with
    shared parameter names so both start from the same weights."""
    fluid = tfluid
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 3
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[8, 10, 10], dtype='float32')
        if fused:
            y = fluid.layers.conv_bn(
                x, num_filters=12, filter_size=filter_size, stride=stride,
                padding=padding, act='relu',
                param_attr=fluid.ParamAttr(name='cw'),
                bn_param_attr=fluid.ParamAttr(name='bs'),
                bn_bias_attr=fluid.ParamAttr(name='bb'))
        else:
            c = fluid.layers.conv2d(
                x, num_filters=12, filter_size=filter_size, stride=stride,
                padding=padding, bias_attr=False,
                param_attr=fluid.ParamAttr(name='cw'))
            y = fluid.layers.batch_norm(
                c, act='relu', param_attr=fluid.ParamAttr(name='bs'),
                bias_attr=fluid.ParamAttr(name='bb'))
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, y, loss


@pytest.mark.parametrize('fs,stride,pad', [(1, 1, 0), (1, 2, 0), (3, 1, 1)])
def test_fused_conv_bn_matches_unfused_pair(fs, stride, pad):
    """Y and the loss of three SGD steps agree at the JAX package's bar
    (rtol 1e-4, atol 1e-5); the fused program's conv weights start as the
    unfused program's."""
    xv = np.random.RandomState(0).rand(4, 8, 10, 10).astype('float32')
    results, init = {}, None
    for fused in (False, True):
        prog, startup, y, loss = _build_pair(fused, fs, stride, pad)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        if init is None:
            init = scope.find_var('cw').clone()
        else:
            scope.set_var('cw', init.clone())
        vals = []
        with fused_flags(tfluid):
            for _ in range(3):
                yv, lv = exe.run(prog, feed={'x': xv}, fetch_list=[y, loss],
                                 scope=scope)
                vals.append((yv, float(lv)))
        results[fused] = vals
    for (y0, l0), (y1, l1) in zip(results[False], results[True]):
        np.testing.assert_allclose(y1, y0, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(l1, l0, rtol=1e-5)


def test_running_statistics_are_rebound_not_updated_in_place():
    """batch_norm and conv2d_bn write MeanOut/VarianceOut under the names
    they read as Mean/Variance: each step binds new tensors (no autograd
    graph attached) and leaves the previous ones untouched, so a recorded
    forward that saved them never sees them change."""
    prog, startup, y, loss = _build_pair(True, 1, 1, 0)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    stats = [v.name for v in prog.list_vars()
             if v.name.endswith(('.mean', '.variance'))]
    assert len(stats) == 2
    before = {n: scope.find_var(n) for n in stats}
    kept = {n: t.clone() for n, t in before.items()}
    xv = np.random.RandomState(0).rand(4, 8, 10, 10).astype('float32')
    exe.run(prog, feed={'x': xv}, fetch_list=[loss], scope=scope)
    for n in stats:
        after = scope.find_var(n)
        assert after is not before[n], n
        assert not after.requires_grad and after.grad_fn is None, n
        torch.testing.assert_close(before[n], kept[n], rtol=0, atol=0)
        assert not torch.equal(after, kept[n]), n


# -- ResNet training against the JAX package ----------------------------------

def _build_resnet(fluid, unique_name, resnet, amp, depth, variant, hw,
                  classes, batch):
    """bench.py's bench_resnet program (py_reader, train_network,
    Momentum(0.01, 0.9), optionally under decorate), built with the fused
    conv + BN op."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 3
    with fused_flags(fluid), unique_name.guard(), \
            fluid.program_guard(prog, startup):
        rdr = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, 3, hw, hw), (-1, 1)],
            dtypes=['float32', 'int64'], name='resnet_reader',
            use_double_buffer=True)
        image, label = fluid.layers.read_file(rdr)
        _, avg, acc = resnet.train_network(image, label, class_dim=classes,
                                           depth=depth, variant=variant)
        opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg)
    return prog, startup, rdr, avg, acc


def _image_batches(steps, batch, hw, classes):
    rng = np.random.RandomState(11)
    return [[rng.rand(batch, 3, hw, hw).astype('float32'),
             rng.randint(0, classes, (batch, 1)).astype('int64')]
            for _ in range(steps)]


def _train(run, rdr, avg, acc, fluid, batches):
    """The reader's pass to its end; [(loss, accuracy)] per step."""
    rdr.decorate_tensor_provider(lambda: iter(batches))
    rdr.start()
    out = []
    try:
        with fused_flags(fluid):
            while True:
                lv, av = run(fetch_list=[avg.name, acc.name])
                out.append((float(np.asarray(lv)), float(np.asarray(av))))
    except fluid.core.EOFException:
        rdr.reset()
    return out


def _jax_resnet_run(amp, config, steps):
    prog, startup, rdr, avg, acc = _build_resnet(
        jfluid, junique_name, jresnet, amp, **config)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        names = [v.name for v in prog.list_vars() if v.persistable
                 and scope.find_var(v.name) is not None]
        init = {n: np.array(scope.find_var(n)) for n in names}
        exe = jfluid.Executor(jfluid.CPUPlace())
        steps_out = _train(lambda **kw: exe.run(prog, **kw), rdr, avg, acc,
                           jfluid, _image_batches(steps, config['batch'],
                                                  config['hw'],
                                                  config['classes']))
        final = {n: np.array(scope.find_var(n)) for n in names}
    return dict(init=init, steps=steps_out, final=final,
                text=prog.to_string())


def _torch_resnet_run(ref, amp, config, steps):
    prog, startup, rdr, avg, acc = _build_resnet(
        tfluid, tunique_name, tresnet, amp, **config)
    assert prog.to_string() == ref['text']
    scope = tfluid.Scope()
    # parameters, velocities and the BN running statistics
    tfluid.io.load_numpy_params(scope, ref['init'], tfluid.CPUPlace(),
                                program=prog)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=avg.name,
                                 main_program=prog, scope=scope)
    steps_out = _train(pe.run, rdr, avg, acc, tfluid, _image_batches(
        steps, config['batch'], config['hw'], config['classes']))
    final = {n: scope.find_var(n).float().numpy() for n in ref['init']}
    return prog, steps_out, final


def _rel(got, want, init):
    """||got update - want update|| / ||want update||."""
    du = want - init
    return float(np.linalg.norm((got - init) - du) / np.linalg.norm(du))


CIFAR = dict(depth=8, variant='cifar', hw=32, classes=10, batch=8)
CIFAR_STEPS = 3
# (losses and running statistics, fc update, conv and BN parameter
# updates), keyed by AMP. The conv/BN updates take the wider bar: BN's
# backward removes the batch mean from every gradient, so a BN bias grad
# is a sum that cancels, and one relu mask that flips between two fp32
# orders of summation (an activation within 1e-5 of zero) moves it by
# 5.7e-4 of its norm. Under AMP the JAX package's two K6 routes (Pallas
# interpret vs XLA) already disagree by 0.146 after three steps; the
# port's bf16 average pooling accumulates in fp32 where XLA's CPU
# reduce_window accumulates in bf16 (~2% apart), which alone moves the
# first loss by 1.2e-3.
CIFAR_TOL = {False: (1e-4, 1e-4, 2e-3), True: (2e-2, 2e-2, 0.3)}


@pytest.fixture(scope='module')
def jax_cifar_runs():
    return {amp: _jax_resnet_run(amp, CIFAR, CIFAR_STEPS)
            for amp in (False, True)}


@pytest.mark.parametrize('amp', [False, True], ids=['fp32', 'amp_bf16'])
def test_resnet_cifar_momentum_steps_match_jax(jax_cifar_runs, amp):
    ref = jax_cifar_runs[amp]
    prog, steps, final = _torch_resnet_run(ref, amp, CIFAR, CIFAR_STEPS)
    tol, fc_tol, conv_tol = CIFAR_TOL[amp]
    ops = [op.type for op in prog.global_block().ops]
    assert ops.count('conv2d_bn') == 9 and 'conv2d' not in ops
    assert len(steps) == CIFAR_STEPS and np.isfinite(steps).all()
    np.testing.assert_allclose([s[0] for s in steps],
                               [s[0] for s in ref['steps']], atol=tol, rtol=0)
    assert [s[1] for s in steps] == [s[1] for s in ref['steps']]
    init, want = ref['init'], ref['final']
    stats = [n for n in init if n.endswith(('.mean', '.variance'))]
    params = [v.name for v in prog.global_block().all_parameters()]
    assert len(stats) == 18 and len(params) == 29
    for name in stats:
        assert _rel(final[name], want[name], init[name]) <= tol, name
    for name in params:
        bar = fc_tol if name.startswith('fc_') else conv_tol
        assert _rel(final[name], want[name], init[name]) <= bar, name


# ResNet-50 at 64 px, batch 2, 10 classes: at 32 px the last stage is
# 1 x 1 and its batch norms see two values per channel, where the JAX
# package's own two K6 routes give losses of 5.016 and 5.257; at 64 px
# they agree to 1e-6.
RESNET50 = dict(depth=50, variant='imagenet', hw=64, classes=10, batch=2)


def test_resnet50_step_matches_jax():
    """One fp32 step: the loss, the BN running statistics, and the
    updates of fc, the stem conv and a stage-1 1x1 conv. Fifty layers of
    batch norm over 2-8 values per channel make the conv updates
    sensitive: the port moves its own stem update by 5.4e-2 when only
    its convolutions' rounding changes (fp64 convs), so those take a bar
    of 0.15 (measured against the JAX package: 3.5e-2)."""
    ref = _jax_resnet_run(False, RESNET50, 1)
    prog, steps, final = _torch_resnet_run(ref, False, RESNET50, 1)
    ops = [op.type for op in prog.global_block().ops]
    assert ops.count('conv2d_bn') == 53
    np.testing.assert_allclose(steps[0][0], ref['steps'][0][0], rtol=1e-4)
    init, want = ref['init'], ref['final']
    stats = [n for n in init if n.endswith(('.mean', '.variance'))]
    assert len(stats) == 106
    worst = max(_rel(final[n], want[n], init[n]) for n in stats)
    assert worst <= 1e-3, worst
    assert _rel(final['fc_0.w_0'], want['fc_0.w_0'],
                init['fc_0.w_0']) <= 1e-3
    for name in ('conv_bn_0.w_0', 'conv_bn_2.w_0'):
        assert _rel(final[name], want[name], init[name]) <= 0.15, name


@pytest.mark.parametrize('amp', [False, True])
@pytest.mark.parametrize('fused', [True, False])
def test_resnet_program_text_is_identical(fused, amp):
    """bench_resnet's program, fused or not, after minimize: the same op
    and var text and the same startup program in both packages."""
    def build(fluid, unique_name, resnet):
        prev = fluid.get_flags(['use_pallas_fused_ops'])
        fluid.set_flags({'use_pallas_fused_ops': fused})
        try:
            prog, startup = fluid.Program(), fluid.Program()
            with unique_name.guard(), fluid.program_guard(prog, startup):
                image = fluid.layers.data(name='image', shape=[3, 32, 32],
                                          dtype='float32')
                label = fluid.layers.data(name='label', shape=[1],
                                          dtype='int64')
                _, avg, _ = resnet.train_network(image, label, class_dim=10,
                                                 depth=18)
                opt = fluid.optimizer.Momentum(learning_rate=0.01,
                                               momentum=0.9)
                if amp:
                    opt = fluid.contrib.mixed_precision.decorate(opt)
                opt.minimize(avg)
        finally:
            fluid.set_flags(prev)
        return prog, startup

    jprog, jstartup = build(jfluid, junique_name, jresnet)
    tprog, tstartup = build(tfluid, tunique_name, tresnet)
    types = {op.type for op in tprog.global_block().ops}
    assert ('conv2d_bn' in types) == fused and ('batch_norm' in types) != fused
    assert tprog.to_string() == jprog.to_string()
    assert tstartup.to_string() == jstartup.to_string()


def test_unported_layouts_raise():
    image = tfluid.layers.data(name='image', shape=[3, 32, 32],
                               dtype='float32')
    for kw in ({'space_to_depth': True}, {'nhwc': True}):
        with pytest.raises(NotImplementedError, match='not ported'):
            tresnet.resnet_imagenet(image, class_dim=10, depth=50, **kw)
