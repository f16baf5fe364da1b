"""paddle_tpu_torch's NHWC layout and space-to-depth stem against the JAX
package, on the CPU, in fp32.

- conv2d (with and without bias), depthwise conv2d, max, average and
  global average pooling, and batch_norm at NHWC: forward and the input
  grad, each against the JAX package at atol 1e-5 (as
  tests/test_nhwc_layout.py sets the op cases up); the depthwise_conv2d,
  grouped and dilated conv2d and batch_norm op types as one-op programs,
  with the grads of every float input;
- the outputs of the NHWC conv and pooling ops are contiguous NHWC
  tensors: the channels-last view went through with no copy;
- resnet_imagenet(depth=18, nhwc=True) at 32 px, batch 8: the same
  Program text as the JAX package's, and two Momentum steps from the
  JAX package's weights, losses within 1e-4 (relative). At batch 2 the
  last stage's batch norms see two values per channel and the step is
  ill-conditioned: there even the NCHW programs of the two packages
  end 0.55 apart after two steps (7.8e-5 at batch 8);
- the space-to-depth stem: the retiled 4x4 conv equals the 7x7/2 conv
  within 1e-5, and one Momentum step of train_network(space_to_depth=
  True) against the JAX package's, loss within 1e-4 (relative).
Weights carry across by name with io.load_numpy_params.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import resnet as jresnet
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import resnet as tresnet

ATOL = 1e-5
LOSS_RTOL = 1e-4


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


def _persistables(scope, program):
    return {v.name: np.array(np.asarray(scope.find_var(v.name)))
            for v in program.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


# -- one-op NHWC programs -------------------------------------------------------

OP_CASES = ('conv', 'conv_bias', 'depthwise', 'pool_max', 'pool_avg_global',
            'pool_avg_exclusive', 'pool_max_ceil', 'batch_norm')


def _op_net(fluid, unique_name, case):
    """x [2, 6, 9, 9] (NCHW feed) -> transpose -> the NHWC op ->
    transpose back -> reduce_mean, with x's grad."""
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[6, 9, 9], dtype='float32')
        x.stop_gradient = False
        h = fluid.layers.transpose(x, perm=[0, 2, 3, 1])
        fmt = 'NHWC'
        if case == 'conv':
            y = fluid.layers.conv2d(h, 8, 3, padding=1, stride=2,
                                    bias_attr=False, data_format=fmt)
        elif case == 'conv_bias':
            y = fluid.layers.conv2d(h, 8, 3, padding=1, data_format=fmt)
        elif case == 'depthwise':
            y = fluid.layers.conv2d(h, 6, 3, padding=1, groups=6,
                                    bias_attr=False, data_format=fmt)
        elif case == 'pool_max':
            y = fluid.layers.pool2d(h, pool_size=3, pool_type='max',
                                    pool_stride=2, pool_padding=1,
                                    data_format=fmt)
        elif case == 'pool_avg_global':
            y = fluid.layers.pool2d(h, pool_type='avg', global_pooling=True,
                                    data_format=fmt)
        elif case == 'pool_avg_exclusive':
            y = fluid.layers.pool2d(h, pool_size=3, pool_type='avg',
                                    pool_stride=2, pool_padding=1,
                                    data_format=fmt)
        elif case == 'pool_max_ceil':
            y = fluid.layers.pool2d(h, pool_size=2, pool_type='max',
                                    pool_stride=2, ceil_mode=True,
                                    data_format=fmt)
        else:
            y = fluid.layers.batch_norm(h, data_layout=fmt)
        out = fluid.layers.transpose(y, perm=[0, 3, 1, 2])
        loss = fluid.layers.reduce_mean(out)
        fluid.backward.append_backward(loss)
    return main, startup, y, out


@pytest.mark.parametrize('case', OP_CASES)
def test_nhwc_op_forward_and_input_grad_match_jax(case):
    x = np.random.RandomState(1).rand(2, 6, 9, 9).astype('float32')
    jmain, jstartup, _, jout = _op_net(jfluid, junique_name, case)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstartup)
        init = _persistables(scope, jmain)
        want = exe.run(jmain, feed={'x': x}, fetch_list=[jout, 'x@GRAD'])
    tmain, _, _, tout = _op_net(tfluid, tunique_name, case)
    assert tmain.to_string() == jmain.to_string()
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tmain)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={'x': x}, fetch_list=[tout, 'x@GRAD'], scope=tscope)
    for name, g, w in zip(('out', 'x@GRAD'), got, want):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=1e-6,
                                   err_msg='%s %s' % (case, name))


def test_nhwc_outputs_are_contiguous_nhwc():
    """ResNet's NHWC stem on the CPU's kernels: a conv reading the
    transposed NCHW feed, then max pooling, a conv and global average
    pooling. Each op hands the kernel a channels-last view and permutes
    the channels-last result back: every output is a contiguous NHWC
    tensor, with no copy of the activations. The first conv gets there
    through its channels-last filter, as its input's memory is NCHW."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[3, 16, 16], dtype='float32')
        h = tfluid.layers.transpose(x, perm=[0, 2, 3, 1])
        outs = [tfluid.layers.conv2d(h, 8, 7, padding=3, stride=2,
                                     bias_attr=False, data_format='NHWC')]
        outs.append(tfluid.layers.pool2d(outs[-1], pool_size=3,
                                         pool_stride=2, pool_padding=1,
                                         data_format='NHWC'))
        outs.append(tfluid.layers.conv2d(outs[-1], 16, 1, bias_attr=False,
                                         data_format='NHWC'))
        outs.append(tfluid.layers.pool2d(outs[-1], pool_type='avg',
                                         global_pooling=True,
                                         data_format='NHWC'))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(2).rand(2, 3, 16, 16).astype('float32')
    got = exe.run(main, feed={'x': xv}, fetch_list=outs, scope=scope,
                  return_numpy=False)
    for t, v in zip(got, outs):
        assert t.is_contiguous(), (v.name, tuple(t.shape), t.stride())


def _one_op(fluid, op_type, inputs, attrs, extra=()):
    """One op over fed inputs and calc_gradient of its first output
    against a fixed cotangent: {name: value} of the outputs and of the
    grads of the float inputs (the running statistics take none)."""
    prog = fluid.Program()
    block = prog.global_block()
    feed, ins, diff = {}, {}, []
    for slot, arr in inputs.items():
        float_in = slot not in ('Mean', 'Variance')
        v = block.create_var(name='in_' + slot.lower(), shape=arr.shape,
                             dtype='float32', is_data=True,
                             stop_gradient=not float_in)
        ins[slot] = [v]
        feed[v.name] = arr
        if float_in:
            diff.append(v)
    out_slot = 'Output' if 'conv' in op_type else 'Y'
    outs = {out_slot: [block.create_var(name='out')]}
    for slot in extra:
        outs[slot] = [block.create_var(name='out_' + slot.lower(),
                                       stop_gradient=True)]
    fetch = ['out'] + ['out_' + slot.lower() for slot in extra]
    with fluid.program_guard(prog, fluid.Program()):
        block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
        out = outs[out_slot][0]
        cot = block.create_var(name='cot', shape=out.shape, dtype='float32',
                               is_data=True, stop_gradient=True)
        feed['cot'] = np.random.RandomState(1).randn(
            *out.shape).astype('float32')
        grads = fluid.backward.calc_gradient([out], diff,
                                             target_gradients=[cot])
        fetch += [g.name for g in grads]
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
    return {n: np.asarray(g) for n, g in zip(fetch, got)}


def _one_op_cases():
    r = np.random.RandomState(4)
    f = lambda *shape: r.randn(*shape).astype('float32')   # noqa: E731
    conv = {'strides': [2, 2], 'paddings': [1, 1], 'dilations': [1, 1],
            'groups': 1, 'data_format': 'NHWC'}
    bn = {'momentum': 0.9, 'epsilon': 1e-5, 'data_layout': 'NHWC'}
    stats = ('MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance')

    def bn_inputs():
        return {'X': f(4, 5, 5, 3), 'Scale': f(3), 'Bias': f(3),
                'Mean': f(3), 'Variance': np.abs(f(3)) + 0.5}
    return [
        ('depthwise_conv2d', 'depthwise_conv2d',
         {'Input': f(2, 7, 7, 4), 'Filter': f(4, 1, 3, 3)},
         dict(conv, groups=4), ()),
        ('conv2d-groups2-dilation2', 'conv2d',
         {'Input': f(2, 9, 9, 4), 'Filter': f(6, 2, 3, 3)},
         dict(conv, strides=[1, 1], paddings=[2, 1], dilations=[2, 2],
              groups=2), ()),
        ('batch_norm-train', 'batch_norm', bn_inputs(),
         dict(bn, is_test=False), stats),
        ('batch_norm-test', 'batch_norm', bn_inputs(),
         dict(bn, is_test=True), stats),
    ]


ONE_OP_CASES = _one_op_cases()


@pytest.mark.parametrize('case', ONE_OP_CASES,
                         ids=[c[0] for c in ONE_OP_CASES])
def test_nhwc_one_op_programs_match_jax(case):
    """The op types themselves at NHWC, as one-op programs: outputs, the
    running statistics and the grads of every float input."""
    _, op_type, inputs, attrs, extra = case
    want = _one_op(jfluid, op_type, inputs, attrs, extra)
    got = _one_op(tfluid, op_type, inputs, attrs, extra)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, atol=ATOL, rtol=1e-6,
                                   err_msg=name)


# -- ResNet-18 at NHWC, and the space-to-depth stem -----------------------------

HW, BATCH, CLASSES = 32, 8, 10


def _resnet_net(fluid, unique_name, resnet, **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name='image', shape=[3, HW, HW],
                                dtype='float32')
        lbl = fluid.layers.data(name='label', shape=[1], dtype='int64')
        _, cost, _ = resnet.train_network(img, lbl, class_dim=CLASSES,
                                          depth=18, **kw)
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(cost)
    return main, startup, cost


def _resnet_losses(steps, **kw):
    """The JAX package's and the port's losses over `steps` Momentum
    steps from the JAX package's initial weights, and the port's
    program."""
    rng = np.random.RandomState(3)
    batches = [{'image': rng.rand(BATCH, 3, HW, HW).astype('float32'),
                'label': rng.randint(0, CLASSES, (BATCH, 1)).astype('int64')}
               for _ in range(steps)]
    jmain, jstartup, jcost = _resnet_net(jfluid, junique_name, jresnet, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstartup)
        init = _persistables(scope, jmain)
        want = [float(np.asarray(exe.run(jmain, feed=b,
                                         fetch_list=[jcost])[0]))
                for b in batches]
    tmain, _, tcost = _resnet_net(tfluid, tunique_name, tresnet, **kw)
    assert tmain.to_string() == jmain.to_string()
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tmain)
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tmain, feed=b, fetch_list=[tcost],
                          scope=tscope)[0]) for b in batches]
    return got, want, tmain


def test_resnet18_nhwc_momentum_steps_match_jax():
    got, want, prog = _resnet_losses(2, nhwc=True)
    ops = [op for op in prog.global_block().ops]
    convs = [op for op in ops if op.type == 'conv2d']
    bns = [op for op in ops if op.type == 'batch_norm']
    assert len(convs) == len(bns) == 20
    assert all(op.attr('data_format') == 'NHWC' for op in convs)
    assert all(op.attr('data_layout') == 'NHWC' for op in bns)
    assert sum(op.type == 'transpose2' for op in ops) == 1
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_s2d_stem_is_the_7x7_stem_exactly():
    """The retiled 4x4 stem (space_to_depth_stem's repacking and pad,
    chip_smoke.s2d_filter's weights) equals the 7x7/stride-2 conv within
    1e-5 in fp32 (tests/test_resnet_s2d.py's bound), and chip_smoke's
    retiling is that test's."""
    from test_resnet_s2d import _s2d_weights
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 32, 32).astype('float32'))
    w = torch.from_numpy(rng.randn(16, 3, 7, 7).astype('float32') * 0.1)
    w4 = chip_smoke.s2d_filter(w)
    np.testing.assert_array_equal(w4.numpy(), _s2d_weights(w.numpy()))
    want = torch.nn.functional.conv2d(x, w, stride=2, padding=3)
    got = chip_smoke.s2d_stem_conv(x, w4)
    assert got.shape == want.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_s2d_resnet_step_matches_jax():
    got, want, prog = _resnet_losses(1, space_to_depth=True)
    ops = [op.type for op in prog.global_block().ops]
    assert ops.count('pad') == 1 and ops.count('conv2d') == 20
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
