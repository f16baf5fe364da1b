"""Fake quantization (paddle_tpu/ops/quant_ops.py), the port against the
JAX package on the CPU.

- fake_quantize in its three modes at 8 and 4 bits: three steps of one
  program (the moving scale, a persistable var the op writes, carried
  from step to step), each step's output, scale and straight-through
  grad within 1e-5; then the test clone, which reads the stored scale.
- round is half to even in both packages: values at k + 0.5 levels.
- fake_dequantize_max_abs within 1e-5.
- The layer builds the JAX package's Program text.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

TOL = 1e-5
UNIQUE = {jfluid: junique_name, tfluid: tunique_name}
MODES = ['abs_max', 'range_abs_max', 'moving_average_abs_max']


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


def _build(fluid, mode, bits):
    prog, startup = fluid.Program(), fluid.Program()
    with UNIQUE[fluid].guard(), fluid.program_guard(prog, startup):
        L = fluid.layers
        x = L.data(name='x', shape=[4, 6], dtype='float32',
                   append_batch_size=False, stop_gradient=False)
        cot = L.data(name='cot', shape=[4, 6], dtype='float32',
                     append_batch_size=False)
        out = L.fake_quantize(x, quantize_type=mode, bit_length=bits)
        loss = L.reduce_sum(L.elementwise_mul(out, cot))
        grad, = fluid.backward.calc_gradient(loss, [x])
    scale = [op.single_output('OutMovingScale')
             for op in prog.global_block().ops
             if op.type == 'fake_quantize'][0]
    return prog, startup, [out.name, scale, grad.name]


def _steps(fluid, mode, bits):
    prog, startup, fetch = _build(fluid, mode, bits)
    test = prog.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    r = np.random.RandomState(3)
    runs = []
    for step, amp in enumerate((1.0, 3.0, 0.5)):
        feed = {'x': (r.randn(4, 6) * amp).astype('float32'),
                'cot': r.randn(4, 6).astype('float32')}
        runs.append([np.asarray(v) for v in exe.run(
            prog, feed=feed, fetch_list=fetch, scope=scope)])
    feed = {'x': (r.randn(4, 6) * 2).astype('float32'),
            'cot': np.zeros((4, 6), 'float32')}
    runs.append([np.asarray(exe.run(test, feed=feed, fetch_list=fetch[:1],
                                    scope=scope)[0])])
    return runs, prog.to_string()


@pytest.mark.parametrize('bits', [8, 4])
@pytest.mark.parametrize('mode', MODES)
def test_fake_quantize_steps_match_jax(mode, bits):
    want, jtext = _steps(jfluid, mode, bits)
    got, ttext = _steps(tfluid, mode, bits)
    assert ttext == jtext
    for rw, rg in zip(want, got):
        for w, g in zip(rw, rg):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    # the straight-through grad is zero where |x| passed the scale (the
    # moving average lags the second step's 3x wider batch)
    if mode == 'moving_average_abs_max':
        assert (got[1][2] == 0).any()


def _round_trip(fluid, x):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        xv = fluid.layers.data(name='x', shape=list(x.shape),
                               dtype='float32', append_batch_size=False)
        out = fluid.layers.fake_quantize(xv, bit_length=8)
    return np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'x': x}, fetch_list=[out], scope=fluid.Scope())[0])


def test_round_is_half_to_even():
    """max |x| = 127 makes x / scale * 127 = x: each .5 level rounds to
    the even integer."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                 'float32')
    want = np.array([127, 0, 2, 2, 0, -2, 4, -126], 'float32')
    np.testing.assert_array_equal(_round_trip(jfluid, x), want)
    np.testing.assert_array_equal(_round_trip(tfluid, x), want)


def _dequant(fluid, x, scale):
    prog = fluid.Program()
    block = prog.global_block()
    xv = block.create_var(name='x', shape=x.shape, dtype='float32',
                          is_data=True)
    sv = block.create_var(name='s', shape=(1,), dtype='float32',
                          is_data=True)
    out = block.create_var(name='out')
    block.append_op(type='fake_dequantize_max_abs',
                    inputs={'X': [xv], 'Scale': [sv]},
                    outputs={'Out': [out]}, attrs={'max_range': 127.0})
    return np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'x': x, 's': scale}, fetch_list=['out'],
        scope=fluid.Scope())[0])


def test_fake_dequantize_matches_jax():
    x = np.random.RandomState(4).randint(-127, 128, (5, 7)).astype(
        'float32')
    s = np.array([3.7], 'float32')
    np.testing.assert_allclose(_dequant(tfluid, x, s), _dequant(jfluid, x, s),
                               atol=TOL, rtol=TOL)
