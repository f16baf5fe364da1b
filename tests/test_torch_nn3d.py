"""The volumetric and indexed pooling and convolution ops
(paddle_tpu/ops/nn3d_ops.py's 9 types), the port against the JAX
package on the CPU.

- Each op type as one-op programs (CASES, through test_torch_sequence's
  harness): the same seeded numpy inputs in both packages, the forward
  outputs and the input grads (from a seeded cotangent) within 1e-5,
  Mask outputs equal; the second run of each in the port reads nothing
  back to the host and builds no tensor from host data (a captured
  segment's rule). The cases cover padding, ceil_mode, exclusive and
  inclusive averages, global pooling, groups, dilation, stride > 1
  transposes, tied window maxima (max_pool*_with_index: the first
  maximum's Mask, the grad split as jnp.max splits it; pool3d and spp:
  the first maximum's grad) and overlapping unpool windows.
- conv3d under AMP (bf16 operands, fp32 math off the card) within 2e-2.
- conv3d, conv3d_transpose and pool3d as layers: the JAX package's
  Program text.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_torch_sequence import (_case, _compare, _cotangents, _forward_of,
                                 _run, _second_run_guarded)

TOL = 1e-5
AMP_TOL = 2e-2


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


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def _tied(seed, *shape, levels=3):
    """Values from a few levels: every window holds ties."""
    return np.random.RandomState(seed).randint(
        0, levels, size=shape).astype('float32')


def _cases():
    c = {}
    x5 = _f(1, 2, 4, 5, 6, 7)
    c['conv3d'] = _case('conv3d', {'Input': x5, 'Filter': _f(2, 6, 4, 3, 3,
                                                             3) * 0.2},
                        {'Output': ['out']}, ['Input', 'Filter'],
                        attrs={'strides': [1, 2, 1], 'paddings': [1, 0, 1]})
    c['conv3d-groups-dilation'] = _case(
        'conv3d', {'Input': x5, 'Filter': _f(3, 4, 2, 2, 3, 2) * 0.2},
        {'Output': ['out']}, ['Input', 'Filter'],
        attrs={'strides': [2, 1, 1], 'paddings': [1, 1, 0],
               'dilations': [2, 1, 2], 'groups': 2})
    xs = _f(4, 2, 3, 3, 4, 3)
    c['conv3d_transpose'] = _case(
        'conv3d_transpose', {'Input': xs, 'Filter': _f(5, 3, 2, 3, 3, 2)},
        {'Output': ['out']}, ['Input', 'Filter'],
        attrs={'strides': [2, 1, 2], 'paddings': [1, 0, 0],
               'dilations': [1, 2, 1]})
    c['depthwise_conv2d_transpose'] = _case(
        'depthwise_conv2d_transpose',
        {'Input': _f(6, 2, 3, 4, 5), 'Filter': _f(7, 3, 1, 3, 3)},
        {'Output': ['out']}, ['Input', 'Filter'],
        attrs={'strides': [2, 2], 'paddings': [1, 0], 'dilations': [1, 2]})
    for ptype in ('max', 'avg'):
        c['pool3d-%s' % ptype] = _case(
            'pool3d', {'X': x5}, {'Out': ['out']}, ['X'],
            attrs={'pooling_type': ptype, 'ksize': [2, 3, 2],
                   'strides': [2, 2, 2], 'paddings': [0, 1, 1]})
        c['pool3d-%s-ceil' % ptype] = _case(
            'pool3d', {'X': x5}, {'Out': ['out']}, ['X'],
            attrs={'pooling_type': ptype, 'ksize': [2, 2, 3],
                   'strides': [2, 2, 2], 'paddings': [1, 0, 1],
                   'ceil_mode': True})
        c['pool3d-%s-global' % ptype] = _case(
            'pool3d', {'X': x5}, {'Out': ['out']}, ['X'],
            attrs={'pooling_type': ptype, 'ksize': [1, 1, 1],
                   'global_pooling': True})
    c['pool3d-avg-inclusive'] = _case(
        'pool3d', {'X': x5}, {'Out': ['out']}, ['X'],
        attrs={'pooling_type': 'avg', 'ksize': [3, 3, 3],
               'strides': [1, 2, 2], 'paddings': [1, 1, 1],
               'exclusive': False})
    c['pool3d-max-ties'] = _case(
        'pool3d', {'X': _tied(8, 2, 2, 4, 4, 4)}, {'Out': ['out']}, ['X'],
        attrs={'pooling_type': 'max', 'ksize': [2, 2, 2],
               'strides': [2, 2, 2]})
    x4 = _f(9, 2, 3, 7, 8)
    for name, x, attrs in (
            ('', x4, {'ksize': [3, 3], 'strides': [2, 2],
                      'paddings': [1, 1]}),
            ('-overlap-ties', _tied(10, 2, 3, 6, 7),
             {'ksize': [3, 2], 'strides': [1, 2], 'paddings': [1, 0]}),
            ('-global', x4, {'ksize': [1, 1], 'global_pooling': True})):
        c['max_pool2d_with_index' + name] = _case(
            'max_pool2d_with_index', {'X': x},
            {'Out': ['out'], 'Mask': ['mask']}, ['X'], attrs=attrs)
    for name, x, attrs in (
            ('', x5, {'ksize': [2, 3, 2], 'strides': [2, 2, 2],
                      'paddings': [1, 1, 0]}),
            ('-ties', _tied(11, 1, 2, 4, 5, 4),
             {'ksize': [2, 2, 2], 'strides': [1, 2, 1]})):
        c['max_pool3d_with_index' + name] = _case(
            'max_pool3d_with_index', {'X': x},
            {'Out': ['out'], 'Mask': ['mask']}, ['X'], attrs=attrs)
    # unpool at the indices of a pool: a 2x2/2 pool's, and an overlapping
    # 3x3/1 pool's, where several windows name the same cell
    for name, k, s, p, seed in (('', 2, 2, 0, 12), ('-overlap', 3, 1, 1, 13)):
        x = _tied(seed, 2, 3, 6, 6, levels=4) + 0.25 * _f(seed, 2, 3, 6, 6)
        idx = _run(jfluid, _case('max_pool2d_with_index', {'X': x},
                                 {'Out': ['out'], 'Mask': ['mask']},
                                 attrs={'ksize': [k, k], 'strides': [s, s],
                                        'paddings': [p, p]}))[0]['mask']
        c['unpool' + name] = _case(
            'unpool', {'X': _f(seed + 1, *idx.shape), 'Indices': idx},
            {'Out': ['out']}, ['X'],
            attrs={'unpooled_height': 6, 'unpooled_width': 6,
                   'ksize': [k, k], 'strides': [s, s], 'paddings': [p, p]})
    for ptype in ('max', 'avg'):
        c['spp-%s' % ptype] = _case(
            'spp', {'X': _f(14, 2, 3, 7, 9)}, {'Out': ['out']}, ['X'],
            attrs={'pyramid_height': 3, 'pooling_type': ptype})
    c['spp-max-ties'] = _case('spp', {'X': _tied(15, 2, 2, 6, 5)},
                              {'Out': ['out']}, ['X'],
                              attrs={'pyramid_height': 2,
                                     'pooling_type': 'max'})
    c['conv_shift'] = _case('conv_shift', {'X': _f(16, 3, 8),
                                           'Y': _f(17, 3, 5)},
                            {'Out': ['out']}, ['X', 'Y'])
    return c


CASES = _cases()


@pytest.mark.parametrize('name', sorted(CASES))
def test_op_forward_and_grads_match_jax(name, monkeypatch):
    case = CASES[name]
    cots = _cotangents(case, _forward_of(jfluid, case))
    want, = _run(jfluid, case, cots=cots)
    got, again = _run(tfluid, case, cots=cots,
                      guard=_second_run_guarded(monkeypatch))
    assert any(n.endswith('@GRAD') for n in got)
    _compare(want, got, TOL)
    _compare(got, again, 0.0)


def test_tie_cases_hold_ties():
    """Each tie case has windows whose maximum repeats, and the with-index
    Masks name the first of them (row-major in the unpadded input)."""
    got, = _run(tfluid, dict(CASES['max_pool2d_with_index-overlap-ties'],
                             check=[]))
    x = CASES['max_pool2d_with_index-overlap-ties']['inputs']['X']
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (0, 0)),
                constant_values=-np.inf)
    n_ties = 0
    for i in range(got['out'].shape[2]):
        for j in range(got['out'].shape[3]):
            win = xp[:, :, i:i + 3, 2 * j:2 * j + 2].reshape(2, 3, -1)
            n_ties += int(((win == win.max(-1, keepdims=True)).sum(-1)
                           > 1).sum())
            first = win.argmax(-1)
            want = (i - 1 + first // 2) * x.shape[3] + 2 * j + first % 2
            np.testing.assert_array_equal(got['mask'][:, :, i, j], want)
    assert n_ties > 10


def _amp_run(fluid, x, w, cot):
    """conv3d under AMP (the op casts its fp32 operands to bf16) and the
    grads of sum(out * cot), as a training step takes them."""
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers
        xv = L.data(name='x', shape=list(x.shape), dtype='float32',
                    append_batch_size=False, stop_gradient=False)
        wv = L.data(name='w', shape=list(w.shape), dtype='float32',
                    append_batch_size=False, stop_gradient=False)
        cv = L.data(name='cot', shape=list(cot.shape), dtype='float32',
                    append_batch_size=False)
        out = prog.global_block().create_var(name='out')
        prog.global_block().append_op(
            type='conv3d', inputs={'Input': [xv], 'Filter': [wv]},
            outputs={'Output': [out]}, attrs={'paddings': [1, 0, 1]})
        loss = L.reduce_sum(L.elementwise_mul(out, cv))
        grads = fluid.backward.calc_gradient(loss, [xv, wv])
    prog._use_bf16 = True
    fetch = ['out'] + [g.name for g in grads]
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'x': x, 'w': w, 'cot': cot}, fetch_list=fetch,
        scope=fluid.Scope())
    return {n: np.asarray(v, 'float32') for n, v in zip(fetch, got)}


def test_conv3d_under_amp_matches_jax():
    """conv3d under AMP (bf16 operands, fp32 math off the card): within
    2e-2 of the JAX package, forward and grads."""
    x, w = _f(18, 1, 2, 3, 4, 4), _f(19, 3, 2, 2, 2, 2) * 0.3
    cot = _f(20, 1, 3, 4, 3, 5)
    want = _amp_run(jfluid, x, w, cot)
    got = _amp_run(tfluid, x, w, cot)
    assert sorted(got) == sorted(want) and len(got) == 3
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=AMP_TOL,
                                   rtol=AMP_TOL, err_msg=n)
    # bf16 operands: the output is not the fp32 conv's
    import torch
    fp32 = torch.nn.functional.conv3d(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      padding=(1, 0, 1)).numpy()
    assert np.abs(fp32 - got['out']).max() > 1e-4


def _layer_program(fluid, unique_name):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        L = fluid.layers
        x = L.data(name='x', shape=[3, 8, 8, 8], dtype='float32')
        y = L.conv3d(x, num_filters=4, filter_size=3, padding=1, act='relu')
        y = L.pool3d(y, pool_size=2, pool_type='avg', pool_stride=2,
                     ceil_mode=True)
        y = L.conv3d_transpose(y, num_filters=2, filter_size=2, stride=2)
        L.mean(y)
    return prog, startup


def test_3d_layers_build_the_jax_program():
    jprog, jstart = _layer_program(jfluid, junique_name)
    tprog, tstart = _layer_program(tfluid, tunique_name)
    assert tprog.to_string() == jprog.to_string()
    assert tstart.to_string() == jstart.to_string()
