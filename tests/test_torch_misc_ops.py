"""The rest of paddle_tpu/ops/misc_ops.py (17 op types) and their layers
in layers/nn_extra.py, the port against the JAX package on the CPU.

- Each op type as one-op programs (CASES, through test_torch_sequence's
  harness): the same seeded numpy inputs, the forward outputs and the
  registered input grads (from seeded cotangents) within 1e-5, integer
  outputs equal; each second run in the port reads nothing back to the
  host and builds no tensor from host data (fill and lod_reset's
  target_lod keep theirs on the op).
- bilinear_interp is align-corners (scale (in - 1) / (out - 1)), not
  F.interpolate's default, and takes sizes of 1 on either side.
- random_crop draws from the Executor's generator (a divergence by
  design from jax.random's draw): held by its properties.
- Each layer builds the JAX package's Program text, and image_resize,
  resize_bilinear, image_resize_short, dice_loss, crop, mean_iou and
  lod_reset run to the JAX package's values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_torch_sequence import (_case, _compare, _forward_of, _run,
                                 _second_run_guarded)

TOL = 1e-5


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


def _r(seed):
    return np.random.RandomState(seed)


def _f(seed, *shape):
    return _r(seed).randn(*shape).astype('float32')


def _cases():
    c = {}
    x = _f(1, 4, 5)
    c['sign'] = _case('sign', {'X': np.array([[-2., 0., 3.5], [0., -0., 1.]],
                                             'float32')}, {'Out': ['out']})
    c['minus'] = _case('minus', {'X': x, 'Y': _f(2, 4, 5)}, {'Out': ['out']},
                       ['X', 'Y'])
    c['multiplex'] = _case(
        'multiplex', {'X': [('x%d' % i, _f(3 + i, 4, 5)) for i in range(3)],
                      'Ids': np.array([[2], [0], [1], [2]], 'int32')},
        {'Out': ['out']}, ['X'])
    c['rank_loss'] = _case(
        'rank_loss', {'Label': _r(6).randint(0, 2, (6, 1)).astype('float32'),
                      'Left': _f(7, 6, 1) * 12, 'Right': _f(8, 6, 1)},
        {'Out': ['out']}, ['Left', 'Right'])
    c['modified_huber_loss'] = _case(
        'modified_huber_loss',
        {'X': np.linspace(-3, 3, 12).astype('float32').reshape(12, 1),
         'Y': _r(9).randint(0, 2, (12, 1)).astype('float32')},
        {'Out': ['out'], 'IntermediateVal': ['inter']}, ['X'])
    xz = _f(10, 3, 4)
    xz[0, 1] = 0.0
    c['l1_norm'] = _case('l1_norm', {'X': xz}, {'Out': ['out']}, ['X'])
    for axis in (1, 2):
        c['norm-axis%d' % axis] = _case(
            'norm', {'X': _f(11, 2, 3, 4)}, {'Out': ['out'], 'Norm': ['nrm']},
            ['X'], attrs={'axis': axis, 'epsilon': 1e-6})
    c['mean_iou'] = _case(
        'mean_iou', {'Predictions': _r(12).randint(0, 5, (3, 7)).astype(
            'int32'), 'Labels': _r(13).randint(0, 4, (3, 7)).astype('int32')},
        {'OutMeanIou': ['miou'], 'OutWrong': ['wrong'],
         'OutCorrect': ['correct']}, attrs={'num_classes': 6})
    for axis in (0, 1, 3):
        c['flatten-axis%d' % axis] = _case(
            'flatten', {'X': _f(14, 2, 3, 4, 5)}, {'Out': ['out']}, ['X'],
            attrs={'axis': axis})
    x4 = _f(15, 3, 5, 6)
    c['crop-attr'] = _case('crop', {'X': x4}, {'Out': ['out']}, ['X'],
                           attrs={'shape': [2, 3, 4], 'offsets': [1, 2, 1]})
    c['crop-minus1'] = _case('crop', {'X': x4}, {'Out': ['out']}, ['X'],
                             attrs={'shape': [-1, 2, 3],
                                    'offsets': [1, 0, 2]})
    c['crop-like-y'] = _case('crop', {'X': x4, 'Y': _f(16, 2, 2, 2)},
                             {'Out': ['out']}, ['X'],
                             attrs={'offsets': [0, 3, 4]})
    c['crop-offsets'] = _case(
        'crop', {'X': x4, 'Offsets': np.array([1, 4, 3], 'int32')},
        {'Out': ['out']}, ['X'], attrs={'shape': [2, 3, 4]})
    c['pad_constant_like'] = _case(
        'pad_constant_like', {'X': _f(17, 4, 5, 6), 'Y': _f(18, 2, 5, 3)},
        {'Out': ['out']}, ['Y'], attrs={'pad_value': 1.5})
    for axis in (0, 1, -1):
        n = (3, 4, 2)[axis]
        c['unstack-axis%d' % axis] = _case(
            'unstack', {'X': _f(19, 3, 4, 2)},
            {'Y': ['y%d' % i for i in range(n)]}, ['X'],
            targets=['y%d' % i for i in range(n)], attrs={'axis': axis})
    c['bilinear_tensor_product'] = _case(
        'bilinear_tensor_product',
        {'X': _f(20, 4, 3), 'Y': _f(21, 4, 5), 'Weight': _f(22, 6, 3, 5),
         'Bias': _f(23, 1, 6)}, {'Out': ['out']},
        ['X', 'Y', 'Weight', 'Bias'])
    c['bilinear_tensor_product-nobias'] = _case(
        'bilinear_tensor_product',
        {'X': _f(24, 4, 3), 'Y': _f(25, 4, 5), 'Weight': _f(26, 2, 3, 5)},
        {'Out': ['out']}, ['X', 'Y', 'Weight'])
    img = _f(27, 2, 3, 5, 7)
    for oh, ow in ((9, 4), (5, 7), (1, 3), (12, 13)):
        c['bilinear_interp-%dx%d' % (oh, ow)] = _case(
            'bilinear_interp', {'X': img}, {'Out': ['out']}, ['X'],
            attrs={'out_h': oh, 'out_w': ow})
    c['bilinear_interp-from1'] = _case(
        'bilinear_interp', {'X': _f(28, 1, 2, 1, 4)}, {'Out': ['out']},
        ['X'], attrs={'out_h': 3, 'out_w': 6})
    c['fill-float32'] = _case(
        'fill', {}, {'Out': ['out']},
        attrs={'value': [0.5, -1.0, 2.0, 3.25, 4.0, 8.0], 'shape': [2, 3],
               'dtype': 'float32'})
    c['fill-int32'] = _case(
        'fill', {}, {'Out': ['out']},
        attrs={'value': [1, 2, 3, 4], 'shape': [4, 1], 'dtype': 'int32'})
    seq = _f(29, 3, 4, 2)
    c['lod_reset-lens'] = _case(
        'lod_reset', {'X': seq, 'TargetLens': np.array([4, 1, 3], 'int32')},
        {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'])
    c['lod_reset-offsets'] = _case(
        'lod_reset', {'X': seq, 'TargetLens': np.array([0, 2, 6, 7],
                                                       'int32')},
        {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'],
        attrs={'target_is_offsets': True})
    c['lod_reset-target_lod'] = _case(
        'lod_reset', {'X': seq}, {'Out': ['out'], 'OutLens': ['out_lens']},
        ['X'], attrs={'target_lod': [0, 3, 4, 6]})
    return c


CASES = _cases()


def _cotangents(case, outs):
    """Seeded cotangents shaped as the JAX package's target outputs (0-d
    ones included)."""
    return {'cot_%d' % i: np.asarray(_r(100 + i).randn(*np.shape(outs[n])),
                                     'float32')
            for i, n in enumerate(case['targets'])}


@pytest.mark.parametrize('name', sorted(CASES))
def test_op_forward_and_grads_match_jax(name, monkeypatch):
    case = CASES[name]
    cots = _cotangents(case, _forward_of(jfluid, case)) \
        if case['check'] else {}
    want, = _run(jfluid, case, cots=cots)
    got, again = _run(tfluid, case, cots=cots,
                      guard=_second_run_guarded(monkeypatch))
    assert any(n.endswith('@GRAD') for n in got) == bool(case['check'])
    _compare(want, got, TOL)
    _compare(got, again, 0.0)


def test_bilinear_interp_is_align_corners():
    """The corners map to the corners, and the result is not
    F.interpolate's default (half-pixel) resize."""
    got, = _run(tfluid, dict(CASES['bilinear_interp-12x13'], check=[]))
    x = CASES['bilinear_interp-12x13']['inputs']['X']
    out = got['out']
    for i, j in ((0, 0), (-1, -1), (0, -1), (-1, 0)):
        np.testing.assert_array_equal(out[:, :, i, j], x[:, :, i, j])
    align = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(12, 13), mode='bilinear',
        align_corners=True).numpy()
    half = torch.nn.functional.interpolate(
        torch.from_numpy(x), size=(12, 13), mode='bilinear').numpy()
    np.testing.assert_allclose(out, align, atol=1e-5)
    assert np.abs(out - half).max() > 1e-2


def _random_crop(fluid, x, shape, runs=2):
    prog = fluid.Program()
    prog.random_seed = 7
    with fluid.program_guard(prog, fluid.Program()):
        xv = fluid.layers.data(name='x', shape=list(x.shape), dtype='float32',
                               append_batch_size=False)
        out = fluid.layers.random_crop(xv, shape)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    return [np.asarray(exe.run(prog, feed={'x': x}, fetch_list=[out],
                               scope=scope)[0]) for _ in range(runs)]


def test_random_crop_properties():
    """Each example's crop is a window of its own input at an offset in
    range; offsets vary across the examples and between runs; the
    shapes are the JAX package's."""
    x = np.arange(16 * 2 * 9 * 11, dtype='float32').reshape(16, 2, 9, 11)
    runs = _random_crop(tfluid, x, [5, 6], runs=3)
    want, = _random_crop(jfluid, x, [5, 6], runs=1)
    offsets = []
    for out in runs:
        assert out.shape == want.shape == (16, 2, 5, 6)
        for b in range(16):
            for c in range(2):
                first = out[b, c, 0, 0] - x[b, c, 0, 0]
                oy, ox = int(first // 11), int(first % 11)
                assert 0 <= oy <= 4 and 0 <= ox <= 5
                np.testing.assert_array_equal(
                    out[b, c], x[b, c, oy:oy + 5, ox:ox + 6])
                offsets.append((oy, ox))
    assert len(set(offsets)) > 10
    assert not np.array_equal(runs[0], runs[1])


def _layers_program(fluid, unique_name):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        L = fluid.layers
        img = L.data(name='img', shape=[3, 6, 8], dtype='float32')
        lab = L.data(name='lab', shape=[1], dtype='int64')
        vec = L.data(name='vec', shape=[4], dtype='float32')
        vec2 = L.data(name='vec2', shape=[5], dtype='float32')
        seq = L.data(name='seq', shape=[3, 4], dtype='float32',
                     append_batch_size=False)
        offs = L.data(name='offs', shape=[4], dtype='int32',
                      append_batch_size=False)
        outs = [L.resize_bilinear(img, out_shape=[9, 11]),
                L.image_resize(img, scale=2.0),
                L.image_resize_short(img, 4),
                L.dice_loss(L.softmax(vec), lab),
                L.crop(img, shape=[-1, 2, 3, 4], offsets=[0, 1, 2, 3]),
                L.pad_constant_like(img, L.crop(img, shape=img,
                                                offsets=[0, 0, 0, 0]), 2.0),
                L.sign(vec), L.l1_norm(vec), L.rank_loss(
                    L.cast(lab, 'float32'), L.reduce_sum(vec, dim=1,
                                                         keep_dim=True),
                    L.reduce_mean(vec, dim=1, keep_dim=True)),
                L.modified_huber_loss(L.reduce_sum(vec, dim=1, keep_dim=True),
                                      L.cast(lab, 'float32')),
                L.bilinear_tensor_product(vec, vec2, 3, act='tanh'),
                L.multiplex([vec, L.scale(vec, 2.0)], L.cast(lab, 'int32')),
                L.lod_reset(seq, target_lod=[0, 1, 3]),
                L.lod_reset(seq, y=offs),
                L.random_crop(img, [4, 5])]
        outs += list(L.unstack(seq, axis=1))
        outs += list(L.mean_iou(L.cast(lab, 'int32'), L.cast(lab, 'int32'),
                                3))
    return prog, startup, outs


def test_layers_build_the_jax_program():
    jprog, jstart, _ = _layers_program(jfluid, junique_name)
    tprog, tstart, _ = _layers_program(tfluid, tunique_name)
    assert tprog.to_string() == jprog.to_string()
    assert tstart.to_string() == jstart.to_string()


def test_layers_run_to_the_jax_values():
    """The layers' outputs (all but random_crop's draw) on one batch."""
    r = _r(30)
    feed = {'img': _f(31, 2, 3, 6, 8), 'lab': r.randint(0, 2, (2, 1)),
            'vec': _f(32, 2, 4), 'vec2': _f(33, 2, 5),
            'seq': _f(34, 3, 4), 'offs': np.array([0, 1, 1, 3], 'int32')}
    got = {}
    for fluid, unique_name in ((jfluid, junique_name),
                               (tfluid, tunique_name)):
        prog, startup, outs = _layers_program(fluid, unique_name)
        outs = [o for o in outs if 'random_crop' not in o.name]
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if fluid is tfluid:
            # the JAX package's initial weights
            tfluid.io.load_numpy_params(scope, params, tfluid.CPUPlace())
        else:
            params = {v.name: np.asarray(scope.find_var(v.name))
                      for v in prog.list_vars() if v.persistable and
                      scope.find_var(v.name) is not None}
        vals = exe.run(prog, feed=feed, fetch_list=outs, scope=scope)
        got[fluid] = [np.asarray(v) for v in vals]
    for w, g in zip(got[jfluid], got[tfluid]):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
