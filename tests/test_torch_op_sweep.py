"""Every op type of the port against the JAX package, forward and grads.

- The sweep: every case of the JAX package's grad sweep
  (test_op_grad_sweep.CONFIGS) whose op type the port registers, plus
  cases of this file's own for op types CONFIGS lacks (elementwise_sub,
  the reduce ops' dim / keep_dim / reduce_all, one_hot, range,
  increment, the two cross-entropy ops, the comparisons and logical
  ops, ...). Each case is a one-op program built the same way in both
  packages from the same numpy inputs; on the CPU its outputs, and the
  grads of the inputs the case checks against a fixed cotangent, must
  agree with the JAX package's within 1e-5 (fp32, one op). Integer and
  bool outputs are compared by value: the JAX package runs with x64 off
  and returns int32 where the port keeps the int64 the Program declares.
- dropout: is_test in both implementations, and the dropout_grad op on
  a fed Mask; truncated_gaussian_random's draw.
- Completeness: every non-grad op type in the port's registry is in the
  sweep, in test_torch_ops.py / test_torch_training.py, or in
  COVERED_ELSEWHERE (each entry names a test that must exist) or
  EXCEPTIONS, with its reason.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import registry as tregistry
from paddle_tpu_torch import unique_name as tunique_name
from test_op_grad_sweep import CONFIGS

ATOL = RTOL = 1e-5


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


def _f(r, *shape):
    return r.randn(*shape).astype('float32')


def _own_configs():
    """Cases for op types (and attrs) that CONFIGS lacks."""
    r = np.random.RandomState(11)
    x = _f(r, 3, 4)
    x234 = _f(r, 2, 3, 4)
    labels = np.array([[0], [3], [-100], [1]], 'int64')
    soft = np.abs(_f(r, 4, 5))
    soft /= soft.sum(-1, keepdims=True)
    cfg = {}

    def add(name, op_type, **kw):
        kw.setdefault('attrs', {})
        kw['type'] = op_type
        cfg[name] = kw

    add('elementwise_sub', 'elementwise_sub',
        inputs={'X': x234, 'Y': _f(r, 3)}, attrs={'axis': 1},
        check=['X', 'Y'])
    add('elementwise_sub-trailing', 'elementwise_sub',
        inputs={'X': x234, 'Y': _f(r, 4)}, attrs={'axis': -1},
        check=['X', 'Y'])
    add('elementwise_mul', 'elementwise_mul',
        inputs={'X': x234, 'Y': _f(r, 2, 3)}, attrs={'axis': 0},
        check=['X', 'Y'])
    add('elementwise_div', 'elementwise_div',
        inputs={'X': x, 'Y': np.abs(_f(r, 3, 4)) + 0.5},
        attrs={'axis': -1}, check=['X', 'Y'])
    add('elementwise_add', 'elementwise_add',
        inputs={'X': x, 'Y': _f(r, 3, 4)}, check=['X', 'Y'])
    add('elementwise_floordiv-int', 'elementwise_floordiv',
        inputs={'X': np.array([7, -7, 9, -1], 'int64'),
                'Y': np.array([2, 2, -4, 3], 'int64')})
    add('elementwise_mod-int', 'elementwise_mod',
        inputs={'X': np.array([7, -7, 9, -1], 'int64'),
                'Y': np.array([2, 2, -4, 3], 'int64')})
    for red in ('sum', 'mean', 'max', 'min', 'prod'):
        add('reduce_%s-dim0-keep' % red, 'reduce_' + red,
            inputs={'X': x234 + 2.0}, attrs={'dim': [0], 'keep_dim': True},
            check=['X'])
        add('reduce_%s-all' % red, 'reduce_' + red,
            inputs={'X': x + 2.0 if red == 'prod' else x},
            attrs={'dim': [0], 'keep_dim': False, 'reduce_all': True},
            check=['X'])
    add('reduce_sum-dims', 'reduce_sum', inputs={'X': x234},
        attrs={'dim': [0, -1], 'keep_dim': False}, check=['X'])
    add('reduce_mean-last', 'reduce_mean', inputs={'X': x234},
        attrs={'dim': [-1], 'keep_dim': False}, check=['X'])
    add('one_hot', 'one_hot',
        inputs={'X': np.array([[1], [0], [4]], 'int64')},
        attrs={'depth': 5})
    add('range', 'range', attrs={'start': 2, 'end': 11, 'step': 3,
                                 'dtype': 'int64'})
    add('range-float', 'range', attrs={'start': 0.5, 'end': 2.0,
                                       'step': 0.25, 'dtype': 'float32'})
    add('increment', 'increment', inputs={'X': np.array([2.5], 'f4')},
        attrs={'step': 1.5})
    add('increment-int64', 'increment',
        inputs={'X': np.array([4], 'int64')}, attrs={'step': 1.0})
    add('softmax_with_cross_entropy', 'softmax_with_cross_entropy',
        inputs={'Logits': _f(r, 4, 5) * 2, 'Label': labels},
        attrs={'soft_label': False, 'ignore_index': -100},
        outputs={'Softmax': ['swce_sm'], 'Loss': ['swce_loss']},
        check=['Logits'], kwargs={'output_names': 'swce_loss'})
    add('softmax_with_cross_entropy-soft', 'softmax_with_cross_entropy',
        inputs={'Logits': _f(r, 4, 5), 'Label': soft},
        attrs={'soft_label': True},
        outputs={'Softmax': ['swce_sm'], 'Loss': ['swce_loss']},
        check=['Logits'], kwargs={'output_names': 'swce_loss'})
    add('sigmoid_cross_entropy_with_logits',
        'sigmoid_cross_entropy_with_logits',
        inputs={'X': _f(r, 4, 3) * 3,
                'Label': np.array([[0, 1, -100], [1, 1, 0], [0, 0, 1],
                                   [1, -100, 0]], 'float32')},
        attrs={'ignore_index': -100}, check=['X'])
    y = np.where(r.rand(3, 4) < 0.3, x, _f(r, 3, 4))
    for cmp in ('less_than', 'less_equal', 'greater_than', 'greater_equal',
                'equal', 'not_equal'):
        add(cmp, cmp, inputs={'X': x, 'Y': y})
    b1, b2 = r.rand(3, 4) < 0.5, r.rand(3, 4) < 0.5
    for lg in ('logical_and', 'logical_or', 'logical_xor'):
        add(lg, lg, inputs={'X': b1, 'Y': b2})
    add('logical_not', 'logical_not', inputs={'X': b1})
    add('isfinite', 'isfinite',
        inputs={'X': [('fin_a', x), ('fin_b', y)]})
    xinf = x.copy()
    xinf[1, 2] = np.inf
    add('isfinite-inf', 'isfinite',
        inputs={'X': [('fin_a', x), ('fin_b', xinf)]})
    add('argsort', 'argsort', inputs={'X': _f(r, 3, 6)}, attrs={'axis': -1},
        outputs={'Out': ['as_out'], 'Indices': ['as_idx']})
    add('argsort-axis0', 'argsort', inputs={'X': _f(r, 5, 3)},
        attrs={'axis': 0}, outputs={'Out': ['as_out'], 'Indices': ['as_idx']})
    add('shape', 'shape', inputs={'Input': x234},
        outputs={'Out': ['shape_out']})
    add('assign_value', 'assign_value',
        attrs={'shape': [2, 3], 'dtype': 'float32',
               'values': [0.5, -1.0, 2.0, 3.5, 0.0, 1.25]})
    add('assign_value-int', 'assign_value',
        attrs={'shape': [3], 'dtype': 'int64', 'values': [4, -2, 7]})
    add('cast-to-int', 'cast', inputs={'X': x * 3},
        attrs={'in_dtype': 'float32', 'out_dtype': 'int64'})
    add('cast-from-int', 'cast',
        inputs={'X': np.array([[3, -1], [0, 5]], 'int64')},
        attrs={'in_dtype': 'int64', 'out_dtype': 'float32'})
    add('cumsum-exclusive-reverse', 'cumsum', inputs={'X': x},
        attrs={'axis': 1, 'exclusive': True, 'reverse': True}, check=['X'])
    add('fill_zeros_like', 'fill_zeros_like', inputs={'X': x})
    add('split-sections', 'split', inputs={'X': _f(r, 5, 4)},
        attrs={'sections': [2, 3], 'axis': 0},
        outputs={'Out': ['sp_a', 'sp_b']}, check=['X'])
    add('squeeze-all', 'squeeze', inputs={'X': x.reshape(3, 1, 4, 1)},
        attrs={'axes': []}, check=['X'])
    add('scatter-add', 'scatter',
        inputs={'X': x, 'Ids': np.array([2, 0], 'int64'),
                'Updates': _f(r, 2, 4)},
        attrs={'overwrite': False}, check=['X', 'Updates'])
    add('label_smooth-prior', 'label_smooth',
        inputs={'X': soft, 'PriorDist': np.full((1, 5), 0.2, 'f4')},
        attrs={'epsilon': 0.2}, check=['X'])
    add('pad-3d', 'pad', inputs={'X': x234},
        attrs={'paddings': [0, 1, 2, 0, 1, 1], 'pad_value': -1.5},
        check=['X'])
    for act, attrs in (('hard_sigmoid', {}), ('leaky_relu', {}),
                       ('stanh', {}), ('softshrink', {}),
                       ('brelu', {}), ('thresholded_relu', {})):
        add(act + '-defaults', act, inputs={'X': x * 4}, attrs=attrs,
            check=['X'])
    add('round-half-even', 'round',
        inputs={'X': np.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49], 'f4')})
    return cfg


def _cases():
    registered = tregistry._REGISTRY
    cases = []
    for op_type, cfg in sorted(CONFIGS.items()):
        if op_type in registered:
            cases.append((op_type, dict(cfg, type=op_type)))
    cases += sorted(_own_configs().items())
    return cases


CASES = _cases()


def _inputs(cfg):
    """[(slot, var name, array)] of a case."""
    out = []
    for slot, val in cfg.get('inputs', {}).items():
        if isinstance(val, list):
            out += [(slot, name, arr) for name, arr in val]
        else:
            out.append((slot, 'in_' + slot.lower(), val))
    return out


def _outputs(cfg):
    """{slot: [var names]} of a case (default: Out -> 'out')."""
    outs = cfg.get('outputs') or {'Out': ['out']}
    return {slot: [n[0] if isinstance(n, tuple) else n for n in names]
            for slot, names in outs.items()}


def _checked(cfg):
    by_slot = {slot: name for slot, name, arr in _inputs(cfg)
               if not isinstance(cfg['inputs'][slot], list)}
    return [by_slot.get(c, c) for c in cfg.get('check', [])]


def _run_case(fluid, cfg):
    """Forward outputs and the checked inputs' grads of one op, by var
    name, as numpy arrays."""
    prog = fluid.Program()
    block = prog.global_block()
    checked = _checked(cfg)
    feed, ins = {}, {}
    for slot, name, arr in _inputs(cfg):
        arr = np.asarray(arr)
        ins.setdefault(slot, []).append(block.create_var(
            name=name, shape=arr.shape, dtype=arr.dtype.name, is_data=True,
            stop_gradient=name not in checked))
        feed[name] = arr.copy()
    outs = {slot: [block.create_var(name=n) for n in names]
            for slot, names in _outputs(cfg).items()}
    fetch = [n for names in _outputs(cfg).values() for n in names]
    with fluid.program_guard(prog, fluid.Program()):
        block.append_op(type=cfg['type'], inputs=ins, outputs=outs,
                        attrs=dict(cfg.get('attrs', {})))
        if checked:
            target_name = cfg.get('kwargs', {}).get('output_names')
            targets = [block.var(target_name)] if target_name else \
                [v for v in outs.get('Out', outs.get('Y', []))]
            cots = []
            for i, t in enumerate(targets):
                cot = block.create_var(name='cot_%d' % i, shape=t.shape,
                                       dtype='float32', is_data=True,
                                       stop_gradient=True)
                feed[cot.name] = np.asarray(np.random.RandomState(
                    1 + i).randn(*t.shape), 'float32')
                cots.append(cot)
            grads = fluid.backward.calc_gradient(
                targets, [block.var(n) for n in checked],
                target_gradients=cots)
            fetch += [g.name for g in grads]
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
    return {n: np.asarray(g) for n, g in zip(fetch, got)}


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    name, cfg = case
    want = _run_case(jfluid, cfg)
    got = _run_case(tfluid, cfg)
    assert sorted(got) == sorted(want)
    assert any(n.endswith('@GRAD') for n in got) == bool(cfg.get('check'))
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            assert g.dtype.kind == w.dtype.kind, (n, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(g, w.astype('float32'), atol=ATOL,
                                       rtol=RTOL, err_msg=n)


# -- dropout -------------------------------------------------------------------

def _dropout_forward(fluid, x, impl, is_test):
    prog = fluid.Program()
    block = prog.global_block()
    xv = block.create_var(name='x', shape=x.shape, dtype='float32',
                          is_data=True)
    out, mask = block.create_var(name='out'), block.create_var(name='mask')
    block.append_op(type='dropout', inputs={'X': [xv]},
                    outputs={'Out': [out], 'Mask': [mask]},
                    attrs={'dropout_prob': 0.3, 'is_test': is_test,
                           'seed': 0, 'dropout_implementation': impl})
    return fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'x': x}, fetch_list=['out', 'mask'], scope=fluid.Scope())


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_is_test_matches_jax(impl):
    x = _f(np.random.RandomState(2), 4, 6)
    want = _dropout_forward(jfluid, x, impl, True)
    got = _dropout_forward(tfluid, x, impl, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('impl', ['downgrade_in_infer', 'upscale_in_train'])
def test_dropout_training_draw(impl):
    """The port's own draw: kept entries are x (or x / (1 - p)), the rest
    0, the Mask says which, and the kept share is near 1 - p."""
    x = _f(np.random.RandomState(3), 200, 50) + 5.0
    out, mask = _dropout_forward(tfluid, x, impl, False)
    keep = mask > 0
    scale = 1.0 / 0.7 if impl == 'upscale_in_train' else 1.0
    np.testing.assert_array_equal(out[~keep], 0.0)
    np.testing.assert_allclose(out[keep], (x / 0.7 if scale != 1.0
                                           else x)[keep], rtol=1e-6)
    np.testing.assert_allclose(mask[keep], scale, rtol=1e-6)
    assert abs(keep.mean() - 0.7) < 0.02


def _dropout_grad(fluid, mask, dout):
    prog = fluid.Program()
    block = prog.global_block()
    m = block.create_var(name='mask', shape=mask.shape, dtype='float32',
                         is_data=True)
    g = block.create_var(name='dout', shape=dout.shape, dtype='float32',
                         is_data=True)
    dx = block.create_var(name='dx')
    block.append_op(type='dropout_grad',
                    inputs={'Mask': [m], 'Out@GRAD': [g]},
                    outputs={'X@GRAD': [dx]},
                    attrs={'dropout_prob': 0.3, 'is_test': False})
    return fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'mask': mask, 'dout': dout}, fetch_list=['dx'],
        scope=fluid.Scope())[0]


def test_dropout_grad_on_a_fed_mask_matches_jax():
    r = np.random.RandomState(4)
    mask = (r.rand(5, 7) < 0.6).astype('float32') / 0.6
    dout = _f(r, 5, 7)
    want = _dropout_grad(jfluid, mask, dout)
    got = _dropout_grad(tfluid, mask, dout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, dout * mask, rtol=1e-6)


def test_dropout_layer_trains_through_its_mask():
    """layers.dropout in a program with a backward: X@GRAD = dOut·Mask."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[8], dtype='float32',
                               stop_gradient=False)
        y = tfluid.layers.dropout(x, dropout_prob=0.5, seed=7,
                                  dropout_implementation='upscale_in_train')
        loss = tfluid.layers.reduce_sum(y)
        grad, = tfluid.backward.calc_gradient([loss], [x])
    mask_name = [op for op in prog.global_block().ops
                 if op.type == 'dropout'][0].output('Mask')[0]
    xb = np.ones((4, 8), 'float32')
    g, m = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed={'x': xb}, fetch_list=[grad, mask_name],
        scope=tfluid.Scope())
    np.testing.assert_array_equal(g, m)
    assert set(np.unique(m)) <= {0.0, 2.0} and 0 < (m > 0).mean() < 1


def test_truncated_gaussian_random_draw():
    def draw(seed):
        prog = tfluid.Program()
        prog.random_seed = seed
        block = prog.global_block()
        block.append_op(type='truncated_gaussian_random',
                        outputs={'Out': [block.create_var(name='w')]},
                        attrs={'shape': [300, 200], 'mean': 1.0,
                               'std': 0.5, 'dtype': 'float32'})
        return tfluid.Executor(tfluid.CPUPlace()).run(
            prog, fetch_list=['w'], scope=tfluid.Scope())[0]
    a, b = draw(5), draw(5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (300, 200) and a.dtype == np.float32
    assert a.min() >= 1.0 - 2 * 0.5 and a.max() <= 1.0 + 2 * 0.5
    assert abs(a.mean() - 1.0) < 0.01
    # a normal truncated at 2 sigma keeps 0.8796 of its std
    assert abs(a.std() - 0.5 * 0.8796) < 0.01


# -- completeness ---------------------------------------------------------------

# op -> (test module, test name, why): each named test must exist
COVERED_ELSEWHERE = {
    'sgd': ('test_torch_training', 'test_optimizer_update_matches_jax',
            'update parity'),
    'momentum': ('test_torch_training', 'test_optimizer_update_matches_jax',
                 'update parity'),
    'conv2d': ('test_torch_resnet', 'test_op_forward_and_grad_match_jax',
               'forward and grads, one-op programs'),
    'depthwise_conv2d': ('test_torch_resnet',
                         'test_op_forward_and_grad_match_jax',
                         'forward and grads, one-op programs'),
    'pool2d': ('test_torch_resnet', 'test_op_forward_and_grad_match_jax',
               'forward and grads, one-op programs'),
    'batch_norm': ('test_torch_resnet', 'test_op_forward_and_grad_match_jax',
                   'forward and grads in train and test mode'),
    'accuracy': ('test_torch_resnet', 'test_op_forward_and_grad_match_jax',
                 'top_k + accuracy case'),
    'top_k': ('test_torch_resnet', 'test_op_forward_and_grad_match_jax',
              'top_k + accuracy case'),
    'conv2d_bn': ('test_torch_resnet', 'test_conv2d_bn_activation_matches_jax',
                  'the fused op under every activation'),
    'save': ('test_torch_ops', 'test_save_load_ops_round_trip', 'round trip'),
    'load': ('test_torch_ops', 'test_save_load_ops_round_trip', 'round trip'),
    'save_combine': ('test_torch_ops', 'test_save_load_ops_round_trip',
                     'round trip'),
    'load_combine': ('test_torch_ops', 'test_save_load_ops_round_trip',
                     'round trip'),
    'uniform_random': ('test_torch_ops', 'test_random_initializer',
                       "torch's stream is not jax.random's: moments"),
    'gaussian_random': ('test_torch_ops', 'test_random_initializer',
                        "torch's stream is not jax.random's: moments"),
    'truncated_gaussian_random': ('test_torch_op_sweep',
                                  'test_truncated_gaussian_random_draw',
                                  "torch's stream is not jax.random's"),
    'read': ('test_torch_training', 'test_lm_momentum_steps_match_jax',
             'py_reader feeds the LM steps'),
}
for _t in ('adam', 'adagrad', 'decayed_adagrad', 'adamax', 'adadelta',
           'rmsprop', 'ftrl', 'proximal_gd', 'proximal_adagrad'):
    COVERED_ELSEWHERE[_t] = ('test_torch_optimizers',
                             'test_update_op_matches_jax', 'update parity')
COVERED_ELSEWHERE['remat_block'] = (
    'test_torch_recompute', 'test_adam_steps_match_the_jax_package',
    'LM steps with every block a remat scope, and its grad, vs the JAX '
    'package')

EXCEPTIONS = {
    'reshape_grad_helper': 'the grad op of reshape2 and reshape, run by '
                           'their grad cases in this sweep',
}


def _module_op_types(module, attr):
    return {c[0] for c in getattr(importlib.import_module(module), attr)}


def test_every_op_type_is_covered():
    registered = {t for t in tregistry._REGISTRY if not t.endswith('_grad')}
    swept = {cfg['type'] for _, cfg in CASES}
    elsewhere = _module_op_types('test_torch_ops', 'CASES') | \
        _module_op_types('test_torch_training', 'GRAD_CASES')
    for op_type, (module, test, why) in COVERED_ELSEWHERE.items():
        assert hasattr(importlib.import_module(module), test), \
            (op_type, module, test)
    missing = registered - swept - elsewhere - set(COVERED_ELSEWHERE) - \
        set(EXCEPTIONS)
    assert not missing, sorted(missing)
    stale = (set(COVERED_ELSEWHERE) | set(EXCEPTIONS)) - registered
    assert not stale, sorted(stale)
