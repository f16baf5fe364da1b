"""paddle_tpu_torch's optimizers against the JAX package, on the CPU.

- Each of the nine update ops the port adds (adam, adagrad,
  decayed_adagrad, adamax, adadelta, rmsprop, ftrl, proximal_gd,
  proximal_adagrad) once on the same numpy inputs: every output within
  1e-5 of max(1, |ref|) (fp32, one op). Ftrl also twice from its fresh
  (zero) accumulators with exactly-zero gradient elements.
- Three steps of a two-layer fc net under each of the nine optimizer
  classes, the port's parameters loaded from the JAX package's
  (io.load_numpy_params): the same program text, then every parameter
  and every accumulator (moments, beta powers, the learning rate) after
  each step within 1e-4 of max(1, |ref|).
- Adam's lazy_mode=True gives the bits of lazy_mode=False on dense
  gradients; FLAGS_bf16_momentum creates a bf16 velocity in both
  packages and the flag is restored after.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

OP_TOL = 1e-5
STEP_TOL = 1e-4
N_STEPS = 3


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


def _close(got, want, tol):
    got, want = np.asarray(got, 'float64'), np.asarray(want, 'float64')
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= tol, err.max()


# -- one update op -------------------------------------------------------------

def _pos(r, *shape):
    return (r.rand(*shape) + 0.1).astype('float32')


def _update_cases():
    r = np.random.RandomState(3)
    shape = (4, 5)

    def f(*s):
        return r.randn(*s).astype('float32')
    lr = np.array([0.05], 'float32')
    return [
        ('adam', {'Moment1': f(*shape), 'Moment2': _pos(r, *shape),
                  'Beta1Pow': np.array([0.9 ** 3], 'f4'),
                  'Beta2Pow': np.array([0.999 ** 3], 'f4')},
         {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8,
          'lazy_mode': False},
         ['ParamOut', 'Moment1Out', 'Moment2Out', 'Beta1PowOut',
          'Beta2PowOut']),
        ('adagrad', {'Moment': _pos(r, *shape)}, {'epsilon': 1e-6},
         ['ParamOut', 'MomentOut']),
        ('decayed_adagrad', {'Moment': _pos(r, *shape)},
         {'decay': 0.95, 'epsilon': 1e-6}, ['ParamOut', 'MomentOut']),
        ('adamax', {'Moment': f(*shape), 'InfNorm': _pos(r, *shape),
                    'Beta1Pow': np.array([0.9 ** 2], 'f4')},
         {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8},
         ['ParamOut', 'MomentOut', 'InfNormOut']),
        ('adadelta', {'AvgSquaredGrad': _pos(r, *shape),
                      'AvgSquaredUpdate': _pos(r, *shape)},
         {'rho': 0.95, 'epsilon': 1e-6},
         ['ParamOut', 'AvgSquaredGradOut', 'AvgSquaredUpdateOut']),
        ('rmsprop', {'MeanSquare': _pos(r, *shape), 'Moment': f(*shape)},
         {'decay': 0.9, 'epsilon': 1e-6, 'momentum': 0.5},
         ['ParamOut', 'MeanSquareOut', 'MomentOut']),
        ('ftrl', {'SquaredAccumulator': _pos(r, *shape),
                  'LinearAccumulator': f(*shape)},
         {'l1': 0.1, 'l2': 0.2, 'lr_power': -0.5},
         ['ParamOut', 'SquaredAccumOut', 'LinearAccumOut']),
        ('ftrl', {'SquaredAccumulator': _pos(r, *shape),
                  'LinearAccumulator': f(*shape)},
         {'l1': 0.1, 'l2': 0.2, 'lr_power': -0.7},
         ['ParamOut', 'SquaredAccumOut', 'LinearAccumOut']),
        ('proximal_gd', {}, {'l1': 0.1, 'l2': 0.2}, ['ParamOut']),
        ('proximal_adagrad', {'Moment': _pos(r, *shape)},
         {'l1': 0.1, 'l2': 0.2}, ['ParamOut', 'MomentOut']),
    ], {'Param': f(*shape), 'Grad': f(*shape), 'LearningRate': lr}


UPDATE_CASES, UPDATE_COMMON = _update_cases()


def _run_update(fluid, op_type, accs, attrs, outs):
    inputs = dict(UPDATE_COMMON, **accs)
    prog = fluid.Program()
    block = prog.global_block()
    ins = {s: [block.create_var(name='in_' + s.lower(), shape=a.shape,
                                dtype='float32', is_data=True)]
           for s, a in inputs.items()}
    out_vars = {s: [block.create_var(name='out_' + s.lower())]
                for s in outs}
    block.append_op(type=op_type, inputs=ins, outputs=out_vars, attrs=attrs)
    return fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={v[0].name: inputs[s].copy() for s, v in ins.items()},
        fetch_list=['out_' + s.lower() for s in outs], scope=fluid.Scope())


def test_ftrl_zero_gradient_on_a_fresh_accumulator_matches_jax():
    """Ftrl creates its squared accumulator filled with 0: an element
    whose gradient is exactly 0 on the first step (an embedding row not
    in the batch, a dead ReLU unit) takes sigma = 0 there, as the JAX
    package's sqrt(new) - sqrt(old) does, and its linear accumulator
    moves on the next step."""
    r = np.random.RandomState(4)
    shape = (4, 5)
    param = r.randn(*shape).astype('float32')
    grads = [r.randn(*shape).astype('float32') for _ in range(2)]
    grads[0].flat[::3] = 0.0
    attrs = {'l1': 0.01, 'l2': 0.01, 'lr_power': -0.5}
    outs = ['ParamOut', 'SquaredAccumOut', 'LinearAccumOut']
    res = {}
    for fluid in (jfluid, tfluid):
        state = [param, np.zeros(shape, 'float32'),
                 np.zeros(shape, 'float32')]
        steps = []
        for g in grads:
            accs = {'Param': state[0], 'Grad': g,
                    'SquaredAccumulator': state[1],
                    'LinearAccumulator': state[2]}
            state = [np.asarray(o) for o in
                     _run_update(fluid, 'ftrl', accs, attrs, outs)]
            steps.append(state)
        res[fluid] = steps
    for got, want in zip(res[tfluid], res[jfluid]):
        for g, w in zip(got, want):
            assert np.isfinite(g).all()
            _close(g, w, OP_TOL)
    zero = res[tfluid][0][1] == 0          # no gradient yet
    assert zero.sum() == grads[0].size // 3 + 1
    assert (res[tfluid][1][2][zero] != 0).all()   # the linear one moves


@pytest.mark.parametrize('case', UPDATE_CASES,
                         ids=['%s-%d' % (c[0], i)
                              for i, c in enumerate(UPDATE_CASES)])
def test_update_op_matches_jax(case):
    want = _run_update(jfluid, *case)
    got = _run_update(tfluid, *case)
    assert case[3][0] == 'ParamOut' and len(got) == len(case[3])
    for g, w in zip(got, want):
        _close(g, w, OP_TOL)
    assert np.abs(np.asarray(want[0]) - UPDATE_COMMON['Param']).max() > 0


# -- three steps of a two-layer net --------------------------------------------

OPTIMIZERS = [
    ('Adam', dict(learning_rate=0.01)),
    ('Adagrad', dict(learning_rate=0.1)),
    ('Adamax', dict(learning_rate=0.01)),
    ('DecayedAdagrad', dict(learning_rate=0.1)),
    ('Adadelta', dict(learning_rate=0.1)),
    ('RMSProp', dict(learning_rate=0.01, momentum=0.5)),
    ('Ftrl', dict(learning_rate=0.1, l1=0.01, l2=0.01)),
    ('ProximalGD', dict(learning_rate=0.1, l1_regularization_strength=0.01,
                        l2_regularization_strength=0.01)),
    ('ProximalAdagrad', dict(learning_rate=0.1,
                             l1_regularization_strength=0.01,
                             l2_regularization_strength=0.01)),
]


def _batches():
    r = np.random.RandomState(5)
    w = r.randn(6, 1).astype('float32')
    out = []
    for _ in range(N_STEPS):
        x = r.randn(8, 6).astype('float32')
        out.append({'x': x, 'y': np.tanh(x @ w)})
    return out


def _net(fluid, opt_name, kw):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[6], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        h = fluid.layers.fc(input=x, size=8, act='tanh')
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        getattr(fluid.optimizer, opt_name)(**kw).minimize(loss)
    return prog, startup, loss


def _persistables(prog, scope):
    return [v.name for v in prog.list_vars()
            if v.persistable and scope.find_var(v.name) is not None]


def _jax_steps(opt_name, kw):
    prog, startup, loss = _net(jfluid, opt_name, kw)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = _persistables(prog, scope)
    init = {n: np.array(scope.find_var(n)) for n in names}
    states = []
    for feed in _batches():
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        states.append({n: np.array(scope.find_var(n)) for n in names})
    return prog, init, states


@pytest.mark.parametrize('opt', OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_three_steps_match_jax(opt):
    jprog, init, states = _jax_steps(*opt)
    prog, startup, loss = _net(tfluid, *opt)
    assert prog.to_string() == jprog.to_string()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace(), program=prog)
    names = _persistables(prog, scope)
    assert sorted(names) == sorted(init)
    n_acc = len(names) - 4                 # two weights, two biases
    assert n_acc >= 1                      # at least the learning rate
    for feed, want in zip(_batches(), states):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        for n in names:
            _close(scope.find_var(n).numpy(), want[n], STEP_TOL)
    moved = [n for n in names
             if np.abs(states[-1][n] - init[n]).max() > 0]
    assert any(n.startswith('fc_0.w') for n in moved)


def _adam_state(lazy):
    prog, startup, loss = _net(tfluid, 'Adam', dict(learning_rate=0.01,
                                                    lazy_mode=lazy))
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for feed in _batches():
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    return {n: scope.find_var(n).numpy() for n in _persistables(prog, scope)}


def test_adam_lazy_mode_equals_dense_update():
    lazy, dense = _adam_state(True), _adam_state(False)
    assert sorted(lazy) == sorted(dense)
    for n in dense:
        np.testing.assert_array_equal(lazy[n], dense[n], err_msg=n)


def test_bf16_momentum_creates_a_bf16_velocity_in_both_packages():
    prev = jfluid.get_flags(['FLAGS_bf16_momentum']), \
        tfluid.get_flags(['FLAGS_bf16_momentum'])
    jfluid.set_flags({'FLAGS_bf16_momentum': True})
    tfluid.set_flags({'FLAGS_bf16_momentum': True})
    try:
        progs = [_net(f, 'Momentum', dict(learning_rate=0.1, momentum=0.9))
                 for f in (jfluid, tfluid)]
    finally:
        jfluid.set_flags(prev[0])
        tfluid.set_flags(prev[1])
    assert tfluid.get_flag('bf16_momentum') is False
    assert progs[0][0].to_string() == progs[1][0].to_string()
    prog, startup, loss = progs[1]
    vel = [v for v in prog.list_vars() if 'velocity' in v.name]
    assert len(vel) == 4 and all(v.dtype == 'bfloat16' for v in vel)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for feed in _batches():
        got, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        assert np.isfinite(got).all()
    import torch
    for v in vel:
        t = scope.find_var(v.name)
        assert t.dtype == torch.bfloat16 and t.abs().max() > 0
