"""paddle_tpu_torch's learning-rate schedules against the JAX package.

Each of the six schedules of layers/learning_rate_scheduler.py, with its
staircase or cycle variants, is built in both packages; both programs
hold the same op types in the same order (the prepended increment of
the step counter first), and six runs on the CPU give the same rate at
every step, within 1e-5 relative (fp32, one op chain). The counter is
an int64 var that the increment writes back to the Scope every run.
polynomial_decay with power != 1 raises AttributeError in the JAX
package (its _pow_scalar_var calls the missing layers.ops.log), so the
port's is held to the closed form there.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

STEPS = 6
RTOL = 1e-5

SCHEDULES = [
    ('noam_decay', dict(d_model=64, warmup_steps=3)),
    ('exponential_decay', dict(learning_rate=0.1, decay_steps=2,
                               decay_rate=0.5, staircase=False)),
    ('exponential_decay', dict(learning_rate=0.1, decay_steps=2,
                               decay_rate=0.5, staircase=True)),
    ('natural_exp_decay', dict(learning_rate=0.1, decay_steps=2,
                               decay_rate=0.5, staircase=False)),
    ('natural_exp_decay', dict(learning_rate=0.1, decay_steps=2,
                               decay_rate=0.5, staircase=True)),
    ('inverse_time_decay', dict(learning_rate=0.1, decay_steps=2,
                                decay_rate=0.5, staircase=False)),
    ('inverse_time_decay', dict(learning_rate=0.1, decay_steps=2,
                                decay_rate=0.5, staircase=True)),
    ('polynomial_decay', dict(learning_rate=0.1, decay_steps=4,
                              end_learning_rate=0.01, power=1.0,
                              cycle=False)),
    ('polynomial_decay', dict(learning_rate=0.1, decay_steps=2,
                              end_learning_rate=0.01, power=1.0,
                              cycle=True)),
    ('piecewise_decay', dict(boundaries=[2, 4], values=[1.0, 0.5, 0.1])),
]


def _id(case):
    name, kw = case
    flags = [k for k in ('staircase', 'cycle') if kw.get(k)]
    if 'power' in kw and kw['power'] != 1.0:
        flags.append('power%g' % kw['power'])
    return '-'.join([name] + flags)


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


def _rates(fluid, name, kw):
    """The op types of the schedule's program, the rate of each of STEPS
    runs and the step counter after them."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        lr = getattr(fluid.layers, name)(**kw)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rates = [float(np.asarray(exe.run(prog, fetch_list=[lr],
                                      scope=scope)[0]).reshape(-1)[0])
             for _ in range(STEPS)]
    counter = int(np.asarray(fluid.fetch_var('@STEP_COUNTER@',
                                             scope=scope)).reshape(-1)[0])
    return [op.type for op in prog.global_block().ops], rates, counter


@pytest.mark.parametrize('case', SCHEDULES, ids=[_id(c) for c in SCHEDULES])
def test_schedule_matches_jax(case):
    name, kw = case
    want_ops, want, want_counter = _rates(jfluid, name, kw)
    got_ops, got, got_counter = _rates(tfluid, name, kw)
    assert got_ops == want_ops
    assert got_ops[0] == 'increment'
    assert got_counter == want_counter == STEPS
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert len(set(np.round(got, 12))) > 1    # the rate moves


def test_noam_decay_formula():
    """The port's noam rate at steps 1..6 is d^-0.5·min(s^-0.5,
    s·w^-1.5) (what chip_smoke's phase a2 holds the card to)."""
    _, got, _ = _rates(tfluid, 'noam_decay', dict(d_model=64,
                                                   warmup_steps=3))
    s = np.arange(1, STEPS + 1, dtype='float64')
    want = 64 ** -0.5 * np.minimum(s ** -0.5, s * 3 ** -1.5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_polynomial_decay_power_matches_closed_form():
    kw = dict(learning_rate=0.1, decay_steps=4, end_learning_rate=0.01,
              power=2.0, cycle=False)
    with pytest.raises(AttributeError, match='log'):
        _rates(jfluid, 'polynomial_decay', kw)
    ops, got, _ = _rates(tfluid, 'polynomial_decay', kw)
    assert 'log' in ops and 'exp' in ops
    s = np.minimum(np.arange(1, STEPS + 1, dtype='float64'), 4)
    want = (0.1 - 0.01) * (1 - s / 4) ** 2 + 0.01
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_step_counter_is_prepended_once_and_int64():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        tfluid.layers.fill_constant([1], 'float32', 1.0)
        a = tfluid.layers.autoincreased_step_counter()
        b = tfluid.layers.autoincreased_step_counter()
    ops = [op.type for op in prog.global_block().ops]
    assert a is b and a.dtype == 'int64' and a.persistable
    assert ops == ['increment', 'fill_constant']
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for step in range(1, 4):
        got, = exe.run(prog, fetch_list=[a], scope=scope)
        assert got.dtype == np.int64 and got.tolist() == [step]
