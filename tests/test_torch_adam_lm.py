"""The training core slice as a whole, against the JAX package on the CPU.

- Variable operators (layers/math_op_patch.py): `x + 1.0`, `2.0 * x`,
  `x ** -0.5`, `x >= y`, `-x` and the rest append the same op types
  and attrs in both packages, and compute the same values.
- The Transformer recipe a Fluid user ran, on a small LM (L2, D64, H4
  so the head dim is 16, F128, V256, T32) with flash_attention=True:
  py_reader feed, fused LM head, mean, Adam(noam_decay(64, 25), beta1
  0.9, beta2 0.98, epsilon 1e-9) with GradientClipByGlobalNorm(1.0)
  set by set_gradient_clip; three steps in fp32 and under bf16 AMP
  from the JAX package's initial weights. The attention runs the plain
  version on the CPU in both packages (head dim 16 is no kernel shape
  in either). The programs hold the same op types in the same order
  and the same persistable vars. (Their texts differ in the global-norm
  clip's last four ops: the port tags them op_role=backward, as it does
  the clip's other ops, so that clone(for_test) strips them; the JAX
  package leaves them untagged, and its clone(for_test) of such a
  program fails at run time.) Per-step losses agree within 1e-4 (fp32)
  or 2e-2 (AMP), the step counter exactly, and each beta power is
  beta^(steps + 1). In fp32 every parameter's update and every Adam
  accumulator agree within 1e-4 relative (norm of the difference over
  the norm of the reference; the key third of each qkv bias is left
  out, KEY_BIASES says why); under AMP the moments, the updates weighted
  by the gradient and the parameters within 2e-2 (_check_amp says how).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import transformer as ttransformer
from test_torch_training import LM_STEPS, _train

CFG = dict(vocab=256, dim=64, heads=4, layers=2, ffn=128, max_len=32,
           flash_attention=True)
CHUNK = 32
TOL = {False: 1e-4, True: 2e-2}          # keyed by AMP
# the qkv biases: a bias on the keys adds q·b to every score of a row, a
# shift the softmax does not see, so the key third of each bias has a
# zero gradient in exact arithmetic and rounding noise in either
# package, which Adam at epsilon 1e-9 turns into steps of +-lr
KEY_BIASES = ('layer0_qkv.w_0', 'layer1_qkv.w_0')


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


# -- Variable operators ----------------------------------------------------------

def _patched(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[3], dtype='float32')
        y = fluid.layers.data(name='y', shape=[3], dtype='float32')
        outs = [x + 1.0, 2.0 * x, x ** -0.5, x >= y, -x, x - y, 1.0 - x,
                x * y, x / 4.0, 3.0 / x, x % 0.7, x < y, x <= y, x > y]
    return prog, outs


def test_variable_operators_append_the_jax_ops():
    jprog, _ = _patched(jfluid)
    tprog, outs = _patched(tfluid)
    assert tprog.to_string() == jprog.to_string()
    types_ = [op.type for op in tprog.global_block().ops]
    for t in ('elementwise_add', 'elementwise_mul', 'elementwise_pow',
              'greater_equal', 'scale', 'elementwise_sub',
              'elementwise_mod', 'less_than'):
        assert t in types_
    neg = [op for op in tprog.global_block().ops if op.type == 'scale'][0]
    assert neg.attr('scale') == -1.0 and neg.attr('bias') == 0.0


def test_variable_operators_compute_the_jax_values():
    r = np.random.RandomState(0)
    feed = {'x': (r.rand(4, 3) + 0.2).astype('float32'),
            'y': (r.rand(4, 3) + 0.2).astype('float32')}
    res = []
    for fluid in (jfluid, tfluid):
        prog, outs = _patched(fluid)
        res.append(fluid.Executor(fluid.CPUPlace()).run(
            prog, feed=feed, fetch_list=outs, scope=fluid.Scope()))
    for w, g in zip(*res):
        w, g = np.asarray(w), np.asarray(g)
        if w.dtype == np.bool_:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- the LM under AMP Adam + noam_decay + global-norm clip ------------------------

def _build(fluid, unique_name, transformer, amp):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 5
    cfg = transformer.TransformerConfig(**CFG)
    with unique_name.guard(), fluid.program_guard(prog, startup):
        rdr = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, cfg.max_len, 1), (-1, cfg.max_len, 1)],
            dtypes=['int64', 'int64'], name='adam_reader',
            use_double_buffer=True)
        tokens, labels = fluid.layers.read_file(rdr)
        trunk = transformer.language_model_trunk(tokens, cfg)
        cost = fluid.layers.fused_softmax_cross_entropy(
            trunk, labels, cfg.vocab, chunk=CHUNK, name='lm_head')
        avg = fluid.layers.mean(cost)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0))
        lr = fluid.layers.noam_decay(d_model=cfg.dim, warmup_steps=25)
        opt = fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                                   epsilon=1e-9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg)
    return prog, startup, rdr, avg, lr


def _state(scope, names, as_numpy):
    return {n: as_numpy(scope.find_var(n)) for n in names}


@pytest.fixture(scope='module')
def jax_adam_runs():
    out = {}
    for amp in (False, True):
        with jfluid.program_guard(jfluid.Program(), jfluid.Program()):
            prog, startup, rdr, avg, _ = _build(jfluid, junique_name,
                                                jtransformer, amp)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            names = [v.name for v in prog.list_vars() if v.persistable
                     and scope.find_var(v.name) is not None]
            init = _state(scope, names, np.array)
            losses = _train(lambda **kw: exe.run(prog, **kw), rdr, avg,
                            jfluid, CFG)
            final = _state(scope, names, np.array)
        out[amp] = dict(init=init, final=final, losses=losses,
                        types=[op.type for op in prog.global_block().ops])
    return out


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _check_fp32(got, ref, params, accs):
    """Every parameter's update and every accumulator within 1e-4."""
    tol = TOL[False]
    for name in sorted(params):
        want = ref['final'][name] - ref['init'][name]
        upd = got[name] - ref['init'][name]
        if name in KEY_BIASES:
            # leave out the key third, whose gradient is rounding noise
            d = CFG['dim']
            want, upd = (np.concatenate([a[:d], a[2 * d:]])
                         for a in (want, upd))
        assert np.abs(want).max() > 0, name
        assert _rel(upd, want) <= tol, name
    for name in accs:
        assert _rel(got[name], np.asarray(ref['final'][name], 'float32')) \
            <= tol, name


def _moment1(accs, param):
    name, = [n for n in accs if n.startswith(param + '_moment1_')]
    return name


def _first_order_rel(upd, want, weight):
    """sum |g|·|upd - want| over sum |g|·|want|: how far the update's
    first-order effect on the loss, g·upd, may stray from the reference
    update's, element by element, with g taken as `weight`. 1 for an
    update of 0, 2 for the reference update reversed."""
    return float(np.sum(weight * np.abs(upd - want)) /
                 max(np.sum(weight * np.abs(want)), 1e-30))


def _check_amp(got, ref, params, accs):
    """Under AMP the two packages round to bf16 at other places, and
    Adam's step, lr·m/sqrt(v), is about lr·sign(g) for an element whose
    gradient is below that rounding: such elements step the other way in
    the other package, and elements with small gradients step by other
    amounts, so updates are not compared element by element, nor by an
    unweighted norm, which weighs those elements as much as any (about
    4e-2 here). The gradients are compared through the moments (all of
    them, as one vector, within 2e-2); the updates of all parameters, as
    one vector, each element weighted by the reference's |first moment|
    (_first_order_rel, within 2e-2); and every parameter stays within
    2e-2 of max(1, |ref|) after the three steps."""
    tol = TOL[True]
    for kind in ('moment1', 'moment2'):
        names = sorted(n for n in accs if kind in n)
        assert names
        g, w = (np.concatenate([np.asarray(src[n], 'float32').ravel()
                                for n in names])
                for src in (got, ref['final']))
        assert _rel(g, w) <= tol, kind
    for name in sorted(params):
        want = ref['final'][name]
        assert np.abs(want - ref['init'][name]).max() > 0, name
        err = np.abs(got[name] - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= tol, name
    upd, want, weight = (np.concatenate([np.asarray(v, 'float32').ravel()
                                         for v in vs]) for vs in zip(*(
        (got[n] - ref['init'][n], ref['final'][n] - ref['init'][n],
         np.abs(ref['final'][_moment1(accs, n)])) for n in sorted(params))))
    assert _first_order_rel(upd, want, weight) <= tol



@pytest.mark.parametrize('amp', [False, True], ids=['fp32', 'amp_bf16'])
def test_adam_noam_clip_steps_match_jax(jax_adam_runs, amp):
    ref = jax_adam_runs[amp]
    prog, startup, rdr, avg, _ = _build(tfluid, tunique_name,
                                        ttransformer, amp)
    types_ = [op.type for op in prog.global_block().ops]
    assert types_ == ref['types']
    assert types_[0] == 'increment' and 'adam' in types_ and \
        'flash_attention' in types_ and 'sqrt' in types_
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, ref['init'], tfluid.CPUPlace(),
                                program=prog)
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=avg.name,
                                 main_program=prog, scope=scope)
    losses = _train(pe.run, rdr, avg, tfluid, CFG)
    tol = TOL[amp]
    assert len(losses) == LM_STEPS and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref['losses'], atol=tol, rtol=0)
    assert sorted(v.name for v in prog.list_vars() if v.persistable and
                  scope.find_var(v.name) is not None) == sorted(ref['final'])
    got = _state(scope, list(ref['final']), lambda t: t.numpy())
    params = {v.name for v in prog.global_block().all_parameters()}
    accs = [n for n in got if n not in params and n != '@STEP_COUNTER@']
    assert any('moment1' in n for n in accs) and \
        any('beta2_pow_acc' in n for n in accs)
    # the run that meets the reader's end has bumped the counter too:
    # its increment runs first, before the read raises EOF
    assert got['@STEP_COUNTER@'].tolist() == \
        np.asarray(ref['final']['@STEP_COUNTER@']).tolist() == [LM_STEPS + 1]
    if amp:
        _check_amp(got, ref, params, accs)
    else:
        _check_fp32(got, ref, params, accs)
    for name in accs:
        if 'beta1_pow_acc' in name or 'beta2_pow_acc' in name:
            beta = 0.9 if 'beta1' in name else 0.98
            np.testing.assert_allclose(got[name], [beta ** (LM_STEPS + 1)],
                                       rtol=1e-6)
