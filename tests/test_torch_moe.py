"""The one-device mixture-of-experts FFN (ops/moe_ops.py, moe_layer,
TransformerConfig(moe_experts=)), the port against the JAX package on
the CPU.

- tests/test_moe_dispatch.py's four one-device tests, each in both
  packages: top-k equals dense at ample capacity (and the port equals
  the JAX package), the counted FLOPs of top-k dispatch stay flat in E
  (XLA's cost analysis there, FlopCounterMode here) while dense grows,
  capacity dropping zeroes the overflow tokens, and 60 Adam steps of an
  aux-loss MoE fall (the port's losses within 1e-4 of the JAX package's).
- moe_ffn (top-k at k 1, 2 and k >= E, dense, each activation) and
  moe_aux_loss as one-op programs: forward and the grads of X, Gate,
  WUp and WDown within 1e-5.
- Ties: equal gates take the lower expert index first (lax.top_k's
  order, a stable descending sort here), the aux loss the first maximum.
- Slot positions counted in int32 under AMP: 600 tokens on one expert
  keep 600 distinct slots with a bf16 route.
- moe_ffn under AMP (a bf16 X, an fp32 Gate and fp32 experts, as the JAX
  package feeds it): the dtypes the JAX package's promotion gives.
- TransformerConfig(moe_experts=2) (tests/test_parallel_axes.py:139):
  the JAX package's Program, and three Momentum steps from its weights
  within 1e-4 in fp32 and 2e-2 under AMP; extract_decode_spec refuses it
  naming moe_ffn.
- io.load_numpy_params copies the [E, D, H] and [E, H, D] experts:
  storage shared with no numpy source.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel.layers import moe_layer as jmoe_layer
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.ops import moe_ops as tmoe
from paddle_tpu_torch.parallel.layers import moe_layer as tmoe_layer
from test_torch_sequence import (_case, _compare, _forward_of, _run,
                                 _second_run_guarded)
import test_torch_training as ttraining

TOL = 1e-5
STEP_TOL = 1e-4
MOE = {jfluid: jmoe_layer, tfluid: tmoe_layer}
UNIQUE = {jfluid: junique_name, tfluid: tunique_name}
LM_CFG = dict(vocab=64, dim=32, heads=2, layers=2, ffn=64, max_len=16,
              moe_experts=2, use_tp=False, use_sp=False)


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


def _gate(seed, *shape):
    z = _f(seed, *shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype('float32')


# -- tests/test_moe_dispatch.py's one-device tests, in both packages ------------

def _moe_prog(fluid, E, k, dispatch, capacity_factor=2.0, S=8, D=16, H=32,
              seed=5, aux_loss=False):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with UNIQUE[fluid].guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[S, D], dtype='float32',
                              append_batch_size=False)
        out = MOE[fluid](x, num_experts=E, hidden_size=H, k=k,
                         dispatch=dispatch, capacity_factor=capacity_factor,
                         aux_loss=aux_loss)
        if aux_loss:
            out, aux = out
        loss = fluid.layers.mean(out)
    return prog, startup, [out, loss] + ([aux] if aux_loss else [])


def _jax_init(prog, startup):
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in prog.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _run_moe(fluid, E, k, mode, xv, init, **kw):
    prog, startup, fetch = _moe_prog(fluid, E, k, mode, **kw)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)     # the JAX package: the same seed
    if fluid is tfluid:
        tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace(),
                                    program=prog)
    return [np.asarray(v) for v in exe.run(prog, feed={'x': xv},
                                           fetch_list=fetch, scope=scope)]


def test_topk_matches_dense_at_ample_capacity():
    S, E, k = 8, 4, 2
    xv = np.random.RandomState(3).rand(S, 16).astype('float32')
    init = _jax_init(*_moe_prog(jfluid, E, k, 'dense')[:2])
    outs = {}
    for fluid in (jfluid, tfluid):
        for mode in ('dense', 'topk'):
            outs[fluid, mode] = _run_moe(fluid, E, k, mode, xv, init,
                                         capacity_factor=float(E * S))[0]
    for fluid in (jfluid, tfluid):
        np.testing.assert_allclose(outs[fluid, 'topk'], outs[fluid, 'dense'],
                                   rtol=1e-5, atol=1e-6)
    for mode in ('dense', 'topk'):
        np.testing.assert_allclose(outs[tfluid, mode], outs[jfluid, mode],
                                   rtol=TOL, atol=TOL)


def moe_flops(E, mode, S=32, D=64, H=128, k=2, cf=1.0):
    """FlopCounterMode's count of moe_ffn's products at [S, D] tokens, E
    experts of [D, H] (the port's emitter functions)."""
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.zeros(S, D)
    gate = torch.full((S, E), 1.0 / E)
    w_up, w_down = torch.zeros(E, D, H), torch.zeros(E, H, D)
    with FlopCounterMode(display=False) as counter:
        route = tmoe.topk_route(gate, k)
        if mode == 'dense':
            h = torch.relu(torch.einsum('sd,edh->seh', x, w_up))
            torch.einsum('seh,ehd,se->sd', h, w_down, route)
        else:
            disp, comb = tmoe.dispatch_combine(
                route, k, tmoe.capacity(S, k, E, cf))
            ein = torch.einsum('sec,sd->ecd', disp, x)
            h = torch.relu(torch.einsum('ecd,edh->ech', ein, w_up))
            y = torch.einsum('ech,ehd->ecd', h, w_down)
            torch.einsum('sec,ecd->sd', comb, y)
    return counter.get_total_flops()


def test_topk_flops_independent_of_expert_count():
    import test_moe_dispatch
    test_moe_dispatch.test_topk_flops_independent_of_expert_count()
    f4, f16 = moe_flops(4, 'topk'), moe_flops(16, 'topk')
    d4, d16 = moe_flops(4, 'dense'), moe_flops(16, 'dense')
    assert d16 > 2.5 * d4
    assert f16 < 1.5 * f4, (f4, f16)
    # chip_smoke moe2's rule: E = 4 and E = 8 within 10%
    f8 = moe_flops(8, 'topk', k=1, cf=2.0)
    assert abs(f8 - moe_flops(4, 'topk', k=1, cf=2.0)) <= 0.1 * f8


def test_capacity_dropping_zeroes_overflow_tokens():
    from paddle_tpu.ops.moe_ops import _dispatch_combine
    import jax.numpy as jnp
    S, E = 4, 2
    route = np.zeros((S, E), 'float32')
    route[:, 0] = 1.0
    jd, jc = (np.asarray(a) for a in _dispatch_combine(jnp.asarray(route),
                                                        1, 1))
    td, tc = (a.numpy() for a in tmoe.dispatch_combine(
        torch.from_numpy(route), 1, 1))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tc, jc)
    assert td[0, 0, 0] == 1.0 and td[1:].sum() == 0.0 and tc[1:].sum() == 0


def _train_aux(fluid, init):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 5
    with UNIQUE[fluid].guard(), fluid.program_guard(prog, startup):
        L = fluid.layers
        x = L.data(name='x', shape=[8, 16], dtype='float32',
                   append_batch_size=False)
        y = L.data(name='y', shape=[8, 16], dtype='float32',
                   append_batch_size=False)
        out, aux = MOE[fluid](x, num_experts=4, hidden_size=32, k=2,
                              aux_loss=True)
        loss = L.elementwise_add(L.mean(L.square_error_cost(out, y)),
                                 L.scale(aux, scale=0.01))
        fluid.optimizer.Adam(0.01).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is None:
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in prog.list_vars() if v.persistable and
                scope.find_var(v.name) is not None}
    else:
        tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace(),
                                    program=prog)
    xv = np.random.RandomState(0).rand(8, 16).astype('float32')
    losses, auxes = [], []
    for _ in range(60):
        lv, av = exe.run(prog, feed={'x': xv, 'y': np.tanh(xv)},
                         fetch_list=[loss, aux], scope=scope)
        losses.append(float(np.asarray(lv)))
        auxes.append(float(np.asarray(av)))
    return init, losses, auxes


def test_moe_topk_trains_and_drops_loss():
    init, want, want_aux = _train_aux(jfluid, None)
    _, got, got_aux = _train_aux(tfluid, init)
    assert np.isfinite(got[-1]) and got[-1] < 0.5 * got[0], (got[0], got[-1])
    assert 0.5 < got_aux[-1] < 4.0
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(got_aux, want_aux, rtol=STEP_TOL,
                               atol=STEP_TOL)


# -- one-op programs: forward and grads -----------------------------------------

def _cases():
    c = {}
    x, gate = _f(1, 2, 6, 8), _gate(2, 2, 6, 4)
    w_up, w_down = _f(3, 4, 8, 16) * 0.3, _f(4, 4, 16, 8) * 0.3
    ins = {'X': x, 'Gate': gate, 'WUp': w_up, 'WDown': w_down}
    slots = ['X', 'Gate', 'WUp', 'WDown']
    for k, mode, act, cf in ((1, 'topk', 'gelu', 2.0),
                             (2, 'topk', 'relu', 1.0),
                             (1, 'topk', 'tanh', 0.5),
                             (4, 'topk', 'sigmoid', 2.0),
                             (2, 'dense', 'gelu', 2.0),
                             (1, 'dense', '', 2.0)):
        c['moe_ffn-%s-k%d-%s-cf%g' % (mode, k, act or 'linear', cf)] = \
            _case('moe_ffn', ins, {'Out': ['out']}, slots,
                  attrs={'k': k, 'dispatch': mode, 'act': act,
                         'capacity_factor': cf})
    c['moe_aux_loss'] = _case('moe_aux_loss', {'Gate': gate},
                              {'Out': ['out']}, ['Gate'])
    tie = np.full((2, 6, 4), 0.25, 'float32')
    tie[0, :3] = [0.4, 0.1, 0.4, 0.1]
    c['moe_ffn-ties'] = _case('moe_ffn', dict(ins, Gate=tie),
                              {'Out': ['out']}, slots,
                              attrs={'k': 1, 'capacity_factor': 4.0})
    c['moe_aux_loss-ties'] = _case('moe_aux_loss', {'Gate': tie},
                                   {'Out': ['out']}, ['Gate'])
    return c


CASES = _cases()


def _cotangents(case, outs):
    return {'cot_%d' % i: np.asarray(np.random.RandomState(100 + i).randn(
        *np.shape(outs[n])), 'float32') for i, n in enumerate(case['targets'])}


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


def test_ties_take_the_lower_expert_index():
    """Equal gates: the first choice is the lower expert (lax.top_k's
    order) and the top-k mask keeps every tied gate."""
    route = torch.tensor([[0.4, 0.1, 0.4, 0.1], [0.25] * 4,
                          [0.1, 0.3, 0.3, 0.3]])
    disp, _ = tmoe.dispatch_combine(route, 1, 4)
    assert disp.sum((1, 2)).tolist() == [1.0, 1.0, 1.0]
    assert disp.sum(2).argmax(1).tolist() == [0, 0, 1]
    masked = tmoe.topk_route(route, 1)
    assert (masked[0] > 0).tolist() == [True, False, True, False]
    assert (masked[1] > 0).all()


def test_slot_positions_count_past_256_under_amp():
    """600 tokens routed to one expert with a bf16 route: 600 distinct
    capacity slots (bf16 counts would round past 256)."""
    S, E = 600, 2
    route = torch.zeros(S, E, dtype=torch.bfloat16)
    route[:, 0] = 1.0
    disp, comb = tmoe.dispatch_combine(route, 1, S)
    assert disp.dtype == torch.bfloat16
    per_slot = disp[:, 0, :].float().sum(0)
    assert per_slot.max().item() == 1.0 and per_slot.sum().item() == S
    np.testing.assert_array_equal(disp[:, 0, :].float().argmax(1).numpy(),
                                  np.arange(S))


def _amp_moe(fluid):
    """moe_ffn fed what the JAX package feeds it under AMP: a bf16 X (the
    LM's layer_norm output), an fp32 Gate and fp32 experts."""
    prog = fluid.Program()
    block = prog.global_block()
    feed = {'x': _f(5, 2, 6, 8), 'gate': _gate(6, 2, 6, 4),
            'w_up': _f(7, 4, 8, 16) * 0.3, 'w_down': _f(8, 4, 16, 8) * 0.3}
    with fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers
        vs = {n: L.data(name=n, shape=list(v.shape), dtype='float32',
                        append_batch_size=False) for n, v in feed.items()}
        x16 = L.cast(vs['x'], 'bfloat16')
        out = block.create_var(name='out')
        block.append_op(type='moe_ffn',
                        inputs={'X': [x16], 'Gate': [vs['gate']],
                                'WUp': [vs['w_up']],
                                'WDown': [vs['w_down']]},
                        outputs={'Out': [out]},
                        attrs={'k': 1, 'capacity_factor': 2.0})
    prog._use_bf16 = True
    got, = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=['out'], scope=fluid.Scope(),
        return_numpy=False)
    return got


def test_amp_dtypes_are_the_jax_promotion():
    want = _amp_moe(jfluid)
    got = _amp_moe(tfluid)
    assert str(np.asarray(want).dtype) == 'float32'
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# -- the MoE LM ------------------------------------------------------------------

def _gate_names(prog):
    return [op.single_input('Gate') for op in prog.global_block().ops
            if op.type == 'moe_ffn']


def _lm_steps(fluid, amp, init=None):
    """Three Momentum steps of the MoE LM (test_torch_training's program
    at LM_CFG) from the JAX package's initial weights: per step the loss,
    every parameter after it, and the tokens whose two largest gates are
    equal (an exact routing tie)."""
    unique = UNIQUE[fluid]
    transformer = jtransformer if fluid is jfluid else ttransformer
    prog, startup, rdr, avg = ttraining._build_train(
        fluid, unique, transformer, amp, LM_CFG, 16, 'moe_reader')
    params = [v.name for v in prog.global_block().all_parameters()]
    gates = _gate_names(prog)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is None:
        init = {n: np.array(scope.find_var(n)) for n in params}
    else:
        tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace(),
                                    program=prog)
    batches = ttraining._batches(LM_CFG)
    rdr.decorate_tensor_provider(lambda: iter(batches))
    rdr.start()
    steps = []
    for _ in batches:
        got = exe.run(prog, fetch_list=[avg.name] + gates, scope=scope)
        top2 = [np.sort(np.asarray(g, 'float32'), -1)[..., -2:]
                for g in got[1:]]
        steps.append(dict(
            loss=float(np.asarray(got[0])),
            params={n: np.array(scope.find_var(n)) for n in params},
            ties=[int((t[..., 0] == t[..., 1]).sum()) for t in top2]))
    rdr.reset()
    return init, steps, prog.to_string()


@pytest.fixture(scope='module')
def jax_moe_lm_runs():
    return {amp: _lm_steps(jfluid, amp) for amp in (False, True)}


@pytest.mark.parametrize('amp', [False, True], ids=['fp32', 'amp_bf16'])
def test_moe_lm_momentum_steps_match_jax(jax_moe_lm_runs, amp):
    """Three steps from the JAX package's weights: the losses and every
    parameter's update (relative) within 1e-4 in fp32, 2e-2 under AMP.
    A top-1 gate's renormalised weight is 1, so the gate fc takes no
    gradient but at an exact tie of the two largest gates: its update
    is held to the JAX package's absolutely (1e-6). Under AMP the gate
    logits are bf16 and can tie exactly; a tie in one package only (a
    last-bit difference in the weights before it) sends that token to
    both experts at half weight there: the parameters are then held
    after each step up to the last one whose ties agree (at least the
    first), and the losses at every step (ROADMAP Queue 3)."""
    init, want, text = jax_moe_lm_runs[amp]
    _, got, ttext = _lm_steps(tfluid, amp, init)
    assert ttext == text and 'moe_ffn' in ttext
    tol = ttraining.LM_TOL[amp]
    np.testing.assert_allclose([s['loss'] for s in got],
                               [s['loss'] for s in want], atol=tol, rtol=0)
    agree = 0
    while agree < len(got) and got[agree]['ties'] == want[agree]['ties']:
        agree += 1
    if not amp:
        assert agree == len(got), [s['ties'] for s in got]
    assert agree >= 1
    gate_w = {n for n in init if n.startswith('fc_')}
    for step in range(agree):
        for name, w0 in init.items():
            want_u = want[step]['params'][name] - w0
            got_u = got[step]['params'][name] - w0
            if name in gate_w and np.abs(want_u).max() < 1e-6:
                assert np.abs(got_u - want_u).max() <= 1e-6, (step, name)
                continue
            rel = np.linalg.norm(got_u - want_u) / np.linalg.norm(want_u)
            assert rel <= tol, (step, name, rel)


def _lm_program(fluid, unique_name, transformer, aux=False):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[1, 16, 1],
                                 dtype='int64', append_batch_size=False)
        transformer.language_model_logits(
            toks, transformer.TransformerConfig(**LM_CFG))
    return prog, startup


def test_moe_config_builds_the_jax_program():
    jprog, jstart = _lm_program(jfluid, junique_name, jtransformer)
    tprog, tstart = _lm_program(tfluid, tunique_name, ttransformer)
    assert tprog.to_string() == jprog.to_string()
    assert tstart.to_string() == jstart.to_string()
    types = [op.type for op in tprog.global_block().ops]
    assert types.count('moe_ffn') == LM_CFG['layers']
    # the experts carry the JAX package's ep annotations
    for v in jprog.global_block().all_parameters():
        assert getattr(tprog.global_block().var(v.name), 'dist_attr',
                       None) == v.dist_attr, v.name


def test_moe_layer_with_aux_loss_builds_the_jax_program():
    texts = []
    for fluid in (jfluid, tfluid):
        prog, _, _ = _moe_prog(fluid, 4, 2, 'topk', aux_loss=True)
        texts.append(prog.to_string())
    assert texts[0] == texts[1] and 'moe_aux_loss' in texts[1]


def test_decode_spec_refuses_an_moe_program():
    from paddle_tpu_torch.transpiler.decode_transpiler import (
        DecodeTranspileError, extract_decode_spec)
    prog, _ = _lm_program(tfluid, tunique_name, ttransformer)
    with pytest.raises(DecodeTranspileError, match='moe_ffn'):
        extract_decode_spec(prog)


def test_load_numpy_params_copies_the_experts():
    """The [E, D, H] and [E, H, D] experts go to the scope as copies: no
    tensor shares storage with its numpy source, and a write to the
    source after the load leaves the scope unchanged."""
    prog, startup, _ = _moe_prog(jfluid, 4, 1, 'topk')
    init = {n: np.array(v) for n, v in _jax_init(prog, startup).items()}
    tprog, _, _ = _moe_prog(tfluid, 4, 1, 'topk')
    experts = {n: v for n, v in init.items() if v.ndim == 3}
    assert sorted(v.shape for v in experts.values()) == \
        [(4, 16, 32), (4, 32, 16)]
    scope = tfluid.Scope()
    tfluid.io.load_numpy_params(scope, init, tfluid.CPUPlace(), program=tprog)
    for n, src in experts.items():
        t = scope.find_var(n)
        assert not np.shares_memory(t.numpy(), src), n
        before = t.clone()
        src += 1.0
        assert torch.equal(scope.find_var(n), before), n
        assert math.isclose(float((torch.from_numpy(src) - t).mean()), 1.0,
                            rel_tol=1e-6)
