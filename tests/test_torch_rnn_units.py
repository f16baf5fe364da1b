"""The RNN units, CTC and the remaining losses: the port against the JAX
package on the CPU.

- Each op type of paddle_tpu/ops/ctc_rnn_ops.py (lstm_unit, gru_unit,
  lstmp, warpctc, ctc_align) and the deterministic ones of loss_ops.py
  (hinge_loss, log_loss, margin_rank_loss, squared_l2_distance, maxout,
  hierarchical_sigmoid) as one-op programs (test_torch_sequence's
  harness): the same seeded inputs through both packages, forward and
  the float inputs' grads within 1e-5, each second run under the
  host-data guard. warpctc over ragged logit and label lengths, blank 0
  and a nonzero blank, norm_by_times on and off; lstmp with and without
  peepholes, reversed, with H0 and C0.
- lstmp under AMP within 2e-2: the port casts its H0 projection to the
  bf16 stream, the JAX package keeps it fp32 (ROADMAP Queue 3).
- warpctc against torch's ctc_loss, the oracle of
  tests/test_inventory_ops.py::test_warpctc_matches_torch (a test-side
  yardstick; the port never calls it).
- The layers gru_unit, lstm_unit, dynamic_lstmp, warpctc,
  ctc_greedy_decoder and the eight loss layers, built in both packages,
  the JAX package's parameters copied into the port: the same Program
  text and fetches within 1e-5.
- nce and sampling_id draw from torch generators, not jax.random, so
  they are held to the JAX package's own properties
  (tests/test_extra_ops.py): nce's backward sees its forward's
  negatives (one SGD step equals -lr times the gradient of the sampled
  loss rebuilt from the same draw), nce trains, sampling_id follows its
  distribution; hsigmoid's probabilities sum to one.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from test_torch_sequence import (_case, _compare, _cotangents, _forward_of,
                                 _run, _second_run_guarded)

TOL = 1e-5
AMP_TOL = 2e-2
B, T = 3, 5
LENS = np.array([5, 1, 3], 'int32')


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


def _f(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        'float32')


def _labels(seed, K, blank, *shape):
    """CTC labels in [0, K) without the blank."""
    ids = np.random.RandomState(seed).randint(0, K - 1, size=shape)
    return np.where(ids >= blank, ids + 1, ids).astype('int32')


def _cases():
    c = {}
    D = 4
    c['lstm_unit'] = _case(
        'lstm_unit', {'X': _f(1, B, 4 * D), 'C_prev': _f(2, B, D)},
        {'C': ['c'], 'H': ['h']}, ['X', 'C_prev'], targets=['c', 'h'],
        attrs={'forget_bias': 0.5})
    gru_in = {'Input': _f(3, B, 3 * D), 'HiddenPrev': _f(4, B, D),
              'Weight': _f(5, D, 3 * D, scale=0.5)}
    c['gru_unit'] = _case(
        'gru_unit', dict(gru_in, Bias=_f(6, 1, 3 * D)),
        {'Hidden': ['hidden'], 'Gate': ['gate'],
         'ResetHiddenPrev': ['reset']},
        ['Input', 'HiddenPrev', 'Weight', 'Bias'],
        attrs={'activation': 'tanh', 'gate_activation': 'sigmoid'})
    c['gru_unit-no-bias-relu'] = _case(
        'gru_unit', gru_in, {'Hidden': ['hidden']},
        ['Input', 'HiddenPrev', 'Weight'],
        attrs={'activation': 'relu', 'gate_activation': 'sigmoid'})
    H, P = 4, 3
    for peep in (False, True):
        for rev in (False, True):
            for init in (False, True):
                ins = {'Input': _f(7, B, T, 4 * H, scale=0.5),
                       'Weight': _f(8, P, 4 * H, scale=0.5),
                       'ProjWeight': _f(9, H, P, scale=0.5),
                       'Bias': _f(10, 1, (7 if peep else 4) * H, scale=0.5),
                       'SeqLens': LENS}
                check = ['Input', 'Weight', 'ProjWeight', 'Bias']
                if init:
                    ins['H0'] = _f(11, B, H)
                    ins['C0'] = _f(12, B, H)
                    check += ['H0', 'C0']
                c['lstmp%s%s%s' % ('-peep' if peep else '',
                                   '-rev' if rev else '',
                                   '-h0c0' if init else '')] = _case(
                    'lstmp', ins, {'Projection': ['proj'], 'Cell': ['cell']},
                    check, targets=['proj', 'cell'],
                    attrs={'use_peepholes': peep, 'is_reverse': rev,
                           'gate_activation': 'sigmoid',
                           'cell_activation': 'tanh',
                           'candidate_activation': 'tanh',
                           'proj_activation': 'tanh' if peep
                           else 'identity'})
    K, L = 5, 3
    for blank in (0, 2):
        for norm in (False, True):
            c['warpctc-blank%d%s' % (blank, '-norm' if norm else '')] = _case(
                'warpctc', {'Logits': _f(13, 4, 6, K),
                            'Label': _labels(14, K, blank, 4, L),
                            'SeqLens': np.array([6, 5, 2, 4], 'int32'),
                            'LabelLens': np.array([3, 2, 1, 0], 'int32')},
                {'Loss': ['loss']}, ['Logits'],
                attrs={'blank': blank, 'norm_by_times': norm})
    c['warpctc-repeats-no-lens'] = _case(
        'warpctc', {'Logits': _f(15, 2, 7, K),
                    'Label': np.array([[1, 1, 3], [2, 4, 4]], 'int32')},
        {'Loss': ['loss']}, ['Logits'], attrs={'blank': 0})
    align_x = np.array([[0, 1, 1, 0, 2, 2], [3, 3, 0, 0, 3, 1],
                        [2, 0, 2, 2, 1, 1]], 'int32')
    c['ctc_align'] = _case(
        'ctc_align', {'Input': align_x,
                      'SeqLens': np.array([6, 5, 3], 'int32')},
        {'Output': ['out'], 'OutLens': ['out_lens']},
        attrs={'blank': 0, 'padding_value': 0})
    c['ctc_align-blank3-pad'] = _case(
        'ctc_align', {'Input': align_x[..., None]},
        {'Output': ['out'], 'OutLens': ['out_lens']},
        attrs={'blank': 3, 'padding_value': -1})
    x = _f(16, 4, 1)
    c['hinge_loss'] = _case(
        'hinge_loss', {'Logits': x, 'Labels': np.array(
            [[1.], [0.], [1.], [0.]], 'float32')},
        {'Loss': ['loss']}, ['Logits'])
    c['log_loss'] = _case(
        'log_loss', {'Predicted': np.array([[0.9], [0.2], [0.6], [0.4]],
                                           'float32'),
                     'Labels': np.array([[1.], [0.], [1.], [1.]], 'float32')},
        {'Loss': ['loss']}, ['Predicted'], attrs={'epsilon': 1e-4})
    c['margin_rank_loss'] = _case(
        'margin_rank_loss', {'X1': _f(17, 4, 1), 'X2': _f(18, 4, 1),
                             'Label': np.array([[1.], [-1.], [1.], [-1.]],
                                               'float32')},
        {'Out': ['out'], 'Activated': ['act']}, ['X1', 'X2'],
        attrs={'margin': 0.1})
    c['squared_l2_distance-broadcast'] = _case(
        'squared_l2_distance', {'X': _f(19, 3, 4), 'Y': _f(20, 1, 4)},
        {'Out': ['out'], 'sub_result': ['sub']}, ['X', 'Y'])
    c['maxout'] = _case('maxout', {'X': _f(21, 2, 6, 3, 3)},
                        {'Out': ['out']}, ['X'], attrs={'groups': 3})
    for C in (6, 8):
        hs = {'X': _f(22, 4, 5), 'W': _f(23, C - 1, 5),
              'Label': np.array([[0], [C - 1], [2], [3]], 'int64')}
        c['hierarchical_sigmoid-%d' % C] = _case(
            'hierarchical_sigmoid', dict(hs, Bias=_f(24, C - 1)),
            {'Out': ['out']}, ['X', 'W', 'Bias'], attrs={'num_classes': C})
    c['hierarchical_sigmoid-no-bias'] = _case(
        'hierarchical_sigmoid', hs, {'Out': ['out']}, ['X', 'W'],
        attrs={'num_classes': 8})
    return c


CASES = _cases()
AMP_CASES = ['lstmp', 'lstmp-peep-rev-h0c0']


def test_cases_cover_the_deterministic_new_op_types():
    assert {c['type'] for c in CASES.values()} == {
        'lstm_unit', 'gru_unit', 'lstmp', 'warpctc', 'ctc_align',
        'hinge_loss', 'log_loss', 'margin_rank_loss', 'squared_l2_distance',
        'maxout', 'hierarchical_sigmoid'}


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


@pytest.mark.parametrize('name', AMP_CASES)
def test_lstmp_under_amp_matches_jax(name):
    case = CASES[name]
    cots = _cotangents(case, _forward_of(jfluid, case, amp=True))
    want, = _run(jfluid, case, amp=True, cots=cots)
    got, = _run(tfluid, case, amp=True, cots=cots)
    assert 'proj_w@GRAD' in got
    _compare(want, got, AMP_TOL)


def test_warpctc_matches_torch_ctc_loss():
    """The JAX package's oracle: torch's ctc_loss on log_softmax'd
    logits, per sequence, over ragged lengths."""
    case = CASES['warpctc-blank2']
    got, = _run(tfluid, dict(case, check=[]))
    ins = case['inputs']
    logp = F.log_softmax(torch.from_numpy(ins['Logits']).transpose(0, 1),
                         dim=-1)
    want = F.ctc_loss(logp, torch.from_numpy(ins['Label'].astype('int64')),
                      torch.from_numpy(ins['SeqLens'].astype('int64')),
                      torch.from_numpy(ins['LabelLens'].astype('int64')),
                      blank=2, reduction='none', zero_infinity=False).numpy()
    np.testing.assert_allclose(got['loss'].ravel(), want, rtol=1e-4,
                               atol=1e-4)


# -- the layers ----------------------------------------------------------------------

def _layer_programs(fluid, build, seed=3):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        fetch = build(fluid, fluid.layers)
    return prog, startup, fetch


def _layers_match(build, feed):
    jprog, jstart, jfetch = _layer_programs(jfluid, build)
    tprog, tstart, tfetch = _layer_programs(tfluid, build)
    assert tprog.to_string() == jprog.to_string()
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jstart.list_vars() if v.persistable}
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tprog)
    want = jexe.run(jprog, feed=feed, fetch_list=jfetch, scope=jscope)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.astype(w.dtype), w)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    return [np.asarray(g) for g in got]


def test_rnn_unit_layers():
    """tests/test_layer_api_complete.py::test_rnn_unit_layers."""
    def build(fluid, L):
        x = L.data(name='x', shape=[6], dtype='float32')
        h0 = L.data(name='h0', shape=[5], dtype='float32')
        c0 = L.data(name='c0', shape=[5], dtype='float32')
        gate_in = L.fc(input=x, size=15)
        gh, r, g = L.gru_unit(gate_in, h0, 15)
        lh, lc = L.lstm_unit(x, h0, c0, forget_bias=0.5)
        return [gh, r, g, lh, lc]
    rng = np.random.RandomState(25)
    got = _layers_match(build, {n: rng.rand(3, d).astype('float32')
                                for n, d in (('x', 6), ('h0', 5),
                                             ('c0', 5))})
    assert got[0].shape == (3, 5) and got[2].shape == (3, 15)


def test_dynamic_lstmp_layer():
    """tests/test_layer_api_complete.py::test_dynamic_lstmp_layer."""
    def build(fluid, L):
        x = L.data(name='x', shape=[8], dtype='float32', lod_level=1)
        proj = L.fc(input=x, size=16)
        proj.seq_lens = x.seq_lens
        proj.lod_level = 1
        return list(L.dynamic_lstmp(proj, size=16, proj_size=6))
    p, c = _layers_match(build, {
        'x': np.random.RandomState(26).rand(2, 5, 8).astype('float32'),
        'x@SEQ_LEN': np.array([5, 3], 'int32')})
    assert p.shape == (2, 5, 6) and c.shape == (2, 5, 4)
    assert not p[1, 3:].any()


def test_warpctc_and_greedy_decoder_layers():
    def build(fluid, L):
        logit = L.data(name='logit', shape=[5], dtype='float32',
                       lod_level=1)
        lab = L.data(name='lab', shape=[3], dtype='int32')
        loss = L.warpctc(logit, lab, norm_by_times=True)
        dec = L.ctc_greedy_decoder(L.softmax(logit), blank=0)
        return [loss, dec, dec.seq_lens]
    rng = np.random.RandomState(27)
    loss, dec, lens = _layers_match(build, {
        'logit': rng.randn(2, 8, 5).astype('float32'),
        'logit@SEQ_LEN': np.array([8, 6], 'int32'),
        'lab': rng.randint(1, 5, (2, 3)).astype('int32')})
    assert loss.shape == (2, 1) and dec.shape == (2, 8)


def test_loss_layers_match_jax():
    def build(fluid, L):
        x = L.data(name='x', shape=[1], dtype='float32')
        y = L.data(name='y', shape=[1], dtype='float32')
        p = L.data(name='p', shape=[1], dtype='float32')
        v = L.data(name='v', shape=[6], dtype='float32')
        im = L.data(name='im', shape=[8, 3, 3], dtype='float32')
        lab = L.data(name='lab', shape=[1], dtype='int64')
        return [L.hinge_loss(x, y), L.log_loss(p, y),
                L.margin_rank_loss(y, x, p, margin=0.1),
                L.squared_l2_distance(v, L.scale(v, scale=0.5)),
                L.maxout(im, groups=4),
                L.hsigmoid(v, lab, num_classes=7)]
    rng = np.random.RandomState(28)
    _layers_match(build, {
        'x': rng.randn(4, 1).astype('float32'),
        'y': (rng.rand(4, 1) < 0.5).astype('float32'),
        'p': rng.rand(4, 1).astype('float32') * 0.8 + 0.1,
        'v': rng.randn(4, 6).astype('float32'),
        'im': rng.rand(4, 8, 3, 3).astype('float32'),
        'lab': rng.randint(0, 7, (4, 1)).astype('int64')})


# -- the random ops, by the JAX package's properties --------------------------------

def test_nce_grad_uses_the_forward_negatives():
    """One SGD step's weight change equals -lr times the gradient of the
    sampled loss rebuilt from the same draw: the port's generator seeded
    from the program's random_seed, drawn once (nce is the program's
    only random op)."""
    V, D, Bn, S, LR = 12, 6, 16, 4, 0.1
    rng = np.random.RandomState(2)
    tv = rng.randint(0, V, (Bn, 1)).astype('int64')
    xv = rng.randn(Bn, D).astype('float32')
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 9
    with tfluid.program_guard(prog, startup):
        x = tfluid.layers.data(name='x', shape=[D], dtype='float32')
        t = tfluid.layers.data(name='t', shape=[1], dtype='int64')
        loss = tfluid.layers.mean(tfluid.layers.nce(
            x, t, num_total_classes=V, num_neg_samples=S,
            param_attr=tfluid.ParamAttr(name='nw'),
            bias_attr=tfluid.ParamAttr(name='nb')))
        tfluid.optimizer.SGD(LR).minimize(loss)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    w0 = scope.find_var('nw').clone()
    b0 = scope.find_var('nb').clone()
    tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed={'x': xv, 't': tv}, fetch_list=[loss], scope=scope)
    negs = torch.randint(0, V, (Bn, S),
                         generator=torch.Generator().manual_seed(9))
    w = w0.clone().requires_grad_()
    lab = torch.from_numpy(tv.reshape(-1))
    xt = torch.from_numpy(xv)
    log_nq = float(np.log(np.float32(S / V)))
    s_pos = (xt * w[lab]).sum(-1) + b0[lab] - log_nq
    s_neg = (xt[:, None] * w[negs]).sum(-1) + b0[negs] - log_nq
    ref = (F.softplus(-s_pos) + F.softplus(s_neg).sum(1)).mean()
    gw, = torch.autograd.grad(ref, w)
    np.testing.assert_allclose(scope.find_var('nw').numpy(),
                               (w0 - LR * gw).numpy(), rtol=1e-4, atol=1e-6)


def test_nce_trains_word_embeddings():
    rng = np.random.RandomState(0)
    V, D, Bn = 32, 16, 64
    ctx_ids = rng.randint(0, V, (256, 1)).astype('int64')
    tgt_ids = (ctx_ids + 1) % V
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 5
    with tfluid.program_guard(prog, startup):
        ctx_v = tfluid.layers.data(name='ctx', shape=[1], dtype='int64')
        tgt_v = tfluid.layers.data(name='tgt', shape=[1], dtype='int64')
        emb = tfluid.layers.embedding(ctx_v, size=[V, D])
        loss = tfluid.layers.mean(tfluid.layers.nce(
            emb, tgt_v, num_total_classes=V, num_neg_samples=8))
        tfluid.optimizer.Adam(0.05).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = []
    for i in range(60):
        sl = slice((i * Bn) % 256, (i * Bn) % 256 + Bn)
        losses.append(float(np.asarray(exe.run(
            prog, feed={'ctx': ctx_ids[sl], 'tgt': tgt_ids[sl]},
            fetch_list=[loss], scope=scope)[0])))
    assert np.isfinite(losses[-1]) and losses[-1] < 0.5 * losses[0]


def test_sampling_id_follows_its_distribution():
    probs = np.tile(np.array([[0.05, 0.9, 0.05]], 'float32'), (512, 1))
    prog = tfluid.Program()
    prog.random_seed = 4
    with tfluid.program_guard(prog, tfluid.Program()):
        x = tfluid.layers.data(name='x', shape=[3], dtype='float32')
        ids = tfluid.layers.sampling_id(x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    a, = exe.run(prog, feed={'x': probs}, fetch_list=[ids])
    b, = exe.run(prog, feed={'x': probs}, fetch_list=[ids])
    assert a.shape == (512,) and a.dtype == np.int64
    assert 0.85 < np.bincount(a, minlength=3)[1] / 512 < 0.95
    assert (a != b).any()


def test_hsigmoid_probabilities_sum_to_one():
    rng = np.random.RandomState(1)
    C, D = 6, 8
    xv = rng.randn(4, D).astype('float32')
    w = rng.randn(C - 1, D).astype('float32')
    bias = rng.randn(C - 1).astype('float32')
    costs = []
    for label in range(C):
        case = _case('hierarchical_sigmoid',
                     {'X': xv, 'W': w, 'Bias': bias,
                      'Label': np.full((4, 1), label, 'int64')},
                     {'Out': ['out']}, attrs={'num_classes': C})
        costs.append(_run(tfluid, case)[0]['out'].ravel())
    np.testing.assert_allclose(np.exp(-np.stack(costs)).sum(0), 1.0,
                               rtol=1e-5)
