"""The 19 sequence op types, the port against the JAX package on the CPU.

- Each op type as a one-op program (cases in CASES): the same numpy
  inputs, made from a seed, go through both packages; the forward
  outputs and the grads of the float inputs (from a seeded cotangent)
  must agree within 1e-5 in fp32, integer outputs by value. The lengths
  are ragged and include 1 and T; the recurrences run forwards and
  reversed, the LSTM with and without peepholes, H0 and C0.
- lstm and gru under AMP (an fc before them makes the bf16 stream):
  within 2e-2 of the JAX package.
- linear_chain_crf and crf_decoding against the JAX package's brute
  force over every path (tests/test_sequence_ops.py).
- Every op's second run reads nothing back to the host and builds no
  tensor from host data (test_torch_executor's guard): on the card the
  segment is captured as a CUDA graph.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import executor as texecutor
from test_sequence_ops import _brute_force_crf
from test_torch_executor import _NoHostData

TOL = 1e-5
AMP_TOL = 2e-2
B, T = 3, 5
LENS = np.array([5, 1, 3], 'int32')      # 1 and T among them


def _r(seed):
    return np.random.RandomState(seed)


def _f(seed, *shape, scale=1.0):
    return (_r(seed).randn(*shape) * scale).astype('float32')


def _ids(seed, high, *shape):
    return _r(seed).randint(0, high, size=shape).astype('int64')


def _case(op_type, inputs, outputs, check=(), targets=None, attrs=None):
    """inputs: slot -> array or [(name, array)]; outputs: slot -> [names];
    check: the input slots whose grads are compared; targets: the output
    names the seeded cotangents flow from (default: the first output)."""
    return dict(type=op_type, inputs=inputs, outputs=outputs,
                check=list(check), attrs=attrs or {},
                targets=targets or [next(iter(outputs.values()))[0]])


def _cases():
    c = {}
    x = _f(1, B, T, 4)
    for pool in ('SUM', 'AVERAGE', 'SQRT', 'MAX', 'LAST', 'FIRST'):
        c['sequence_pool-' + pool] = _case(
            'sequence_pool', {'X': x, 'SeqLens': LENS},
            {'Out': ['out'], 'MaxIndex': ['max_index']}, ['X'],
            attrs={'pooltype': pool})
    c['sequence_pool-no-lens'] = _case(
        'sequence_pool', {'X': _f(2, B, T, 2, 3)}, {'Out': ['out']}, ['X'],
        attrs={'pooltype': 'AVERAGE'})
    c['sequence_softmax'] = _case(
        'sequence_softmax', {'X': _f(3, B, T, 1), 'SeqLens': LENS},
        {'Out': ['out']}, ['X'])
    c['sequence_softmax-2d'] = _case(
        'sequence_softmax', {'X': _f(4, B, T), 'SeqLens': LENS},
        {'Out': ['out']}, ['X'])
    c['sequence_expand'] = _case(
        'sequence_expand', {'X': _f(5, B, 4), 'Y': _f(6, B, T, 2)},
        {'Out': ['out']}, ['X'])
    c['sequence_expand-3d'] = _case(
        'sequence_expand', {'X': _f(5, B, 1, 4), 'Y': _f(6, B, T, 2)},
        {'Out': ['out']}, ['X'])
    for clen, cstart in ((3, -1), (4, -2), (2, 0)):
        c['sequence_conv-%d%+d' % (clen, cstart)] = _case(
            'sequence_conv', {'X': x, 'Filter': _f(7, clen * 4, 6),
                              'SeqLens': LENS},
            {'Out': ['out']}, ['X', 'Filter'],
            attrs={'contextLength': clen, 'contextStart': cstart,
                   'contextStride': 1})
    H = 4
    for peep in (False, True):
        for rev in (False, True):
            for init in (False, True):
                ins = {'Input': _f(8, B, T, 4 * H, scale=0.5),
                       'Weight': _f(9, H, 4 * H, scale=0.5),
                       'Bias': _f(10, 1, (7 if peep else 4) * H, scale=0.5),
                       'SeqLens': LENS}
                check = ['Input', 'Weight', 'Bias']
                if init:
                    ins['H0'] = _f(11, B, H)
                    ins['C0'] = _f(12, B, H)
                    check += ['H0', 'C0']
                c['lstm%s%s%s' % ('-peep' if peep else '',
                                  '-rev' if rev else '',
                                  '-h0c0' if init else '')] = _case(
                    'lstm', ins, {'Hidden': ['hidden'], 'Cell': ['cell']},
                    check, targets=['hidden', 'cell'],
                    attrs={'use_peepholes': peep, 'is_reverse': rev,
                           'gate_activation': 'sigmoid',
                           'cell_activation': 'tanh',
                           'candidate_activation': 'tanh'})
    c['lstm-relu-candidate'] = _case(
        'lstm', {'Input': _f(8, B, T, 4 * H), 'Weight': _f(9, H, 4 * H),
                 'Bias': _f(10, 1, 4 * H), 'SeqLens': LENS},
        {'Hidden': ['hidden'], 'Cell': ['cell']},
        ['Input', 'Weight', 'Bias'], targets=['hidden'],
        attrs={'use_peepholes': False, 'is_reverse': True,
               'gate_activation': 'sigmoid', 'cell_activation': 'sigmoid',
               'candidate_activation': 'relu'})
    for rev in (False, True):
        for init in (False, True):
            ins = {'Input': _f(13, B, T, 3 * H), 'Weight': _f(14, H, 3 * H),
                   'Bias': _f(15, 1, 3 * H), 'SeqLens': LENS}
            check = ['Input', 'Weight', 'Bias']
            if init:
                ins['H0'] = _f(16, B, H)
                check.append('H0')
            c['gru%s%s' % ('-rev' if rev else '',
                           '-h0' if init else '')] = _case(
                'gru', ins, {'Hidden': ['hidden']}, check,
                attrs={'is_reverse': rev, 'gate_activation': 'sigmoid',
                       'activation': 'tanh'})
    c['cos_sim'] = _case('cos_sim', {'X': _f(17, B, 4), 'Y': _f(18, B, 4)},
                         {'Out': ['out']}, ['X', 'Y'])
    c['cos_sim-broadcast'] = _case(
        'cos_sim', {'X': _f(17, B, 4), 'Y': _f(18, 1, 4)}, {'Out': ['out']},
        ['X', 'Y'])
    N = 4
    crf_in = {'Emission': _f(19, B, T, N), 'Transition': _f(20, N + 2, N),
              'Label': _ids(21, N, B, T, 1), 'SeqLens': LENS}
    c['linear_chain_crf'] = _case(
        'linear_chain_crf', crf_in,
        {'LogLikelihood': ['ll'], 'Alpha': ['alpha'],
         'EmissionExps': ['eexps'], 'TransitionExps': ['texps']},
        ['Emission', 'Transition'])
    c['crf_decoding'] = _case(
        'crf_decoding', {k: v for k, v in crf_in.items() if k != 'Label'},
        {'ViterbiPath': ['path']})
    c['crf_decoding-label'] = _case(
        'crf_decoding', crf_in, {'ViterbiPath': ['path']})
    lens_b = np.array([2, 4, 1], 'int32')
    c['sequence_concat'] = _case(
        'sequence_concat',
        {'X': [('xa', _f(22, B, T, 2)), ('xb', _f(23, B, 4, 2))],
         'SeqLens': [('la', LENS), ('lb', lens_b)]},
        {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'])
    c['sequence_concat-features'] = _case(
        'sequence_concat',
        {'X': [('xa', _f(22, B, T, 2)), ('xb', _f(23, B, T, 3))],
         'SeqLens': [('la', LENS), ('lb', LENS)]},
        {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'],
        attrs={'axis': 1})
    for dtype in ('int64', 'int32', 'float32', 'bool'):
        c['sequence_mask-' + dtype] = _case(
            'sequence_mask', {'X': LENS}, {'Y': ['y']},
            attrs={'maxlen': 6, 'out_dtype': dtype})
    for padded in (-1, 4, 7):
        c['sequence_pad%+d' % padded] = _case(
            'sequence_pad', {'X': _f(24, B, T, 2),
                             'PadValue': np.array([-2.5], 'float32'),
                             'SeqLens': LENS},
            {'Out': ['out'], 'Length': ['length']}, ['X'],
            attrs={'padded_length': padded})
    c['sequence_unpad'] = _case(
        'sequence_unpad', {'X': _f(25, B, T, 2),
                           'Length': LENS.astype('int64')},
        {'Out': ['out']}, ['X'])
    erase_ids = _ids(26, 5, B, T, 1)
    c['sequence_erase'] = _case(
        'sequence_erase', {'X': erase_ids, 'SeqLens': LENS},
        {'Out': ['out'], 'OutLens': ['out_lens']},
        attrs={'tokens': [2, 3]})
    c['sequence_erase-2d'] = _case(
        'sequence_erase', {'X': erase_ids[..., 0]},
        {'Out': ['out'], 'OutLens': ['out_lens']}, attrs={'tokens': [0]})
    for new_dim in (3, 12):
        c['sequence_reshape-%d' % new_dim] = _case(
            'sequence_reshape', {'X': _f(27, B, 4, 6),
                                 'SeqLens': np.array([4, 1, 2], 'int32')},
            {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'],
            attrs={'new_dim': new_dim})
    c['sequence_slice'] = _case(
        'sequence_slice', {'X': _f(28, B, T, 2),
                           'Offset': np.array([[1], [0], [2]], 'int64'),
                           'Length': np.array([[3], [1], [1]], 'int64'),
                           'SeqLens': LENS},
        {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'])
    c['row_conv'] = _case(
        'row_conv', {'X': x, 'Filter': _f(29, 3, 4), 'SeqLens': LENS},
        {'Out': ['out']}, ['X', 'Filter'])
    c['im2sequence'] = _case(
        'im2sequence', {'X': _f(30, 2, 3, 5, 6)},
        {'Out': ['out'], 'OutLens': ['out_lens']}, ['X'],
        attrs={'kernels': [2, 3], 'strides': [1, 2],
               'paddings': [1, 0, 0, 1]})
    for normalized in (False, True):
        c['edit_distance%s' % ('-normalized' if normalized else '')] = _case(
            'edit_distance',
            {'Hyps': _ids(31, 4, B, T, 1), 'Refs': _ids(32, 4, B, 6, 1),
             'HypLens': LENS, 'RefLens': np.array([6, 2, 0], 'int32')},
            {'Out': ['out'], 'SequenceNum': ['seq_num']},
            attrs={'normalized': normalized})
    c['edit_distance-no-lens'] = _case(
        'edit_distance',
        {'Hyps': _ids(33, 3, B, 4), 'Refs': _ids(34, 3, B, 7)},
        {'Out': ['out']}, attrs={'normalized': False})
    return c


CASES = _cases()


def test_cases_cover_the_19_op_types():
    assert len({c['type'] for c in CASES.values()}) == 19


def _inputs(case):
    """[(slot, var name, array)] of a case."""
    out = []
    for slot, val in case['inputs'].items():
        if isinstance(val, list):
            out += [(slot, name, arr) for name, arr in val]
        else:
            out.append((slot, 'in_' + slot.lower(), val))
    return out


def _build(fluid, case, amp=False):
    """The one-op program (behind an fc under AMP, which makes the bf16
    activation stream), its feed and its fetch names."""
    prog = fluid.Program()
    block = prog.global_block()
    checked = [n for slot, n, _ in _inputs(case) if slot in case['check']]
    feed, ins = {}, {}
    with fluid.program_guard(prog, fluid.Program()):
        for slot, name, arr in _inputs(case):
            var = block.create_var(name=name, shape=arr.shape,
                                   dtype=arr.dtype.name, is_data=True,
                                   stop_gradient=name not in checked)
            feed[name] = arr.copy()
            if amp and slot == 'Input':
                # the Input through an identity-initialised fc: bf16 out
                proj = fluid.layers.fc(
                    input=var, size=arr.shape[-1], num_flatten_dims=2,
                    bias_attr=False,
                    param_attr=fluid.ParamAttr(
                        name='proj_w',
                        initializer=fluid.initializer.NumpyArrayInitializer(
                            np.eye(arr.shape[-1], dtype='float32'))))
                if case['check']:
                    checked.append('proj_w')
                var = proj
            ins.setdefault(slot, []).append(var)
        outs = {slot: [block.create_var(name=n) for n in names]
                for slot, names in case['outputs'].items()}
        block.append_op(type=case['type'], inputs=ins, outputs=outs,
                        attrs=dict(case['attrs']))
        fetch = [n for names in case['outputs'].values() for n in names]
        if checked:
            targets = [block.var(n) for n in case['targets']]
            cots = []
            for i, t in enumerate(targets):
                cot = block.create_var(name='cot_%d' % i, shape=t.shape,
                                       dtype='float32', is_data=True,
                                       stop_gradient=True)
                cots.append(cot)
            inputs = [block.var(n) for n in checked]
            if amp:
                # the loss sum(target * cot): the recurrence's grad op
                # gets its output's dtype (bf16) back, as in training
                L = fluid.layers
                loss = L.sums([L.reduce_sum(L.elementwise_mul(t, c))
                               for t, c in zip(targets, cots)])
                grads = fluid.backward.calc_gradient(loss, inputs)
            else:
                grads = fluid.backward.calc_gradient(
                    targets, inputs, target_gradients=cots)
            fetch += [g.name for g in grads]
    if amp:
        prog._use_bf16 = True
    return prog, feed, fetch


def _cotangents(case, outs):
    """Seeded cotangents shaped as the JAX package's target outputs."""
    return {'cot_%d' % i: _f(100 + i, *np.shape(outs[n]))
            for i, n in enumerate(case['targets'])}


def _run(fluid, case, amp=False, cots=None, guard=None):
    prog, feed, fetch = _build(fluid, case, amp)
    if 'cot_0' in {v.name for v in prog.list_vars()}:
        feed.update(cots)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if amp:
        # the identity projection's initialiser went to a throwaway
        # startup program: set the parameter directly
        scope.set_var('proj_w', np.eye(
            case['inputs']['Input'].shape[-1], dtype='float32'))
    runs = [exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)]
    if guard is not None:
        runs.append(guard(lambda: exe.run(prog, feed=feed, fetch_list=fetch,
                                          scope=scope)))
    return [{n: np.asarray(v) for n, v in zip(fetch, got)} for got in runs]


def _forward_of(fluid, case, amp=False):
    """The target outputs' values (to shape the cotangents)."""
    prog, feed, fetch = _build(fluid, dict(case, check=[]), amp)
    scope = fluid.Scope()
    if amp:
        scope.set_var('proj_w', np.eye(
            case['inputs']['Input'].shape[-1], dtype='float32'))
    got = fluid.Executor(fluid.CPUPlace()).run(prog, feed=feed,
                                               fetch_list=fetch, scope=scope)
    return {n: np.asarray(v) for n, v in zip(fetch, got)}


def _compare(want, got, tol):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape, (n, g.shape, w.shape)
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=n)
        else:
            np.testing.assert_allclose(g.astype('float32'),
                                       w.astype('float32'), rtol=tol,
                                       atol=tol, err_msg=n)


def _second_run_guarded(monkeypatch):
    """A callable that runs its argument with every device op of the
    Executor under _NoHostData."""
    run_ops = texecutor.Executor._run_ops

    def guarded(step, ctx, drop):
        with _NoHostData():
            return run_ops(step, ctx, drop)

    def run(fn):
        monkeypatch.setattr(texecutor.Executor, '_run_ops',
                            staticmethod(guarded))
        try:
            return fn()
        finally:
            monkeypatch.setattr(texecutor.Executor, '_run_ops',
                                staticmethod(run_ops))
    return run


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


AMP_CASES = ['lstm', 'lstm-peep-rev-h0c0', 'gru', 'gru-rev-h0']


@pytest.mark.parametrize('name', AMP_CASES)
def test_recurrence_under_amp_matches_jax(name):
    case = CASES[name]
    cots = _cotangents(case, _forward_of(jfluid, case, amp=True))
    want, = _run(jfluid, case, amp=True, cots=cots)
    got, = _run(tfluid, case, amp=True, cots=cots)
    assert 'proj_w@GRAD' in got
    _compare(want, got, AMP_TOL)


def test_crf_and_viterbi_against_brute_force():
    """Every path of a tiny CRF enumerated (the JAX package's brute
    force): each sequence's NLL and its best path."""
    N = 3
    em = _f(40, B, T, N)
    tr = _f(41, N + 2, N)
    lab = _ids(42, N, B, T, 1)
    case = CASES['linear_chain_crf']
    case = dict(case, inputs=dict(case['inputs'], Emission=em,
                                  Transition=tr, Label=lab), check=[])
    got, = _run(tfluid, case)
    dec, = _run(tfluid, dict(CASES['crf_decoding'], inputs={
        'Emission': em, 'Transition': tr, 'SeqLens': LENS}))
    log_z, best = _brute_force_crf(em, tr, LENS)
    start, end, trans = tr[0], tr[1], tr[2:]
    for b, L in enumerate(LENS):
        y = lab[b, :, 0]
        gold = start[y[0]] + em[b, 0, y[0]] + end[y[L - 1]]
        for t in range(1, L):
            gold += trans[y[t - 1], y[t]] + em[b, t, y[t]]
        np.testing.assert_allclose(got['ll'][b, 0], log_z[b] - gold,
                                   rtol=1e-5)
        np.testing.assert_array_equal(dec['path'][b, :L, 0], best[b][:L])
        assert not dec['path'][b, L:].any()
