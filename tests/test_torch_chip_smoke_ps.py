"""chip_smoke.py's parameter-server phases ps1 and ps2, without a card:
their wiring into main() after rf1, the programs they train (the
flagship LM at full width cut to 2 layers, DeepFM at its Criteo
settings with a distributed table), how those transpile, the CTR
batches, and the checks refusing a trainer that starts off the
pservers' slices, trainers that end apart, losses that do not fall, an
update off the local run's, and the split of a step read from the
profiler's host events. (The
phases run end to end on the CPU through `chip_smoke.ps_lm_steps(root,
spec=..., place_name='cpu')`, a cluster of subprocesses; the port's own
clusters are tests/test_torch_dist_pserver.py's.)"""
import inspect

import numpy as np
import pytest

import chip_smoke
import paddle_tpu_torch as tfluid


def test_ps_phases_are_wired_into_main_after_rf1(tmp_path):
    src = inspect.getsource(chip_smoke.main)
    order = ['record_file_steps(', 'ps_lm_steps(', 'ps_deepfm_steps(',
             'nhwc_steps(']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    # ps1's fp32 K1 and K2 join their kernel rows' launches
    assert "ps1['launches']['K1']" in src and "ps1['launches']['K2']" in src
    assert "'--ps-worker'" in src
    for fn, name in ((chip_smoke.ps_lm_steps, 'ps1'),
                     (chip_smoke.ps_deepfm_steps, 'ps2')):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(str(tmp_path / 'missing'))


def _transpile(phase, spec=None):
    t, loss, batches = chip_smoke._ps_transpiled(
        phase, spec or {}, 0, '127.0.0.1:1,127.0.0.1:2')
    return t, loss, batches


def test_ps1_trains_the_flagship_lm_cut_to_two_layers():
    """MODEL's widths, 2 layers: 236 M parameters, 0.94 GB of fp32
    gradients a step, every large one sliced over both pservers; fp32
    flash attention (2 forward, 2 backward ops); SGD 1e-3 on the
    pservers; one global batch of 2 x 8 sequences."""
    t, loss, batches = _transpile('ps1')
    params = t.origin_program.global_block().all_parameters()
    n = sum(int(np.prod(p.shape)) for p in params)
    assert 230e6 < n < 240e6, n
    cfg = chip_smoke.ps_lm_cfg({})
    assert (cfg.vocab, cfg.dim, cfg.heads, cfg.ffn, cfg.max_len,
            cfg.layers) == (32768, 2048, 16, 8192, 512, 2)
    assert cfg.flash_attention and not t.origin_program._use_bf16
    prog = t.get_trainer_program()
    types = [op.type for op in prog.global_block().ops]
    assert types.count('flash_attention') == 2
    assert types.count('flash_attention_grad') == 2
    assert 'sgd' not in types and types.count('concat') > 0
    assert {i.ep for i in t.var_blocks} == set(t.pserver_endpoints)
    big = [i for i in t.var_blocks if i.split_count > 1]
    assert len(big) >= 2 * 8
    pprog = t.get_pserver_program(t.pserver_endpoints[0])
    lsv = pprog.global_block().ops[-1]
    assert lsv.type == 'listen_and_serv' and lsv.attr('sync_mode')
    assert lsv.attr('Fanin') == chip_smoke.PS_TRAINERS == 2
    sgd = [op for b in pprog.blocks[1:] for op in b.ops]
    assert {op.type for op in sgd} == {'sgd'}
    assert len(batches) == chip_smoke.PS_STEPS == 4
    assert batches[0]['tokens'].shape == (16, 512, 1)
    # the start of the trainer's startup pulls the pservers' values
    tail = [op.type for op in t.get_trainer_startup_program()
            .global_block().ops][-3:]
    assert 'recv' in [op.type for op in t.get_trainer_startup_program()
                      .global_block().ops] and tail[-1] == 'concat'


def test_ps2_trains_deepfm_at_its_criteo_settings():
    """39 fields (13 dense, 26 categorical), embedding 10 over 1,000,001
    hashed ids, distributed (prefetched, split_ids backward, absent from
    the trainer), the first-order table is_sparse, a 400-400-400 tower,
    Adam 1e-3 on the pservers, no dropout, batch 2 x 1000."""
    t, loss, batches = _transpile('ps2')
    assert t.table_name == 'fm_emb' and t._table_shape == (1000001, 10)
    prog = t.get_trainer_program()
    block = prog.global_block()
    types = [op.type for op in block.ops]
    assert 'prefetch' in types and 'split_ids' in types
    assert 'dropout' not in types and 'adam' not in types
    assert not block.has_var('fm_emb')
    fcs = [op for op in t.origin_program.global_block().ops
           if op.type == 'mul']
    assert [tuple(t.origin_program.global_block().var(
        op.input('Y')[0]).shape) for op in fcs] == [
        (390, 400), (400, 400), (400, 400), (400, 1)]
    w1 = [i for i in t.var_blocks if i.param.name == 'fm_w1']
    assert w1 and all(i.sparse for i in w1)
    for ep in t.pserver_endpoints:
        pp = t.get_pserver_program(ep)
        assert pp.global_block().var('fm_emb').shape[0] in (500000, 500001)
        assert {op.type for b in pp.blocks[1:] for op in b.ops} == {'adam'}
    b = batches[0]
    assert b['feat_idx'].shape == b['feat_value'].shape == (2000, 39)
    assert b['label'].shape == (2000, 1)


def test_deepfm_batches_are_zipf_skewed_hashed_and_seeded():
    ps2 = chip_smoke.PS2
    a = chip_smoke.deepfm_batches(ps2, 2, 2000)
    b = chip_smoke.deepfm_batches(ps2, 2, 2000)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    idx = a[0]['feat_idx']
    assert idx.min() >= 0 and idx.max() < ps2['ids']
    assert np.array_equal(idx[:, :13], np.tile(np.arange(13), (2000, 1)))
    cat = idx[:, 13:]
    # Zipf(1.1): a field's most frequent id takes a large share of rows
    shares = [np.unique(cat[:, f], return_counts=True)[1].max() / 2000.
              for f in range(26)]
    assert min(shares) > 0.05          # 1/zeta(1.1) ~ 0.095; uniform ~ 1e-6
    assert len(np.unique(cat)) > 5000
    val = a[0]['feat_value']
    assert np.all(val[:, 13:] == 1) and 0 <= val[:, :13].min() < \
        val[:, :13].max() < 1
    assert 0.15 < a[0]['label'].mean() < 0.35
    # a spec's 'seed' draws other batches (the readings on other seeds)
    c = chip_smoke.deepfm_batches(ps2, 1, 2000, chip_smoke.SEED + 1)
    assert not np.array_equal(c[0]['feat_idx'], idx)
    assert chip_smoke._ps_transpiled('ps2', {'seed': chip_smoke.SEED + 1},
                                     0, '127.0.0.1:1,127.0.0.1:2')[0] \
        .origin_program.random_seed == chip_smoke.SEED + 1


def _results(change=None):
    res = {'pserver0': {'digests': {'w.block0': 1, 'b': 2}},
           'pserver1': {'digests': {'w.block1': 3}}}
    for i in range(2):
        res['trainer%d' % i] = {
            'digests': {'w.block0': 1, 'b': 2, 'w.block1': 3},
            'final': {'w': 7, 'b': 8}, 'losses': [2.0, 1.5, 1.2, 1.0]}
    for (role, key), value in (change or {}).items():
        res[role][key] = value
    return res


def test_ps_checks_pass_a_good_cluster_and_refuse_faults():
    assert chip_smoke._ps_common_checks('ps1', _results()) == 3
    bad = [
        (('trainer1', 'digests'), {'w.block0': 1, 'b': 2, 'w.block1': 4},
         'differs from the pservers'),
        (('trainer1', 'final'), {'w': 7, 'b': 9}, 'different parameters'),
        (('trainer0', 'losses'), [2.0, 1.5, 1.2, 2.1], 'do not fall'),
        (('trainer0', 'losses'), [2.0, float('nan'), 1.2, 1.0],
         'do not fall'),
    ]
    for key, value, match in bad:
        with pytest.raises(AssertionError, match=match):
            chip_smoke._ps_common_checks('ps1', _results({key: value}))


def test_step_parts_read_the_profilers_host_events(tmp_path):
    """A trainer step split by part from fluid.profiler's host trace:
    send's wait for the card counts as device time, not send's; the
    segments after recv are concat's."""
    prof = tfluid.profiler
    spans = [('device_segment:0(9 ops)', 2.0), ('host_op:send', 5.0),
             ('host_op:send_barrier', 1.0), ('host_op:recv', 4.0),
             ('host_op:fetch_barrier', 0.5), ('device_segment:7(1 ops)', 0.25)]
    path = str(tmp_path / 'step.trace')
    prof.start_profiler('CPU')
    t = 100.0
    for name, ms in spans:
        ev = prof.RecordEvent(name)
        ev.start = t
        t += ms / 1e3
        with mock_perf_counter(t):
            ev.__exit__(None, None, None)
        if name == 'host_op:send':
            inner = prof.RecordEvent('send:wait_for_device')
            inner.start = t - 3e-3
            with mock_perf_counter(t - 1e-3):
                inner.__exit__(None, None, None)
    prof.stop_profiler(None, path)
    events = chip_smoke._host_events(path)
    assert [n for n, _, _ in events][:2] == ['device_segment:0(9 ops)',
                                             'host_op:send']
    parts = chip_smoke._step_parts(events)
    want = {'device': 4.0, 'send': 3.0, 'barriers': 1.5, 'recv': 4.0,
            'concat': 0.25, 'prefetch': 0.0, 'split': 0.0}
    assert set(parts) == set(want)
    for k, v in want.items():
        assert abs(parts[k] - v) < 1e-6, (k, parts[k], v)


def mock_perf_counter(value):
    from unittest import mock
    return mock.patch.object(tfluid.profiler.time, 'perf_counter',
                             return_value=value)


def test_the_worker_entry_needs_its_arguments_and_the_package():
    """The script's worker mode is taken only with `--ps-worker <role>
    <index>` beside the package; bare, the script still refuses to run
    without a card."""
    src = inspect.getsource(chip_smoke.main)
    assert "len(sys.argv) == 4 and sys.argv[1] == '--ps-worker'" in src
    assert src.index("'--ps-worker'") < src.index('torch.cuda.is_available')
    assert tfluid.DistributeTranspiler is not None


def test_ps_local_check_holds_each_update_to_a_fixed_limit():
    """Every parameter's gradient-weighted update difference from the
    local run within PS_UPDATE_TOL, the trainers' mean loss within
    PS_LOSS_TOL of the local run's at every step and the largest weight
    difference within the phase's fixed limit, whatever the same local
    run's spread against the CPU; ps2's pulled values the startup's CPU
    draws."""
    def res(**local):
        base = {'pulled_mismatch': [], 'diffs': {'w': 5e-5, 'b': 1e-6},
                'weighted': {'w': chip_smoke.PS_UPDATE_TOL / 2, 'b': 0.0},
                'losses': [2.0, 1.5], 'cpu_spread': {'w': 1.0}}
        base.update(local)
        return {'trainer0': {'losses': [2.0 + 4e-6, 1.6], 'local': base},
                'trainer1': {'losses': [2.0, 1.4]}}
    for phase in ('ps1', 'ps2'):
        worst, weighted, loss = chip_smoke._ps_local_check(phase, res())
        assert (worst, weighted) == (5e-5, chip_smoke.PS_UPDATE_TOL / 2)
        assert abs(loss - 2e-6) < 1e-9
        for stale in (1.0, 2 * chip_smoke.PS_UPDATE_TOL, float('nan')):
            with pytest.raises(AssertionError, match=r"\['b'\] differ"):
                chip_smoke._ps_local_check(
                    phase, res(weighted={'w': 0.0, 'b': stale}))
        with pytest.raises(AssertionError, match='mean losses'):
            chip_smoke._ps_local_check(phase, res(losses=[2.0, 1.5 + 3e-5]))
        with pytest.raises(AssertionError, match='CPU draws'):
            chip_smoke._ps_local_check(phase, res(pulled_mismatch=['w']))
    far = res(diffs={'w': 1.5e-4})
    with pytest.raises(AssertionError, match='want <= 0.0001'):
        chip_smoke._ps_local_check('ps1', far)
    assert chip_smoke._ps_local_check('ps2', far)[0] == 1.5e-4
    with pytest.raises(AssertionError, match='want <= 0.001'):
        chip_smoke._ps_local_check('ps2', res(diffs={'w': 1.1e-3}))
