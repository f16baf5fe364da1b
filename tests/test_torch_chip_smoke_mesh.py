"""chip_smoke.py's mesh phases mp1, mp2, pp1 and ck1 end to end on the
CPU at a tiny width, and their wiring into main().

Kept apart from tests/test_torch_chip_smoke.py so that the test runner's
per-file distribution can run their ranks beside that file's other
tests."""
import pytest

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


# -- mp1, mp2: the device mesh ------------------------------------------------

MP_TINY = dict(vocab=512, dim=64, heads=2, ffn=128, max_len=64, layers=2)


@pytest.mark.parametrize('name', ['mp1', 'mp2', 'pp1', 'ck1'])
def test_mesh_phases_run_on_the_cpu_at_a_tiny_width(tmp_path, name):
    """mp1 (the ring LM on sp=4), mp2 (the flagship LM on dp=2 x tp=2) and
    pp1 (4 layers, 2 a stage, on pp=2 x dp=2) through the one runner and
    worker entry, 4 CPU ranks, D 64, T 64: the ranks agree, start from
    the one-process run's weights, and their losses and first-step
    updates are within its bounds; mp1's ranks compute r + 1 blocks each
    way a step, pp1's move activations, cotangents and gradient sums
    over pp. ck1 (2 layers, dp=2 with ZeRO-3, 6 steps, a save every 2,
    rank 1 killed at its 5th step) on 2 CPU ranks under the Supervisor:
    the killed job resumes at incarnation 1 and ends on the fault-free
    bits, and the one-process restore is the same bits."""
    if name == 'ck1':
        spec = {'model': dict(MP_TINY), 'batch': 4, 'head_chunk': 128}
        try:
            out = chip_smoke.checkpoint_kill_steps(str(tmp_path), spec=spec,
                                                   place_name='cpu')
        finally:
            chip_smoke.remove_scratch()
        assert out['n_vars'] > 0 and out['restored_mb'] > 0
        for st in out['stats']['base'].values():
            assert st['files'] > 0 and st['max_host_bytes'] > 0
        return
    fn = {'mp1': chip_smoke.mesh_ring_steps, 'mp2': chip_smoke.mesh_tp_steps,
          'pp1': chip_smoke.pipeline_steps}[name]
    spec = {'model': dict(MP_TINY), 'batch': 4, 'head_chunk': 128}
    if name == 'pp1':
        spec['model'].update(layers=4, pp_stages=2)
        spec['batch'] = 8
    try:
        out = fn(str(tmp_path), spec=spec, place_name='cpu')
    finally:
        chip_smoke.remove_scratch()
    assert out['loss_diff'] <= chip_smoke.TRAIN_LOSS_TOL
    assert max(out['upd'].values()) <= chip_smoke.TRAIN_UPDATE_TOL
    if name == 'mp2':
        assert 'all-reduce' in out['audit']
    if name == 'pp1':
        assert all(r['grad_bytes'] > 0 for r in out['pp'])
        assert sum(r['act_bytes'] for r in out['pp']) == \
            sum(r['cot_bytes'] for r in out['pp']) > 0


def test_mesh_phases_are_wired_into_main():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    assert src.index('disagg_serving(') < src.index('mesh_ring_steps(') < \
        src.index('mesh_tp_steps(') < src.index('pipeline_steps(')
    # ck1 runs beside a3 and a4 (values only), joined before moe1
    assert src.index('checkpoint_kill_steps') < \
        src.index('check_optimizer_ops(') < \
        src.index('check_training_ops(') < src.index('ck1_thread.join()') \
        < src.index('moe_steps(')
    for name in ('mp1', 'mp2', 'pp1'):
        assert "%s['launches']['K1']" % name in src and \
            "%s['launches']['K2']" % name in src
    # ck1 trains under the deterministic split backward
    for kind in ('K1', 'K3a', 'K3b'):
        assert "ck1['launches']['%s']" % kind in src
