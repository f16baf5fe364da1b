"""chip_smoke.py's mesh phases mp1, mp2, pp1, ck1 and sv1 end to end on
the CPU at a tiny width, and their wiring into main().

Kept apart from tests/test_torch_chip_smoke.py so that the test runner's
per-file distribution can run their ranks beside that file's other
tests."""
import pytest

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


# -- mp1, mp2: the device mesh ------------------------------------------------

MP_TINY = dict(vocab=512, dim=64, heads=2, ffn=128, max_len=64, layers=2)


@pytest.mark.parametrize('name', ['mp1', 'mp2', 'pp1', 'ck1', 'sv1'])
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
    bits, and the one-process restore is the same bits. sv1 (2 layers,
    use_tp, 8 requests x 8 tokens) on 2 CPU ranks of a tp=2 serving
    mesh: dense and paged streams against the one-process server's,
    the mesh stats, each rank's half of every qkv and up weight, the
    ranks gone at the end."""
    if name == 'sv1':
        try:
            out = chip_smoke.mesh_serving(
                str(tmp_path), spec={'model': dict(MP_TINY),
                                     'new_tokens': 8, 'timed': 2},
                place_name='cpu')
        finally:
            chip_smoke.remove_scratch()
        assert out['world'] == 2
        assert out['dense']['equal'] + len(out['dense']['ties']) == 8
        assert out['paged']['equal'] + len(out['paged']['ties']) == 8
        assert min(out['collective_s']) > 0
        return
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
    # the mesh phases are units of the second lane, which main() joins
    # after its last phase
    units = inspect.getsource(chip_smoke.second_lane_units)
    for call in ('_ck1_beside_a3_a4(', 'mesh_ring_steps(',
                 '_pp1_then_sv1(', 'mesh_tp_steps('):
        assert call in units
    assert src.index('lc_steps(') < src.index('second.join()') < \
        src.index("lane['sv1']")
    # sv1's ranks start beside pp1; their K1 fp32 launches count on the
    # K1 fp32 row
    pp = inspect.getsource(chip_smoke._pp1_then_sv1)
    assert pp.index('start_serving_group') < pp.index('pipeline_steps(') \
        < pp.index('starter.join()') < pp.index('mesh_serving(')
    assert "sv1['launches']['K1']" in src
    # ck1 runs beside a3 and a4 (values only)
    ck = inspect.getsource(chip_smoke._ck1_beside_a3_a4)
    assert ck.index('checkpoint_kill_steps') < \
        ck.index('check_optimizer_ops(') < \
        ck.index('check_training_ops(') < ck.index('ck1_thread.join()')
    for name in ('mp1', 'mp2', 'pp1'):
        assert "%s['launches']['K1']" % name in src and \
            "%s['launches']['K2']" % name in src
    # ck1 trains under the deterministic split backward
    for kind in ('K1', 'K3a', 'K3b'):
        assert "ck1['launches']['%s']" % kind in src
