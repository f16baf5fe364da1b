"""chip_smoke.py's online-refresh and fleet phases on1, fl1 and fl2, run
end to end on the CPU at a tiny width: their processes are the ones the
card runs (the on1 cluster as `chip_smoke.py --ps-worker` roles, the
replicas as `python -m paddle_tpu_torch.tools.serve_replica` with
SERVE_PLACE=cpu), and each phase's checks are shown to fail on a planted
fault: a pserver that stamps one digest wrong (on1), a replica whose
deploy is skipped (fl1), a shipped page with one row changed (fl2)."""
import inspect

import numpy as np
import pytest

import chip_smoke
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models.transformer import TransformerConfig
from paddle_tpu_torch.serving import FleetRouter, disagg

ON_SPEC = {'model': dict(vocab=512, dim=32, heads=2, ffn=64, max_len=96),
           'batch': 2, 'head_chunk': 64, 'new_tokens': 8,
           'refresh_timeout': 60}
# replica 1 exits at its 2nd SRV_POLL (one a 10 ms router tick while it
# holds streams); 64 tokens keep every stream live for many ticks, so
# the kill lands mid-stream however fast the host decodes
FL1_SPEC = {'streams': 8, 'new_tokens': 64, 'max_prompt': 40, 'slots': 4,
            'kill_poll': 2}
FL2_SPEC = {'streams': 4, 'new_tokens': 8, 'slots': 4, 'page_tokens': 8,
            'chunk': 16, 'system': 32}


@pytest.fixture(autouse=True)
def remove_scratch():
    yield
    chip_smoke.remove_scratch()


@pytest.fixture(scope='module')
def model_dir(tmp_path_factory):
    """c1's model at a tiny width, saved by the port on the CPU."""
    d = str(tmp_path_factory.mktemp('fleet_smoke_model'))
    cfg = TransformerConfig(**dict(chip_smoke.MODEL, vocab=512, dim=32,
                                   heads=2, ffn=64, layers=2, max_len=64))
    chip_smoke.build_and_save(cfg, tfluid.CPUPlace(), d)
    return d


def test_fleet_phases_are_wired_into_main_last(tmp_path):
    src = inspect.getsource(chip_smoke.main)
    # on1, fl1 and fl2 are units of the second lane, which main() lets
    # start once c1 has saved the model the fleets load, and joins last
    units = inspect.getsource(chip_smoke.second_lane_units)
    for call in ('online_refresh(', 'fleet_serving(model_dir',
                 'disagg_serving(model_dir'):
        assert call in units
    order = ['SecondLane(model_dir', 'check_probe(', 'build_and_save(',
             'update(go=True)', 'nhwc_steps(', 'second.join()',
             'except PhaseError']
    pos = [src.index(s) for s in order]
    assert pos == sorted(pos)
    # the replicas' fp32 K1 launches join K1's row
    assert "sum(fl1['launches'].values())" in src
    # on1's roles start through ps1's runner and worker entry
    module = inspect.getsource(chip_smoke)
    assert 'def on_worker_main' not in module
    assert "run_ps_cluster('on1'" in module
    assert "+ on1['launches']['K1']" in src
    for fn, name, args in ((chip_smoke.online_refresh, 'on1', ()),
                           (chip_smoke.fleet_serving, 'fl1', ('x',)),
                           (chip_smoke.disagg_serving, 'fl2', ('x',))):
        with pytest.raises(chip_smoke.PhaseError, match='phase %s: ' % name):
            fn(*args, str(tmp_path / 'missing'))


def test_on1_serving_and_training_share_every_parameter_name():
    """The serving program's parameters are the trainer's, name for
    name and shape for shape (the refresh installs by name)."""
    prog, _, _ = chip_smoke.on_serving_program({})
    t, _, _ = chip_smoke._on_transpiled({}, '127.0.0.1:1,127.0.0.1:2')
    train = {p.name: tuple(p.shape) for p in
             t.origin_program.global_block().all_parameters()}
    serve = {p.name: tuple(p.shape) for p in
             prog.global_block().all_parameters()}
    assert serve == train
    cfg = chip_smoke.ps_lm_cfg({})
    assert (cfg.vocab, cfg.dim, cfg.heads, cfg.ffn, cfg.layers) == \
        (32768, 2048, 16, 8192, 2)


def test_on1_runs_on_the_cpu_and_refuses_a_corrupted_digest(tmp_path):
    out = chip_smoke.online_refresh(str(tmp_path), spec=ON_SPEC,
                                    place_name='cpu')
    assert out['refreshes'] >= 1 and out['equal'] == chip_smoke.ON_PROMPTS
    assert out['n_params'] > 0 and out['mb'] > 0
    with pytest.raises(chip_smoke.PhaseError, match='digest mismatch'):
        chip_smoke.online_refresh(str(tmp_path),
                                  spec=dict(ON_SPEC, plant='digest'),
                                  place_name='cpu')


def test_fl1_runs_on_the_cpu_and_refuses_a_skipped_deploy(tmp_path,
                                                          model_dir,
                                                          monkeypatch):
    out = chip_smoke.fleet_serving(model_dir, str(tmp_path), spec=FL1_SPEC,
                                   place_name='cpu')
    assert out['failovers'] >= 1 and out['equal'] == FL1_SPEC['streams']
    assert out['deploy_equal'] == chip_smoke.FL1_DEPLOY_STREAMS
    assert set(out['launches']) == {'r0', 'd0', 'd1'}
    orig = FleetRouter._deploy_one
    seen = []

    def skip_second(self, rep, min_version, timeout):
        seen.append(rep.endpoint)
        if len(seen) == 2:
            return int(min_version)      # reported, never refreshed
        return orig(self, rep, min_version, timeout)
    monkeypatch.setattr(FleetRouter, '_deploy_one', skip_second)
    with pytest.raises(chip_smoke.PhaseError, match='not as published'):
        chip_smoke.fleet_serving(model_dir, str(tmp_path), spec=FL1_SPEC,
                                 place_name='cpu')


def test_fl2_runs_on_the_cpu_and_refuses_a_changed_row(tmp_path, model_dir,
                                                       monkeypatch):
    out = chip_smoke.disagg_serving(model_dir, str(tmp_path), spec=FL2_SPEC,
                                    place_name='cpu')
    assert out['bit_equal'] and out['row_err'] == 0.0
    assert out['local_reprefills'] >= 1
    assert out['equal'] == out['streams'] == 2 * FL2_SPEC['streams']
    orig = disagg.unpack_rows

    def one_row_changed(meta, value):
        rows = [np.array(r) for r in orig(meta, value)]
        rows[0][0, 0] += 1.0
        return rows
    monkeypatch.setattr(disagg, 'unpack_rows', one_row_changed)
    with pytest.raises(chip_smoke.PhaseError,
                       match='shipped page rows differ'):
        chip_smoke.disagg_serving(model_dir, str(tmp_path), spec=FL2_SPEC,
                                  place_name='cpu')
