"""chip_smoke.py's profiler and record-file phases pf1 and rf1 end to
end on the CPU at a tiny width.

Moved out of tests/test_torch_chip_smoke.py, unchanged, so that the
test runner's per-file distribution can run it beside that file's other
tests instead of after them."""
import numpy as np

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.models.transformer import TransformerConfig


def test_pf1_and_rf1_run_on_the_cpu_at_a_tiny_width(tmp_path, monkeypatch):
    import paddle_tpu_torch as tfluid
    place = tfluid.CPUPlace()
    cfg = TransformerConfig(vocab=64, dim=32, heads=2, layers=2, ffn=64,
                            max_len=16, flash_attention=True, use_tp=False,
                            use_sp=False)
    tr = chip_smoke.LMRun(cfg, place, 2, 64, 'pf1_tiny_reader')
    tr.feed(chip_smoke.bench_provider(cfg, 2, np.random.RandomState(0)))
    for _ in range(3):
        tr.step()
    try:
        pf1 = chip_smoke.profile_lm_steps(tr, 0, lambda: None,
                                          str(tmp_path), place)
    finally:
        chip_smoke.remove_scratch()
    assert pf1['maps'] == 1 and pf1['tl_out'] == pf1['r_out'] == 0.0
    assert pf1['drive'][1] < 0.05 * pf1['drive'][0]
    monkeypatch.setattr(chip_smoke, 'RESNET',
                        dict(depth=50, image_hw=32, class_dim=1000))
    monkeypatch.setattr(chip_smoke, 'RF',
                        dict(files=2, records=8, per_chunk=4, threads=2,
                             decode_s=0.2, warmup=2, iters=1))
    try:
        rf1 = chip_smoke.record_file_steps(place, lambda: None,
                                           str(tmp_path), 0, batch=4)
    finally:
        chip_smoke.remove_scratch()
    assert rf1['bits'] and rf1['img_err'] <= chip_smoke.RF_IMAGE_ATOL
    assert set(rf1['rates']) == {1, 2} and min(rf1['rates'].values()) > 0
    assert rf1['pre_ms'] > 0 and rf1['rec_ms'] > 0
