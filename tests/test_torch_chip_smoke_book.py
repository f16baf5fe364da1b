"""chip_smoke.py's book phases bk1, bk2, bk3 and mo1 end to end on the CPU
at a small width.

Moved out of tests/test_torch_chip_smoke.py, unchanged, so that the
test runner's per-file distribution can run it beside that file's other
tests instead of after them."""
import numpy as np

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


def test_book_phases_run_on_the_cpu_at_a_small_width(tmp_path):
    """bk1, bk2, bk3 and mo1 end to end on the CPU (depth 8, batch 8; the
    kernels' plain versions): x1's rule, the fused step vs the unfused
    one by r2's rule, every chapter's loss falling, the inference round
    trip, memory_optimize and release_memory the same bits, and the
    Print text."""
    import paddle_tpu_torch as tfluid
    place = tfluid.CPUPlace()

    def sync():
        pass
    bk1 = chip_smoke.book_image_steps(place, sync, depth=8, batch=8)
    assert len(bk1['losses']) == chip_smoke.BOOK['steps']
    assert bk1['bits'] and np.isfinite(bk1['losses']).all()
    bk2 = chip_smoke.book_fused_steps(bk1, place, sync)
    assert bk2['launches'] == 0 and bk2['k6_ms'] == {}
    assert bk2['r2']['loss_diff'] <= chip_smoke.TRAIN_LOSS_TOL
    bk3 = chip_smoke.book_chapter_steps(place, sync, str(tmp_path / 'fit'),
                                        scale=8)
    assert sorted(bk3) == ['fit_a_line', 'recognize_digits', 'word2vec']
    assert bk3['fit_a_line']['round_trip'] <= chip_smoke.SAVE_TOL
    mo1 = chip_smoke.memory_modules(bk1, place, sync)
    assert mo1['release_memory']['segments'] > \
        mo1['release_memory']['plain_segments'] == 1
    assert mo1['print']['segments'] >= 2 and mo1['print']['chars'] > 0
