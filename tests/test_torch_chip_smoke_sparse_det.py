"""chip_smoke.py's sparse and detection phases sp1, det1 and det2 end to
end on the CPU at tiny widths.

Moved out of tests/test_torch_chip_smoke.py, unchanged, so that the
test runner's per-file distribution can run it beside that file's other
tests instead of after them."""
import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


def test_sparse_and_detection_phases_run_on_the_cpu_at_a_tiny_width():
    """sp1, det1 and det2 end to end on the CPU at tiny widths: lazy
    Adam's untouched rows, captured vs op by op (op by op twice here),
    sparse vs dense (the same bits), the word2vec fan-out, the SSD step
    vs the CPU, detection_margin on the decode."""
    import paddle_tpu_torch as tfluid
    place = tfluid.CPUPlace()

    def sync():
        pass
    w = dict(dict_size=50, word=8, hidden=8, batch=4, lr=1e-2, max_len=6,
             beam=3)
    sp1 = chip_smoke.sparse_steps(place, sync, w, dict(embed=8, hidden=16,
                                                       batch=8, lr=0.05))
    assert sp1['bits'] and sp1['cpu'][0] == 0.0
    assert sp1['lazy'][0] == 2 * chip_smoke.SQ_BATCHES and \
        sp1['lazy'][1] > 0
    for k in ('adam', 'sgd', 'word2vec'):
        assert max(sp1[k][0].values()) == 0.0
    det1 = chip_smoke.ssd_steps(place, sync, chip_smoke.SSD_TINY)
    assert det1['bits'] and det1['cpu'][0] == 0.0
    assert det1['sizes'] == [(16, 16), (8, 8), (4, 4)]
    det2 = chip_smoke.ssd_decode(det1, place, sync, chip_smoke.SSD_TINY)
    assert det2['margin'][:2] == (chip_smoke.SSD_TINY['decode_batch'], 0)
    assert det2['map_diff'] == 0.0 and min(det2['count']) > 0
    assert 0.0 < det2['mixed'][0] < 1.0 and det2['mixed'][1] == 0.0
