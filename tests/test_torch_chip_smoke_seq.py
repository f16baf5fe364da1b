"""chip_smoke.py's sequence phases sq1-sq4 end to end on the CPU at tiny
widths, and sq4's chunk_eval refusing other counts.

Moved out of tests/test_torch_chip_smoke.py, unchanged, so that the
test runner's per-file distribution can run it beside that file's other
tests instead of after them."""
import pytest

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


def test_sequence_phases_run_on_the_cpu_at_a_tiny_width():
    """sq1-sq4 end to end on the CPU at tiny widths: x1's rule, the loss
    falling on the second pass, the card-vs-CPU comparison (here the CPU
    twice: the same bits), the frozen embedding and the Viterbi margin
    rule."""
    import paddle_tpu_torch as tfluid
    place = tfluid.CPUPlace()

    def sync():
        pass
    sq1 = chip_smoke.stacked_lstm_steps(
        place, sync, dict(vocab=100, T=6, batch=4, emb=8, hid=8))
    assert sq1['bits'] and sq1['cpu'][0] == 0.0
    assert len(sq1['losses']) == 2 * chip_smoke.SQ_BATCHES
    sq2 = chip_smoke.sentiment_steps(place, sync, dict(
        emb=8, hid=8, stacked=3, batch=4, lr=0.05))
    assert sorted(sq2) == ['conv', 'stacked_lstm']
    assert all(r['signatures'] >= 1 for r in sq2.values())
    sq3 = chip_smoke.recommender_steps(place, sync, dict(batch=8, lr=0.2))
    assert sq3['falls'][1] < sq3['falls'][0]
    sq4 = chip_smoke.srl_steps(place, sync, dict(
        word_dim=32, mark_dim=5, hidden=8, depth=2, batch=3,
        mix_hidden_lr=1e-3))
    assert sq4['viterbi'] == (3, 0.0) and sq4['cpu'][0] == 0.0


def test_sq4_chunk_eval_runs_and_refuses_other_counts(monkeypatch):
    import paddle_tpu_torch as tfluid
    w = dict(word_dim=32, mark_dim=5, hidden=8, depth=2, batch=3,
             mix_hidden_lr=1e-3)
    sq4 = chip_smoke.srl_steps(tfluid.CPUPlace(), lambda: None, w)
    assert len(sq4['chunks']) == 3 and all(0 <= v <= 1 for v in
                                           sq4['chunks'])
    program = chip_smoke._chunk_program
    calls = []

    def other(fluid, B, T, n):
        calls.append(1)
        # the first batch's card side counts one chunk type fewer
        return program(fluid, B, T, n - (len(calls) == 1))
    monkeypatch.setattr(chip_smoke, '_chunk_program', other)
    with pytest.raises(chip_smoke.PhaseError, match='chunk_eval'):
        chip_smoke.srl_steps(tfluid.CPUPlace(), lambda: None, w)
