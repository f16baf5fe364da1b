"""chip_smoke.py's paged serving phases v1-v5 end to end on the CPU at a
tiny width.

Moved out of tests/test_torch_chip_smoke.py, unchanged, so that the
test runner's per-file distribution can run it beside that file's other
tests instead of after them."""
import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models.transformer import TransformerConfig


def test_paged_phases_run_on_the_cpu_at_a_tiny_width(tmp_path):
    """v1-v5 end to end on the CPU at a tiny width (vocab 64, dim 32, 2
    layers, max_len 512): the dense streams of c3's prompts, then every
    check of v1-v5 on the plain ops."""
    import paddle_tpu_torch as tfluid
    cfg = TransformerConfig(vocab=64, dim=32, heads=2, layers=2, ffn=64,
                            max_len=512, flash_attention=True, use_tp=False,
                            use_sp=False)
    place = tfluid.CPUPlace()
    chip_smoke.build_and_save(cfg, place, str(tmp_path))
    pred, dec = chip_smoke.load_and_prepare(str(tmp_path), place)
    prompts = chip_smoke.prompts_for(cfg.vocab, cfg.max_len)
    with tfluid.serving.LMServer(dec) as srv:
        hs = [srv.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
              for p in prompts]
        streams = [srv.result(h, 600) for h in hs]
    counters = {chip_smoke.KERNELS[k][0]: getattr(fa,
                                                  chip_smoke.KERNELS[k][0])
                for k in chip_smoke.KERNELS}

    def sync():
        pass
    v1 = chip_smoke.paged_serving(pred, dec, prompts, streams, counters,
                                  sync)
    pdec = v1.pop('dec')
    assert v1['captures']['prepared_programs'] == 2
    v2 = chip_smoke.prefix_sharing(pdec, sync)
    assert (v2['hits'], v2['reused'], v2['warm_chunks']) == \
        (7, 7 * chip_smoke.SYSTEM_PROMPT, 7)
    v3 = chip_smoke.preemption(pred, pdec, sync)
    assert v3['swap']['preemptions'] >= 1 and v3['swap']['swap_bytes'] > 0
    v4 = chip_smoke.speculative(pred, prompts, v1['streams'], pdec, sync)
    assert set(v4) == {1, cfg.layers}
    assert v4[cfg.layers]['accept_rate'] > v4[1]['accept_rate']
    v5 = chip_smoke.weight_swap(pred, pdec, sync)
    assert len(v5['checked']) == 4
