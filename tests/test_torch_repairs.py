"""Two faults of the port against the JAX package, repaired.

1. The flash_attention op sent every CUDA tensor to the kernels, which
   raise for a head dim other than 64 or 128 or a dtype other than fp32
   or bf16; the JAX package sends every shape its kernel does not tile
   to the naive contraction. The port now routes by one predicate,
   kernels.flash_attention.kernel_takes, and counts every plain forward
   on a CUDA tensor in FlashAttention.plain_cuda_calls.
2. TransformerConfig's defaults differed from the JAX package's
   (use_tp=False, use_sp=False, raising on True). The default config now
   builds the same main and startup Program in both packages, through
   the one-device parallel layers, and trains three Momentum steps equal
   to the JAX package's.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import transformer as ttransformer
from test_torch_training import _jax_run, _port_run_matches

# TransformerConfig's defaults spelled out (the batches need vocab and
# max_len); use_tp, use_sp and flash_attention are left to the defaults
DEFAULT_CFG = dict(vocab=256, dim=64, heads=4, layers=2, ffn=128,
                   max_len=64)


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


# -- 1: the route to the plain versions ----------------------------------------

def _cuda_like(d, dtype, bh=8, t=32):
    """What kernel_takes reads of a [BH, T, d] CUDA tensor, without a
    card."""
    return types.SimpleNamespace(device=torch.device('cuda', 0),
                                 dtype=dtype, shape=(bh, t, d),
                                 dim=lambda: 3)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=['fp32', 'bf16', 'fp16'])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_kernel_takes_only_the_kernels_shapes(d, dtype):
    want = d in (64, 128) and dtype in (torch.float32, torch.bfloat16)
    assert fa.kernel_takes(_cuda_like(d, dtype)) is want
    # a CPU tensor of any shape goes to the plain versions
    assert not fa.kernel_takes(torch.zeros(2, 8, d, dtype=dtype))


def test_kernel_takes_bounds_the_grid():
    assert fa.kernel_takes(_cuda_like(64, torch.bfloat16, bh=65535))
    assert not fa.kernel_takes(_cuda_like(64, torch.bfloat16, bh=65536))
    assert not fa.kernel_takes(_cuda_like(64, torch.bfloat16, bh=0))


def test_the_route_is_the_predicate(monkeypatch):
    """FlashAttention routes by kernel_takes and nothing else: a
    predicate that says yes sends even a CPU tensor to the kernel
    wrapper (which refuses it), and CPU plain calls are not counted."""
    q = torch.from_numpy(np.random.RandomState(1).randn(
        2, 8, 16).astype('float32'))
    before = fa.FlashAttention.plain_cuda_calls
    fa.flash_attention(q, q, q)
    assert fa.FlashAttention.plain_cuda_calls == before
    monkeypatch.setattr(fa, 'kernel_takes', lambda t: True)
    with pytest.raises(ValueError, match='needs a CUDA tensor'):
        fa.flash_attention(q, q, q)


# -- 2: TransformerConfig's defaults -------------------------------------------

def _build_default(fluid, unique_name, transformer):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[1, 64, 1],
                                 dtype='int64', append_batch_size=False)
        transformer.language_model_logits(
            toks, transformer.TransformerConfig(vocab=256))
    return prog, startup


def test_default_config_builds_the_jax_program():
    cfg = ttransformer.TransformerConfig(vocab=256)
    jcfg = jtransformer.TransformerConfig(vocab=256)
    assert (cfg.use_tp, cfg.use_sp) == (jcfg.use_tp, jcfg.use_sp) == \
        (True, True)
    jprog, jstartup = _build_default(jfluid, junique_name, jtransformer)
    tprog, tstartup = _build_default(tfluid, tunique_name, ttransformer)
    assert tprog.to_string() == jprog.to_string()
    assert tstartup.to_string() == jstartup.to_string()
    assert tprog.to_json() == jprog.to_json()
    types_ = [op.type for op in tprog.global_block().ops]
    assert types_.count('sharding_constraint') > 0
    # the weights carry the JAX package's shard annotations
    for v in jprog.global_block().all_parameters():
        assert getattr(tprog.global_block().var(v.name), 'dist_attr',
                       None) == v.dist_attr, v.name


# the ids the two cases had beside the moe_experts case (kw0), ported
# now: pp_stages still raises naming item 8's pipeline bullet; the ring
# config builds the JAX package's Program
@pytest.mark.parametrize('kw', [dict(pp_stages=2), dict(ring_attention=True)],
                         ids=['kw1', 'kw2'])
def test_unported_parallelism_raises(kw):
    if 'pp_stages' in kw:
        with pytest.raises(NotImplementedError,
                           match='Queue 1 item 8, the pipeline bullet'):
            ttransformer.TransformerConfig(**kw)
        return
    cfg = dict(vocab=64, dim=16, heads=2, layers=1, ffn=32, max_len=8,
               use_tp=True, use_sp=True, **kw)
    texts = []
    for fl, tr, un in ((jfluid, jtransformer, junique_name),
                       (tfluid, ttransformer, tunique_name)):
        prog, startup = fl.Program(), fl.Program()
        with un.guard(), fl.program_guard(prog, startup):
            toks = fl.layers.data(name='t', shape=[8, 1], dtype='int64')
            tr.language_model_trunk(toks, tr.TransformerConfig(**cfg))
        texts.append(prog.to_string())
    assert texts[1] == texts[0]
    assert 'ring_attention' in texts[1]


@pytest.mark.parametrize('name', ['ring_attention'])
def test_unported_parallel_layers_raise(name):
    """Ported: the layer appends the JAX package's op (it raised before
    this slice)."""
    from paddle_tpu_torch.parallel import layers as pl
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        q = tfluid.layers.data(name='q', shape=[2, 8, 4], dtype='float32')
        out = getattr(pl, name)(q, q, q, causal=False)
    op = prog.global_block().ops[-1]
    assert op.type == 'ring_attention' and op.attr('causal') is False
    assert out.shape == q.shape


def test_default_config_lm_trains_like_jax():
    """Three Momentum steps of the default-config LM (tp/sp annotations,
    the matmul attention path) from the JAX package's initial weights:
    losses and every parameter's update within 1e-4."""
    ref = _jax_run(False, DEFAULT_CFG, 64, 'default_reader')
    _port_run_matches(ref, False, DEFAULT_CFG, 64, 'default_reader')
