"""Mesh-sharded serving (paddle_tpu_torch/serving/mesh.py,
prepare_decoding(mesh=), LMServer(mesh=), the decode transpiler's
param-spec recovery, DecodePredictor.load_sharded, SERVE_MESH_SHAPE)
held to the JAX package on the CPU.

The oracle is tests/test_mesh_serving.py, case for case (its chaos-sweep
leg belongs to the chaos sweep's slice). The JAX package saves each
model; the port loads the directory. A serving mesh here is the caller's
process driving rank processes (spawned interpreters under gloo, one
rank group a mesh shape, shared by every predictor on it); greedy
streams are held to the port's own one-device stream, as the JAX test
holds its mesh to its single chip:
- 'tp=1' is the 1-device mesh 'dp=1', served in process;
- tp=2 dense, paged and speculative streams equal the one-device one,
  and a second stream prepares nothing new (a mesh run is not captured);
- the page pools are heads-sharded on every rank, before and after a
  stream's pages leave for the host and come back;
- a use_tp model's recovered specs and serve specs are the JAX
  package's for the same saved model, and each rank holds half of every
  qkv and up weight;
- a checkpoint saved sharded on dp=2 x tp=2 serves, through
  load_sharded, on dp=2,tp=2 (paged) and on tp=2 (dense) after the
  served weights were zeroed;
- moe_ffn, ring_attention and an unknown mesh axis are refused with the
  JAX package's messages;
- LMServer(mesh=) and a SERVE_MESH_SHAPE replica report the mesh;
- tp=2 prefill logits are within 1e-5 of the JAX package's one-device
  logits, and the decode programs are the JAX package's op for op;
- the ranks exit when their last predictor closes and when the caller
  process is killed.
"""
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as jprogram_guard
from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import AnalysisPredictor as JAnalysisPredictor
from paddle_tpu.models.transformer import TransformerConfig
from paddle_tpu.models.transformer import \
    language_model_logits as jlanguage_model_logits
from paddle_tpu.transpiler import decode_transpiler as jdt
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
from paddle_tpu_torch.models import transformer as tmodels
from paddle_tpu_torch.serving import LMServer
from paddle_tpu_torch.serving import mesh as smesh
from paddle_tpu_torch.transpiler import decode_transpiler as tdt
from test_paged import _save_lm
from torch_threads import one_torch_thread  # noqa: F401

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _TESTS)
import torch_fleet_worker as tfw  # noqa: E402

CFG = TransformerConfig(vocab=64, dim=32, heads=4, layers=2, ffn=64,
                        max_len=32)
TP_CFG = TransformerConfig(vocab=64, dim=32, heads=4, layers=2, ffn=64,
                           max_len=32, use_tp=True)
PROMPT = [3, 11, 5, 2]
GEN = 10
LOGITS_ATOL = 1e-5


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


@pytest.fixture(scope='module')
def lm_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh_lm')
    _save_lm(tmp, CFG, 7)
    return str(tmp)


@pytest.fixture(scope='module')
def tp_lm_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh_tp_lm')
    _save_lm(tmp, TP_CFG, 7)
    return str(tmp)


def _predictor(model_dir):
    # every predictor its own weight scope, as in the JAX test
    return AnalysisPredictor(AnalysisConfig(model_dir,
                                            place=tfluid.CPUPlace()))


@pytest.fixture(scope='module')
def ref_stream(lm_dir):
    return _predictor(lm_dir).prepare_decoding(slots=2).generate(
        PROMPT, GEN)


@pytest.fixture(scope='module')
def tp_ref_stream(tp_lm_dir):
    return _predictor(tp_lm_dir).prepare_decoding(slots=2).generate(
        PROMPT, GEN)


@pytest.fixture(scope='module')
def anchor(lm_dir):
    """A tp=2 predictor held over the module: the tp=2 rank group stays
    up between the tests (started once), and closes with it."""
    dec = _predictor(lm_dir).prepare_decoding(slots=2, mesh='tp=2')
    yield dec
    dec.close()
    smesh.shutdown()


# -- streams: the 1-device mesh, tp=2 dense, paged and speculative -------------

def test_mesh_1x1_bit_exact(lm_dir, ref_stream):
    dec = _predictor(lm_dir).prepare_decoding(slots=2, mesh='tp=1')
    # build() spells the all-size-1 mesh 'dp=1'; it runs in process
    assert dec.mesh_shape == 'dp=1' and dec.mesh_devices == 1
    assert isinstance(dec._exe, tfluid.Executor)
    assert dec.generate(PROMPT, GEN) == ref_stream


def test_mesh_tp2_dense_bit_exact_and_compile_once(anchor, lm_dir,
                                                   ref_stream):
    dec = _predictor(lm_dir).prepare_decoding(slots=2, mesh='tp=2')
    assert dec.mesh_shape == 'tp=2' and dec.mesh_devices == 2
    assert dec.generate(PROMPT, GEN) == ref_stream
    # a second stream runs the prepared programs again: nothing new is
    # prepared or captured (a mesh run is eager)
    before = dict(dec.jit_cache_stats())
    dec.generate([5, 9], GEN)
    after = dict(dec.jit_cache_stats())
    assert after['prepared_programs'] == before['prepared_programs'] == 2
    assert after['compiled_segments'] == before['compiled_segments'] == 0
    assert after['segment_misses'] == before['segment_misses']
    assert after['segment_hits'] > before['segment_hits']


def test_mesh_tp2_paged_bit_exact_pool_sharded(anchor, lm_dir, ref_stream):
    dec = _predictor(lm_dir).prepare_decoding(
        slots=2, paged=True, page_tokens=4, prefill_chunk=8, mesh='tp=2')
    assert dec.generate(PROMPT, GEN) == ref_stream
    whole = dec._pair.pool_shape                 # [pages, pt, H, dh]

    def pools_sharded():
        for r, got in enumerate(dec._exe.layout()):
            assert got['spec'] == (None, None, 'tp', None), r
            want = (whole[0], whole[1], whole[2] // 2, whole[3])
            assert got['shapes'] == [want] * len(dec._pair.cache_names), r
    pools_sharded()
    # the preemption round trip: a stream's pages to host RAM (whole
    # heads, the JAX package's snapshot format) and back, in place
    dec.reset()
    dec.open_stream(0, PROMPT)
    while dec.prefill_step(0) is None:
        pass
    snap = dec.save_stream(0)
    assert snap['data'][0].shape == (1,) + tuple(whole[1:])
    assert snap['data'][0].dtype == np.float32
    dec.release(0)
    dec.restore_stream(0, snap)
    pools_sharded()
    dec.reset()
    assert dec.generate(PROMPT, GEN) == ref_stream


def test_mesh_tp2_speculative_bit_exact(anchor, lm_dir, ref_stream):
    dec = _predictor(lm_dir).prepare_decoding(
        slots=2, speculative=True, spec_k=2, draft_layers=1,
        page_tokens=4, prefill_chunk=8, mesh='tp=2')
    # the draft serves on the target's mesh
    assert dec.draft.mesh_shape == dec.mesh_shape == 'tp=2'
    assert dec.draft._exe.group is dec._exe.group
    assert dec.generate(PROMPT, GEN) == ref_stream


# -- the TP model: spec recovery and sharded weights --------------------------

def _qkv_up(layers):
    return {'layer%d_%s_0.w' % (l, k) for l in range(layers)
            for k in ('qkv', 'up')}


def test_tp_model_spec_recovery_and_tp2_serving(anchor, tp_lm_dir,
                                                tp_ref_stream):
    """A use_tp program reloaded from save_inference_model (its
    dist_attr lost) recovers each weight's spec from the surviving
    sharding_constraint ops, as the JAX package does, and serves on tp=2
    with its qkv and up weights sharded."""
    dec = _predictor(tp_lm_dir).prepare_decoding(slots=2, mesh='tp=2')
    specs = dec._pair.spec.param_specs
    for layer in range(TP_CFG.layers):
        assert specs['layer%d_qkv_0.w' % layer] == (None, 'tp')
        assert specs['layer%d_up_0.w' % layer] == (None, 'tp')
        assert specs['layer%d_proj_0.w' % layer] == ('tp', None)
        assert specs['layer%d_down_0.w' % layer] == ('tp', None)
    jpred = JAnalysisPredictor(JAnalysisConfig(tp_lm_dir,
                                               place=jfluid.CPUPlace()))
    jspec = jdt.extract_decode_spec(jpred._program)
    assert specs == jspec.param_specs
    serve = dec._pair.spec.serve_param_specs()
    assert serve == jspec.serve_param_specs()
    assert set(serve) == _qkv_up(TP_CFG.layers)
    assert all(s == (None, 'tp') for s in serve.values())
    assert dec.generate(PROMPT, GEN) == tp_ref_stream
    # each rank holds half the columns of every qkv and up weight, all
    # of the rest
    names = sorted(dec.param_names())
    whole = {n: tuple(dec._weight_scope.find_var(n).shape) for n in names}
    for r, shapes in enumerate(dec._exe.weight_shapes(names)):
        for n, got in zip(names, shapes):
            want = whole[n]
            if n in serve:
                want = (want[0], want[1] // 2)
            assert got == want, (r, n)


def _save_on_mesh(root, values, axes):
    """One generation saved the way a job on `axes` saves it: each
    simulated rank writes its shards (dim 0 over tp where it divides,
    as the JAX test shards), rank 0 last, which commits."""
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.checkpoint import sharded as ckpt_sharded
    from paddle_tpu_torch.parallel import mesh as tmesh
    from paddle_tpu_torch.parallel.layout import local_part, normalize
    mesh = tmesh.MeshConfig(**axes).build()
    savers = [checkpoint.AsyncShardedSaver(root, incarnation=0, rank=r,
                                           world=mesh.size)
              for r in range(mesh.size)]
    for r in reversed(range(mesh.size)):
        arrays = {}
        for n, t in values.items():
            spec = tmesh.fit_spec(('tp',) if t.ndim else None,
                                  tuple(t.shape), mesh)
            part = local_part(t, normalize(spec, t.ndim, mesh), mesh, r)
            arrays[n] = ckpt_sharded.local_shard(part.clone(), spec, mesh, r)
        savers[r].save(arrays, block=True)
    for s in savers:
        s.close()


def test_cross_topology_resharded_decode_bit_exact(anchor, tp_lm_dir,
                                                   tp_ref_stream, tmp_path):
    """The TP model's weights saved sharded on a dp=2 x tp=2 training
    mesh (each simulated rank its shards) serve, through load_sharded,
    on the 2x2 mesh (paged) and on tp=2 (dense) after the served weights
    were zeroed: the stream can only come from the checkpoint."""
    src = _predictor(tp_lm_dir).prepare_decoding(slots=2)
    values = {n: src._weight_scope.find_var(n).detach().clone()
              for n in src.param_names()}
    root = str(tmp_path / 'ckpt')
    _save_on_mesh(root, values, dict(dp=2, tp=2))
    for mesh_spec, kwargs in [
            ('dp=2,tp=2', dict(paged=True, page_tokens=4,
                               prefill_chunk=8)),
            ('tp=2', {})]:
        dec = _predictor(tp_lm_dir).prepare_decoding(
            slots=2, mesh=mesh_spec, **kwargs)
        dec.install_weights(dec.stage_weights(
            {n: np.zeros(tuple(v.shape), np.float32)
             for n, v in values.items()}))
        assert dec.generate(PROMPT, GEN) != tp_ref_stream, mesh_spec
        dec.load_sharded(root)
        dec.reset()
        assert dec.generate(PROMPT, GEN) == tp_ref_stream, mesh_spec
        # the digests are taken over the whole values the ranks hold
        src_digests = src.param_digests()
        assert dec.param_digests() == src_digests, mesh_spec
        dec.close()


# -- refusals ------------------------------------------------------------------

def _jax_program(kw):
    prog, startup = JProgram(), JProgram()
    prog.random_seed = startup.random_seed = 7
    with junique_name.guard(), jprogram_guard(prog, startup):
        toks = jfluid.layers.data(name='tokens', shape=[1, kw['max_len'], 1],
                                  dtype='int64', append_batch_size=False)
        jlanguage_model_logits(toks, TransformerConfig(**kw))
    return prog


def _port_program(kw):
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 7
    with tfluid.program_guard(prog, startup):
        toks = tfluid.layers.data(name='tokens', shape=[1, kw['max_len'], 1],
                                  dtype='int64', append_batch_size=False)
        tmodels.language_model_logits(toks, tmodels.TransformerConfig(**kw))
    return prog


def _refusal(extract, prog, error):
    with pytest.raises(error) as info:
        extract(prog)
    return str(info.value)


@pytest.mark.parametrize('kwargs,pattern', [
    (dict(moe_experts=2), 'moe_ffn'),
    (dict(ring_attention=True, use_sp=True), 'ring_attention'),
], ids=['moe_ffn', 'ring_attention'])
def test_unsupported_ops_fail_loud(kwargs, pattern):
    kw = dict(vocab=64, dim=32, heads=4, layers=1, ffn=64, max_len=16,
              **kwargs)
    got = _refusal(tdt.extract_decode_spec, _port_program(kw),
                   tdt.DecodeTranspileError)
    want = _refusal(jdt.extract_decode_spec, _jax_program(kw),
                    jdt.DecodeTranspileError)
    assert pattern in got and got == want


def test_unknown_mesh_axis_fails_loud_naming_weight():
    kw = dict(vocab=64, dim=32, heads=4, layers=1, ffn=64, max_len=16)
    msgs = []
    for prog, extract, error in (
            (_port_program(kw), tdt.extract_decode_spec,
             tdt.DecodeTranspileError),
            (_jax_program(kw), jdt.extract_decode_spec,
             jdt.DecodeTranspileError)):
        blk = prog.global_block()
        wname = [v for v in blk.vars if v.endswith('qkv_0.w')][0]
        blk.var(wname).dist_attr = (None, 'zz')
        msgs.append(_refusal(extract, prog, error))
    assert 'unknown mesh axis' in msgs[0] and msgs[0] == msgs[1]


# -- the stats surface ---------------------------------------------------------

def test_server_stats_carry_mesh_shape(anchor, lm_dir, ref_stream):
    with LMServer(lm_dir, place=tfluid.CPUPlace(), slots=2, workers=1,
                  mesh='tp=2') as srv:
        assert srv.generate(PROMPT, GEN) == ref_stream
        stats = srv.stats()
        assert stats['mesh_shape'] == 'tp=2'
        assert stats['mesh_devices'] == 2


def _health(endpoint):
    from paddle_tpu_torch.distributed import wire
    host, port = endpoint.rsplit(':', 1)
    with socket.create_connection((host, int(port)), timeout=30) as s:
        wire.write_msg(s, wire.SRV_HEALTH, {'seq': 1})
        _rt, meta, _ = wire.read_msg(s)
    return meta


@pytest.mark.timeout(300)
def test_mesh_replica_serves_and_reports_its_mesh(lm_dir, ref_stream):
    """A SERVE_PLACE=cpu replica with SERVE_MESH_SHAPE=tp=2 serves the
    one-device stream through the router, and its SRV_HEALTH carries
    mesh_shape 'tp=2' and mesh_devices 2."""
    from paddle_tpu_torch.serving import FleetRouter
    procs, eps = tfw.launch_replicas(
        lm_dir, 1, slots=2, extra_env={0: {'SERVE_MESH_SHAPE': 'tp=2'}})
    router = FleetRouter(eps, poll_secs=0.005, probe_secs=0.05)
    try:
        router.start()
        router.wait_healthy(timeout=120.0)
        req = router.submit(PROMPT, max_new_tokens=GEN)
        assert [int(t) for t in req.result(timeout=120.0)] == ref_stream
        h = _health(eps[0])
        assert h['mesh_shape'] == 'tp=2' and h['mesh_devices'] == 2
    finally:
        router.stop()
        launches = tfw.cleanup_replicas(procs, eps)
    assert launches[0] is not None        # a clean exit


# -- against the JAX package: logits and the programs ---------------------------

def test_tp2_prefill_logits_match_the_jax_package(anchor, lm_dir):
    jdec = JAnalysisPredictor(JAnalysisConfig(
        lm_dir, place=jfluid.CPUPlace())).prepare_decoding(slots=2)
    _, want = jdec.prefill([PROMPT], [0], return_logits=True)
    dec = _predictor(lm_dir).prepare_decoding(slots=2, mesh='tp=2')
    _, got = dec.prefill([PROMPT], [0], return_logits=True)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= LOGITS_ATOL


def _op_types(prog):
    return [op.type for op in prog.global_block().ops]


def _constraint_specs(prog):
    return [tuple(op.attr('spec')) for op in prog.global_block().ops
            if op.type == 'sharding_constraint']


@pytest.mark.parametrize('model', ['naive', 'flash'])
def test_decode_programs_are_the_jax_packages_op_for_op(lm_dir, tmp_path,
                                                        model):
    """Dense prefill/decode, paged prefill/decode, verify and the draft's
    pair: the same op types in the same order and the same constraint
    specs as the JAX package's programs (a flash spec pins nothing)."""
    if model == 'flash':
        cfg = TransformerConfig(vocab=64, dim=32, heads=4, layers=2,
                                ffn=64, max_len=32, flash_attention=True,
                                use_tp=False, use_sp=False)
        model_dir = str(tmp_path)
        _save_lm(model_dir, cfg, 7)
    else:
        model_dir = lm_dir
    jprog = JAnalysisPredictor(JAnalysisConfig(
        model_dir, place=jfluid.CPUPlace()))._program
    tprog = _predictor(model_dir)._program
    kw = dict(slots=2, page_tokens=4, kv_pages=17, prefill_chunk=8)
    jd = jdt.DecodeTranspiler().transpile(jprog, slots=2)
    td = tdt.DecodeTranspiler().transpile(tprog, slots=2)
    js = jdt.DecodeTranspiler().transpile_spec(jprog, spec_k=2,
                                               draft_layers=1, **kw)
    ts = tdt.DecodeTranspiler().transpile_spec(tprog, spec_k=2,
                                               draft_layers=1, **kw)
    pairs = [(jd.prefill_program, td.prefill_program),
             (jd.decode_program, td.decode_program),
             (js.target.prefill_program, ts.target.prefill_program),
             (js.target.decode_program, ts.target.decode_program),
             (js.verify_program, ts.verify_program),
             (js.draft.prefill_program, ts.draft.prefill_program),
             (js.draft.decode_program, ts.draft.decode_program)]
    for j, t in pairs:
        assert _op_types(t) == _op_types(j)
        assert _constraint_specs(t) == _constraint_specs(j)
        assert 'sharding_constraint' in _op_types(t)
    want_ax = None if model == 'flash' else 'tp'
    assert td.spec.cache_spec() == (None, None, want_ax, None) == \
        jd.spec.cache_spec()


# -- the ranks' lifetime ---------------------------------------------------------

def _alive(pid):
    try:
        with open('/proc/%d/stat' % pid) as f:
            return f.read().split(')')[-1].split()[0] != 'Z'
    except OSError:
        return False


def _wait_gone(pids, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.2)
    return False


def test_ranks_exit_with_their_last_predictor(lm_dir):
    """The last predictor of a group closes it: its ranks exit."""
    dec = _predictor(lm_dir).prepare_decoding(slots=2, mesh='dp=2')
    pids = [int(p) for p in dec._exe.call('os:getpid')]
    assert len(set(pids)) == 2 and all(_alive(p) for p in pids)
    clone = dec.clone()
    dec.close()
    assert all(_alive(p) for p in pids)       # the clone still serves
    assert clone.generate(PROMPT, 3)
    clone.close()
    assert _wait_gone(pids)


_LEADER = r'''
import sys
sys.path.insert(0, %(root)r)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
dec = AnalysisPredictor(AnalysisConfig(%(model)r, place=fluid.CPUPlace())
                        ).prepare_decoding(slots=2, mesh='dp=2')
print('PIDS', *dec._exe.call('os:getpid'), flush=True)
sys.stdin.read()
'''


def test_ranks_exit_when_the_caller_is_killed(lm_dir):
    """A caller killed with SIGKILL: its ranks see the socket close (or
    their parent gone) and exit."""
    root = os.path.dirname(_TESTS)
    proc = subprocess.Popen(
        [sys.executable, '-c', _LEADER % dict(root=root, model=lm_dir)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    try:
        line = ''
        while not line.startswith('PIDS'):
            line = proc.stdout.readline()
            assert line or proc.poll() is None, 'the caller exited'
        pids = [int(p) for p in line.split()[1:]]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        assert _wait_gone(pids)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_a_failed_rank_closes_the_group_and_raises(lm_dir):
    """A rank whose command fails (a page it does not have) fails the
    call with its traceback; the group is closed, its ranks gone."""
    dec = _predictor(lm_dir).prepare_decoding(
        slots=2, paged=True, page_tokens=4, prefill_chunk=8, mesh='dp=2')
    pids = [int(p) for p in dec._exe.call('os:getpid')]
    with pytest.raises(smesh.MeshRankError, match='rank 0 failed'):
        dec._exe.read_rows([10 ** 6])
    assert dec._exe.group.closed
    assert _wait_gone(pids)
    with pytest.raises(smesh.MeshRankError, match='closed'):
        dec.generate(PROMPT, 2)
