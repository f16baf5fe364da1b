"""Mesh-native sharded checkpoints (paddle_tpu_torch/checkpoint/{sharded,
restore,elastic}.py, CheckpointConfig(sharded=True), Trainer(strategy=))
held to the JAX package on the CPU.

The oracle is tests/test_sharded_ckpt.py, case for case (its
chaos-sweep case belongs to the chaos sweep's slice): the reshard
matrix, no host gather, the digests with the quarantine and the .prev
fallback, the COMMIT discipline, the rotation, the OWNER fence,
MeshCheckpointer's scope round trip, the Trainer's in-process resume,
a one-device predictor serving from a dp2tp2 checkpoint through
DecodePredictor.load_sharded (dense and paged) and the ckpt.*
instruments and spans. The port's saver takes its rank and
its local shards explicitly, so each simulated rank of a mesh drives the
per-rank write path here without a process group; rank 0 commits last.
The format is the JAX package's: a generation it saves on a dp2tp2 mesh
restores in the port bit-equal, bf16 included, and the reverse.

One spawn of 4 ranks (tests/torch_mesh_worker.py) makes one real save
on dp2tp2, restored by the JAX package and by the port on tp4 and on no
mesh; a Supervisor runs a 2-rank ZeRO-3 Adam job twice, once with rank
1 killed at its 5th step, and the resumed run ends bit-equal.
"""
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import checkpoint as jckpt
from paddle_tpu.parallel import mesh as jmesh
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import checkpoint
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.checkpoint import manifest as ckpt_manifest
from paddle_tpu_torch.checkpoint import restore as ckpt_restore
from paddle_tpu_torch.checkpoint import sharded as ckpt_sharded
from paddle_tpu_torch.checkpoint.elastic import MeshCheckpointer
from paddle_tpu_torch.distributed.resilience import StaleIncarnationError
from paddle_tpu_torch.distributed.supervisor import Supervisor
from paddle_tpu_torch.obs import telemetry, trace
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel.layout import local_part, normalize

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _TESTS)
import torch_mesh_worker as W  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

_SPECS = {'w': ('dp', 'tp'), 'b': ('dp',), 'scalar': None,
          'h': (None, 'tp')}
_MESHES = {'dp4': dict(dp=4), 'dp2tp2': dict(dp=2, tp=2),
           'tp4': dict(tp=4)}


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


def _ref_values(bf16=False):
    rng = np.random.RandomState(42)
    out = {'w': torch.from_numpy(rng.randn(8, 8).astype('float32')),
           'b': torch.from_numpy(rng.randn(8).astype('float32')),
           'scalar': torch.tensor(3.25, dtype=torch.float32)}
    if bf16:
        out['h'] = torch.from_numpy(rng.randn(4, 8).astype('float32')
                                    ).to(torch.bfloat16)
    return out


def _bits(t):
    """A tensor's raw words as numpy (bf16 as int16), for bit equality."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _tmesh(axes):
    return tmesh.MeshConfig(**axes).build()


def _spec(name, shape, mesh):
    return tmesh.fit_spec(_SPECS[name], shape, mesh)


def _rank_arrays(values, mesh, rank):
    """Each value's ShardedValue on `rank` of `mesh`, by _SPECS."""
    out = {}
    for name, t in values.items():
        spec = _spec(name, tuple(t.shape), mesh)
        part = local_part(t, normalize(spec, t.ndim, mesh), mesh, rank)
        out[name] = ckpt_sharded.local_shard(part.clone(), spec, mesh, rank)
    return out


def port_save(root, values, axes=None, extras=None, incarnation=0,
              savers=None):
    """One generation saved the way a job of `axes` saves it: each
    simulated rank writes its shards, rank 0 (last) commits. Returns
    each rank's stats."""
    mesh = _tmesh(axes) if axes else None
    world = mesh.size if mesh is not None else 1
    own = savers is None
    if own:
        savers = [checkpoint.AsyncShardedSaver(
            root, incarnation=incarnation, rank=r, world=world)
            for r in range(world)]
    for r in reversed(range(world)):
        arrays = _rank_arrays(values, mesh, r) if mesh is not None else \
            {n: t.clone() for n, t in values.items()}
        savers[r].save(arrays, extras=extras, block=True)
    stats = [s.last_stats for s in savers]
    if own:
        for s in savers:
            s.close()
    return stats


def _check_rank_values(ckpt, values, axes):
    """Every rank of `axes` reads its shard of every value, bit-equal to
    the reference's part under the recorded spec fit to the mesh."""
    if axes is None:
        for name, want in values.items():
            got = ckpt.read(name)
            assert got.dtype == want.dtype and \
                np.array_equal(_bits(got), _bits(want)), name
        return
    mesh = _tmesh(axes)
    for r in range(mesh.size):
        for name, want in values.items():
            spec = tmesh.fit_spec(ckpt.spec_of(name), tuple(want.shape),
                                  mesh)
            part = local_part(want, normalize(spec, want.ndim, mesh), mesh,
                              r)
            got = ckpt.as_torch(name, mesh, rank=r)
            assert tuple(got.shape) == tuple(part.shape), (name, r)
            assert np.array_equal(_bits(got), _bits(part)), (name, r)


# -- serving: DecodePredictor.load_sharded after a reshard ---------------------

@pytest.mark.parametrize('paged', [False, True], ids=['dense', 'paged'])
def test_serve_after_reshard_parity(tmp_path, paged):
    """Weights saved sharded on a dp=2 x tp=2 training mesh, loaded by a
    one-device predictor (the dense DecodePredictor and the paged one):
    the stream is the one of the predictor's own weights, the caches are
    never in the checkpoint, and a missing param raises naming it."""
    from test_paged import _save_lm
    from paddle_tpu.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab=32, dim=16, heads=2, layers=1, ffn=32,
                            max_len=8, use_tp=False, use_sp=False)
    model_dir = str(tmp_path / 'model')
    _save_lm(model_dir, cfg, 7)
    predictor = tfluid.inference.AnalysisPredictor(
        tfluid.inference.AnalysisConfig(model_dir, place=tfluid.CPUPlace()))
    if paged:
        dec = predictor.prepare_decoding(slots=2, paged=True,
                                         page_tokens=4, kv_pages=8,
                                         prefill_chunk=cfg.max_len)
    else:
        dec = predictor.prepare_decoding(slots=2, prefill_batch=1)
    prompt = [3, 1, 4]
    ref_tokens = dec.generate(prompt, 4)

    cache_names = set(dec._pair.cache_names)
    names = dec.param_names()
    values = {n: dec._weight_scope.find_var(n).detach().clone()
              for n in names}
    specs = {n: ('tp',) if v.ndim and v.shape[0] % 2 == 0 else None
             for n, v in values.items()}
    mesh = _tmesh(dict(dp=2, tp=2))

    def save(root, vals):
        savers = [checkpoint.AsyncShardedSaver(root, incarnation=0, rank=r,
                                               world=mesh.size)
                  for r in range(mesh.size)]
        for r in reversed(range(mesh.size)):
            arrays = {}
            for n, t in vals.items():
                sp = tmesh.fit_spec(specs[n], tuple(t.shape), mesh)
                part = local_part(t, normalize(sp, t.ndim, mesh), mesh, r)
                arrays[n] = ckpt_sharded.local_shard(part.clone(), sp, mesh,
                                                     r)
            savers[r].save(arrays, block=True)
        for sv in savers:
            sv.close()
    root = str(tmp_path / 'ckpt')
    save(root, values)
    ckpt = checkpoint.load_checkpoint(root)
    assert not (set(ckpt.var_names()) & cache_names)

    # scramble the live weights, then roll to the sharded checkpoint
    for n, v in values.items():
        dec._weight_scope.set_var(n, torch.zeros_like(v))
    assert dec.generate(prompt, 4) != ref_tokens
    dec.load_sharded(root)
    dec.reset()
    assert dec.generate(prompt, 4) == ref_tokens

    # a checkpoint missing a referenced param raises, naming it
    partial = dict(values)
    missing = sorted(partial)[0]
    del partial[missing]
    root2 = str(tmp_path / 'partial')
    save(root2, partial)
    with pytest.raises(RuntimeError, match='missing param %r' % missing):
        dec.load_sharded(root2)


# -- the reshard matrix --------------------------------------------------------

RESTORES = sorted(_MESHES) + ['dp8', 'none']


@pytest.mark.parametrize('restore_mesh', RESTORES)
@pytest.mark.parametrize('save_mesh', sorted(_MESHES))
def test_reshard_matrix(tmp_path, save_mesh, restore_mesh):
    ref = _ref_values()
    port_save(str(tmp_path), ref, _MESHES[save_mesh], extras={'step': 1})
    ckpt = checkpoint.load_checkpoint(str(tmp_path))
    assert ckpt.generation == 1 and ckpt.extras == {'step': 1}
    assert set(ckpt.var_names()) == set(ref)
    axes = {'dp8': dict(dp=8), 'none': None}.get(restore_mesh,
                                                 _MESHES.get(restore_mesh))
    _check_rank_values(ckpt, ref, axes)
    if axes is not None:
        vals, extras, gen = checkpoint.restore_sharded(
            str(tmp_path), mesh=_tmesh(axes), rank=0)
        assert gen == 1 and extras == {'step': 1}


def test_no_host_gather_on_save(tmp_path):
    """Saving a dp=4-sharded (8, 8) value: each rank's largest host
    allocation is its one shard and it writes one file; four files of
    one shard each, never the gathered value."""
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh = _tmesh(dict(dp=4))
    savers = [checkpoint.AsyncShardedSaver(str(tmp_path), incarnation=0,
                                           rank=r, world=4)
              for r in range(4)]
    for r in reversed(range(4)):
        part = local_part(w, normalize(('dp', None), 2, mesh), mesh, r)
        savers[r].save({'w': ckpt_sharded.local_shard(part.clone(),
                                                      ('dp', None), mesh,
                                                      r)}, block=True)
    shard_bytes = w.numel() * 4 // 4
    for s in savers:
        assert s.last_stats['max_host_bytes'] == shard_bytes
        assert s.last_stats['files'] == 1
        assert s.last_stats['bytes'] == shard_bytes
        s.close()
    cur = os.path.join(str(tmp_path), ckpt_sharded.CURRENT_DIR)
    bins = sorted(f for f in os.listdir(cur) if f.endswith('.bin'))
    assert len(bins) == 4, bins
    for f in bins:
        assert os.path.getsize(os.path.join(cur, f)) == shard_bytes, f


def test_a_committed_generation_holds_the_jax_packages_files(tmp_path):
    """The same values on the same dp2tp2 mesh: the port's committed
    generation holds exactly the JAX package's files (the ranks' records
    are gone), its shard files byte for byte, and its manifest's vars."""
    ref = _ref_values()
    port_save(str(tmp_path / 'port'), ref, _MESHES['dp2tp2'])
    jmesh_ = jmesh.MeshConfig(dp=2, tp=2).build()
    jckpt.save_sharded(str(tmp_path / 'jax'), _jplace(ref, jmesh_),
                       incarnation=0)
    dirs = [os.path.join(str(tmp_path / k), ckpt_sharded.CURRENT_DIR)
            for k in ('port', 'jax')]
    files = [sorted(os.listdir(d)) for d in dirs]
    assert files[0] == files[1]
    for f in files[0]:
        if f.endswith('.bin'):
            with open(os.path.join(dirs[0], f), 'rb') as a, \
                    open(os.path.join(dirs[1], f), 'rb') as b:
                assert a.read() == b.read(), f
    mans = []
    for d in dirs:
        with open(os.path.join(d, ckpt_sharded.MANIFEST_FILE)) as f:
            mans.append(json.load(f)['vars'])
    for name in ref:
        port_v, jax_v = mans[0][name], mans[1][name]
        assert (port_v['shape'], port_v['dtype']) == \
            (jax_v['shape'], jax_v['dtype'])
        key = lambda s: s['file']   # noqa: E731
        assert sorted(port_v['shards'], key=key) == \
            sorted(jax_v['shards'], key=key)
    assert not [d for d in os.listdir(str(tmp_path / 'port'))
                if d.startswith('.staging')]


# -- durability ------------------------------------------------------------------

def _save_two_generations(root):
    """gen 1 holds ref1, gen 2 (current/) holds ref1 + 1, both from 4
    simulated dp2tp2 ranks."""
    ref1 = _ref_values()
    ref2 = {k: v + 1 for k, v in ref1.items()}
    savers = [checkpoint.AsyncShardedSaver(root, incarnation=0, rank=r,
                                           world=4) for r in range(4)]
    port_save(root, ref1, _MESHES['dp2tp2'], {'gen': 'one'}, savers=savers)
    port_save(root, ref2, _MESHES['dp2tp2'], {'gen': 'two'}, savers=savers)
    for s in savers:
        s.close()
    return ref1, ref2


def test_bit_flip_in_every_shard_file_detected_with_prev_fallback(tmp_path):
    template = str(tmp_path / 'template')
    ref1, _ref2 = _save_two_generations(template)
    cur = os.path.join(template, ckpt_sharded.CURRENT_DIR)
    victims = sorted(
        f for f in os.listdir(cur)
        if f not in (ckpt_manifest.DIGESTS_FILE, ckpt_sharded.COMMIT_FILE))
    assert any(v.endswith('.bin') for v in victims)
    assert ckpt_sharded.MANIFEST_FILE in victims
    for victim in victims:
        root = str(tmp_path / ('case_' + victim.replace('.', '_')))
        shutil.copytree(template, root)
        path = os.path.join(root, ckpt_sharded.CURRENT_DIR, victim)
        with open(path, 'rb') as f:
            blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0x40
        with open(path, 'wb') as f:
            f.write(bytes(blob))
        got = ckpt_restore._try_open(
            os.path.join(root, ckpt_sharded.CURRENT_DIR))
        assert isinstance(got, str), victim
        ckpt = checkpoint.load_checkpoint(root)
        assert ckpt is not None and ckpt.extras == {'gen': 'one'}, victim
        assert os.path.isdir(os.path.join(
            root, ckpt_sharded.CURRENT_DIR + '.corrupt')), victim
        for name, want in ref1.items():
            assert np.array_equal(_bits(ckpt.read(name)), _bits(want)), \
                (victim, name)


def test_missing_commit_skipped_without_quarantine(tmp_path):
    root = str(tmp_path)
    _save_two_generations(root)
    cur = os.path.join(root, ckpt_sharded.CURRENT_DIR)
    os.remove(os.path.join(cur, ckpt_sharded.COMMIT_FILE))
    ckpt = checkpoint.load_checkpoint(root)
    assert ckpt.extras == {'gen': 'one'}
    assert os.path.isdir(cur)
    assert not os.path.isdir(cur + '.corrupt')


def test_no_loadable_generation_returns_none(tmp_path):
    values, extras, gen = checkpoint.restore_sharded(
        str(tmp_path / 'never_written'))
    assert values is None and extras is None and gen == 0


def test_out_of_order_async_commits_never_roll_current_back(tmp_path):
    root = str(tmp_path)
    ref1 = _ref_values()
    ref2 = {k: v + 1 for k, v in ref1.items()}
    saver = checkpoint.AsyncShardedSaver(root, incarnation=0, workers=1)
    snap1, mh1 = saver.snapshot({n: t.clone() for n, t in ref1.items()})
    snap2, mh2 = saver.snapshot({n: t.clone() for n, t in ref2.items()})
    # the newer generation commits first, the older one lands late
    saver._do_write_and_commit(2, snap2, {'gen': 'two'}, mh2, time.time())
    saver._do_write_and_commit(1, snap1, {'gen': 'one'}, mh1, time.time())
    assert saver.last_stats['superseded'] is True
    saver.close()
    ckpt = checkpoint.load_checkpoint(root)
    assert ckpt.generation == 2 and ckpt.extras == {'gen': 'two'}
    for name, want in ref2.items():
        assert np.array_equal(_bits(ckpt.read(name)), _bits(want)), name
    assert not [d for d in os.listdir(root) if d.startswith('.staging')]


def test_generation_rotation_and_numbering(tmp_path):
    root = str(tmp_path)
    _save_two_generations(root)
    gens = []
    for sub in (ckpt_sharded.CURRENT_DIR, ckpt_sharded.PREV_DIR):
        with open(os.path.join(root, sub, ckpt_sharded.MANIFEST_FILE)) as f:
            gens.append(json.load(f)['generation'])
    assert gens == [2, 1]
    saver = checkpoint.AsyncShardedSaver(root, incarnation=0)
    assert saver.generation == 3
    saver.close()


# -- OWNER fencing ---------------------------------------------------------------

def test_stale_incarnation_refused_at_claim(tmp_path):
    root = str(tmp_path)
    checkpoint.AsyncShardedSaver(root, incarnation=1).close()
    with pytest.raises(StaleIncarnationError):
        checkpoint.AsyncShardedSaver(root, incarnation=0)
    # any rank of a stale incarnation is refused, not only rank 0
    with pytest.raises(StaleIncarnationError):
        checkpoint.AsyncShardedSaver(root, incarnation=0, rank=1, world=2)
    checkpoint.AsyncShardedSaver(root, incarnation=1).close()
    checkpoint.AsyncShardedSaver(root, incarnation=2).close()


def test_fence_rechecked_before_rotation(tmp_path):
    root = str(tmp_path)
    old = checkpoint.AsyncShardedSaver(root, incarnation=0)
    successor = checkpoint.AsyncShardedSaver(root, incarnation=5)
    successor.save(_ref_values(), extras={'who': 'successor'}, block=True)
    successor.close()
    with pytest.raises(StaleIncarnationError):
        old.save(_ref_values(), block=True)
    with pytest.raises(StaleIncarnationError):
        old.close()
    ckpt = checkpoint.load_checkpoint(root)
    assert ckpt.extras == {'who': 'successor'}


# -- MeshCheckpointer and the Trainer ----------------------------------------------

def test_mesh_checkpointer_scope_roundtrip_and_cache_exclusion(tmp_path):
    prog = tfluid.Program()
    block = prog.global_block()
    block.create_var(name='p', shape=[4], dtype='float32', persistable=True)
    block.create_var(name='kv', shape=[4], dtype='float32',
                     persistable=True, is_cache=True)
    block.create_var(name='tmp', shape=[4], dtype='float32',
                     persistable=False)
    scope = tfluid.Scope()
    scope.set_var('p', torch.arange(4, dtype=torch.float32))
    scope.set_var('kv', torch.ones(4))
    scope.set_var('tmp', torch.ones(4))
    assert set(MeshCheckpointer.checkpoint_vars(scope, prog)) == {'p'}

    mc = MeshCheckpointer(str(tmp_path), incarnation=7)
    mc.save_scope(scope, prog, extras={'step_id': 3}, block=True)
    assert mc.last_stats['generation'] == 1
    mc.close()

    scope2 = tfluid.Scope()
    reader = MeshCheckpointer(str(tmp_path))   # restore-only: no claim
    assert reader.restore_scope(scope2, prog) == {'step_id': 3}
    assert torch.equal(scope2.find_var('p'), torch.arange(4,
                                                          dtype=torch.float32))
    assert scope2.find_var('kv') is None
    with open(os.path.join(str(tmp_path), ckpt_sharded.OWNER_FILE)) as f:
        assert json.load(f)['incarnation'] == 7


class _Abort(Exception):
    pass


def _sharded_trainer_run(ckpt_dir, abort_at=None):
    tunique_name.switch()

    def train_func():
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
        y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = tfluid.layers.fc(
            input=x, size=1,
            param_attr=tfluid.ParamAttr(
                name='sw', initializer=tfluid.initializer.Normal(
                    scale=0.1, seed=3)))
        return tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))

    def reader():
        rng = np.random.RandomState(7)
        w = np.linspace(-1, 1, 4).astype('float32')[:, None]
        for _ in range(10):
            x = rng.randn(8, 4).astype('float32')
            yield [x, x @ w]

    trainer = tfluid.Trainer(
        train_func, lambda: tfluid.optimizer.Adam(0.02),
        place=tfluid.CPUPlace(),
        checkpoint_config=tfluid.CheckpointConfig(
            checkpoint_dir=ckpt_dir, step_interval=3, sharded=True))
    seen = []

    def handler(event):
        if isinstance(event, tfluid.EndStepEvent):
            seen.append((event.epoch, event.step,
                         float(np.asarray(event.metrics[0]))))
            if abort_at is not None and \
                    (event.epoch, event.step) == abort_at:
                raise _Abort()
    try:
        trainer.train(num_epochs=1, event_handler=handler,
                      reader=reader, feed_order=['x', 'y'])
    except _Abort:
        pass
    if trainer._mesh_checkpointer is not None:
        trainer._mesh_checkpointer.close()
    return seen, trainer


def test_trainer_sharded_resume_exact(tmp_path):
    """CheckpointConfig(sharded=True): a killed trainer resumes at the
    exact next step with losses identical to an uninterrupted run."""
    full, _ = _sharded_trainer_run(str(tmp_path / 'full'))
    ckpt = str(tmp_path / 'ck')
    _sharded_trainer_run(ckpt, abort_at=(0, 7))     # last save at step 5
    assert os.path.exists(os.path.join(ckpt, ckpt_sharded.CURRENT_DIR,
                                       ckpt_sharded.COMMIT_FILE))
    resumed, _ = _sharded_trainer_run(ckpt)
    assert resumed[0][:2] == (0, 6)
    full_by_key = {(e, s): v for e, s, v in full}
    for e, s, v in resumed:
        assert v == full_by_key[(e, s)], 'step (%d, %d)' % (e, s)
    assert resumed[-1][:2] == full[-1][:2] == (0, 9)


def test_ckpt_instruments_and_spans(tmp_path):
    obs_dir = str(tmp_path / 'obs')
    telemetry.reset()
    telemetry.enable()
    trace.enable(obs_dir, role='ckpt-test')
    try:
        root = str(tmp_path / 'ck')
        port_save(root, _ref_values())
        got, _, _ = checkpoint.restore_sharded(root, mesh=_tmesh(dict(dp=4)),
                                               rank=1)
        assert got is not None
    finally:
        trace.disable()
        telemetry.disable()
    snap = telemetry.snapshot()
    telemetry.reset()
    assert snap['counters']['ckpt.generations'] == 1
    assert snap['hists']['ckpt.save_latency']['count'] == 1
    assert snap['hists']['ckpt.restore_latency']['count'] == 1
    assert snap['hists']['ckpt.bytes_written']['sum'] > 0
    spans = set()
    for fn in os.listdir(obs_dir):
        with open(os.path.join(obs_dir, fn)) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get('type') == 'span':
                    spans.add(rec['name'])
    assert {'ckpt.snapshot', 'ckpt.write',
            'ckpt.restore.open', 'ckpt.restore.read'} <= spans


# -- across the packages -------------------------------------------------------------

def _jplace(values, mesh):
    """The values on a JAX mesh by _SPECS (test_sharded_ckpt.py::_place);
    bf16 through jnp.bfloat16."""
    out = {}
    for name, t in values.items():
        if t.dtype == torch.bfloat16:
            arr = jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        else:
            arr = t.numpy()
        spec = jmesh.fit_spec(_SPECS[name], np.shape(arr), mesh)
        out[name] = jax.device_put(arr, jmesh.named_sharding(mesh, spec))
    return out


def _jbits(arr):
    arr = np.asarray(arr)
    return arr.view(np.int16) if arr.dtype.itemsize == 2 and \
        arr.dtype.kind not in 'iu' else arr


@pytest.mark.parametrize('restore_mesh', ['dp2tp2', 'tp4', 'none'])
def test_a_jax_generation_restores_in_the_port(tmp_path, restore_mesh):
    ref = _ref_values(bf16=True)
    jckpt.save_sharded(str(tmp_path), _jplace(
        ref, jmesh.MeshConfig(dp=2, tp=2).build()), extras={'step': 4},
        incarnation=0)
    ckpt = checkpoint.load_checkpoint(str(tmp_path))
    assert ckpt.extras == {'step': 4}
    assert ckpt.dtype_of('h') == torch.bfloat16
    _check_rank_values(ckpt, ref, _MESHES.get(restore_mesh))


@pytest.mark.parametrize('restore_mesh', ['dp2tp2', 'tp4', 'none'])
def test_a_port_generation_restores_in_jax(tmp_path, restore_mesh):
    ref = _ref_values(bf16=True)
    port_save(str(tmp_path), ref, _MESHES['dp2tp2'], extras={'step': 4})
    mesh = None if restore_mesh == 'none' else \
        jmesh.MeshConfig(**_MESHES[restore_mesh]).build()
    vals, extras, gen = jckpt.restore_sharded(str(tmp_path), mesh=mesh)
    assert gen == 1 and extras == {'step': 4}
    assert str(np.asarray(vals['h']).dtype) == 'bfloat16'
    for name, want in ref.items():
        assert np.array_equal(_jbits(vals[name]), _bits(want)), name


# -- the ranks ------------------------------------------------------------------------

@pytest.fixture(scope='module')
def mesh_save(tmp_path_factory):
    """One real save of 4 ranks on dp2tp2 (the use_tp LM after one Adam
    step), from the JAX package's initial weights."""
    from paddle_tpu import unique_name as junique_name
    with junique_name.guard():
        prog, startup, _ = W.lm_program(dict(W.LM_SMALL, use_tp=True,
                                             use_sp=True), jfluid)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    inputs = {}
    for v in prog.list_vars():
        if v.persistable and scope.find_var(v.name) is not None:
            inputs['ck/p/' + v.name] = np.array(scope.find_var(v.name))
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 64, (4, 8, 1)).astype('int64')
    inputs['lm/tokens'], inputs['lm/labels'] = toks, np.roll(toks, -1, 1)
    root = str(tmp_path_factory.mktemp('ck_root'))
    inputs['ck/root'] = np.array(root)
    host_root = str(tmp_path_factory.mktemp('host_root'))
    inputs['ht/root'] = np.array(host_root)
    res = W.spawn(tmp_path_factory.mktemp('ck4'), 4,
                  ['ckpt_save', 'host_trainer'], inputs)
    return W.results(res, 'ckpt_save'), root, \
        W.results(res, 'host_trainer'), host_root


def test_a_four_rank_save_restores_in_jax_and_the_port(mesh_save):
    ranks, root = mesh_save[:2]
    whole = {k[2:]: v for k, v in ranks[0].items() if k.startswith('v/')}
    assert whole
    ckpt = checkpoint.load_checkpoint(root)
    assert ckpt.extras == {'step_id': 0}
    assert set(ckpt.var_names()) == set(whole)
    # every rank wrote at most its shards: no host buffer past one shard
    for r in ranks:
        assert r['stats'][2] <= r['max_local']
    assert sum(int(r['stats'][1]) for r in ranks) == sum(
        len(ckpt._vars[n]['shards']) for n in ckpt.var_names())
    ref = {n: torch.from_numpy(v) for n, v in whole.items()}
    for axes in (dict(tp=4), None):
        _check_rank_values(ckpt, ref, axes)
    for mesh in (jmesh.MeshConfig(tp=4).build(), None):
        vals, _, gen = jckpt.restore_sharded(root, mesh=mesh)
        assert gen == 1
        for n, want in whole.items():
            assert np.array_equal(np.asarray(vals[n]), want), n


def test_mesh_trainer_host_checkpoints_are_whole_and_resume_exact(
        mesh_save):
    """Trainer(strategy=dp=4 ZeRO-3) with a CheckpointConfig without
    sharded=True: rank 0 alone writes each checkpoint, of whole values
    (a second Trainer on every rank resumes A's final values at their
    whole shapes), the ids run on as one writer numbers them, and the
    resumed run ends on the uninterrupted run's weights, Adam moments
    and losses, bit for bit."""
    ranks, root = mesh_save[2:]
    names = sorted(k[2:] for k in ranks[0] if k.startswith('a/'))
    assert 'mw1' in names and any('moment' in n for n in names)
    for r in ranks:
        assert bool(r['b_resumed']) and not bool(r['a_resumed'])
        assert r['b0/mw1'].shape == (8, 16)
        for n in names:
            assert np.array_equal(r['b0/' + n], r['a/' + n]), n
            assert np.array_equal(r['b/' + n], r['c/' + n]), n
    # A saved after steps 0 and 1, B after steps 2 and 3 and at the
    # epoch's end; the rotation keeps the newest 3
    assert sorted(os.listdir(root)) == ['checkpoint_2', 'checkpoint_3',
                                        'checkpoint_4']
    assert len(ranks[0]['c_losses']) == 4
    assert np.array_equal(ranks[0]['b_losses'], ranks[0]['c_losses'][2:])


def _run_mesh_job(workdir, ckpt_root, kill_nth=None, steps=6, dp=2):
    os.makedirs(workdir, exist_ok=True)
    np.savez(os.path.join(workdir, 'inputs.npz'))
    sup = Supervisor(max_restarts=2, backoff=0.3, log_dir=workdir)
    for r in range(dp):
        env = dict(os.environ)
        for k in ('JAX_PLATFORMS', 'XLA_FLAGS'):
            env.pop(k, None)
        env.update({'PADDLE_TRAINER_ID': str(r),
                    'PADDLE_TRAINERS_NUM': str(dp),
                    'MESH_WORK': workdir, 'MESH_CKPT': ckpt_root,
                    'MESH_STEPS': str(steps), 'MESH_DP': str(dp),
                    'MESH_CKPT_EVERY': '2', 'OMP_NUM_THREADS': '1'})
        if kill_nth is not None and r == 1:
            env['FLAGS_fault_plan'] = json.dumps(
                {'rules': [{'when': 'step', 'type': '*', 'nth': kill_nth,
                            'action': 'exit'}]})
        sup.add_role('rank%d' % r, [sys.executable,
                                    os.path.join(_TESTS,
                                                 'torch_mesh_worker.py'),
                                    workdir, 'mesh_trainer'], env=env)
    sup.start()
    states = sup.wait(timeout=240)
    sup.stop()
    res = None
    path = os.path.join(workdir, 'rank0.npz')
    if os.path.exists(path):
        res = {k[len('mesh_trainer/'):]: v
               for k, v in np.load(path).items()}
    return states, dict(sup.restarts), res, sup


@pytest.mark.chaos
@pytest.mark.timeout(400)
def test_mesh_kill_resumes_bit_exact(tmp_path):
    """test_sharded_ckpt.py::test_mesh_kill9_resumes_bit_exact on 2 ranks:
    a ZeRO-3 Adam job under the Supervisor saves async sharded
    generations; rank 1 is killed at its 5th step, rank 0 fails in gloo,
    the Supervisor restarts both at incarnation 1 (a fresh rendezvous),
    the job resumes from the last committed generation, and every final
    weight and Adam moment equals the fault-free run's bit for bit."""
    b_states, b_restarts, base, _ = _run_mesh_job(
        str(tmp_path / 'base'), str(tmp_path / 'base_ckpt'))
    assert b_states == {'rank0': 'done', 'rank1': 'done'}
    assert b_restarts == {'rank0': 0, 'rank1': 0}
    kill_ckpt = str(tmp_path / 'kill_ckpt')
    k_states, k_restarts, killed, sup = _run_mesh_job(
        str(tmp_path / 'kill'), kill_ckpt, kill_nth=5)
    assert k_states == {'rank0': 'done', 'rank1': 'done'}, \
        sup.output('rank0')[-3000:] + sup.output('rank1')[-3000:]
    assert k_restarts == {'rank0': 1, 'rank1': 1}, 'fault plan never fired'
    names = sorted(k for k in base if k.startswith('w/'))
    assert names == sorted(k for k in killed if k.startswith('w/'))
    assert any('moment' in n for n in names)
    for n in names:
        assert np.array_equal(base[n], killed[n]), n
    # ZeRO-3 split mb1 ((16,), dp=2) into 2 files; incarnation 1 owns it
    cur = os.path.join(kill_ckpt, ckpt_sharded.CURRENT_DIR)
    assert len([f for f in os.listdir(cur) if f.startswith('mb1.s')]) == 2
    with open(os.path.join(kill_ckpt, ckpt_sharded.OWNER_FILE)) as f:
        assert json.load(f)['incarnation'] == 1
