"""paddle_tpu_torch stands alone: it imports neither jax nor paddle_tpu,
its entry points never fall back to the CPU quietly, and it builds the
same Program text as the JAX package, which is what lets a model
directory and weights carry across by name."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.models import transformer as ttransformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'paddle_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'paddle_tpu')


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The JAX package's fixture (conftest.py) resets only its own
    default programs; reset the port's too."""
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_package_source_imports_no_jax_and_no_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith('.py')]
    assert len(files) > 20
    assert os.path.join(PKG, 'tools', 'probe_exp2.py') in files
    bad = sorted((os.path.relpath(f, ROOT), mod) for f in files
                 for mod in _imported_roots(f) if mod in FORBIDDEN)
    assert not bad, bad


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    path = os.path.join(ROOT, 'chip_smoke.py')
    bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = ('import sys\n'
            'import paddle_tpu_torch\n'
            'import paddle_tpu_torch.kernels.flash_attention\n'
            'import paddle_tpu_torch.kernels.conv_bn\n'
            'import paddle_tpu_torch.models.resnet\n'
            'import paddle_tpu_torch.tools.probe_exp2\n'
            'import paddle_tpu_torch.obs.telemetry\n'
            'import paddle_tpu_torch.serving.speculative\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "paddle_tpu")]\n'
            'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_entry_points_raise_without_a_card_and_a_place(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default place is valid')
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.inference.AnalysisPredictor(
            tfluid.inference.AnalysisConfig(str(tmp_path)))
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.serving.LMServer(str(tmp_path))
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.serving.LMServer(str(tmp_path), paged=True)
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.serving.LMServer(str(tmp_path), speculative=True)
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.Executor(tfluid.CUDAPlace(0))


@pytest.mark.parametrize('flash', [True, False])
def test_language_model_program_text_is_identical(flash):
    kw = dict(vocab=128, dim=256, heads=2, layers=2, ffn=512, max_len=128,
              use_tp=False, use_sp=False, flash_attention=flash)

    def build(fluid, unique_name, transformer):
        prog, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(prog, startup):
            toks = fluid.layers.data(name='tokens', shape=[1, 128, 1],
                                     dtype='int64', append_batch_size=False)
            transformer.language_model_logits(
                toks, transformer.TransformerConfig(**kw))
        return prog, startup

    jprog, jstartup = build(jfluid, junique_name, jtransformer)
    tprog, tstartup = build(tfluid, tunique_name, ttransformer)
    assert tprog.to_string() == jprog.to_string()
    assert tstartup.to_string() == jstartup.to_string()
    assert tprog.to_json() == jprog.to_json()


@pytest.mark.parametrize('amp', [False, True])
def test_training_program_text_is_identical(amp):
    """bench.py's training step (py_reader, trunk, fused LM head, mean,
    Momentum, optionally under decorate) after minimize: same grad ops,
    same attrs, same vars, same startup program."""
    kw = dict(vocab=128, dim=256, heads=2, layers=2, ffn=512, max_len=128,
              use_tp=False, use_sp=False, flash_attention=True)

    def build(fluid, unique_name, transformer):
        prog, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(prog, startup):
            rdr = fluid.layers.py_reader(
                capacity=4, shapes=[(-1, 128, 1), (-1, 128, 1)],
                dtypes=['int64', 'int64'], name='text_reader')
            tokens, labels = fluid.layers.read_file(rdr)
            cfg = transformer.TransformerConfig(**kw)
            cost = fluid.layers.fused_softmax_cross_entropy(
                transformer.language_model_trunk(tokens, cfg), labels,
                cfg.vocab, chunk=4096, name='lm_head')
            avg = fluid.layers.mean(cost)
            opt = fluid.optimizer.Momentum(learning_rate=0.001, momentum=0.9)
            if amp:
                opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(avg)
        return prog, startup

    jprog, jstartup = build(jfluid, junique_name, jtransformer)
    tprog, tstartup = build(tfluid, tunique_name, ttransformer)
    assert tprog._use_bf16 == jprog._use_bf16 == amp
    assert sum(op.type.endswith('_grad') for op in tprog.global_block().ops) \
        > 20
    assert tprog.to_string() == jprog.to_string()
    assert tstartup.to_string() == jstartup.to_string()
    assert tprog.to_json() == jprog.to_json()


def test_parallel_executor_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: use_cuda=True is valid')
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.ParallelExecutor(use_cuda=True, main_program=tfluid.Program())
    pe = tfluid.ParallelExecutor(use_cuda=False,
                                 main_program=tfluid.Program())
    assert pe.device.type == 'cpu'


def test_trainer_and_obs_modules_leave_jax_out_of_sys_modules():
    code = ('import sys\n'
            'import paddle_tpu_torch\n'
            'import paddle_tpu_torch.trainer, paddle_tpu_torch.inferencer\n'
            'import paddle_tpu_torch.memory\n'
            'import paddle_tpu_torch.obs.trace, paddle_tpu_torch.obs.report\n'
            'import paddle_tpu_torch.obs.slo, paddle_tpu_torch.obs.perf\n'
            'import paddle_tpu_torch.distributed.resilience\n'
            'import paddle_tpu_torch.distributed.statefile\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "paddle_tpu")]\n'
            'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


PS_MODULES = ['distributed', 'distributed.wire', 'distributed.rpc',
              'distributed.param_service', 'distributed.master',
              'distributed.supervisor', 'distributed.env',
              'distributed.resilience', 'ops.dist_ops',
              'transpiler.distribute_transpiler', 'transpiler.ps_dispatcher']


def test_parameter_server_modules_leave_jax_out_of_sys_modules():
    """Every module of the parameter-server slice imports, with its
    worker script, and none of them brings in jax or the JAX package;
    the static scan above covers their sources."""
    for mod in PS_MODULES:
        assert os.path.exists(os.path.join(
            PKG, *mod.split('.')) + ('.py' if '.' in mod else
                                     os.sep + '__init__.py')), mod
    code = ('import sys\n'
            + ''.join('import paddle_tpu_torch.%s\n' % m for m in PS_MODULES)
            + 'sys.path.insert(0, "tests")\n'
              'import torch_ps_worker\n'
              'bad = [m for m in sys.modules if m.split(".")[0] in '
              '("jax", "jaxlib", "paddle_tpu")]\n'
              'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
    worker = os.path.join(ROOT, 'tests', 'torch_ps_worker.py')
    assert not [m for m in _imported_roots(worker) if m in FORBIDDEN]


def test_trainer_and_inferencer_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default place is valid')

    def train_func():
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
        return tfluid.layers.mean(tfluid.layers.fc(input=x, size=1))

    def opt():
        return tfluid.optimizer.SGD(0.1)

    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.Trainer(train_func, opt)
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.Trainer(train_func, opt, parallel=True)
    with pytest.raises(RuntimeError, match='CPUPlace'):
        tfluid.Inferencer(param_path=str(tmp_path))
    trainer = tfluid.Trainer(train_func, opt, place=tfluid.CPUPlace())
    assert trainer.exe.device.type == 'cpu'


def test_profiler_record_files_and_channels_stand_alone():
    """The profiler, the record files with their native sources, the
    channels and the tools that read their output import neither jax nor
    paddle_tpu, and the copied C++ sources include nothing of the JAX
    package."""
    for rel in ('profiler.py', 'recordio.py', 'recordio_writer.py',
                'integrity.py', 'channels.py', 'concurrency.py',
                'native/__init__.py', 'tools/timeline.py',
                'tools/obs_report.py', 'layers/io.py'):
        path = os.path.join(PKG, rel)
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, (rel, bad)
    for name in ('recordio.cc', 'prefetcher.cc'):
        src = open(os.path.join(PKG, 'native', name)).read()
        includes = [line for line in src.splitlines()
                    if line.startswith('#include')]
        assert includes and not any('paddle_tpu' in line
                                    for line in includes), includes
    code = ('import sys\n'
            'import paddle_tpu_torch\n'
            'import paddle_tpu_torch.profiler, paddle_tpu_torch.recordio\n'
            'import paddle_tpu_torch.recordio_writer\n'
            'import paddle_tpu_torch.channels, paddle_tpu_torch.concurrency\n'
            'import paddle_tpu_torch.native, paddle_tpu_torch.integrity\n'
            'import paddle_tpu_torch.tools.timeline\n'
            'import paddle_tpu_torch.tools.obs_report\n'
            'paddle_tpu_torch.recordio._lib()\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "paddle_tpu")]\n'
            'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


FLEET_MODULES = ['online', 'online.subscriber', 'serving.replica',
                 'serving.fleet', 'serving.disagg', 'tools.serve_replica']


def test_online_and_fleet_modules_leave_jax_out_of_sys_modules():
    """The online refresh, the replica, the router, disaggregation and
    the replica entry point import, with the tests' fleet helper, and
    none of them brings in jax or the JAX package; their sources import
    neither."""
    for mod in FLEET_MODULES:
        path = os.path.join(PKG, *mod.split('.'))
        path = path + '.py' if os.path.exists(path + '.py') else \
            os.path.join(path, '__init__.py')
        assert os.path.exists(path), mod
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, (mod, bad)
    code = ('import sys\n'
            + ''.join('import paddle_tpu_torch.%s\n' % m
                      for m in FLEET_MODULES)
            + 'sys.path.insert(0, "tests")\n'
              'import torch_fleet_worker\n'
              'bad = [m for m in sys.modules if m.split(".")[0] in '
              '("jax", "jaxlib", "paddle_tpu")]\n'
              'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def test_serve_replica_raises_without_a_card_unless_told_the_cpu(tmp_path):
    """The replica entry point serves on CUDAPlace(0) and raises without
    a card; only SERVE_PLACE=cpu serves on the host."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default place is valid')
    env = dict(os.environ, SERVE_MODEL_DIR=str(tmp_path))
    env.pop('SERVE_PLACE', None)
    out = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.tools.serve_replica'],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert 'SERVE_PLACE=cpu' in out.stderr
    assert 'READY' not in out.stdout
    from paddle_tpu_torch.tools import serve_replica
    os.environ['SERVE_PLACE'] = 'cpu'
    try:
        assert serve_replica.place_from_env().device.type == 'cpu'
    finally:
        del os.environ['SERVE_PLACE']
