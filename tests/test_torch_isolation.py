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
