"""paddle_tpu_torch's deployment path against the JAX package, on the CPU:
AnalysisPredictor's batch-norm fold (transpiler.InferenceTranspiler),
save_inference_model(export_for_deployment=), FLAGS_ckpt_verify and
FLAGS_check_nan_inf.

- The repair: a conv + batch_norm model saved by the JAX package and
  served by both packages' AnalysisPredictor: the JAX package's program
  has no batch_norm, and now the port's has none either (the port's
  AnalysisConfig had no ir_optim, and its predictor served the BN ops).
- InferenceTranspiler on resnet_imagenet(depth=18, is_test=True) with
  random BN statistics and affine, at NCHW and NHWC: the same Program
  text as the JAX package's fold, the same folded weights, outputs
  within 2e-4 (tests/test_parity_modules.py:252's bound).
- AnalysisPredictor and clone (the same bits, from memory);
  switch_ir_optim(False) keeps the BN ops.
- FLAGS_ckpt_verify: the same CHECKPOINT_DIGESTS as the JAX package
  writes, a clean round trip, a flipped byte raises
  CheckpointCorruptError naming the var, in either package's directory.
- FLAGS_check_nan_inf: the port's message names the op and output the
  JAX package's names (fp32 and bf16), and a clean checked run gives
  the unchecked run's values.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu.checkpoint import manifest as jmanifest
from paddle_tpu.executor import OpExecutionError as JOpExecutionError
from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
from paddle_tpu.inference import AnalysisPredictor as JAnalysisPredictor
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.transpiler import InferenceTranspiler as JTranspiler
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.checkpoint import CheckpointCorruptError
from paddle_tpu_torch.checkpoint import manifest as tmanifest
from paddle_tpu_torch.executor import OpExecutionError
from paddle_tpu_torch.inference import (AnalysisConfig, AnalysisPredictor,
                                        Config, create_analysis_predictor)
from paddle_tpu_torch.models import resnet as tresnet

FOLD_TOL = 2e-4


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


def _types(program):
    return [op.type for op in program.global_block().ops]


def _jax_conv_bn_model(model_dir):
    """tests/test_parity_modules.py's model: conv2d -> batch_norm(is_test)
    -> reduce_sum, saved by the JAX package; returns (feed, output)."""
    prog, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(prog, startup):
        x = jfluid.layers.data(name='x', shape=[3, 8, 8], dtype='float32')
        c = jfluid.layers.conv2d(x, num_filters=4, filter_size=3, padding=1,
                                 bias_attr=False)
        bn = jfluid.layers.batch_norm(c, is_test=True)
        out = jfluid.layers.reduce_sum(bn, dim=[1, 2, 3])
    exe = jfluid.Executor(jfluid.CPUPlace())
    xb = np.random.RandomState(0).rand(2, 3, 8, 8).astype('float32')
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        rng = np.random.RandomState(1)
        for name, val in (('batch_norm_0.w_0', 1 + 0.2 * rng.randn(4)),
                          ('batch_norm_0.b_0', rng.randn(4)),
                          ('batch_norm_0.mean', rng.randn(4)),
                          ('batch_norm_0.variance', rng.rand(4) + 0.5)):
            scope.set_var(name, val.astype('float32'))
        want, = exe.run(prog, feed={'x': xb}, fetch_list=[out])
        jfluid.io.save_inference_model(model_dir, ['x'], [out], exe,
                                       main_program=prog)
    return xb, np.asarray(want)


def test_analysis_predictor_folds_batch_norm_as_the_jax_package_does(
        tmp_path):
    """The repair: before it, the port's AnalysisPredictor served the
    loaded program with its batch_norm op, the JAX package's without."""
    model_dir = str(tmp_path / 'model')
    xb, want = _jax_conv_bn_model(model_dir)
    jpred = JAnalysisPredictor(JAnalysisConfig(model_dir,
                                               place=jfluid.CPUPlace()))
    tpred = AnalysisPredictor(AnalysisConfig(model_dir,
                                             place=tfluid.CPUPlace()))
    jtypes, ttypes = _types(jpred._program), _types(tpred._program)
    assert 'batch_norm' not in jtypes
    assert ttypes == jtypes == ['conv2d', 'elementwise_add', 'reduce_sum']
    assert tpred._program.to_string() == jpred._program.to_string()
    got = tpred.run({'x': xb})[0]
    np.testing.assert_allclose(got, np.asarray(jpred.run({'x': xb})[0]),
                               rtol=FOLD_TOL, atol=FOLD_TOL)
    np.testing.assert_allclose(got, want, rtol=FOLD_TOL, atol=FOLD_TOL)


def test_switch_ir_optim_off_keeps_the_batch_norm_ops(tmp_path):
    model_dir = str(tmp_path / 'model')
    xb, want = _jax_conv_bn_model(model_dir)
    cfg = AnalysisConfig(model_dir, place=tfluid.CPUPlace())
    assert cfg.ir_optim is True
    assert cfg.switch_ir_optim(False) is cfg and cfg.ir_optim is False
    pred = AnalysisPredictor(cfg)
    assert 'batch_norm' in _types(pred._program)
    np.testing.assert_allclose(pred.run({'x': xb})[0], want, rtol=1e-5,
                               atol=1e-5)
    # a plain Config takes the default, ir_optim on
    plain = create_analysis_predictor(Config(model_dir,
                                             place=tfluid.CPUPlace()))
    assert isinstance(plain, AnalysisPredictor)
    assert 'batch_norm' not in _types(plain._program)


def _resnet_inference(fluid, unique_name, resnet, nhwc):
    prog, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(prog, startup):
        image = fluid.layers.data(name='image', shape=[3, 32, 32],
                                  dtype='float32')
        out = resnet.resnet_imagenet(image, class_dim=10, depth=18,
                                     is_test=True, nhwc=nhwc)
    return prog, startup, out


@pytest.mark.parametrize('nhwc', [False, True], ids=['NCHW', 'NHWC'])
def test_inference_transpiler_matches_jax(nhwc):
    """The same weights, random BN statistics and affine, folded by both
    packages' InferenceTranspiler: the same Program text, the same
    folded filters and biases, outputs within FOLD_TOL."""
    jprog, jstartup, jout = _resnet_inference(jfluid, junique_name, jresnet,
                                              nhwc)
    tprog, _, tout = _resnet_inference(tfluid, tunique_name, tresnet, nhwc)
    assert tprog.to_string() == jprog.to_string()
    rng = np.random.RandomState(2)
    img = rng.rand(2, 3, 32, 32).astype('float32')
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    params = {}
    for v in jprog.list_vars():
        if not v.persistable:
            continue
        val = np.array(np.asarray(jscope.find_var(v.name)))
        if v.name.endswith(('.mean', '.b_0')) and 'batch_norm' in v.name:
            val = (0.1 * rng.randn(*val.shape)).astype('float32')
        elif v.name.endswith('.variance'):
            val = rng.uniform(0.5, 1.5, val.shape).astype('float32')
        elif v.name.startswith('batch_norm') and v.name.endswith('.w_0'):
            val = (1 + 0.1 * rng.randn(*val.shape)).astype('float32')
        params[v.name] = val
        jscope.set_var(v.name, val)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, params, tfluid.CPUPlace(),
                                program=tprog)
    JTranspiler().transpile(jprog, jfluid.CPUPlace(), scope=jscope)
    tfluid.InferenceTranspiler().transpile(tprog, tfluid.CPUPlace(),
                                           scope=tscope)
    assert 'batch_norm' not in _types(tprog)
    assert _types(tprog).count('elementwise_add') == \
        _types(jprog).count('elementwise_add')
    assert tprog.to_string() == jprog.to_string()
    folded = [v.name for v in tprog.list_vars() if v.persistable]
    assert sum(n.endswith('.bn_fold_bias') for n in folded) == 20
    for name in folded:
        np.testing.assert_allclose(
            tscope.find_var(name).numpy(), np.asarray(jscope.find_var(name)),
            rtol=1e-6, atol=1e-7, err_msg=name)
    with jfluid.scope_guard(jscope):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed={'image': img}, fetch_list=[jout])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed={'image': img}, fetch_list=[tout], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=FOLD_TOL,
                               atol=FOLD_TOL)


def test_predictor_clone_gives_the_same_bits_from_memory(tmp_path):
    """A clone shares the folded weights and program, works after the
    model directory is gone, and does not fold again."""
    import shutil
    model_dir = str(tmp_path / 'model')
    xb, _ = _jax_conv_bn_model(model_dir)
    pred = AnalysisPredictor(AnalysisConfig(model_dir,
                                            place=tfluid.CPUPlace()))
    first = pred.run([xb])[0]
    shutil.rmtree(model_dir)
    clone = pred.clone()
    assert isinstance(clone, AnalysisPredictor)
    assert clone._scope is pred._scope
    assert _types(clone._program) == _types(pred._program)
    assert sum(v.name.endswith('.bn_fold_bias')
               for v in clone._program.list_vars()) == 1
    np.testing.assert_array_equal(clone.run([xb])[0], first)
    np.testing.assert_array_equal(pred.run([xb])[0], first)


@pytest.mark.parametrize('export', [True, False])
def test_save_inference_model_takes_export_for_deployment(tmp_path, export):
    """Accepted and, as in the JAX package, without effect: the same
    files as the default call."""
    x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
    y = tfluid.layers.fc(input=x, size=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    a, b = str(tmp_path / 'a'), str(tmp_path / 'b')
    assert tfluid.io.save_inference_model(a, ['x'], [y], exe) == [y.name]
    assert tfluid.io.save_inference_model(
        b, ['x'], [y], exe, export_for_deployment=export) == [y.name]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        assert open(os.path.join(a, f), 'rb').read() == \
            open(os.path.join(b, f), 'rb').read()


def test_flag_defaults_are_the_jax_packages():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags
    for name in ('check_nan_inf', 'ckpt_verify'):
        assert tflags._DEFAULTS[name] is jflags._DEFAULTS[name] is False


def _flip_byte(path):
    with open(path, 'rb') as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0x01
    with open(path, 'wb') as f:
        f.write(bytes(blob))


def test_ckpt_verify_round_trip_and_a_flipped_byte(tmp_path, capsys):
    """tests/test_sharded_ckpt.py's check in the port, and across the
    packages: the same manifest for the same files, the JAX package's
    directory verified by the port and the port's by the JAX package."""
    x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
    tfluid.layers.fc(input=x, size=2, param_attr=tfluid.ParamAttr(name='fw'),
                     bias_attr=tfluid.ParamAttr(name='fb'))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    plain = str(tmp_path / 'plain')
    tfluid.io.save_persistables(exe, plain)
    assert tmanifest.read_digests(plain) is None
    verified = str(tmp_path / 'verified')
    tfluid.set_flags({'FLAGS_ckpt_verify': True})
    jfluid.set_flags({'FLAGS_ckpt_verify': True})
    try:
        tfluid.io.load_persistables(exe, plain)      # no manifest: a warning
        assert 'loading unverified' in capsys.readouterr().err
        tfluid.io.save_persistables(exe, verified)
        digests = tmanifest.read_digests(verified)
        assert set(digests) == {'fw', 'fb'}
        assert digests == jmanifest.write_digests(str(tmp_path / 'plain'),
                                                  files=['fw', 'fb'])
        tfluid.io.load_persistables(exe, verified)   # a clean load passes
        # the JAX package verifies the port's directory
        jx = jfluid.layers.data(name='x', shape=[4], dtype='float32')
        jfluid.layers.fc(input=jx, size=2,
                         param_attr=jfluid.ParamAttr(name='fw'),
                         bias_attr=jfluid.ParamAttr(name='fb'))
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jfluid.default_startup_program())
        jfluid.io.load_persistables(jexe, verified)
        _flip_byte(os.path.join(verified, 'fb'))
        with pytest.raises(CheckpointCorruptError) as ei:
            tfluid.io.load_persistables(exe, verified)
        assert 'fb' in str(ei.value) and ei.value.var == 'fb'
        from paddle_tpu.checkpoint import CheckpointCorruptError as JError
        with pytest.raises(JError) as ej:
            jfluid.io.load_persistables(jexe, verified)
        assert str(ej.value) == str(ei.value)
        # the port verifies a directory the JAX package wrote
        jdir = str(tmp_path / 'jax')
        jfluid.io.save_persistables(jexe, jdir)
        tfluid.io.load_persistables(exe, jdir)
        _flip_byte(os.path.join(jdir, 'fw'))
        with pytest.raises(CheckpointCorruptError, match='fw'):
            tfluid.io.load_persistables(exe, jdir)
    finally:
        tfluid.set_flags({'FLAGS_ckpt_verify': False})
        jfluid.set_flags({'FLAGS_ckpt_verify': False})


def _log_program(fluid, bf16):
    """tests/test_error_context.py's programs: log of a negative input
    (in bf16 with bf16=True), then reduce_sum."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[3], dtype='float32')
        if bf16:
            x = fluid.layers.cast(x, 'bfloat16')
        logx = fluid.layers.log(x)
        if bf16:
            logx = fluid.layers.cast(logx, 'float32')
        out = fluid.layers.reduce_sum(logx)
    return prog, out


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
def test_check_nan_inf_names_the_op_the_jax_package_names(bf16):
    feed = {'x': -np.ones((2, 3), 'float32')}
    jprog, jout = _log_program(jfluid, bf16)
    tprog, tout = _log_program(tfluid, bf16)
    assert tprog.to_string() == jprog.to_string()
    msgs = []
    for fluid, prog, out, err in ((jfluid, jprog, jout, JOpExecutionError),
                                  (tfluid, tprog, tout, OpExecutionError)):
        exe = fluid.Executor(fluid.CPUPlace())
        fluid.set_flags({'FLAGS_check_nan_inf': True})
        try:
            with pytest.raises(err) as ei:
                exe.run(prog, feed=feed, fetch_list=[out])
        finally:
            fluid.set_flags({'FLAGS_check_nan_inf': False})
        msgs.append(str(ei.value))
        # without the flag the NaN flows through
        v, = exe.run(prog, feed=feed, fetch_list=[out])
        assert np.isnan(np.asarray(v)).all()
    assert msgs[1] == msgs[0]
    assert msgs[1].startswith('NaN/Inf detected in output') and \
        "'log'" in msgs[1]


def test_check_nan_inf_clean_run_matches_the_unchecked_run():
    """Three SGD steps under the flag (op by op, every output scanned)
    give the unchecked steps' values."""
    def build():
        prog, startup = tfluid.Program(), tfluid.Program()
        prog.random_seed = startup.random_seed = 3
        with tfluid.program_guard(prog, startup):
            x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
            y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
            pred = tfluid.layers.fc(input=x, size=1)
            loss = tfluid.layers.mean(
                tfluid.layers.square_error_cost(pred, y))
            tfluid.optimizer.SGD(0.1).minimize(loss)
        return prog, startup, loss
    feed = {'x': np.random.RandomState(0).rand(4, 4).astype('float32'),
            'y': np.ones((4, 1), 'float32')}
    prog, startup, loss = build()
    out = {}
    for flag in (False, True):
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        tfluid.set_flags({'FLAGS_check_nan_inf': flag})
        try:
            out[flag] = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                       scope=scope)[0]) for _ in range(3)]
        finally:
            tfluid.set_flags({'FLAGS_check_nan_inf': False})
    assert out[True] == out[False]
