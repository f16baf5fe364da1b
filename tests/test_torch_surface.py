"""Nine public-surface faults of the port against the JAX package,
repaired. Each was a public name or argument of a module the port
counted as done that raised in the port where the JAX package runs.
Every test builds the same thing in both packages and compares them;
where random numbers are drawn the two are compared by their startup
ops and attrs and by the draws' moments.

1. fluid.core's device queries (answering for CUDA, by design);
2. the initializers TruncatedNormal, MSRA, Bilinear,
   NumpyArrayInitializer, the *Initializer aliases, init_on_cpu;
3. Variable.astype, Block.create_var(initializer=, error_clip=),
   Block.rename_var / remove_var, Operator.set_attr / rename_input /
   rename_output, fluid.name_scope and fluid.grad_var_name;
4. WeightNormParamAttr and the weight-normalised parameter;
5. Scope.new_scope / drop_kids / local_var_names, ExecutionStrategy,
   BuildStrategy, ParallelExecutor(share_vars_from=, exec_strategy=,
   build_strategy=), device_count and run(feed_dict=);
6. layers.less_than, less_equal, greater_than, greater_equal, equal,
   not_equal;
7. inference.create_paddle_predictor, registry.has_op, op_infer_shape,
   op_grad_maker, reader.pipeline.leaked_threads and
   PyReader.decorate_batch_generator;
8. layers.lookup_table, the alias of layers.embedding;
9. layers.load, which appends a load op (a host step) restoring a var
   that io.save_vars wrote;
10. the sequence_first_step and sequence_last_step op types, which the
   JAX package registers (a Program that appends them, as one loaded
   from a saved __model__ may, raised KeyError in the port);
11. Adam(lazy_mode=True) on an is_sparse=True embedding: the port
   ignored is_sparse and applied the dense update to every row, so a
   row touched in one step and missed in the next kept moving on its
   decayed moments (0.0335 from the JAX package after two steps);
12. the detection layers and op types, which the JAX package has;
13. the place names TPUPlace, XLAPlace (aliases of CUDAPlace, a
   divergence by design: the JAX package's accelerator place is
   TPUPlace) and CUDAPinnedPlace (a host place), with _switch_scope, at
   the top level and TPUPlace, XLAPlace in fluid.core;
14. registry.op_emitter(type, stateful=) and register_op(stateful=),
   kept on OpDef.stateful, with the JAX package's random ops marked;
15. Block.create_var with a keyword Variable does not read
   (capacity=...), which the JAX package's Variable takes and ignores.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name


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


def _startup_values(fluid, startup):
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in startup.list_vars() if v.persistable}


# -- 1: core's device queries --------------------------------------------------

def test_core_device_queries_answer_for_cuda():
    for fluid in (jfluid, tfluid):
        for name in ('is_compiled_with_cuda', 'is_compiled_with_tpu',
                     'get_cuda_device_count', 'get_tpu_device_count',
                     'get_device_count'):
            assert callable(getattr(fluid.core, name)), (fluid, name)
    core = tfluid.core
    assert core.is_compiled_with_cuda() is torch.cuda.is_available()
    assert core.is_compiled_with_tpu() is False
    assert core.get_cuda_device_count() == torch.cuda.device_count()
    assert core.get_tpu_device_count() == 0
    assert core.get_device_count() == max(torch.cuda.device_count(), 1)


# -- 2: initializers -----------------------------------------------------------

def _init_program(fluid, make_init, shape):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fluid.layers.create_parameter(shape=shape, dtype='float32',
                                      name='w', default_initializer=make_init(
                                          fluid.initializer))
    return startup


DETERMINISTIC_INITS = {
    'bilinear': (lambda I: I.Bilinear(), [3, 2, 4, 5]),
    'bilinear-alias': (lambda I: I.BilinearInitializer(), [2, 1, 3, 3]),
    'numpy': (lambda I: I.NumpyArrayInitializer(
        np.arange(12, dtype='float32').reshape(3, 4) / 7.0), [3, 4]),
}


@pytest.mark.parametrize('name', sorted(DETERMINISTIC_INITS))
def test_deterministic_initializers_match_jax(name):
    make_init, shape = DETERMINISTIC_INITS[name]
    j = _init_program(jfluid, make_init, shape)
    t = _init_program(tfluid, make_init, shape)
    assert t.to_string() == j.to_string()
    want, got = _startup_values(jfluid, j)['w'], _startup_values(tfluid, t)['w']
    assert got.shape == tuple(shape)
    np.testing.assert_array_equal(got, want)


RANDOM_INITS = {
    'truncated_normal': (lambda I: I.TruncatedNormal(0.5, 2.0), 2.0 * 0.8796),
    'msra_uniform': (lambda I: I.MSRA(), (6.0 / 256) ** 0.5 / 3 ** 0.5),
    'msra_normal': (lambda I: I.MSRAInitializer(uniform=False),
                    (2.0 / 256) ** 0.5),
    'msra_fan_in': (lambda I: I.MSRA(uniform=False, fan_in=64),
                    (2.0 / 64) ** 0.5),
}


@pytest.mark.parametrize('name', sorted(RANDOM_INITS))
def test_random_initializers_match_jax_by_ops_and_moments(name):
    make_init, std = RANDOM_INITS[name]
    shape = [128, 256]
    j = _init_program(jfluid, make_init, shape)
    t = _init_program(tfluid, make_init, shape)
    assert t.to_string() == j.to_string()
    assert [op.attrs for op in t.global_block().ops] == \
        [op.attrs for op in j.global_block().ops]
    want, got = _startup_values(jfluid, j)['w'], _startup_values(tfluid, t)['w']
    assert got.shape == tuple(shape)
    mean = 0.5 if name == 'truncated_normal' else 0.0
    for arr in (want, got):
        assert abs(arr.mean() - mean) < 0.02 * std
        assert abs(arr.std() / std - 1) < 0.02, (arr.std(), std)


def test_init_on_cpu_and_the_aliases():
    for fluid in (jfluid, tfluid):
        I = fluid.initializer
        assert I.force_init_on_cpu() is False
        with I.init_on_cpu():
            assert I.force_init_on_cpu() is True
        assert I.force_init_on_cpu() is False
        for alias, cls in (('ConstantInitializer', 'Constant'),
                           ('UniformInitializer', 'Uniform'),
                           ('NormalInitializer', 'Normal'),
                           ('XavierInitializer', 'Xavier'),
                           ('MSRAInitializer', 'MSRA'),
                           ('BilinearInitializer', 'Bilinear')):
            assert getattr(I, alias) is getattr(I, cls)
    assert sorted(tfluid.initializer.__all__) == \
        sorted(jfluid.initializer.__all__)


# -- 3: the framework surface --------------------------------------------------

def _framework_script(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with fluid.name_scope('block_a'):
            x = fluid.layers.data(name='x', shape=[3], dtype='float32')
            h = fluid.layers.fc(input=x, size=2)
        ints = h.astype('int64')
        block = main.global_block()
        extra = block.create_var(name='extra', shape=[2], dtype='float32',
                                 initializer=fluid.initializer.Constant(1.0),
                                 error_clip=None)
        block.create_var(name='doomed', shape=[1], dtype='float32')
        block.remove_var('doomed')
        block.rename_var(h.name, 'renamed_h')
        op = block.ops[-1]
        op.set_attr('note', 7)
        op.rename_input('renamed_h', 'renamed_again')
        op.rename_output(ints.name, 'ints_out')
    return main, extra


def test_framework_surface_matches_jax():
    j, jextra = _framework_script(jfluid)
    t, textra = _framework_script(tfluid)
    assert t.to_string() == j.to_string()
    cast = t.global_block().ops[-1]
    assert cast.type == 'cast' and cast.attr('note') == 7
    assert cast.input('X') == ['renamed_again']
    assert cast.output('Out') == ['ints_out']
    assert 'doomed' not in t.global_block().vars
    assert textra.error_clip is None and jextra.error_clip is None
    assert tfluid.grad_var_name('w') == jfluid.grad_var_name('w') == 'w@GRAD'
    for name in ('name_scope', 'grad_var_name', 'WeightNormParamAttr',
                 'ExecutionStrategy', 'BuildStrategy'):
        assert name in tfluid.__all__ and hasattr(tfluid, name)


def test_astype_runs_as_a_cast():
    x = tfluid.layers.data(name='x', shape=[3], dtype='float32')
    y = x.astype('int32')
    assert y.dtype == 'int32'
    out, = tfluid.Executor(tfluid.CPUPlace()).run(
        feed={'x': np.array([[1.7, -2.2, 3.0]], 'float32')}, fetch_list=[y])
    np.testing.assert_array_equal(out, [[1, -2, 3]])


# -- 4: WeightNormParamAttr ----------------------------------------------------

def _weight_norm_net(fluid, unique_name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[6], dtype='float32')
            y = fluid.layers.data(name='y', shape=[1], dtype='float32')
            h = fluid.layers.fc(
                input=x, size=4, act='tanh',
                param_attr=fluid.WeightNormParamAttr(dim=1, name='wn_h'))
            pred = fluid.layers.fc(
                input=h, size=1,
                param_attr=fluid.WeightNormParamAttr(dim=None))
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(input=pred, label=y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def test_weight_norm_fc_trains_like_jax():
    jmain, jstartup, jloss = _weight_norm_net(jfluid, junique_name)
    tmain, tstartup, tloss = _weight_norm_net(tfluid, tunique_name)
    assert tmain.to_string() == jmain.to_string()
    assert tstartup.to_string() == jstartup.to_string()
    params = sorted(p.name for p in tmain.global_block().all_parameters())
    # g and v are the parameters; w is computed in the main program
    assert params == ['fc_0.w_0', 'fc_1.w_0.wn.g', 'fc_1.w_0.wn.v',
                      'fc_1.w_1', 'wn_h.wn.g', 'wn_h.wn.v']
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jstartup.list_vars() if v.persistable}
    np.testing.assert_array_equal(init['wn_h.wn.g'], np.ones(4, 'f4'))
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tmain)
    rng = np.random.RandomState(3)
    for _ in range(3):
        feed = {'x': rng.randn(5, 6).astype('f4'),
                'y': rng.randn(5, 1).astype('f4')}
        want, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for n in params:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.array(jscope.find_var(n)),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
        assert not np.array_equal(np.array(jscope.find_var(n)), init[n]), n


# -- 5: Scope and the one-device ParallelExecutor -------------------------------

def _scope_script(fluid):
    root = fluid.Scope()
    root.set_var('a', np.ones(2, 'f4'))
    kid = root.new_scope()
    kid.set_var('b', np.zeros(3, 'f4'))
    kid.var('c')
    seen = (kid.has_var('a'), kid.find_var('a') is not None,
            root.has_var('b'), sorted(kid.local_var_names()),
            sorted(root.local_var_names()))
    grandkid = kid.new_scope()
    root.drop_kids()
    return seen, grandkid.has_var('a'), len(root._kids), len(kid._kids)


def test_scope_kids_match_jax():
    assert _scope_script(tfluid) == _scope_script(jfluid)


def _pe_net(fluid, unique_name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[5], dtype='float32')
            y = fluid.layers.data(name='y', shape=[1], dtype='float32')
            h = fluid.layers.fc(input=x, size=8, act='relu')
            pred = fluid.layers.fc(input=h, size=1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(input=pred, label=y))
            test_prog = main.clone(for_test=True)
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, test_prog, loss


def _pe_losses(fluid, unique_name, use_cuda, init=None):
    main, startup, test_prog, loss = _pe_net(fluid, unique_name)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        if init is None:
            fluid.Executor(fluid.CPUPlace()).run(startup)
            init = {v.name: np.array(scope.find_var(v.name))
                    for v in startup.list_vars() if v.persistable}
        else:
            fluid.io.load_numpy_params(scope, init, fluid.CPUPlace(),
                                       program=main)
        es, bs = fluid.ExecutionStrategy(), fluid.BuildStrategy()
        es.num_iteration_per_drop_scope = 1
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.AllReduce
        train = fluid.ParallelExecutor(use_cuda=use_cuda, loss_name=loss.name,
                                       main_program=main, exec_strategy=es,
                                       build_strategy=bs)
        test = fluid.ParallelExecutor(use_cuda=use_cuda, main_program=test_prog,
                                      share_vars_from=train)
        rng = np.random.RandomState(9)
        losses = []
        for _ in range(3):
            feed = {'x': rng.randn(8, 5).astype('f4'),
                    'y': rng.randn(8, 1).astype('f4')}
            losses.append(float(np.asarray(
                train.run(fetch_list=[loss.name], feed_dict=feed)[0])))
            losses.append(float(np.asarray(
                test.run(fetch_list=[loss.name], feed=feed)[0])))
    return init, losses, train, test


def test_parallel_executor_shares_vars_with_a_test_executor_like_jax():
    init, want, jtrain, _ = _pe_losses(jfluid, junique_name, True)
    _, got, train, test = _pe_losses(tfluid, tunique_name, False, init)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the test pass after each train step sees that step's update
    assert got[1] < got[0] and got[3] < got[2]
    assert test._scope is train._scope
    assert train.device_count == test.device_count == 1
    assert jtrain.device_count >= 1


@pytest.mark.parametrize('kwargs', [{'num_trainers': 2}, {'trainer_id': 1},
                                    {'devices': [tfluid.CPUPlace()] * 2},
                                    {'strategy': object()}],
                         ids=['num_trainers', 'trainer_id', 'devices',
                              'strategy'])
def test_parallel_executor_multi_device_arguments_raise(kwargs, monkeypatch):
    """Item 8 ported these arguments (tests/test_torch_mesh.py runs them
    over ranks); what still raises, in one process with no job: several
    trainers with no endpoint (the JAX package's message), a device list
    of another length than the world, and a strategy that is not one. A
    trainer id alone is accepted, as in the JAX package."""
    for k in ('PADDLE_TRAINER_ENDPOINTS', 'PADDLE_DIST_INIT_METHOD',
              'PADDLE_TRAINERS_NUM', 'PADDLE_TRAINERS'):
        monkeypatch.delenv(k, raising=False)
    if 'trainer_id' in kwargs:
        pe = tfluid.ParallelExecutor(use_cuda=False,
                                     main_program=tfluid.Program(), **kwargs)
        assert pe.device_count == 1 and pe.mesh is None
        return
    want = {'num_trainers': (ValueError, 'PADDLE_TRAINER_ENDPOINTS'),
            'devices': (ValueError, 'one place each'),
            'strategy': (TypeError, 'DistributedStrategy')}[next(iter(kwargs))]
    with pytest.raises(want[0], match=want[1]):
        tfluid.ParallelExecutor(use_cuda=False, main_program=tfluid.Program(),
                                **kwargs)


def test_parallel_executor_writes_its_dot_text(tmp_path):
    main, _, _, _ = _pe_net(tfluid, tunique_name)
    bs = tfluid.BuildStrategy()
    bs.debug_graphviz_path = str(tmp_path / 'pe.dot')
    tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                            build_strategy=bs)
    jmain, _, _, _ = _pe_net(jfluid, junique_name)
    assert (tmp_path / 'pe.dot').read_text() == \
        jfluid.debugger.program_to_dot(jmain)


# -- 6: the comparison layers ---------------------------------------------------

COMPARISONS = ['less_than', 'less_equal', 'greater_than', 'greater_equal',
               'equal', 'not_equal']


def _compare_run(fluid, unique_name, layer, xv, yv):
    with unique_name.guard():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name='x', shape=[4], dtype='float32')
            y = fluid.layers.data(name='y', shape=[4], dtype='float32')
            out = getattr(fluid.layers, layer)(x, y)
    got, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={'x': xv, 'y': yv}, fetch_list=[out], scope=fluid.Scope())
    return main.to_string(), np.asarray(got)


@pytest.mark.parametrize('layer', COMPARISONS)
def test_comparison_layer_matches_jax(layer):
    r = np.random.RandomState(5)
    xv = r.randn(3, 4).astype('f4')
    yv = np.where(r.rand(3, 4) < 0.4, xv, r.randn(3, 4).astype('f4'))
    jtext, want = _compare_run(jfluid, junique_name, layer, xv, yv)
    ttext, got = _compare_run(tfluid, tunique_name, layer, xv, yv)
    assert ttext == jtext
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert layer in tfluid.layers.__all__


# -- 7: small names ------------------------------------------------------------

def test_small_names_exist_as_in_jax():
    assert tfluid.inference.create_paddle_predictor is \
        tfluid.inference.create_predictor
    from paddle_tpu import inference as jinference
    assert jinference.create_paddle_predictor is jinference.create_predictor
    from paddle_tpu import registry as jregistry
    from paddle_tpu_torch import registry as tregistry
    for reg in (jregistry, tregistry):
        assert reg.has_op('mul') and not reg.has_op('no_such_op')


def test_op_infer_shape_and_op_grad_maker_register():
    from paddle_tpu_torch import registry

    @registry.op_infer_shape('surface_probe_op')
    def infer(op, block):
        pass

    @registry.op_grad_maker('surface_probe_op')
    def grad(op, block, no_grad_set):
        return []

    try:
        opdef = registry.get_op('surface_probe_op')
        assert opdef.infer_shape is infer and opdef.grad is grad
    finally:
        del registry._REGISTRY['surface_probe_op']


def _leak_one(fluid, name):
    """A py_reader whose generator blocks; reset() gives up on its
    worker after join_timeout. Returns leaked_threads() before and
    after, and releases the worker."""
    from importlib import import_module
    pipeline = import_module(fluid.__name__ + '.reader.pipeline')
    release = threading.Event()
    rdr = pipeline.PyReader(name, shapes=[(-1, 2)], dtypes=['float32'],
                            capacity=2, use_double_buffer=False,
                            join_timeout=0.2)

    def provider():
        release.wait(10)
        yield [np.zeros((1, 2), 'f4')]

    rdr.decorate_tensor_provider(provider)
    before = pipeline.leaked_threads()
    rdr.start()
    rdr.reset()
    after = pipeline.leaked_threads()
    release.set()
    for t in rdr._threads:
        t.join(5)
    return before, after


def test_leaked_threads_counts_like_jax():
    jb, ja = _leak_one(jfluid, 'surface_leak_jax')
    tb, ta = _leak_one(tfluid, 'surface_leak_torch')
    assert ja - jb == ta - tb == 1


def test_decorate_batch_generator_feeds_the_read_op():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        rdr = tfluid.layers.py_reader(capacity=2, shapes=[(-1, 3)],
                                      dtypes=['float32'],
                                      name='surface_batches')
        x = tfluid.layers.read_file(rdr)
        y = tfluid.layers.scale(x, scale=2.0)
    batch = np.arange(6, dtype='f4').reshape(2, 3)
    rdr.decorate_batch_generator(lambda: iter([[batch]]))
    rdr.start()
    try:
        out, = tfluid.Executor(tfluid.CPUPlace()).run(main, fetch_list=[y])
    finally:
        rdr.reset()
    np.testing.assert_array_equal(out, batch * 2)


# -- 8: layers.lookup_table ------------------------------------------------------

def _lookup_program(fluid, unique_name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data(name='ids', shape=[1], dtype='int64')
            out = fluid.layers.lookup_table(input=ids, size=[11, 6],
                                            padding_idx=2)
    return main, startup, out


def test_lookup_table_is_embedding_as_in_jax():
    for fluid in (jfluid, tfluid):
        assert fluid.layers.lookup_table is fluid.layers.embedding
        assert 'lookup_table' in fluid.layers.__all__
    jmain, jstartup, jout = _lookup_program(jfluid, junique_name)
    tmain, tstartup, tout = _lookup_program(tfluid, tunique_name)
    assert tmain.to_string() == jmain.to_string()
    init = _startup_values(jfluid, jstartup)
    ids = np.array([[0], [2], [10], [2]], 'int64')
    jscope = jfluid.Scope()
    for name, val in init.items():
        jscope.set_var(name, val)
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed={'ids': ids}, fetch_list=[jout], scope=jscope)
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tmain)
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={'ids': ids}, fetch_list=[tout], scope=tscope)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not got[1].any() and not got[3].any()


# -- 9: layers.load --------------------------------------------------------------

def _saved_var(fluid, unique_name, dirname):
    """Save the startup value of a [3, 4] parameter with io.save_vars."""
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[4], dtype='float32')
            fluid.layers.fc(input=x, size=3, bias_attr=False)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    w = main.global_block().all_parameters()[0]
    with fluid.scope_guard(scope):
        fluid.io.save_vars(exe, dirname, main_program=main, vars=[w])
    return w.name, np.asarray(scope.find_var(w.name))


def _loaded(fluid, path, load_as_fp16):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        out = main.global_block().create_var(name='restored',
                                             dtype='float32')
        kw = {} if load_as_fp16 is None else {'load_as_fp16': load_as_fp16}
        ret = fluid.layers.load(out, path, **kw)
    assert ret is out
    got, = fluid.Executor(fluid.CPUPlace()).run(
        main, fetch_list=[out], scope=fluid.Scope())
    return main, np.asarray(got)


@pytest.mark.parametrize('load_as_fp16', [None, True])
def test_load_layer_restores_a_saved_var_like_jax(tmp_path, load_as_fp16):
    jname, jval = _saved_var(jfluid, junique_name, str(tmp_path / 'j'))
    tname, tval = _saved_var(tfluid, tunique_name, str(tmp_path / 't'))
    assert tname == jname
    jmain, want = _loaded(jfluid, str(tmp_path / 'j' / jname), load_as_fp16)
    tmain, got = _loaded(tfluid, str(tmp_path / 't' / tname), load_as_fp16)
    assert tmain.to_string() == jmain.to_string()
    assert [op.type for op in tmain.global_block().ops] == ['load']
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, tval.astype(got.dtype))
    np.testing.assert_array_equal(want, jval.astype(want.dtype))
    # each package reads the other's file to the same values
    _, cross = _loaded(tfluid, str(tmp_path / 'j' / jname), load_as_fp16)
    np.testing.assert_array_equal(cross, want)


# -- 10: sequence_first_step and sequence_last_step ------------------------------

@pytest.mark.parametrize('op_type', ['sequence_first_step',
                                     'sequence_last_step'])
def test_first_and_last_step_op_types_match_jax(op_type):
    """A one-op Program of each type over one seeded input with ragged
    lengths (1 and T among them), in both packages: the forward within
    1e-5, and the same backward: the JAX package registers no grad for
    these types, so calc_gradient of the input is None in both."""
    rng = np.random.RandomState(18)
    x = rng.randn(4, 5, 3).astype('float32')
    lens = np.array([5, 1, 3, 2], 'int32')
    got = {}
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        block = prog.global_block()
        with fluid.program_guard(prog, fluid.Program()):
            xv = block.create_var(name='x', shape=x.shape, dtype='float32',
                                  is_data=True, stop_gradient=False)
            lv = block.create_var(name='lens', shape=lens.shape,
                                  dtype='int32', is_data=True)
            out = block.create_var(name='out')
            block.append_op(type=op_type, inputs={'X': [xv], 'SeqLens': [lv]},
                            outputs={'Out': [out]})
            cot = block.create_var(name='cot', shape=(4, 3),
                                   dtype='float32', is_data=True)
            grads = fluid.backward.calc_gradient([out], [xv],
                                                 target_gradients=[cot])
        r, = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed={'x': x, 'lens': lens, 'cot': np.ones((4, 3),
                                                            'float32')},
            fetch_list=['out'], scope=fluid.Scope())
        got[fluid.__name__] = (np.asarray(r), grads,
                               [op.type for op in block.ops])
    want, jgrads, jops = got['paddle_tpu']
    have, tgrads, tops = got['paddle_tpu_torch']
    idx = np.zeros(4, int) if op_type == 'sequence_first_step' else lens - 1
    np.testing.assert_array_equal(want, x[np.arange(4), idx])
    np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
    assert jgrads == [None] and tgrads == [None]
    assert tops == jops


# -- 11: lazy Adam on a sparse embedding ---------------------------------------

def _lazy_adam_probe(fluid, init):
    """An embedding [50, 8] with is_sparse=True, mean-pooled into an fc,
    under Adam(0.05, lazy_mode=True), from `init`: step 1 draws its ids
    from 0-19, step 2 from 0-9. Returns every persistable after each
    step."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name='ids', shape=[4], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(
            ids, size=[50, 8], is_sparse=True,
            param_attr=fluid.ParamAttr(name='emb_w'))
        pred = fluid.layers.fc(fluid.layers.reduce_mean(emb, dim=1), size=1,
                               param_attr=fluid.ParamAttr(name='fc_w'),
                               bias_attr=fluid.ParamAttr(name='fc_b'))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, label))
        fluid.optimizer.Adam(0.05, lazy_mode=True).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    for n, v in init.items():
        scope.set_var(n, torch.tensor(v) if fluid is tfluid else v)
    rng = np.random.RandomState(5)
    after = []
    for high in (20, 10):
        feed = {'ids': rng.randint(0, high, (16, 4)).astype('int64'),
                'label': rng.rand(16, 1).astype('float32')}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        after.append({n: np.array(scope.find_var(n)) for n in names})
    return after


def test_lazy_adam_on_a_sparse_embedding_matches_jax():
    """Both packages from one seeded numpy init: after the two steps
    every persistable (table, moments, fc) within 1e-5 of the JAX
    package, and the rows step 2 missed (10-19) hold step 1's bits in
    the table and in both moments."""
    rng = np.random.RandomState(11)
    init = {'emb_w': rng.randn(50, 8).astype('float32'),
            'fc_w': rng.randn(8, 1).astype('float32'),
            'fc_b': np.zeros((1,), 'float32')}
    jafter = _lazy_adam_probe(jfluid, init)
    tafter = _lazy_adam_probe(tfluid, init)
    for n, want in jafter[-1].items():
        np.testing.assert_allclose(tafter[-1][n], want, rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    table = [n for n in tafter[-1] if n == 'emb_w' or
             n.startswith(('emb_w_moment1', 'emb_w_moment2'))]
    assert len(table) == 3      # the table and its two moments
    for n in table:
        np.testing.assert_array_equal(tafter[1][n][10:20],
                                      tafter[0][n][10:20], err_msg=n)
    assert np.abs(tafter[1]['emb_w'][:10] - tafter[0]['emb_w'][:10]).max() \
        > 1e-4


# -- 12: the detection layers and op types -------------------------------------

def test_detection_layers_and_op_types_exist_as_in_jax():
    """Every public name of the JAX package's layers/detection.py, the
    module name `detection` and polygon_box_transform are the port's
    too, and every op type of its ops/detection_ops.py is registered,
    grad or not as there. The port shares at least 214 of the JAX
    package's public layer names and 224 of its non-grad op types."""
    from paddle_tpu import registry as jregistry
    from paddle_tpu.layers import detection as jdetection
    from paddle_tpu.ops import detection_ops as jdetection_ops
    from paddle_tpu_torch import registry as tregistry
    names = set(jdetection.__all__) | {'detection', 'polygon_box_transform'}
    assert len(names) == 17
    assert names <= set(dir(tfluid.layers))
    types = {t for t, d in jregistry._REGISTRY.items()
             if getattr(d.emit, '__module__', '') == jdetection_ops.__name__}
    assert len(types) == 15
    for t in types:
        assert tregistry.has_op(t)
        assert tregistry.has_op(t + '_grad') == jregistry.has_op(t + '_grad')

    def public(mod):
        return {n for n in dir(mod) if not n.startswith('_')}
    assert len(public(jfluid.layers) & public(tfluid.layers)) >= 214

    def op_types(reg):
        return {t for t in reg._REGISTRY if not t.endswith('_grad')}
    assert len(op_types(jregistry) & op_types(tregistry)) >= 224


# -- 13: feed and fetch; each not-ported message names its item ---------------

@pytest.mark.parametrize('op_type', ['feed', 'fetch'])
def test_feed_and_fetch_registered_as_in_jax(op_type):
    """The JAX package registers feed and fetch as host, no-grad markers
    (paddle_tpu/ops/io_ops.py:52-53): has_op and get_op answer alike."""
    from paddle_tpu import registry as jregistry
    from paddle_tpu_torch import registry as tregistry
    assert tregistry.has_op(op_type) is jregistry.has_op(op_type) is True
    jdef, tdef = jregistry.get_op(op_type), tregistry.get_op(op_type)
    assert (tdef.host, tdef.no_grad) == (jdef.host, jdef.no_grad) == \
        (True, True)


def _raises_naming(item, fn):
    with pytest.raises(NotImplementedError, match='Queue 1 item %d' % item):
        fn()


# (ROADMAP.md Queue 1 item, call): what is left of item 8 (mesh
# serving); host-side distribution (item 7) and the profiler (item 9)
# are ported
NOT_PORTED = {
    'serve_replica_mesh': (8, lambda: _serve_replica_with(
        {'SERVE_MESH_SHAPE': 'tp=2'})),
}


def _ring_program():
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        q = tfluid.layers.data(name='q', shape=[2, 8, 4], dtype='float32')
        out = tfluid.parallel.layers.ring_attention(q, q, q)
    return prog, out


def _fc_trainer(**kw):
    def train_func():
        x = tfluid.layers.data(name='x', shape=[4], dtype='float32')
        y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
        return tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(input=x, size=1), y))
    return tfluid.Trainer(train_func, lambda: tfluid.optimizer.SGD(0.1),
                          place=tfluid.CPUPlace(), **kw)


# item 8's entry points the mesh slices ported (they raised before): each
# now builds or runs
PORTED_NOW = {
    'ring_attention': lambda: __import__(
        'paddle_tpu_torch.models.transformer', fromlist=['x'])
    .TransformerConfig(ring_attention=True).ring_attention,
    'ring_attention_layer': lambda: [
        op.type for op in _ring_program()[0].global_block().ops] ==
    ['ring_attention'],
    'collective_audit': lambda: tfluid.profiler.collective_audit(
        [{'kind': 'all-reduce', 'bytes': 16}]) == {'all-reduce': [16]},
    'pp_stages': lambda: __import__(
        'paddle_tpu_torch.models.transformer', fromlist=['x'])
    .TransformerConfig(pp_stages=2).pp_stages == 2,
    'pp_strategy': lambda: tfluid.parallel.DistributedStrategy(
        pp=2, dp=2, micro_batches=4).mesh_config().build().shape ==
    {'pp': 2, 'dp': 2},
    'sharded_checkpoint': lambda: tfluid.CheckpointConfig(
        sharded=True).sharded,
    'trainer_strategy': lambda: _fc_trainer(
        strategy=tfluid.parallel.DistributedStrategy()).parallel,
}


@pytest.mark.parametrize('name', sorted(PORTED_NOW))
def test_not_ported_messages_name_their_item_ported_now(name):
    assert PORTED_NOW[name]() is True


def _serve_replica_with(env):
    import os
    from paddle_tpu_torch.tools import serve_replica
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        serve_replica.main()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize('name', sorted(NOT_PORTED))
def test_not_ported_messages_name_their_item(name):
    item, fn = NOT_PORTED[name]
    _raises_naming(item, fn)


def test_not_ported_docs_name_their_item():
    """The module texts that send a reader to the ROADMAP name the item
    that holds the work: host-side distribution (item 7), the profiler
    (item 9) and item 8's training half are ported, so distributed,
    resilience, trace, obs, obs.report, the checkpoints and the trainer
    name no item; the parallel layers and the profiler's
    collective_audit are item 8's ported part and name none."""
    import re
    from paddle_tpu_torch import (checkpoint, distributed, obs, profiler,
                                  trainer)
    from paddle_tpu_torch.distributed import resilience
    from paddle_tpu_torch.obs import report, trace
    from paddle_tpu_torch.parallel import layers as players
    want = {distributed: set(), resilience: set(), trace: set(),
            checkpoint: set(), trainer: set(), obs: set(), report: set(),
            players: set(), profiler: set()}
    for mod, items in want.items():
        text = open(mod.__file__).read()
        found = {int(n) for n in re.findall(r'Queue\s+1\s+item\s+(\d)',
                                             text)}
        found |= {int(n) for n in re.findall(r'checkpoints; item (\d)',
                                             text)}
        assert found == items, (mod.__name__, found)


# -- 14: ROADMAP Queue 1 item 6, done ------------------------------------------

ITEM6_TYPES = {
    'bilinear_interp', 'bilinear_tensor_product', 'crop', 'fill', 'flatten',
    'l1_norm', 'lod_reset', 'mean_iou', 'minus', 'modified_huber_loss',
    'multiplex', 'norm', 'pad_constant_like', 'random_crop', 'rank_loss',
    'sign', 'unstack', 'conv3d', 'conv3d_transpose', 'conv_shift',
    'depthwise_conv2d_transpose', 'max_pool2d_with_index',
    'max_pool3d_with_index', 'pool3d', 'spp', 'unpool', 'auc',
    'chunk_eval', 'positive_negative_pair', 'precision_recall',
    'fake_quantize', 'fake_dequantize_max_abs', 'moe_ffn', 'moe_aux_loss'}
# nothing is left: item 8's ring attention is ported (item 7's
# host-side distribution before it)
LEFT_TYPES = set()
LEFT_LAYERS = set()


def test_item6_op_types_and_layers_exist_as_in_jax():
    """Item 6's 34 op types are registered, each with a grad exactly
    where the JAX package has one and with its host and no_grad flags;
    the port has all 272 of the JAX package's non-grad op types (since
    item 8's ring_attention) and all 245 of its layer names."""
    from paddle_tpu import registry as jregistry
    from paddle_tpu_torch import registry as tregistry
    for t in ITEM6_TYPES:
        jd, td = jregistry.get_op(t), tregistry.get_op(t)
        assert (td.host, td.no_grad) == (jd.host, jd.no_grad), t
        assert tregistry.has_op(t + '_grad') == \
            jregistry.has_op(t + '_grad'), t

    def op_types(reg):
        return {t for t in reg._REGISTRY if not t.endswith('_grad')}
    jtypes, ttypes = op_types(jregistry), op_types(tregistry)
    assert len(jtypes) == 272 and len(jtypes & ttypes) == 272
    assert jtypes - ttypes == LEFT_TYPES

    def public(mod):
        return {n for n in dir(mod) if not n.startswith('_')}
    jl, tl = public(jfluid.layers), public(tfluid.layers)
    assert len(jl) == 245 and len(jl & tl) == 245
    assert jl - tl == LEFT_LAYERS
    from paddle_tpu.layers import nn_extra as jnn_extra
    assert set(jnn_extra.__all__) <= tl


def test_metrics_evaluator_and_datasets_are_exported_as_in_jax():
    for name in ('metrics', 'evaluator'):
        assert name in tfluid.__all__
        assert set(getattr(jfluid, name).__all__) == \
            set(getattr(tfluid, name).__all__)
    import importlib
    assert jfluid.dataset.__all__ == tfluid.dataset.__all__
    for name in ('flowers', 'voc2012', 'mq2007', 'image'):
        jmod = importlib.import_module('paddle_tpu.dataset.' + name)
        tmod = importlib.import_module('paddle_tpu_torch.dataset.' + name)
        assert set(jmod.__all__) == set(tmod.__all__)


# -- 13-15: ROADMAP Queue 3's three surface faults, repaired ------------------

def test_place_names_and_switch_scope_exist_as_in_jax():
    """TPUPlace and XLAPlace are CUDAPlace (the JAX package's accelerator
    place is TPUPlace, with CUDAPlace and XLAPlace its aliases);
    CUDAPinnedPlace is a host place in both packages; _switch_scope is
    exported at the top level; fluid.core has TPUPlace and XLAPlace."""
    for name in ('TPUPlace', 'XLAPlace', 'CUDAPinnedPlace', '_switch_scope'):
        assert hasattr(jfluid, name) and hasattr(tfluid, name), name
    for name in ('TPUPlace', 'XLAPlace', '_switch_scope'):
        assert name in jfluid.__all__ and name in tfluid.__all__, name
    assert tfluid.TPUPlace is tfluid.XLAPlace is tfluid.CUDAPlace
    assert jfluid.XLAPlace is jfluid.CUDAPlace is jfluid.TPUPlace
    assert jfluid.CUDAPinnedPlace is jfluid.CPUPlace
    assert tfluid.CUDAPinnedPlace is tfluid.CPUPlace
    assert tfluid.core.TPUPlace is tfluid.core.XLAPlace is tfluid.CUDAPlace
    assert tfluid.TPUPlace(0).device == torch.device('cuda', 0)
    assert tfluid.CUDAPinnedPlace().device.type == 'cpu'
    scope = tfluid.Scope()
    prev = tfluid._switch_scope(scope)
    try:
        assert tfluid.global_scope() is scope
    finally:
        tfluid._switch_scope(prev)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CPUPlace'):
            tfluid.Executor(tfluid.TPUPlace())


def test_fit_a_line_through_executor_of_a_pinned_place_as_in_jax():
    """The verify skill's fit_a_line drive, written for the JAX package
    with a place name the port lacked; CUDAPinnedPlace is the host place
    in both packages, so the same script runs in both."""
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype('f4')
    batches = [rng.randn(32, 13).astype('f4') for _ in range(40)]
    losses = {}
    for fluid, un in ((jfluid, junique_name), (tfluid, tunique_name)):
        main, startup = fluid.Program(), fluid.Program()
        with un.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name='x', shape=[13], dtype='float32')
            y = fluid.layers.data(name='y', shape=[1], dtype='float32')
            pred = fluid.layers.fc(input=x, size=1)
            loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
            fluid.optimizer.SGD(0.01).minimize(loss)
        exe = fluid.Executor(fluid.CUDAPinnedPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            if fluid is tfluid:
                tfluid.io.load_numpy_params(scope, jstate, exe.place)
            else:
                jstate = {v.name: np.asarray(scope.find_var(v.name))
                          for v in startup.list_vars() if v.persistable}
            losses[fluid] = [float(np.asarray(exe.run(
                main, feed={'x': xb, 'y': xb @ w}, fetch_list=[loss])[0]))
                for xb in batches]
    np.testing.assert_allclose(losses[tfluid], losses[jfluid], rtol=1e-5,
                               atol=1e-6)
    assert losses[tfluid][-1] < 0.5 * losses[tfluid][0]


def test_op_emitter_takes_stateful_as_in_jax():
    """op_emitter(type, stateful=) and register_op(stateful=) keep the
    flag on OpDef.stateful, and the port marks the JAX package's random
    op types."""
    from paddle_tpu import registry as jregistry
    from paddle_tpu_torch import registry as tregistry

    @tregistry.op_emitter('surface_probe_random', stateful=True)
    def _emit(ctx, op):
        pass
    tregistry.register_op('surface_probe_plain', stateful=False)
    try:
        assert tregistry.get_op('surface_probe_random').stateful is True
        assert tregistry.get_op('surface_probe_plain').stateful is False
    finally:
        tregistry._REGISTRY.pop('surface_probe_random')
        tregistry._REGISTRY.pop('surface_probe_plain')

    def stateful(reg):
        return {t for t, d in reg._REGISTRY.items() if d.stateful}
    assert stateful(tregistry) == stateful(jregistry)
    assert 'dropout' in stateful(tregistry)


def test_create_var_takes_unknown_keywords_as_in_jax():
    for fluid in (jfluid, tfluid):
        block = fluid.Program().global_block()
        v = block.create_var(name='q', shape=[4], dtype='float32',
                             capacity=4, some_future_attr='x')
        assert v.name == 'q' and tuple(v.shape) == (4,)
        assert v.dtype == 'float32'


# -- 23: ROADMAP Queue 1 item 7's last bullet, done ----------------------------

def test_serving_and_online_exports_equal_the_jax_packages():
    import paddle_tpu.online as jonline
    import paddle_tpu.serving as jserving
    import paddle_tpu_torch.online as tonline
    import paddle_tpu_torch.serving as tserving
    assert tserving.__all__ == jserving.__all__
    assert tonline.__all__ == jonline.__all__ == ['ParamSubscriber',
                                                  'RefreshError']
    for mod in (tserving, tonline):
        for name in mod.__all__:
            assert hasattr(mod, name), name


@pytest.mark.parametrize('name', ['enable_refresh', 'subscriber',
                                  'refresh_once', 'param_digests',
                                  'stats', 'close'])
def test_lmserver_refresh_surface_matches_jax(name):
    """LMServer's online-refresh members take the JAX package's
    arguments (subscriber is a property in both)."""
    import inspect
    from paddle_tpu.serving import LMServer as J
    from paddle_tpu_torch.serving import LMServer as T
    j, t = inspect.getattr_static(J, name), inspect.getattr_static(T, name)
    assert isinstance(t, property) == isinstance(j, property)
    if not isinstance(j, property):
        assert inspect.signature(t) == inspect.signature(j)


@pytest.mark.parametrize('module,names', [
    ('online.subscriber', ['ParamSubscriber']),
    ('serving.replica', ['ReplicaServer']),
    ('serving.fleet', ['FleetRouter', 'FleetAutoscaler', 'FleetRequest']),
    ('serving.disagg', ['pack_pages', 'unpack_rows', 'install_shipment',
                        'serve_page_fetch', 'fetch_and_install',
                        'count_local_reprefill'])])
def test_fleet_module_signatures_match_jax(module, names):
    """The ported classes and functions take the JAX package's arguments,
    method for method."""
    import importlib
    import inspect
    jmod = importlib.import_module('paddle_tpu.' + module)
    tmod = importlib.import_module('paddle_tpu_torch.' + module)
    assert tmod.__all__ == jmod.__all__
    for name in names:
        j, t = getattr(jmod, name), getattr(tmod, name)
        if inspect.isclass(j):
            jm = {k for k, v in vars(j).items() if callable(v)}
            assert {k for k, v in vars(t).items() if callable(v)} == jm
            for k in jm:
                assert inspect.signature(getattr(t, k)) == \
                    inspect.signature(getattr(j, k)), (name, k)
        else:
            assert inspect.signature(t) == inspect.signature(j), name


def test_online_and_fleet_flags_match_jax():
    """The online_* and fleet_* flags (and disagg_ship_timeout) exist in
    the port with the JAX package's defaults."""
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags
    names = [k for k in jflags._DEFAULTS
             if k.startswith(('online_', 'fleet_', 'disagg_'))]
    assert len(names) == 18
    for k in names:
        assert tflags._DEFAULTS[k] == jflags._DEFAULTS[k], k
