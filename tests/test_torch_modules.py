"""The small one-device modules of the port against the JAX package:
transpiler.memory_optimization_transpiler (the reuse plan, and
release_memory's delete_var host ops), the print and delete_var ops with
layers.Print, average, annotations, op, contrib.memory_usage_calc,
default_scope_funcs, debugger, graphviz and net_drawer.

Each test builds the same Program in both packages (same layers, same
unique names) and compares what the module makes of it: the reuse plan
and the dot text must be equal, the Print text equal byte for byte, and
programs with release_memory's or Print's host ops must train to the JAX
package's losses within 1e-5 from the same initial parameters.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as junique_name
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

PACKAGES = {'jax': (jfluid, junique_name), 'torch': (tfluid, tunique_name)}


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


def _mlp(fluid, train=True, print_hidden=False, first_n=-1):
    """fc(16, relu) x3 -> fc(1) -> square error; SGD when train."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[16], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        h = x
        for i in range(3):
            h = fluid.layers.fc(input=h, size=16, act='relu')
            if print_hidden and i == 0:
                fluid.layers.Print(x, message='the feed', first_n=first_n)
                h = fluid.layers.Print(h, first_n=first_n)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        if train:
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _build(pkg, fn, *args, **kwargs):
    fluid, unique_name = PACKAGES[pkg]
    with unique_name.guard():
        return fn(fluid, *args, **kwargs)


def _feeds(steps=3, batch=4):
    rng = np.random.RandomState(21)
    return [{'x': rng.randn(batch, 16).astype('f4'),
             'y': rng.randn(batch, 1).astype('f4')} for _ in range(steps)]


def _port_losses(tprog, tloss, init, feeds):
    tscope = tfluid.Scope()
    tfluid.io.load_numpy_params(tscope, init, tfluid.CPUPlace(),
                                program=tprog)
    texe = tfluid.Executor(tfluid.CPUPlace())
    return [float(np.asarray(texe.run(tprog, feed=f, fetch_list=[tloss],
                                      scope=tscope)[0])) for f in feeds]


def _train_both(jprog, jstartup, jloss, tprog, tloss, feeds):
    """The JAX package's losses, the port's from its initial
    persistables, and those persistables."""
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jstartup.list_vars() if v.persistable}
    want = [float(np.asarray(jexe.run(jprog, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0])) for f in feeds]
    return want, _port_losses(tprog, tloss, init, feeds), init


# -- memory_optimize / release_memory -------------------------------------------

@pytest.mark.parametrize('train', [False, True], ids=['forward', 'train'])
def test_memory_optimize_plan_matches_jax(train):
    jprog, _, _ = _build('jax', _mlp, train=train)
    tprog, _, _ = _build('torch', _mlp, train=train)
    want = jfluid.memory_optimize(jprog)
    got = tfluid.memory_optimize(tprog)
    assert got == want and len(got) >= 1
    assert tprog._memory_reuse_plan is got
    assert tprog.to_string() == jprog.to_string()   # not rewritten
    skip = sorted(want)[:1]
    assert tfluid.memory_optimize(tprog, skip_opt_set=skip) == \
        jfluid.memory_optimize(jprog, skip_opt_set=skip)
    from paddle_tpu.transpiler import memory_optimization_transpiler as jm
    from paddle_tpu_torch.transpiler import memory_optimization_transpiler \
        as tm
    for jb, tb in zip(jprog.blocks, tprog.blocks):
        assert tm.ControlFlowGraph(tb).liveness() == \
            jm.ControlFlowGraph(jb).liveness()


def test_memory_optimize_keeps_the_losses():
    feeds = _feeds()
    jprog, jstartup, jloss = _build('jax', _mlp)
    tprog, _, tloss = _build('torch', _mlp)
    tfluid.memory_optimize(tprog, print_log=True)
    want, got, _ = _train_both(jprog, jstartup, jloss, tprog, tloss, feeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_release_memory_matches_jax():
    feeds = _feeds()
    jprog, jstartup, jloss = _build('jax', _mlp)
    tprog, _, tloss = _build('torch', _mlp)
    plain, _, ploss = _build('torch', _mlp)
    jfluid.release_memory(jprog)
    tfluid.release_memory(tprog)
    assert tprog.to_string() == jprog.to_string()
    n_delete = [op.type for op in tprog.global_block().ops].count(
        'delete_var')
    assert n_delete >= 10
    want, got, init = _train_both(jprog, jstartup, jloss, tprog, tloss,
                                  feeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the same bits as the program without the delete_var ops
    assert _port_losses(plain, ploss, init, feeds) == got
    # each delete_var is a host step between device segments
    from paddle_tpu_torch.executor import PreparedProgram, _HostStep
    steps = PreparedProgram(tprog, 0, ['x', 'y'], [tloss.name]).steps
    assert sum(isinstance(s, _HostStep) for s in steps) == n_delete


# -- print / layers.Print ---------------------------------------------------------

def _print_run(pkg, capfd, first_n, runs):
    fluid = PACKAGES[pkg][0]
    prog, startup, loss = _build(pkg, _mlp, print_hidden=True,
                                 first_n=first_n)
    text = prog.to_string()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    capfd.readouterr()
    feed = _feeds(1, batch=2)[0]
    for _ in range(runs):
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    return text, capfd.readouterr().err


@pytest.mark.parametrize('first_n', [-1, 2], ids=['every_run', 'first_n'])
def test_print_text_matches_jax(capfd, first_n):
    jtext, jerr = _print_run('jax', capfd, first_n, runs=3)
    ttext, terr = _print_run('torch', capfd, first_n, runs=3)
    assert ttext == jtext
    # the feed's print is bit-identical; the hidden layer's values come
    # from each package's own fc, so only its header lines must match
    jfeed = [b for b in jerr.split('the feed\n') if b]
    tfeed = [b for b in terr.split('the feed\n') if b]
    want_runs = 3 if first_n < 0 else first_n
    assert len(tfeed) == len(jfeed) == want_runs
    for j, t in zip(jfeed, tfeed):
        jvar, jhidden = j.split('Variable: fc_0.tmp_2\n')
        tvar, thidden = t.split('Variable: fc_0.tmp_2\n')
        assert tvar == jvar
        assert tvar.startswith('Variable: x\nshape: [2, 16]\n'
                               'dtype: float32\ndata: [[')
        assert thidden.splitlines()[:2] == jhidden.splitlines()[:2] == \
            ['shape: [2, 16]', 'dtype: float32']
    from paddle_tpu_torch.ops.io_ops import print_text
    x = _feeds(1, batch=2)[0]['x']
    assert tfeed[0].startswith(print_text('x', x))


def test_print_in_a_training_program_matches_jax():
    feeds = _feeds()
    jprog, jstartup, jloss = _build('jax', _mlp, print_hidden=True,
                                    first_n=1)
    tprog, _, tloss = _build('torch', _mlp, print_hidden=True, first_n=1)
    assert tprog.to_string() == jprog.to_string()
    want, got, _ = _train_both(jprog, jstartup, jloss, tprog, tloss, feeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # two prints: the block runs as device segments between host steps
    from paddle_tpu_torch.executor import PreparedProgram, _HostStep
    steps = PreparedProgram(tprog, 0, ['x', 'y'], [tloss.name]).steps
    assert [type(s).__name__ for s in steps].count('_HostStep') == 2
    assert not isinstance(steps[0], _HostStep)


# -- average, annotations, op, memory_usage, default_scope_funcs ---------------------

def _weighted_average(fluid):
    avg = fluid.average.WeightedAverage()
    avg.add(value=2.0, weight=1)
    avg.add(value=4.0, weight=2)
    avg.add(value=np.array([1.0]), weight=1)
    first = avg.eval()
    avg.reset()
    avg.add(value=np.array([[1.0, 2.0], [3.0, 4.0]]), weight=3)
    errors = []
    for bad in ((lambda: avg.add(value='x', weight=1)),
                (lambda: avg.add(value=1.0, weight=np.ones(2))),
                (lambda: fluid.average.WeightedAverage().eval())):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    return first, avg.eval(), errors


def test_weighted_average_matches_jax():
    jfirst, jsecond, jerrors = _weighted_average(jfluid)
    tfirst, tsecond, terrors = _weighted_average(tfluid)
    np.testing.assert_array_equal(tfirst, jfirst)
    np.testing.assert_array_equal(tsecond, jsecond)
    assert terrors == jerrors and len(terrors) == 3


def test_deprecated_matches_jax(capsys):
    out = {}
    for pkg, (fluid, _) in PACKAGES.items():
        @fluid.annotations.deprecated(since='0.1', instead='new_fn',
                                      extra_message='see the docs')
        def old_fn(a, b=2):
            """Adds."""
            return a + b
        assert old_fn(1, b=3) == 4
        out[pkg] = (capsys.readouterr().err, old_fn.__doc__, old_fn.__name__)
    assert out['torch'] == out['jax']
    assert 'API old_fn is deprecated since 0.1' in out['torch'][0]


def test_op_factory_matches_jax():
    from paddle_tpu.op import Operator as JOperator
    from paddle_tpu_torch.op import Operator as TOperator
    for kwargs in ({'X': 'x', 'Out': 'out', 'scale': 2.0},
                   {'X': ['a', 'b'], 'out__Y': 'y', 'axis': 1},
                   {'in__Out': 'o', 'Y': 'y', 'value': [1, 2]}):
        assert TOperator('scale', **kwargs) == JOperator('scale', **kwargs)
    assert set(TOperator.types()) == set(tfluid.registry._REGISTRY)
    assert TOperator.get_op_info('mul').type == 'mul'
    with pytest.raises(ValueError):
        TOperator('not_a_real_op')


@pytest.mark.parametrize('batch', [1, 32])
def test_memory_usage_matches_jax(batch):
    jprog, _, _ = _build('jax', _mlp)
    tprog, _, _ = _build('torch', _mlp)
    got = tfluid.contrib.memory_usage(tprog, batch_size=batch)
    assert got == jfluid.contrib.memory_usage(jprog, batch_size=batch)
    assert got > 0
    with pytest.raises(ValueError):
        tfluid.contrib.memory_usage(tprog, batch_size=0)


def _scope_funcs(fluid):
    dsf = fluid.default_scope_funcs
    log = []
    dsf.var('a')
    dsf.get_cur_scope().set_var('a', 1)
    log.append((dsf.has_var('a'), dsf.find_var('a')))
    dsf.enter_local_scope()
    dsf.var('b')
    log.append((dsf.find_var('a'), dsf.has_var('b'),
                sorted(dsf.get_cur_scope().local_var_names())))
    dsf.leave_local_scope()
    log.append(dsf.has_var('b'))
    dsf.scoped_function(lambda: log.append(
        (dsf.var('c'), dsf.has_var('c'))))
    log.append((dsf.has_var('c'), len(dsf.get_cur_scope()._kids)))
    return log


def test_default_scope_funcs_match_jax():
    import threading
    out = {}
    for pkg, (fluid, _) in PACKAGES.items():
        # a thread of its own: each package's stack starts empty
        t = threading.Thread(target=lambda f=fluid, p=pkg: out.__setitem__(
            p, _scope_funcs(f)))
        t.start()
        t.join(30)
    assert out['torch'] == out['jax']


# -- debugger, graphviz, net_drawer ------------------------------------------------

def test_program_dot_text_matches_jax(tmp_path):
    jprog, jstartup, _ = _build('jax', _mlp)
    tprog, tstartup, _ = _build('torch', _mlp)
    assert tfluid.debugger.program_to_dot(tprog) == \
        jfluid.debugger.program_to_dot(jprog)
    skip = ['x']
    assert tfluid.graphviz.program_to_dot(tprog, skip_vars=skip) == \
        jfluid.graphviz.program_to_dot(jprog, skip_vars=skip)
    tfluid.debugger.draw_block_graphviz(tprog.global_block(),
                                        str(tmp_path / 't.dot'))
    jfluid.debugger.draw_block_graphviz(jprog.global_block(),
                                        str(tmp_path / 'j.dot'))
    assert (tmp_path / 't.dot').read_text() == \
        (tmp_path / 'j.dot').read_text()
    tfluid.net_drawer.draw_graph(tstartup, tprog, str(tmp_path / 'tn.dot'))
    jfluid.net_drawer.draw_graph(jstartup, jprog, str(tmp_path / 'jn.dot'))
    text = (tmp_path / 'tn.dot').read_text()
    assert text == (tmp_path / 'jn.dot').read_text()
    assert text.startswith('digraph "network" {') and 'mul' in text


def test_graph_preview_generator_matches_jax(tmp_path):
    paths = {}
    for pkg, (fluid, _) in PACKAGES.items():
        g = fluid.graphviz.GraphPreviewGenerator('demo')
        a = g.add_param('w', 'float32', highlight=True)
        b = g.add_op('mul', color='red')
        c = g.add_arg('out')
        g.add_edge(a, b, style='bold')
        g.add_edge(b, c)
        paths[pkg] = g(str(tmp_path / ('%s.dot' % pkg)))
    assert open(paths['torch']).read() == open(paths['jax']).read()
