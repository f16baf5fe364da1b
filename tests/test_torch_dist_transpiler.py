"""paddle_tpu_torch's DistributeTranspiler against the JAX package's on
the CPU (no sockets but the startup-pull test's in-process pservers).

- For tests/ps_worker.py's four models (mlp, sparse, table, deepfm), a
  program with an LR schedule and Momentum, and the HashName and
  unsliced configurations, the trainer program, every pserver program,
  every pserver startup program and the trainer startup program equal
  the JAX package's op by op: the same blocks, ops, attrs, var names,
  shapes, dtypes and slicing.
- The trainer startup ends with the pull (`recv` of every owned block,
  `fetch_barrier`, `concat`), as in the JAX package: with pservers on
  the CPU and unseeded initializers, the trainer's parameters after its
  startup equal the pservers' slices exactly, where the origin startup
  alone draws other values.
- tests/test_dist_transpiler.py's cases on the port.
"""
import os
import socket
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import ps_worker as jworker            # noqa: E402
import torch_ps_worker as tworker      # noqa: E402

EPS = '127.0.0.1:6170,127.0.0.1:6171'


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


def _norm(v):
    """Attr values compared as plain data (tuples as lists)."""
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if hasattr(v, 'idx') and hasattr(v, 'ops'):     # a sub-block attr
        return ('block', v.idx)
    return v


def program_record(prog):
    """Every block of a program as plain data: (idx, parent, vars, ops)."""
    out = []
    for b in prog.blocks:
        vs = sorted((n, None if v.shape is None else list(v.shape),
                     str(v.dtype), bool(v.persistable))
                    for n, v in b.vars.items())
        ops = [(op.type,
                sorted((k, list(x)) for k, x in op.inputs.items()),
                sorted((k, list(x)) for k, x in op.outputs.items()),
                sorted((k, _norm(x)) for k, x in op.attrs.items()))
               for op in b.ops]
        out.append((b.idx, b.parent_idx, vs, ops))
    return out


def _transpile(fluid, build, optimizer, config=None, trainer_id=0,
               sync=True):
    loss = build()
    if isinstance(loss, tuple):             # (loss, feeds, params)
        loss = loss[0]
    optimizer(fluid).minimize(loss)
    t = fluid.DistributeTranspiler(config=config)
    t.transpile(trainer_id, pservers=EPS, trainers=2, sync_mode=sync)
    return t


def _all_programs(t):
    progs = {'trainer': t.get_trainer_program(),
             'trainer_startup': t.get_trainer_startup_program()}
    for ep in t.pserver_endpoints:
        main, startup = t.get_pserver_programs(ep)
        progs['pserver ' + ep] = main
        progs['pserver_startup ' + ep] = startup
    return progs


def _lr_mlp(fluid):
    x = fluid.layers.data(name='x', shape=[64], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    h = fluid.layers.fc(input=x, size=300, act='relu',
                        param_attr=fluid.ParamAttr(name='lw1'))
    pred = fluid.layers.fc(input=h, size=1)
    return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def _momentum_with_schedule(fluid):
    lr = fluid.layers.exponential_decay(0.1, decay_steps=3,
                                        decay_rate=0.5, staircase=True)
    return fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)


CASES = {
    'mlp': ('build_mlp', lambda f: f.optimizer.SGD(0.01), None, True),
    'sparse': ('build_sparse', lambda f: f.optimizer.SGD(0.01), None,
               True),
    'table': ('table', lambda f: f.optimizer.SGD(0.01), None, True),
    'deepfm_adam': ('build_deepfm', lambda f: f.optimizer.Adam(0.01),
                    None, True),
    'lr_schedule_momentum': ('lr', _momentum_with_schedule, None, True),
    'mlp_async': ('build_mlp', lambda f: f.optimizer.SGD(0.01), None,
                  False),
    'hash_name': ('build_deepfm', lambda f: f.optimizer.Adam(0.01),
                  'hash', True),
    'unsliced': ('build_mlp', lambda f: f.optimizer.SGD(0.01), 'whole',
                 True),
}


def _builder(mod, fluid, name):
    if name == 'table':
        return lambda: mod.build_sparse(distributed_table=True)
    if name == 'lr':
        return lambda: _lr_mlp(fluid)
    return getattr(mod, name)


def _config(fluid, kind):
    if kind is None:
        return None
    cfg = fluid.DistributeTranspilerConfig()
    if kind == 'hash':
        cfg.split_method = fluid.transpiler.HashName
    else:
        cfg.slice_var_up = False
    return cfg


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('trainer_id', [0, 1])
def test_programs_equal_the_jax_packages(case, trainer_id):
    build, opt, cfg, sync = CASES[case]
    records = {}
    for name, fluid, mod in (('jax', jfluid, jworker),
                             ('torch', tfluid, tworker)):
        t = _transpile(fluid, _builder(mod, fluid, build), opt,
                       _config(fluid, cfg), trainer_id, sync)
        records[name] = {k: program_record(p)
                         for k, p in _all_programs(t).items()}
        records[name]['blocks'] = [
            (i.pname, i.gname, i.offset, i.rows, i.ep, i.sparse)
            for i in t.var_blocks]
    assert sorted(records['jax']) == sorted(records['torch'])
    for k in records['jax']:
        assert records['torch'][k] == records['jax'][k], k
    # the trainer startup ends with the pull
    tail = [op[0] for op in records['torch']['trainer_startup'][0][3]]
    assert 'recv' in tail and tail.index('recv') < tail.index(
        'fetch_barrier')


# -- the startup pull ----------------------------------------------------------

def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(('127.0.0.1', 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def test_trainer_startup_pulls_the_pservers_initial_values():
    """Two pservers on the CPU (threads of this process) and one
    trainer, unseeded initializers: each startup draws its own numbers,
    so only the pull makes the trainer start from the pservers' slices.
    With it the trainer's parameters equal the slices exactly; the
    origin startup alone does not."""
    x = tfluid.layers.data(name='x', shape=[64], dtype='float32')
    y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
    h = tfluid.layers.fc(input=x, size=256, act='relu')
    pred = tfluid.layers.fc(input=h, size=1)
    loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
    tfluid.optimizer.SGD(0.1).minimize(loss)
    eps = ','.join('127.0.0.1:%d' % p for p in _free_ports(2))
    t = tfluid.DistributeTranspiler()
    t.transpile(0, pservers=eps, trainers=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    ps_scopes, threads, errors = [], [], []

    def serve(main, startup, scope):
        try:
            exe_ps = tfluid.Executor(tfluid.CPUPlace())
            exe_ps.run(startup, scope=scope)
            exe_ps.run(main, scope=scope)
        except Exception as e:       # noqa: BLE001 -- asserted below
            errors.append(e)
    for ep in t.pserver_endpoints:
        main, startup = t.get_pserver_programs(ep)
        scope = tfluid.Scope()
        ps_scopes.append((ep, scope))
        th = threading.Thread(target=serve, args=(main, startup, scope),
                              daemon=True)
        th.start()
        threads.append(th)
    origin = tfluid.Scope()
    exe.run(t.startup_program, scope=origin)
    trainer = tfluid.Scope()
    try:
        exe.run(t.get_trainer_startup_program(), scope=trainer)
    finally:
        exe.close()                  # COMPLETE: the pservers stop
    for th in threads:
        th.join(timeout=30)
    assert not errors and not any(th.is_alive() for th in threads)
    params = [v.name for v in t.origin_program.global_block()
              .all_parameters()]
    assert len(params) == 4
    by_ep = dict(ps_scopes)
    differ = 0
    for p in params:
        got = np.asarray(trainer.find_var(p).numpy())
        blocks = [i for i in t.var_blocks if i.param.name == p]
        for info in blocks:
            shard = by_ep[info.ep].find_var(info.pname).numpy()
            assert np.array_equal(got[info.offset:info.offset + info.rows],
                                  shard), info.pname
        if not np.array_equal(np.asarray(origin.find_var(p).numpy()), got):
            differ += 1
    # the weights (not the zero biases) of the origin startup differ
    assert differ == 2


# -- tests/test_dist_transpiler.py's cases on the port ----------------------

def _build_net(emb_sparse=False, emb_distributed=False):
    fluid = tfluid
    if emb_sparse or emb_distributed:
        ids = fluid.layers.data(name='ids', shape=[4], dtype='int64')
        emb = fluid.layers.embedding(
            ids, size=[1024, 16], is_sparse=True,
            is_distributed=emb_distributed,
            param_attr=fluid.ParamAttr(name='emb_w'))
        x = fluid.layers.reduce_mean(emb, dim=1)
    else:
        x = fluid.layers.data(name='x', shape=[64], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    pred = fluid.layers.fc(input=x, size=256, act='relu',
                           param_attr=fluid.ParamAttr(name='big_w'),
                           bias_attr=fluid.ParamAttr(name='small_b'))
    pred = fluid.layers.fc(input=pred, size=1,
                           param_attr=fluid.ParamAttr(name='w2'))
    return fluid.layers.mean(fluid.layers.square_error_cost(pred, y))


def _transpile_net(**kw):
    loss = _build_net(**kw)
    tfluid.optimizer.SGD(0.1).minimize(loss)
    t = tfluid.DistributeTranspiler()
    t.transpile(0, pservers=EPS, trainers=2)
    return t


def test_trainer_program_structure():
    t = _transpile_net()
    ops = [op.type for op in t.get_trainer_program().global_block().ops]
    assert 'sgd' not in ops
    assert 'send' in ops and 'recv' in ops
    assert ops.index('send') < ops.index('send_barrier') < \
        ops.index('recv') < ops.index('fetch_barrier')
    assert 'split' in ops and 'concat' in ops
    split = [op for op in t.get_trainer_program().global_block().ops
             if op.type == 'split'][0]
    assert split.input('X') == ['big_w@GRAD']
    assert sum(split.attr('sections')) == 64


def test_split_blocks_balance_across_pservers():
    t = _transpile_net()
    by_ep = {}
    for info in t.var_blocks:
        by_ep.setdefault(info.ep, []).append(info.pname)
    assert len(by_ep) == 2
    blocks = sorted(n for ns in by_ep.values() for n in ns)
    assert 'big_w.block0' in blocks and 'big_w.block1' in blocks
    assert 'small_b' in blocks
    eps = {i.ep for i in t.var_blocks if i.pname.startswith('big_w.block')}
    assert len(eps) == 2


def test_pserver_program_structure():
    t = _transpile_net()
    prog = t.get_pserver_program('127.0.0.1:6170')
    g0 = prog.global_block()
    lsv = [op for op in g0.ops if op.type == 'listen_and_serv']
    assert len(lsv) == 1
    attrs = lsv[0].attrs
    assert attrs['Fanin'] == 2 and attrs['sync_mode']
    for entry in attrs['grad_to_block_id']:
        gname, bid = entry.rsplit(':', 1)
        blk = prog.blocks[int(bid)]
        assert [op.type for op in blk.ops] == ['sgd']
        assert g0.has_var(gname)


def test_pserver_startup_slices_match_local_init():
    """Running both pserver startups re-creates exactly the local init
    (seeded initializers, both on the CPU)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name='x', shape=[16], dtype='float32')
        y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
        h = tfluid.layers.fc(
            input=x, size=600, act='relu',
            param_attr=tfluid.ParamAttr(
                name='sw', initializer=tfluid.initializer.Normal(seed=3)))
        pred = tfluid.layers.fc(input=h, size=1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    t = tfluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers=EPS, trainers=2,
                startup_program=startup)
    exe = tfluid.Executor(tfluid.CPUPlace())
    local = tfluid.Scope()
    exe.run(startup, scope=local)
    full = local.find_var('sw').numpy().copy()
    got = {}
    for ep in t.pserver_endpoints:
        ps = tfluid.Scope()
        exe.run(t.get_startup_program(ep), scope=ps)
        for info in t.var_blocks:
            if info.ep == ep and info.param.name == 'sw':
                got[info.offset] = ps.find_var(info.pname).numpy().copy()
    rebuilt = np.concatenate([got[k] for k in sorted(got)], axis=0)
    np.testing.assert_array_equal(rebuilt, full)


def test_distributed_table_rewrite():
    t = _transpile_net(emb_distributed=True)
    tp = t.get_trainer_program()
    ops = [op.type for op in tp.global_block().ops]
    assert 'prefetch' in ops and 'lookup_table' not in ops
    assert 'split_ids' in ops
    assert not tp.global_block().has_var('emb_w')
    grad_op = [op for op in tp.global_block().ops
               if op.type == 'lookup_table_grad'][0]
    assert not grad_op.input('W')
    assert tuple(grad_op.attr('__table_shape__')) == (1024, 16)
    for i, ep in enumerate(t.pserver_endpoints):
        pp = t.get_pserver_program(ep)
        tv = pp.global_block().var('emb_w')
        assert tv.shape[0] == 512
        lsv = [op for op in pp.global_block().ops
               if op.type == 'listen_and_serv'][0]
        assert lsv.attr('prefetch_table') == 'emb_w'


def test_sparse_grad_uses_split_selected_rows():
    t = _transpile_net(emb_sparse=True)
    ops = [op.type for op in t.get_trainer_program().global_block().ops]
    assert 'split_selected_rows' in ops


def test_sparse_grad_clipped_still_split_sparse():
    loss = _build_net(emb_sparse=True)
    tfluid.clip.set_gradient_clip(tfluid.clip.GradientClipByGlobalNorm(1.0))
    tfluid.optimizer.SGD(0.1).minimize(loss)
    t = tfluid.DistributeTranspiler()
    t.transpile(0, pservers=EPS, trainers=2)
    block = t.get_trainer_program().global_block()
    emb_blocks = [i for i in t.var_blocks if i.param.name == 'emb_w']
    assert emb_blocks[0].sparse
    if emb_blocks[0].split_count > 1:
        srcs = [op for op in block.ops if op.type == 'split_selected_rows']
        assert any(op.input('X') == [emb_blocks[0].grad] for op in srcs)


def test_restore_shard_fallback_matches_by_content(tmp_path):
    old_eps = ['127.0.0.1:9531', '127.0.0.1:12345']
    new_eps = ['127.0.0.1:7001', '127.0.0.1:7002']

    def transpile(eps):
        prog, startup = tfluid.Program(), tfluid.Program()
        with tunique_name.guard(), tfluid.program_guard(prog, startup):
            x = tfluid.layers.data(name='x', shape=[16], dtype='float32')
            y = tfluid.layers.data(name='y', shape=[1], dtype='float32')
            p = tfluid.layers.fc(input=x, size=1, name='w1')
            loss = tfluid.layers.mean(
                tfluid.layers.square_error_cost(p, y))
            tfluid.optimizer.SGD(0.1).minimize(loss)
        t = tfluid.DistributeTranspiler()
        t.transpile(0, program=prog, pservers=','.join(eps), trainers=1,
                    startup_program=startup)
        return t

    t_old = transpile(old_eps)
    ckpt = tmp_path / 'ck'
    for i, ep in enumerate(old_eps):
        prog_i, _ = t_old.get_pserver_programs(ep)
        d = ckpt / ep.replace(':', '_')
        d.mkdir(parents=True)
        for name, var in prog_i.global_block().vars.items():
            if var.persistable and '@' not in name:
                (d / name).write_bytes(b'x')
    t_new = transpile(new_eps)
    for i, ep in enumerate(new_eps):
        main, _ = t_new.get_pserver_programs(ep, checkpoint_dir=str(ckpt))
        shard = main.global_block().ops[-1].attrs['checkpoint_dir']
        assert shard.endswith(old_eps[i].replace(':', '_')), (ep, shard)
        mine = {n for n, v in main.global_block().vars.items()
                if v.persistable and '@' not in n}
        assert mine & set(os.listdir(shard))


def test_send_and_recv_layers_build_the_jax_packages_ops():
    """layers.io's Send and Recv: one epmap entry per var, the barriers
    behind them, as in the JAX package."""
    records = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            a = fluid.layers.data(name='a', shape=[3], dtype='float32')
            b = fluid.layers.data(name='b', shape=[3], dtype='float32')
            fluid.layers.Send('127.0.0.1:1,127.0.0.1:2', [a, b, a])
            got = fluid.layers.Recv(['127.0.0.1:1'], [b], sync=False)
            assert got == [b]
        records.append(program_record(main))
    assert records[0] == records[1]
    ops = records[1][0][3]
    assert [o[0] for o in ops] == ['send', 'send_barrier', 'recv']


# -- the routing host ops as one-op programs against the JAX package ---------

def _one_op(fluid, op_type, ins, outs, attrs, feed):
    """Run one op over fed vars (shape-free: host ops infer nothing) and
    fetch its outputs."""
    prog = fluid.Program()
    block = prog.global_block()
    for n, v in feed.items():
        block.create_var(name=n, shape=v.shape, dtype=str(v.dtype))
    for names in outs.values():
        for n in names:
            block.create_var(name=n)
    block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
    exe = fluid.Executor(fluid.CPUPlace())
    fetch = [n for names in outs.values() for n in names]
    return exe.run(prog, feed=feed, fetch_list=fetch)


def _sr_numpy(v):
    """A fetched SelectedRows (0-d object array) as (values, rows, height)."""
    sr = v[()] if isinstance(v, np.ndarray) and v.dtype == object else v
    return (np.asarray(sr.values, 'float32'), np.asarray(sr.rows),
            sr.height)


def test_routing_ops_match_the_jax_packages():
    """split_ids (raw ids), merge_ids and slice_rows give the JAX
    package's values; split_ids and split_selected_rows on a
    SelectedRows gradient (made by a sparse embedding's grad op) give its
    shards."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, size=(12, 1)).astype('int64')
    x = rng.randn(9, 4).astype('float32')
    shard0 = rng.randn(int((ids % 3 == 0).sum()), 4).astype('float32')
    shard1 = rng.randn(int((ids % 3 == 1).sum()), 4).astype('float32')
    shard2 = rng.randn(int((ids % 3 == 2).sum()), 4).astype('float32')
    cases = [
        ('split_ids', {'Ids': ['ids']}, {'Out': ['a', 'b', 'c']}, {},
         {'ids': ids}),
        ('merge_ids', {'Ids': ['ids'], 'X': ['s0', 's1', 's2']},
         {'Out': ['m']}, {}, {'ids': ids, 's0': shard0, 's1': shard1,
                             's2': shard2}),
        ('slice_rows', {'X': ['x']}, {'Out': ['y']},
         {'start': 1, 'end': -1, 'step': 3}, {'x': x}),
        ('slice_rows', {'X': ['x']}, {'Out': ['y']},
         {'start': 2, 'end': 7, 'step': 1}, {'x': x}),
    ]
    for op_type, ins, outs, attrs, feed in cases:
        got = _one_op(tfluid, op_type, ins, outs, attrs, feed)
        want = _one_op(jfluid, op_type, ins, outs, attrs, feed)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), op_type

    def sparse_shards(fluid, op_type, attrs, n):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w = fluid.layers.data(name='ids', shape=[1], dtype='int64')
            emb = fluid.layers.embedding(
                w, size=[30, 4], is_sparse=True,
                param_attr=fluid.ParamAttr(
                    name='tbl', initializer=fluid.initializer.Constant(0.5)))
            loss = fluid.layers.reduce_sum(fluid.layers.square(emb))
            fluid.backward.append_backward(loss)
            block = main.global_block()
            outs = ['shard%d' % i for i in range(n)]
            for o in outs:
                block.create_var(name=o)
            block.append_op(type=op_type,
                            inputs={('Ids' if op_type == 'split_ids'
                                     else 'X'): ['tbl@GRAD']},
                            outputs={'Out': outs}, attrs=attrs)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        return [_sr_numpy(v) for v in exe.run(
            main, feed={'ids': ids % 30}, fetch_list=outs)]
    for op_type, attrs, n in (('split_ids', {}, 2),
                              ('split_selected_rows',
                               {'height_sections': [10, 20]}, 2)):
        with tfluid.scope_guard(tfluid.Scope()):
            got = sparse_shards(tfluid, op_type, attrs, n)
        with jfluid.scope_guard(jfluid.Scope()):
            want = sparse_shards(jfluid, op_type, attrs, n)
        for (gv, gr, gh), (wv, wr, wh) in zip(got, want):
            assert gh == wh and np.array_equal(gr, wr), op_type
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
