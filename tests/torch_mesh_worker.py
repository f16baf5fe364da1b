"""One rank of a port mesh job on the CPU, for the mesh tests
(tests/test_torch_mesh.py, test_torch_parallel_axes.py,
test_torch_ring_attention.py).

The test process (which holds JAX) spawns the ranks as fresh
interpreters with the PADDLE_* env contract and a FileStore rendezvous
(PADDLE_DIST_INIT_METHOD=file://...). Every rank runs the cases named
on its command line, in order, each with the inputs the test wrote to
<dir>/inputs.npz (keys '<case>/<name>'), and writes what each case
returns to <dir>/rank<r>.npz (keys '<case>/<name>'); a case that raises
writes '<case>/error' with the message instead, so one spawn serves all
of a file's cases of one world size.

  python tests/torch_mesh_worker.py <dir> <case> [<case> ...]
"""
import importlib
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import unique_name  # noqa: E402
from paddle_tpu_torch.parallel import DistributedStrategy  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _fresh():
    fluid.framework.switch_main_program(fluid.Program())
    fluid.framework.switch_startup_program(fluid.Program())
    unique_name.switch()


def _startup(startup, scope, params):
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    if params:
        fluid.io.load_numpy_params(scope, params, fluid.CPUPlace())


def _params(inp, prefix):
    return {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}


def _pe(prog, scope, loss=None, **kw):
    from paddle_tpu_torch.parallel import distributed as D
    D.init_parallel_env()
    return fluid.ParallelExecutor(use_cuda=False, main_program=prog,
                                  scope=scope,
                                  loss_name=loss.name if loss else None,
                                  **kw)


# -- the JAX package's test programs, built with the port ----------------------

def mlp_program(F=fluid, seed=5):
    """tests/test_parallel_executor.py::_build (F: either package)."""
    prog, startup = F.Program(), F.Program()
    startup.random_seed = seed
    with F.program_guard(prog, startup):
        x = F.layers.data(name='x', shape=[8], dtype='float32')
        y = F.layers.data(name='y', shape=[1], dtype='float32')
        h = F.layers.fc(input=x, size=16, act='relu')
        pred = F.layers.fc(input=h, size=1)
        loss = F.layers.mean(F.layers.square_error_cost(pred, y))
        F.optimizer.SGD(0.05).minimize(loss)
    return prog, startup, loss


def adam_mlp_program(F=fluid, z3_names=False, in_dim=16):
    """tests/test_parallel_axes.py's ZeRO-1 / ZeRO-3 programs."""
    prog, startup = F.Program(), F.Program()
    prog.random_seed = startup.random_seed = 9
    with F.program_guard(prog, startup):
        x = F.layers.data(name='x', shape=[in_dim], dtype='float32')
        y = F.layers.data(name='y', shape=[1], dtype='float32')
        kw1 = dict(param_attr=F.ParamAttr(name='z3w')) if z3_names \
            else {}
        kw2 = dict(param_attr=F.ParamAttr(name='z3w2')) if z3_names \
            else {}
        h = F.layers.fc(input=x, size=32, act='relu', **kw1)
        pred = F.layers.fc(input=h, size=1, **kw2)
        loss = F.layers.mean(F.layers.square_error_cost(pred, y))
        F.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return prog, startup, loss


def bn_program(F=fluid, nhwc=False, seed=7):
    """tests/test_bn_local_stats.py::_build."""
    fmt = 'NHWC' if nhwc else 'NCHW'
    prog, startup = F.Program(), F.Program()
    startup.random_seed = seed
    with F.program_guard(prog, startup):
        x = F.layers.data(name='x', shape=[3, 8, 8], dtype='float32')
        y = F.layers.data(name='y', shape=[1], dtype='int64')
        if nhwc:
            x = F.layers.transpose(x, perm=[0, 2, 3, 1])
        c = F.layers.conv2d(x, 8, 3, padding=1, bias_attr=False,
                                data_format=fmt)
        b = F.layers.batch_norm(c, act='relu', data_layout=fmt)
        c2 = F.layers.conv2d(b, 8, 3, padding=1, bias_attr=False,
                                 data_format=fmt)
        b2 = F.layers.batch_norm(c2, act='relu', data_layout=fmt)
        p = F.layers.pool2d(b2, pool_type='avg', global_pooling=True,
                                data_format=fmt)
        pred = F.layers.fc(p, size=10, act='softmax')
        loss = F.layers.mean(F.layers.cross_entropy(pred, y))
        F.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def lm_program(cfg_kw, F=fluid, seed=11):
    """tests/test_parallel_axes.py::_transformer_progs."""
    transformer = importlib.import_module(F.__name__ +
                                          '.models.transformer')
    cfg = transformer.TransformerConfig(**cfg_kw)
    prog, startup = F.Program(), F.Program()
    prog.random_seed = seed
    startup.random_seed = seed
    with F.program_guard(prog, startup):
        tokens = F.layers.data(name='tokens', shape=[cfg.max_len, 1],
                                   dtype='int64')
        labels = F.layers.data(name='labels', shape=[cfg.max_len, 1],
                                   dtype='int64')
        _, avg_cost = transformer.train_network(tokens, labels, cfg)
        F.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return prog, startup, avg_cost


def dist_program(F=fluid, mode="dp"):
    """tests/dist_worker.py::build."""
    prog, startup = F.Program(), F.Program()
    prog.random_seed = startup.random_seed = 11
    with F.program_guard(prog, startup):
        x = F.layers.data(name='x', shape=[8], dtype='float32')
        y = F.layers.data(name='y', shape=[1], dtype='float32')
        if mode == 'tp':
            column_parallel_fc = F.parallel.layers.column_parallel_fc
            row_parallel_fc = F.parallel.layers.row_parallel_fc
            h = column_parallel_fc(x, 16, act='relu')
            pred = row_parallel_fc(h, 1)
        elif mode == 'sp':
            ring_attention = F.parallel.layers.ring_attention
            h = F.layers.fc(input=x, size=16, act='relu')
            q = F.layers.reshape(h, shape=[-1, 1, 8, 2])
            att = ring_attention(q, q, q, causal=True)
            flat = F.layers.reshape(att, shape=[-1, 16])
            pred = F.layers.fc(input=flat, size=1)
        else:
            h = F.layers.fc(input=x, size=16, act='relu')
            pred = F.layers.fc(input=h, size=1)
        loss = F.layers.mean(F.layers.square_error_cost(pred, y))
        F.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return prog, startup, loss


def _losses(pe, loss, feeds):
    return np.array([float(np.asarray(pe.run(fetch_list=[loss.name],
                                             feed=f)[0]).reshape(-1)[0])
                     for f in feeds])


def _feeds(inp, prefix, names, n):
    return [{k: inp['%s%s%d' % (prefix, k, i)] for k in names}
            for i in range(n)]


# -- cases ----------------------------------------------------------------------

@case
def env(inp):
    from paddle_tpu_torch.parallel import distributed as D
    import torch.distributed as dist
    D.init_parallel_env()
    return {'rank': np.array(D.trainer_id()),
            'world': np.array(D.num_trainers()),
            'up': np.array(D.is_initialized()),
            'backend': np.array(dist.get_backend())}


@case
def pe_mlp(inp):
    """test_parallel_executor.py::test_pe_matches_single_device."""
    _fresh()
    prog, startup, loss = mlp_program()
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'pe_mlp/p/'))
    pe = _pe(prog, scope, loss)
    n = int(inp['pe_mlp/n'])
    out = {'device_count': np.array(pe.device_count),
           'losses': _losses(pe, loss, _feeds(inp, 'pe_mlp/', 'xy', n))}
    try:
        pe.run(fetch_list=[loss.name],
               feed={'x': np.zeros((30, 8), 'float32'),
                     'y': np.zeros((30, 1), 'float32')})
        out['uneven'] = np.array('no error')
    except ValueError as e:
        out['uneven'] = np.array(str(e))
    return out


@case
def pe_strategies(inp):
    """test_parallel_executor.py::test_pe_strategies_accepted."""
    _fresh()
    prog, startup, loss = mlp_program()
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'pe_mlp/p/'))
    es = fluid.ExecutionStrategy()
    es.num_iteration_per_drop_scope = 2
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.AllReduce
    pe = _pe(prog, scope, loss, exec_strategy=es, build_strategy=bs)
    return {'losses': _losses(pe, loss, _feeds(inp, 'pe_mlp/', 'xy', 3))}


def _zero(inp, name, strategy=None, build_strategy=None, z3=False,
          in_dim=16):
    _fresh()
    prog, startup, loss = adam_mlp_program(fluid, z3, in_dim)
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, name + '/p/'))
    pe = _pe(prog, scope, loss, strategy=strategy,
             build_strategy=build_strategy)
    out = {'losses': _losses(pe, loss, _feeds(inp, name + '/', 'xy', 4))}
    shapes = {}
    for n in scope.local_var_names():
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            shapes[n] = np.array(tuple(v.shape))
    for n, s in shapes.items():
        out['shape/' + n] = s
    return out


@case
def zero1(inp):
    """test_parallel_axes.py::test_zero1_sharded_optimizer_state."""
    w = int(os.environ['PADDLE_TRAINERS_NUM'])
    return _zero(inp, 'zero1', DistributedStrategy(
        dp=w, sharded_optimizer=True))


@case
def zero1_replicated(inp):
    w = int(os.environ['PADDLE_TRAINERS_NUM'])
    return _zero(inp, 'zero1', DistributedStrategy(dp=w))


@case
def reduce_knob(inp):
    """test_parallel_axes.py::test_reduce_strategy_knob_drives_zero1."""
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return _zero(inp, 'zero1', build_strategy=bs)


@case
def zero3(inp):
    """test_parallel_axes.py::test_zero3_sharded_params."""
    w = int(os.environ['PADDLE_TRAINERS_NUM'])
    return _zero(inp, 'zero3', DistributedStrategy(
        dp=w, sharded_params=True), z3=True, in_dim=10)


def _bn(inp, local, nhwc=False, steps=5, via_strategy=False):
    _fresh()
    fluid.flags.set_flags({'FLAGS_bn_local_stats': bool(local) and
                           not via_strategy})
    try:
        prog, startup, loss = bn_program(fluid, nhwc)
        scope = fluid.Scope()
        _startup(startup, scope, _params(inp, 'bn%s/p/' % (
            '_nhwc' if nhwc else '')))
        bs = None
        if via_strategy:
            bs = fluid.BuildStrategy()
            bs.bn_local_stats = bool(local)
        pe = _pe(prog, scope, loss, build_strategy=bs)
        feed = {'x': inp['bn/x'], 'y': inp['bn/y']}
        losses = _losses(pe, loss, [feed] * steps)
        audit = fluid.profiler.collective_audit(pe.collective_records())
        return {'losses': losses,
                'n_coll': np.array(sum(len(v) for v in audit.values())),
                'flag_after': np.array(bool(fluid.flags.get_flag(
                    'bn_local_stats')))}
    finally:
        fluid.flags.set_flags({'FLAGS_bn_local_stats': False})


@case
def bn_sync(inp):
    return _bn(inp, False)


@case
def bn_local(inp):
    return _bn(inp, True)


@case
def bn_local_nhwc(inp):
    return _bn(inp, True, nhwc=True, steps=3)


@case
def bn_knob(inp):
    """test_bn_local_stats.py::test_build_strategy_knob: the override is
    the executor's; a sibling keeps the synchronised form."""
    local = _bn(inp, True, steps=1, via_strategy=True)
    sync = _bn(inp, False, steps=1, via_strategy=True)
    return {'local_n': local['n_coll'], 'sync_n': sync['n_coll'],
            'flag_after': local['flag_after']}


@case
def colrow(inp):
    """test_parallel_axes.py::test_column_row_parallel_fc_pair_matches_fc
    (dp=2, tp=2)."""
    from paddle_tpu_torch.parallel.layers import (column_parallel_fc,
                                                  row_parallel_fc)
    _fresh()
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 3
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[8, 16], dtype='float32',
                              append_batch_size=False)
        x3 = fluid.layers.reshape(x, shape=[2, 4, 16])
        h = column_parallel_fc(x3, 32, act='relu')
        y = row_parallel_fc(h, 16)
        out = fluid.layers.reduce_sum(y)
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'colrow/p/'))
    pe = _pe(prog, scope, strategy=DistributedStrategy(dp=2, tp=2))
    r, = pe.run(fetch_list=[out.name], feed={'x': inp['colrow/x']})
    shapes = {'shape/' + p.name: np.array(tuple(scope.find_var(
        p.name).shape)) for p in prog.global_block().all_parameters()}
    audit = fluid.profiler.collective_audit(pe.collective_records())
    res = {'out': np.asarray(r)}
    res.update(shapes)
    res.update({'audit/' + k: np.array(v) for k, v in audit.items()})
    return res


LM_SMALL = dict(vocab=64, dim=16, heads=2, layers=2, ffn=32, max_len=8)


@case
def lm_tp_sp(inp):
    """test_parallel_axes.py::test_transformer_tp_sp_matches_serial on a
    tp=2, sp=2 mesh."""
    _fresh()
    prog, startup, loss = lm_program(dict(LM_SMALL, use_tp=True,
                                          use_sp=True))
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'lm/p/'))
    pe = _pe(prog, scope, loss, strategy=DistributedStrategy(tp=2, sp=2))
    feed = {'tokens': inp['lm/tokens'], 'labels': inp['lm/labels']}
    return {'losses': _losses(pe, loss, [feed] * 3)}


@case
def lm_dp_tp(inp):
    _fresh()
    prog, startup, loss = lm_program(dict(LM_SMALL, use_tp=True,
                                          use_sp=True))
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'lm/p/'))
    pe = _pe(prog, scope, loss, strategy=DistributedStrategy(dp=2, tp=2))
    feed = {'tokens': inp['lm/tokens'], 'labels': inp['lm/labels']}
    out = {'losses': _losses(pe, loss, [feed] * 3)}
    for p in prog.global_block().all_parameters():
        out['shape/' + p.name] = np.array(tuple(scope.find_var(
            p.name).shape))
    return out


def moe_program(F=fluid, k=1, dispatch='topk'):
    """test_parallel_axes.py::test_moe_expert_parallel_runs's program
    (8 tokens), with the aux loss in the objective."""
    prog, startup = F.Program(), F.Program()
    prog.random_seed = startup.random_seed = 5
    with F.program_guard(prog, startup):
        x = F.layers.data(name='x', shape=[8, 16], dtype='float32',
                          append_batch_size=False)
        y, aux = F.parallel.layers.moe_layer(
            x, num_experts=4, hidden_size=32, k=k, dispatch=dispatch,
            capacity_factor=1.0, aux_loss=True)
        loss = F.layers.elementwise_add(F.layers.mean(y),
                                        F.layers.scale(aux, 0.01))
        F.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def _moe(inp, tag, k, dispatch='topk'):
    _fresh()
    prog, startup, loss = moe_program(fluid, k, dispatch)
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, tag + '/p/'))
    pe = _pe(prog, scope, loss, strategy=DistributedStrategy(dp=2, ep=2))
    losses = _losses(pe, loss, [{'x': inp['moe/x']}] * 3)
    audit = fluid.profiler.collective_audit(pe.collective_records())
    out = {'losses': losses}
    out.update({'audit/' + kk: np.array(v) for kk, v in audit.items()})
    for p in prog.global_block().all_parameters():
        out['shape/' + p.name] = np.array(tuple(scope.find_var(
            p.name).shape))
    return out


@case
def moe_top1(inp):
    """test_parallel_axes.py::test_moe_expert_parallel_runs on dp=2,
    ep=2, held to the one-device run (top-1)."""
    return _moe(inp, 'moe_top1', 1)


@case
def moe_top2(inp):
    return _moe(inp, 'moe_top2', 2)


@case
def moe_dense(inp):
    return _moe(inp, 'moe_dense', 1, 'dense')


@case
def lm_ring(inp):
    """test_ring_attention.py::
    test_transformer_ring_attention_trains_on_dp_sp_mesh on sp=4."""
    _fresh()
    prog, startup, loss = lm_program(inp_cfg(inp, 'lmr/cfg'))
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'lmr/p/'))
    pe = _pe(prog, scope, loss, strategy=DistributedStrategy(
        **{k: int(v) for k, v in (kv.split('=') for kv in str(
            inp['lmr/mesh']).split(','))}))
    feed = {'tokens': inp['lmr/tokens'], 'labels': inp['lmr/labels']}
    out = {'losses': _losses(pe, loss, [feed] * 3)}
    audit = fluid.profiler.collective_audit(pe.collective_records())
    out.update({'audit/' + kk: np.array(v) for kk, v in audit.items()})
    return out


@case
def lm_grads(inp):
    """One step of the LM of inp['lmg/cfg'] on the mesh inp['lmg/mesh'],
    fetching the loss and every parameter's gradient (whole values)."""
    _fresh()
    prog, startup, loss = lm_program(inp_cfg(inp, 'lmg/cfg'))
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'lmg/p/'))
    pe = _pe(prog, scope, loss, strategy=DistributedStrategy(
        **{k: int(v) for k, v in (kv.split('=') for kv in str(
            inp['lmg/mesh']).split(','))}))
    names = [p.name for p in prog.global_block().all_parameters()]
    vals = pe.run(fetch_list=[loss.name] + [n + '@GRAD' for n in names],
                  feed={'tokens': inp['lmg/tokens'],
                        'labels': inp['lmg/labels']})
    out = {'loss': np.asarray(vals[0])}
    out.update({'grad/' + n: np.asarray(v) for n, v in zip(names,
                                                         vals[1:])})
    return out


def inp_cfg(inp, key):
    cfg = {}
    for kv in str(inp[key]).split(','):
        k, v = kv.split('=')
        cfg[k] = (v == 'True') if v in ('True', 'False') else int(v)
    return cfg


def _multihost(inp, mode, build_strategy=None):
    """tests/dist_worker.py's modes: each trainer feeds its local rows."""
    from paddle_tpu_torch.parallel import distributed as D
    _fresh()
    prog, startup, loss = dist_program(fluid, mode)
    scope = fluid.Scope()
    _startup(startup, scope, _params(inp, 'dist_%s/p/' % mode))
    n = int(os.environ['PADDLE_TRAINERS_NUM'])
    tid = int(os.environ['PADDLE_TRAINER_ID'])
    kw = {}
    if mode == 'tp':
        kw['strategy'] = DistributedStrategy(dp=n // 2, tp=2)
    elif mode == 'sp':
        kw['strategy'] = DistributedStrategy(sp=n)
    if build_strategy is not None:
        kw['build_strategy'] = build_strategy
    pe = _pe(prog, scope, loss, num_trainers=n, trainer_id=tid, **kw)
    losses = []
    for i in range(int(inp['dist/steps'])):
        xv, yv = inp['dist/x%d' % i], inp['dist/y%d' % i]
        if 'dp' in pe.mesh.axis_names:
            xl = D.shard_rows_for_process(xv, pe.mesh, 'dp')
            yl = D.shard_rows_for_process(yv, pe.mesh, 'dp')
        else:
            xl, yl = xv, yv
        l, = pe.run(fetch_list=[loss.name], feed={'x': xl, 'y': yl})
        losses.append(float(np.asarray(l).reshape(-1)[0]))
    return {'losses': np.array(losses)}


@case
def dist_dp(inp):
    return _multihost(inp, 'dp')


@case
def dist_zero1(inp):
    bs = fluid.BuildStrategy()
    bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return _multihost(inp, 'dp', bs)


@case
def dist_sp(inp):
    return _multihost(inp, 'sp')


@case
def dist_tp(inp):
    return _multihost(inp, 'tp')


@case
def ring(inp):
    """test_ring_attention.py / test_ring_flash.py: the ring on sp=world
    against full attention, forward and gradients."""
    from paddle_tpu_torch.parallel import collectives as C
    from paddle_tpu_torch.parallel.mesh import Mesh
    from paddle_tpu_torch.parallel.ring_attention import (
        ring_attention_local, RingCounters)
    from paddle_tpu_torch.parallel import distributed as D
    n = int(os.environ['PADDLE_TRAINERS_NUM'])
    D.init_parallel_env()
    mesh = Mesh(('sp',), (n,))
    ax = C.axis(mesh, 'sp')
    out = {}
    for causal in (True, False):
        for flash in (True, False):
            tag = '%s_%s' % ('causal' if causal else 'full',
                             'flash' if flash else 'fold')
            q, k, v, tgt = (torch.from_numpy(inp['ring/' + s]) for s in
                            ('q', 'k', 'v', 'tgt'))
            ql, kl, vl, tl = (t.chunk(n, 2)[ax.index].contiguous()
                              .requires_grad_(s != 'tgt')
                              for s, t in zip(('q', 'k', 'v', 'tgt'),
                                              (q, k, v, tgt)))
            RingCounters.fwd_blocks = RingCounters.bwd_blocks = 0
            o = ring_attention_local(ql, kl, vl, ax, causal=causal,
                                     flash=flash)
            loss = torch.sum((o - tl) ** 2)
            gq, gk, gv = torch.autograd.grad(loss, (ql, kl, vl))
            for name, t in (('o', o), ('dq', gq), ('dk', gk), ('dv', gv)):
                out['%s/%s' % (tag, name)] = C.gather(
                    t.detach().contiguous(), 2, ax).numpy()
            out['%s/blocks' % tag] = np.array(
                [RingCounters.fwd_blocks, RingCounters.bwd_blocks])
    return out


def spawn(tmp_dir, world, cases, inputs, timeout=240):
    """Run `cases` on `world` CPU ranks (fresh interpreters, a FileStore
    rendezvous in tmp_dir) and return each rank's results as a dict."""
    import subprocess
    d = str(tmp_dir)
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, 'inputs.npz'), **inputs)
    store = os.path.join(d, 'store')
    if os.path.exists(store):
        os.remove(store)
    procs = []
    for r in range(world):
        env = dict(os.environ)
        for k in ('JAX_PLATFORMS', 'XLA_FLAGS'):
            env.pop(k, None)
        env.update({'PADDLE_TRAINER_ID': str(r),
                    'PADDLE_TRAINERS_NUM': str(world),
                    'PADDLE_DIST_INIT_METHOD': 'file://' + store,
                    'PADDLE_DIST_TIMEOUT': str(timeout),
                    'OMP_NUM_THREADS': '1'})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), d] + list(cases),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout + 60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError('rank %d exited %d:\n%s'
                               % (r, p.returncode, out[-4000:]))
    return [dict(np.load(os.path.join(d, 'rank%d.npz' % r)))
            for r in range(world)]


def results(res, case_name):
    """One case's results of every rank; raises with a rank's error."""
    out = []
    for r in res:
        err = r.get(case_name + '/error')
        if err is not None:
            raise AssertionError('%s failed on a rank:\n%s'
                                 % (case_name, str(err)))
        pre = case_name + '/'
        out.append({k[len(pre):]: v for k, v in r.items()
                    if k.startswith(pre)})
    return out


def main():
    torch.set_num_threads(1)
    d = sys.argv[1]
    inp = dict(np.load(os.path.join(d, 'inputs.npz'), allow_pickle=False))
    out = {}
    for name in sys.argv[2:]:
        try:
            res = CASES[name](inp)
            for k, v in res.items():
                out['%s/%s' % (name, k)] = np.asarray(v)
        except Exception as e:
            out['%s/error' % name] = np.array(
                '%s: %s\n%s' % (type(e).__name__, e,
                                traceback.format_exc()[-3000:]))
    rank = int(os.environ.get('PADDLE_TRAINER_ID', 0))
    np.savez(os.path.join(d, 'rank%d.npz' % rank), **out)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
