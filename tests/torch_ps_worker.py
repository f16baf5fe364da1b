"""Subprocess worker for the port's parameter-server tests (sync + async
modes): the port's copy of tests/ps_worker.py, on paddle_tpu_torch.

Spawned by test_torch_dist_pserver.py and test_torch_supervisor.py with
its role in PS_* env vars (PS_ROLE pserver|trainer, PS_MODEL, PS_ENDPOINTS,
PS_TRAINERS, PS_STEPS, PS_SYNC, PS_OPTIMIZER, PS_TRAINER_ID,
PS_PSERVER_ID, PS_CHECKPOINT, PS_RESTORE, PS_DIE_AFTER, PS_DIE_TID); the
model builders, batches and `local_train` are ps_worker.py's, so a port
trainer and a JAX pserver (or the reverse) transpile the same program.
It imports neither jax nor paddle_tpu: everything runs on the CPU.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                      # noqa: E402
import paddle_tpu_torch as fluid        # noqa: E402

BATCH_PER_TRAINER = 16
VOCAB = 512
EMB_DIM = 16


def build_mlp():
    """Dense MLP: the fc weight (64x256 = 16384 elems) splits across two
    pservers; biases stay whole."""
    x = fluid.layers.data(name='x', shape=[64], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    h = fluid.layers.fc(input=x, size=256, act='relu',
                        param_attr=fluid.ParamAttr(
                            name='w1',
                            initializer=fluid.initializer.Normal(
                                scale=0.1, seed=7)),
                        bias_attr=fluid.ParamAttr(
                            name='b1',
                            initializer=fluid.initializer.Constant(0.1)))
    pred = fluid.layers.fc(input=h, size=1,
                           param_attr=fluid.ParamAttr(
                               name='w2',
                               initializer=fluid.initializer.Normal(
                                   scale=0.1, seed=11)))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    return loss, ['x', 'y'], ['w1', 'b1', 'w2']


def build_sparse(distributed_table=False):
    """Sparse embedding (SelectedRows grads). VOCAB*EMB_DIM=8192 elems:
    the table splits row-wise across pservers in plain sparse mode, or is
    mod-sharded + prefetched when distributed_table=True."""
    ids = fluid.layers.data(name='ids', shape=[4], dtype='int64')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    emb = fluid.layers.embedding(
        ids, size=[VOCAB, EMB_DIM], is_sparse=True,
        is_distributed=distributed_table,
        param_attr=fluid.ParamAttr(
            name='emb_w',
            initializer=fluid.initializer.Normal(scale=0.1, seed=5)))
    pooled = fluid.layers.reduce_mean(emb, dim=1)
    pred = fluid.layers.fc(input=pooled, size=1,
                           param_attr=fluid.ParamAttr(
                               name='fc_w',
                               initializer=fluid.initializer.Normal(
                                   scale=0.1, seed=13)))
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    params = ['fc_w'] if distributed_table else ['emb_w', 'fc_w']
    return loss, ['ids', 'y'], params


def build_deepfm():
    """DeepFM-style CTR model: sparse first-order weights + sparse field
    embeddings, FM second-order interaction, deep MLP tower, logistic
    loss."""
    fields = 8
    ids = fluid.layers.data(name='ids', shape=[fields], dtype='int64')
    label = fluid.layers.data(name='label', shape=[1], dtype='float32')
    first = fluid.layers.embedding(
        ids, size=[VOCAB, 1], is_sparse=True,
        param_attr=fluid.ParamAttr(
            name='fm_w1',
            initializer=fluid.initializer.Normal(scale=0.01, seed=3)))
    emb = fluid.layers.embedding(
        ids, size=[VOCAB, EMB_DIM], is_sparse=True,
        param_attr=fluid.ParamAttr(
            name='fm_emb',
            initializer=fluid.initializer.Normal(scale=0.01, seed=9)))
    # FM second order: 0.5 * sum((sum_f v_f)^2 - sum_f v_f^2)
    summed = fluid.layers.reduce_sum(emb, dim=1)               # [B, D]
    sum_sq = fluid.layers.square(summed)
    sq_sum = fluid.layers.reduce_sum(fluid.layers.square(emb), dim=1)
    second = fluid.layers.scale(
        fluid.layers.reduce_sum(
            fluid.layers.elementwise_sub(sum_sq, sq_sum),
            dim=1, keep_dim=True), scale=0.5)                  # [B, 1]
    fo = fluid.layers.reduce_sum(first, dim=1)                 # [B, 1]
    deep_in = fluid.layers.reshape(emb, shape=[-1, 8 * EMB_DIM])
    deep = fluid.layers.fc(input=deep_in, size=32, act='relu',
                           param_attr=fluid.ParamAttr(
                               name='deep_w1',
                               initializer=fluid.initializer.Normal(
                                   scale=0.1, seed=21)))
    deep_out = fluid.layers.fc(input=deep, size=1,
                               param_attr=fluid.ParamAttr(
                                   name='deep_w2',
                                   initializer=fluid.initializer.Normal(
                                       scale=0.1, seed=23)))
    logit = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(fo, second), deep_out)
    loss = fluid.layers.mean(
        fluid.layers.sigmoid_cross_entropy_with_logits(logit, label))
    return loss, ['ids', 'label'], ['fm_w1', 'fm_emb', 'deep_w1', 'deep_w2']


MODELS = {'mlp': build_mlp, 'sparse': build_sparse,
          'table': lambda: build_sparse(distributed_table=True),
          'deepfm': build_deepfm}


def make_batch(model, rng, batch):
    if model == 'mlp':
        x = rng.randn(batch, 64).astype('float32')
        w = np.linspace(-1, 1, 64).astype('float32')[:, None]
        return {'x': x, 'y': (x @ w + 0.1).astype('float32')}
    if model in ('sparse', 'table'):
        ids = rng.randint(0, VOCAB, size=(batch, 4)).astype('int64')
        return {'ids': ids,
                'y': rng.rand(batch, 1).astype('float32')}
    ids = rng.randint(0, VOCAB, size=(batch, 8)).astype('int64')
    return {'ids': ids,
            'label': (rng.rand(batch, 1) > 0.5).astype('float32')}


def make_optimizer(name):
    if name == 'adam':
        return fluid.optimizer.Adam(0.01)
    return fluid.optimizer.SGD(0.01)


def local_train(model, steps, optimizer='sgd', trainers=2):
    """The non-distributed baseline over the same GLOBAL batches."""
    loss, feeds, params = MODELS[model]()
    make_optimizer(optimizer).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        batch = make_batch(model, rng, BATCH_PER_TRAINER * trainers)
        l, = exe.run(feed=batch, fetch_list=[loss])
        losses.append(float(l))
    weights = {p: fluid.fetch_var(p).tolist() for p in params}
    return losses, weights


def main():
    role = os.environ['PS_ROLE']
    model = os.environ['PS_MODEL']
    eps = os.environ['PS_ENDPOINTS']
    trainers = int(os.environ['PS_TRAINERS'])
    steps = int(os.environ['PS_STEPS'])
    sync = os.environ.get('PS_SYNC', '1') == '1'
    optimizer = os.environ.get('PS_OPTIMIZER', 'sgd')
    trainer_id = int(os.environ.get('PS_TRAINER_ID', 0))

    loss, feeds, params = MODELS[model]()
    make_optimizer(optimizer).minimize(loss)

    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id, pservers=eps, trainers=trainers,
                sync_mode=sync)
    exe = fluid.Executor(fluid.CPUPlace())

    if role == 'pserver':
        ep = eps.split(',')[int(os.environ['PS_PSERVER_ID'])]
        main_prog, startup = t.get_pserver_programs(
            ep, checkpoint_dir=os.environ.get('PS_RESTORE') or None)
        exe.run(startup)
        exe.run(main_prog)       # blocks until all trainers COMPLETE
        return

    # elastic recovery: a RESTARTED trainer (incarnation > 0, set by the
    # supervisor) re-registers BEFORE the startup recv and resumes at
    # min(expected) across shards, or max(round) where a shard had
    # retired it (see ps_worker.py)
    incarnation = int(fluid.get_flag('trainer_incarnation', 0) or 0)
    resume_step = 0
    if incarnation > 0:
        from paddle_tpu_torch.distributed.rpc import get_client
        clients = [get_client(ep, trainer_id) for ep in eps.split(',')]
        infos = [c.register() for c in clients]
        if any(i.get('rejoined') for i in infos):
            resume_step = max(int(i['round']) for i in infos)
        else:
            resume_step = min(int(i['expected']) for i in infos)
        for c in clients:
            c.set_round(resume_step)
        print('REJOIN inc=%d resume_step=%d infos=%s'
              % (incarnation, resume_step, infos), flush=True)

    exe.run(t.get_trainer_startup_program())
    initial = {p: fluid.fetch_var(p).tolist() for p in params
               if fluid.global_scope().find_var(p) is not None}
    prog = t.get_trainer_program()
    rng = np.random.RandomState(0)
    losses = []
    # PS_DIE_AFTER=k: this trainer dies SILENTLY (no COMPLETE, no
    # socket shutdown handshake) after k steps
    die_after = int(os.environ.get('PS_DIE_AFTER', 0))
    for step in range(steps):
        if die_after and trainer_id == int(
                os.environ.get('PS_DIE_TID', 1)) and step == die_after:
            os._exit(137)
        gbatch = make_batch(model, rng, BATCH_PER_TRAINER * trainers)
        lo = trainer_id * BATCH_PER_TRAINER
        batch = {k: v[lo:lo + BATCH_PER_TRAINER] for k, v in gbatch.items()}
        if step < resume_step:
            continue   # replayed history: batch drawn (RNG parity) only
        l, = exe.run(prog, feed=batch, fetch_list=[loss])
        losses.append(float(l))
    ckpt = os.environ.get('PS_CHECKPOINT')
    if ckpt and trainer_id == 0:
        exe.run(t.checkpoint_notify_program(ckpt))
    weights = {p: fluid.fetch_var(p).tolist() for p in params
               if fluid.global_scope().find_var(p) is not None}
    print('RESULT ' + json.dumps({'losses': losses, 'weights': weights,
                                  'initial': initial}))
    exe.close()


if __name__ == '__main__':
    main()
