"""Helpers for the port's fleet, online and disaggregation tests, and a
subprocess worker for the port's online-refresh cluster.

The model is the JAX package's tiny LM (tests/fleet_worker.py's CFG:
vocab 64, dim 32, 2 heads, 2 layers, max_len 16), built and saved by the
JAX package; the port's replicas load that directory on the CPU. A port
replica is the entry point users run,
`python -m paddle_tpu_torch.tools.serve_replica`, with SERVE_PLACE=cpu.

As a script this file is one role of the port's online cluster
(tests/online_worker.py's, over the port): env ON_ROLE pserver, trainer
or serving; PS_ENDPOINTS, PS_STEPS, ON_DIR, PS_PSERVER_ID as there. The
trainer prints 'RESULT <json>' with its losses and the digests of its
parameters as pulled after the last round; the serving process prints
'RESULT <json>' with its installed digests, version, counters and the
streams it decoded before and after the refresh caught up.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(_TESTS)
sys.path.insert(0, ROOT)

CFG = dict(vocab=64, dim=32, heads=2, layers=2, ffn=64, max_len=16,
           use_tp=False, use_sp=False)
SEED = 11
# the online cluster's LM and workload (tests/online_worker.py's)
ON_CFG = dict(vocab=32, dim=16, heads=2, layers=1, ffn=32, max_len=8,
              use_tp=False, use_sp=False)
ON_BATCH = 4
ON_PROMPT = [3, 1, 4]
ON_GEN = 8


def build_model(model_dir):
    """The JAX package builds and saves the seeded tiny LM
    (tests/fleet_worker.py's build_model)."""
    sys.path.insert(0, _TESTS)
    import fleet_worker
    fleet_worker.build_model(model_dir)


def make_prompts(seed, n, budget):
    """n (prompt, session) pairs inside CFG's max_len
    (tests/fleet_worker.py's make_prompts)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        plen = int(rng.randint(2, 5))
        prompt = [int(t) for t in rng.randint(1, CFG['vocab'], plen)]
        out.append((prompt, i % 4))
    return out


def free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(('127.0.0.1', 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def launch_replicas(model_dir, n, slots=4, extra_env=None, timeout=120.0):
    """n port replica processes on the CPU, on ephemeral ports; waits
    for each READY line. extra_env: {replica index: {env overrides}}.
    Returns (procs, endpoints)."""
    procs, eps = [], []
    try:
        for i in range(n):
            # one thread a replica: the tiny model gains nothing from
            # more, and replicas beside the test process must not
            # oversubscribe the host's cores
            env = dict(os.environ, SERVE_MODEL_DIR=model_dir,
                       SERVE_ENDPOINT='127.0.0.1:0', SERVE_PLACE='cpu',
                       SERVE_SLOTS=str(slots), SERVE_WORKERS='1',
                       OMP_NUM_THREADS='1')
            env.update((extra_env or {}).get(i, {}))
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'paddle_tpu_torch.tools.serve_replica'],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            line = ''
            while not line.startswith('READY '):
                if time.monotonic() > deadline:
                    raise RuntimeError('a replica was not ready in %ss'
                                       % timeout)
                line = p.stdout.readline()
                if not line and p.poll() is not None:
                    raise RuntimeError('a replica exited %s before READY'
                                       % p.returncode)
            eps.append('127.0.0.1:%d' % int(line.split()[1]))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return procs, eps


def complete_replica(endpoint, timeout=30.0):
    """COMPLETE one replica (a clean exit 0); False if it is gone."""
    from paddle_tpu_torch.distributed import wire
    host, port = endpoint.rsplit(':', 1)
    try:
        with socket.create_connection((host, int(port)), timeout=5.0) as s:
            s.settimeout(timeout)
            wire.write_msg(s, wire.COMPLETE, {'seq': 0})
            wire.read_msg(s)
        return True
    except OSError:
        return False


def cleanup_replicas(procs, eps):
    """COMPLETE every replica; returns the 'LAUNCHES' json each clean
    one printed (None for a replica that died)."""
    for ep in eps:
        complete_replica(ep)
    out = []
    for p in procs:
        try:
            rest, _ = p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            rest, _ = p.communicate()
        lines = [ln for ln in (rest or '').splitlines()
                 if ln.startswith('LAUNCHES ')]
        out.append(json.loads(lines[-1][len('LAUNCHES '):])
                   if lines else None)
    return out


def warm_replica(endpoint, prompt, budget, timeout=120.0):
    """A throwaway stream over a direct connection, watched through
    SRV_HEALTH (never SRV_POLL, so a fault rule counting SRV_POLLs keeps
    its count) until the replica is idle."""
    from paddle_tpu_torch.distributed import wire
    host, port = endpoint.rsplit(':', 1)
    with socket.create_connection((host, int(port)), timeout=10.0) as s:
        s.settimeout(timeout)
        wire.write_msg(s, wire.SRV_SUBMIT,
                       {'seq': 0, 'rid': 'warm', 'mnt': int(budget)},
                       np.asarray(prompt, np.int64))
        wire.read_msg(s)
        deadline = time.monotonic() + timeout
        seq = 1
        while True:
            wire.write_msg(s, wire.SRV_HEALTH, {'seq': seq})
            _, meta, _ = wire.read_msg(s)
            if not meta.get('active') and not meta.get('queue_depth'):
                return
            if time.monotonic() > deadline:
                raise RuntimeError('warm-up of %s timed out' % endpoint)
            seq += 1
            time.sleep(0.05)


# -- the online cluster's roles ------------------------------------------------

def _digest(value):
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.integrity import crc32
    return crc32(wire._payload_of(value)[1])


def _wait_for(path, timeout=300):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise RuntimeError('timed out waiting for %s' % path)
        time.sleep(0.05)


def _on_logits(fluid, batch):
    from paddle_tpu_torch.models.transformer import (TransformerConfig,
                                                     language_model_logits)
    toks = fluid.layers.data(name='tokens', shape=[batch, ON_CFG['max_len'],
                                                   1],
                             dtype='int64', append_batch_size=False)
    return language_model_logits(toks, TransformerConfig(**ON_CFG))


def _on_train_program(fluid):
    logits = _on_logits(fluid, ON_BATCH)
    # labels after the trunk: the serving graph stops at the logits, so
    # every unique_name the two processes share is already spent
    labels = fluid.layers.data(name='labels',
                               shape=[ON_BATCH, ON_CFG['max_len'], 1],
                               dtype='int64', append_batch_size=False)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, labels))
    params = [p.name for p in fluid.default_main_program().global_block()
              .all_parameters()]
    fluid.optimizer.SGD(0.1).minimize(loss)
    return loss, params


def run_trainer(eps, steps, workdir):
    import paddle_tpu_torch as fluid
    loss, params = _on_train_program(fluid)
    t = fluid.DistributeTranspiler()
    t.transpile(0, pservers=eps, trainers=1, sync_mode=True)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(t.get_trainer_startup_program())
    prog = t.get_trainer_program()
    rng = np.random.RandomState(0)
    shape = (ON_BATCH, ON_CFG['max_len'], 1)
    losses = []
    for _ in range(steps):
        feed = {'tokens': rng.randint(0, ON_CFG['vocab'], shape, 'int64'),
                'labels': rng.randint(0, ON_CFG['vocab'], shape, 'int64')}
        loss_v, = exe.run(prog, feed=feed, fetch_list=[loss])
        losses.append(float(loss_v))
    scope = fluid.global_scope()
    digests = {p: _digest(scope.find_var(p)) for p in params
               if scope.find_var(p) is not None}
    with open(os.path.join(workdir, 'TRAINER_DONE'), 'w') as f:
        f.write('done')
    print('RESULT ' + json.dumps({'losses': losses, 'digests': digests}),
          flush=True)
    # COMPLETE only once serving has pulled the last version
    _wait_for(os.path.join(workdir, 'SERVING_DONE'))
    exe.close()


def run_pserver(eps, pserver_id):
    import paddle_tpu_torch as fluid
    _on_train_program(fluid)
    t = fluid.DistributeTranspiler()
    t.transpile(0, pservers=eps, trainers=1, sync_mode=True)
    main_prog, startup = t.get_pserver_programs(eps.split(',')[pserver_id])
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    exe.run(main_prog)       # until the trainer COMPLETEs


def run_serving(eps, steps, workdir):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.serving import LMServer
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 11
    with fluid.program_guard(prog, startup):
        logits = _on_logits(fluid, 1)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    model_dir = os.path.join(workdir, 'saved_model')
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ['tokens'], [logits], exe,
                                      main_program=prog)
    pred = fluid.inference.AnalysisPredictor(
        fluid.inference.AnalysisConfig(model_dir, place=fluid.CPUPlace()))
    dec = pred.prepare_decoding(slots=2, prefill_batch=1)
    srv = LMServer(dec)
    try:
        before = srv.generate(ON_PROMPT, max_new_tokens=ON_GEN)
        sub = srv.enable_refresh(eps.split(','))
        # the poll loop's own machinery must converge: no restart, no
        # manual pull
        deadline = time.monotonic() + 240
        while sub.installed_version < steps:
            if time.monotonic() > deadline:
                raise RuntimeError('refresh never reached version %d: %r'
                                   % (steps, sub.stats()))
            time.sleep(0.05)
        after = srv.generate(ON_PROMPT, max_new_tokens=ON_GEN)
        stats = srv.stats()
        print('RESULT ' + json.dumps({
            'digests': srv.param_digests(),
            'installed_version': sub.installed_version,
            'refreshes': stats['refreshes'],
            'refresh_failures': stats['refresh_failures'],
            'weight_swaps': stats['weight_swaps'],
            'tokens_before': [int(x) for x in before],
            'tokens_after': [int(x) for x in after]}), flush=True)
        with open(os.path.join(workdir, 'SERVING_DONE'), 'w') as f:
            f.write('done')
    finally:
        srv.close()


def main():
    role = os.environ['ON_ROLE']
    eps = os.environ['PS_ENDPOINTS']
    steps = int(os.environ['PS_STEPS'])
    workdir = os.environ['ON_DIR']
    if role == 'pserver':
        run_pserver(eps, int(os.environ['PS_PSERVER_ID']))
    elif role == 'trainer':
        run_trainer(eps, steps, workdir)
    else:
        run_serving(eps, steps, workdir)


if __name__ == '__main__':
    main()
