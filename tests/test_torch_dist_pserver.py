"""End-to-end parameter-server training on paddle_tpu_torch: real
processes, real sockets, on the CPU (tests/test_dist_pserver.py's claim
on the port, with tests/torch_ps_worker.py for its roles).

Parity claim: 2 trainers x 2 pservers in sync mode train to the weights
of a local single-process run over the same global batches (gradients
of per-trainer mean losses average to the full-batch gradient, and the
pserver applies the same optimizer op on sliced parameter blocks):
within 1e-5 for the mlp, the sparse embedding, the distributed lookup
table and DeepFM under Adam. Async mode trains. And one mixed cluster:
the JAX package's pservers (run by tests/ps_worker.py, unchanged) with
the port's trainers land within 1e-5 of the JAX package's local run,
the trainers having pulled the JAX package's initial values.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH_WORKER = os.path.join(_HERE, 'torch_ps_worker.py')
_JAX_WORKER = os.path.join(_HERE, 'ps_worker.py')
sys.path.insert(0, _HERE)


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


def run_cluster(model, steps=4, optimizer='sgd', trainers=2, pservers=2,
                sync=True, extra_env=None, pserver_worker=_TORCH_WORKER):
    """Start the pservers and trainers as subprocesses, wait for all, and
    return each trainer's RESULT (losses, final and initial weights)."""
    eps = ','.join('127.0.0.1:%d' % p for p in _free_ports(pservers))
    base_env = dict(os.environ)
    base_env.pop('XLA_FLAGS', None)
    base_env.update({'PS_MODEL': model, 'PS_ENDPOINTS': eps,
                     'PS_TRAINERS': str(trainers), 'PS_STEPS': str(steps),
                     'PS_SYNC': '1' if sync else '0',
                     'PS_OPTIMIZER': optimizer})
    base_env.update(extra_env or {})
    procs = []
    try:
        for i in range(pservers):
            env = dict(base_env, PS_ROLE='pserver', PS_PSERVER_ID=str(i))
            procs.append(subprocess.Popen(
                [sys.executable, pserver_worker], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for i in range(trainers):
            env = dict(base_env, PS_ROLE='trainer', PS_TRAINER_ID=str(i))
            procs.append(subprocess.Popen(
                [sys.executable, _TORCH_WORKER], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=240)[0]
                for p in procs[pservers:] + procs[:pservers]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs[pservers:] + procs[:pservers], outs):
        assert p.returncode == 0, out[-4000:]
    results = []
    for out in outs[:trainers]:
        line = [ln for ln in out.splitlines() if ln.startswith('RESULT ')]
        assert line, out[-4000:]
        results.append(json.loads(line[-1][len('RESULT '):]))
    return results


def _port_local(model, steps=4, optimizer='sgd'):
    """The port's local run, in a subprocess-free fresh program state."""
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch import framework, unique_name
    import torch_ps_worker
    main, startup = framework.Program(), framework.Program()
    with unique_name.guard(), framework.program_guard(main, startup), \
            tfluid.scope_guard(tfluid.Scope()):
        return torch_ps_worker.local_train(model, steps, optimizer)


def _assert_close(results, local_w, atol):
    for p, lw in local_w.items():
        np.testing.assert_allclose(
            np.asarray(results[0]['weights'][p]), np.asarray(lw),
            rtol=0, atol=atol, err_msg='param %s diverged' % p)
        # both trainers pulled identical params
        assert np.array_equal(np.asarray(results[0]['weights'][p]),
                              np.asarray(results[1]['weights'][p])), p


@pytest.mark.timeout(300)
@pytest.mark.parametrize('model,optimizer', [('mlp', 'sgd'),
                                             ('sparse', 'sgd'),
                                             ('table', 'sgd'),
                                             ('deepfm', 'adam')])
def test_sync_cluster_matches_the_local_run(model, optimizer):
    """mlp (a split fc weight), sparse (SelectedRows over the wire, a
    split embedding), table (is_distributed: mod-sharded, prefetched
    forward, SelectedRows shards backward; the trainer never holds it)
    and DeepFM under Adam: within 1e-5 of the port's local run."""
    _, local_w = _port_local(model, optimizer=optimizer)
    results = run_cluster(model, optimizer=optimizer)
    _assert_close(results, local_w, 1e-5)
    losses = results[0]['losses']
    assert len(losses) == 4 and all(np.isfinite(losses))


@pytest.mark.timeout(300)
def test_async_mode_trains():
    """Async SGD: no barriers, updates applied on arrival. No exact
    parity exists by design -- assert it trains."""
    results = run_cluster('mlp', steps=8, sync=False)
    losses = results[0]['losses']
    assert losses[-1] < losses[0]


@pytest.mark.timeout(300)
def test_port_trainers_against_jax_pservers_match_the_jax_local_run():
    """The JAX package's pservers (tests/ps_worker.py) and the port's
    trainers: the trainers start from the JAX package's initial values
    (the startup pull) and end within 1e-5 of the JAX package's local
    run over the same global batches."""
    import ps_worker
    results = run_cluster('mlp', pserver_worker=_JAX_WORKER)
    local_losses, local_w = ps_worker.local_train('mlp', 4, 'sgd', 2)
    _assert_close(results, local_w, 1e-5)
    # the pulled initial weights are the JAX package's draws
    import paddle_tpu as jfluid
    from paddle_tpu import framework as jframework, unique_name
    main, startup = jframework.Program(), jframework.Program()
    with unique_name.guard(), jframework.program_guard(main, startup):
        loss, _, params = ps_worker.build_mlp()
        ps_worker.make_optimizer('sgd').minimize(loss)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        for p in params:
            assert np.array_equal(np.asarray(results[0]['initial'][p],
                                             'float32'),
                                  np.asarray(scope.find_var(p))), p
