"""CSP channels in the port (paddle_tpu_torch/channels.py, concurrency.py)
against the JAX package's (tests/test_channels.py's eleven tests, each
run on both packages): buffered order, unbuffered rendezvous, close
drains then raises, range iteration, Select's one committed case and its
default, close on a full buffer, a timed-out recv leaving no ticket,
every blocked sender woken by close, Select's send under rendezvous, and
a producer thread feeding Executor.run (the port's losses within 1e-5 of
the JAX package's from the same weights); then concurrency's Go, go and
channel_* helpers. Every blocking call here has a timeout, so no test
can hang.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import channels as jchannels
from paddle_tpu import concurrency as jconcurrency
from paddle_tpu import unique_name as junique_name
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import channels as tchannels
from paddle_tpu_torch import concurrency as tconcurrency
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name

T = 5.0     # seconds: the bound of every blocking call
PACKAGES = [pytest.param((jfluid, jchannels, jconcurrency), id='jax'),
            pytest.param((tfluid, tchannels, tconcurrency), id='port')]


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


@pytest.mark.parametrize('pkg', PACKAGES)
def test_buffered_send_recv_order(pkg):
    fluid, _, _ = pkg
    ch = fluid.make_channel(capacity=4)
    for i in range(4):
        ch.send(i, timeout=T)
    assert [ch.recv(timeout=T) for _ in range(4)] == [0, 1, 2, 3]


@pytest.mark.parametrize('pkg', PACKAGES)
def test_unbuffered_rendezvous(pkg):
    _, channels, _ = pkg
    ch = channels.Channel(capacity=0)
    got = []

    def sender():
        ch.send('x', timeout=T)
        got.append('sent')
    t = threading.Thread(target=sender)
    t.start()
    time.sleep(0.1)
    assert not got            # send blocks until a receiver arrives
    assert ch.recv(timeout=T) == 'x'
    t.join(timeout=T)
    assert not t.is_alive() and got == ['sent']


@pytest.mark.parametrize('pkg', PACKAGES)
def test_close_drains_then_raises(pkg):
    _, channels, _ = pkg
    ch = channels.Channel(capacity=3)
    ch.send(1, timeout=T)
    ch.send(2, timeout=T)
    ch.close()
    assert ch.recv(timeout=T) == 1 and ch.recv(timeout=T) == 2
    with pytest.raises(channels.ChannelClosed):
        ch.recv(timeout=T)
    with pytest.raises(channels.ChannelClosed):
        ch.send(3, timeout=T)
    assert ch.closed


@pytest.mark.parametrize('pkg', PACKAGES)
def test_range_iteration(pkg):
    _, channels, _ = pkg
    ch = channels.Channel(capacity=8)
    for i in range(5):
        ch.send(i, timeout=T)
    ch.close()
    assert list(ch) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize('pkg', PACKAGES)
def test_select_commits_to_one_ready_case(pkg):
    _, channels, _ = pkg
    a, b = channels.Channel(capacity=1), channels.Channel(capacity=1)
    b.send('from_b', timeout=T)
    fired = []
    with channels.Select() as sel:
        sel.case_recv(a, lambda v: fired.append(('a', v)))
        sel.case_recv(b, lambda v: fired.append(('b', v)))
    assert fired == [('b', 'from_b')]
    ok, _ = a.poll()
    assert not ok


@pytest.mark.parametrize('pkg', PACKAGES)
def test_select_default(pkg):
    _, channels, _ = pkg
    a = channels.Channel(capacity=1)
    fired = []
    with channels.Select() as sel:
        sel.case_recv(a, lambda v: fired.append(v))
        sel.default(lambda: fired.append('none'))
    assert fired == ['none']


@pytest.mark.parametrize('pkg', PACKAGES)
def test_close_on_full_buffer_does_not_block(pkg):
    fluid, channels, _ = pkg
    ch = fluid.make_channel(capacity=1)
    ch.send(1, timeout=T)
    t = threading.Thread(target=ch.close)
    t.start()
    t.join(timeout=2)
    assert not t.is_alive()          # close() never blocks
    assert ch.recv(timeout=T) == 1   # the buffered value still drains
    with pytest.raises(channels.ChannelClosed):
        ch.recv(timeout=T)


@pytest.mark.parametrize('pkg', PACKAGES)
def test_timed_out_recv_leaves_no_stale_ticket(pkg):
    _, channels, _ = pkg
    ch = channels.Channel(capacity=0)
    with pytest.raises(TimeoutError):
        ch.recv(timeout=0.1)
    # a later send still blocks (no phantom receiver)
    with pytest.raises(TimeoutError):
        ch.send('x', timeout=0.2)


@pytest.mark.parametrize('pkg', PACKAGES)
def test_all_blocked_senders_wake_on_close(pkg):
    _, channels, _ = pkg
    ch = channels.Channel(capacity=0)
    errs = []

    def sender():
        try:
            ch.send('v', timeout=T)
        except channels.ChannelClosed:
            errs.append('closed')
    threads = [threading.Thread(target=sender) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    ch.close()
    for t in threads:
        t.join(timeout=2)
    assert not any(t.is_alive() for t in threads)
    assert errs == ['closed'] * 3


@pytest.mark.parametrize('pkg', PACKAGES)
def test_select_send_respects_rendezvous(pkg):
    _, channels, _ = pkg
    ch = channels.Channel(capacity=0)
    fired = []
    with channels.Select() as sel:
        sel.case_send(ch, 'v', lambda: fired.append('sent'))
        sel.default(lambda: fired.append('none'))
    assert fired == ['none']         # no receiver -> default, not send


def _pipeline_losses(fluid, un, init=None):
    prog, startup = fluid.Program(), fluid.Program()
    with un.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[4], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    ch = fluid.make_channel(capacity=2)
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1).astype('float32')

    def producer():
        for _ in range(12):
            xb = rng.randn(8, 4).astype('float32')
            ch.send((xb, xb @ w), timeout=T)
        ch.close()
    with fluid.scope_guard(scope):
        exe.run(startup)
        names = [v.name for v in startup.list_vars() if v.persistable]
        if init is None:
            init = {n: np.asarray(scope.find_var(n)) for n in names}
        else:
            fluid.io.load_numpy_params(scope, init, fluid.CPUPlace())
        t = threading.Thread(target=producer)
        t.start()
        losses = []
        while True:
            try:
                xb, yb = ch.recv(timeout=T)
            except Exception as e:      # ChannelClosed ends the pass
                if type(e).__name__ != 'ChannelClosed':
                    raise
                break
            losses.append(float(np.asarray(exe.run(
                prog, feed={'x': xb, 'y': yb}, fetch_list=[loss])[0])))
        t.join(timeout=T)
        assert not t.is_alive()
    return losses, init


def test_channel_pipeline_around_executor():
    """A producer thread feeds batches through a channel to the consumer
    driving Executor.run, in both packages from the same weights."""
    jlosses, init = _pipeline_losses(jfluid, junique_name)
    tlosses, _ = _pipeline_losses(tfluid, tunique_name, init)
    assert len(tlosses) == 12 and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('pkg', PACKAGES)
def test_go_and_the_channel_helpers(pkg):
    fluid, channels, concurrency = pkg
    ch = concurrency.make_channel(capacity=0)
    out = fluid.make_channel(capacity=4)

    def worker(n):
        for i in range(n):
            concurrency.channel_send(ch, i, timeout=T)
        concurrency.channel_close(ch)

    with fluid.Go() as g:
        g.go(worker, 3)
    got = []
    while True:
        v, ok = concurrency.channel_recv(ch, return_value=-1, timeout=T)
        if not ok:
            assert v == -1
            break
        got.append(v)
    assert got == [0, 1, 2]
    assert concurrency.channel_send(ch, 9, timeout=T) is False
    t = concurrency.go(out.send, 'done', timeout=T)
    t.join(timeout=T)
    assert not t.is_alive() and out.recv(timeout=T) == 'done'
    with pytest.raises(RuntimeError, match='g.go'):
        with fluid.Go():
            pass
