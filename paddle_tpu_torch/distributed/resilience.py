"""Resilience layer for the distributed stack (counterpart of
paddle_tpu/distributed/resilience.py): deterministic fault injection,
the retry policy and the failure taxonomy, at the wire layer and at the
Trainer's step boundary.

**Failure taxonomy** -- every RPC failure is either

- `RetryableRPCError` (subclass of ConnectionError): transport-level or
  explicitly transient -- a reconnect + idempotent replay is safe and is
  performed transparently by `PSClient`/`MasterClient`; the Trainer
  re-runs a step that raised one in place (FLAGS_trainer_step_retries);
- `FatalRPCError` (subclass of RuntimeError): the server executed the
  request and rejected it (zombie trainer, optimize failure, bad
  message), retries were escalated, or the Trainer's anomaly guard gave
  up -- replaying cannot help; `Trainer.train` rolls back to the last
  SUCCESS-marked checkpoint (FLAGS_trainer_max_rollbacks).

`REPLY_ERR` wire metas carry a `retryable` bool so the classification
crosses the wire.

**RetryPolicy** -- the exponential-backoff-plus-jitter schedule every
reconnecting client shares (flags: `rpc_max_retries`,
`rpc_retry_backoff`, `rpc_retry_max_backoff`, `rpc_reconnect_secs`).

**FaultPlan** -- a declarative, seeded description of faults to inject
at the wire layer (hooks in `wire.write_msg`/`read_msg`) and at the
Trainer step boundary, enabled per process by `FLAGS_fault_plan` (a JSON
plan, a path to one, ``seed:N``, ``kill:ROLE:N``, ``corrupt:N`` or
``grayfail:ROLE:N``), with the JAX package's schema::

    {"rules": [
       {"when": "send",           # send | recv | step
        "type": "SEND_VAR",       # wire/master msg-type name, or "*"
        "nth": 3,                 # fire on the Nth matching event
        "action": "drop",         # drop | close | delay | error | exit
                                  #   | corrupt | nan | stall
        "secs": 0.2,              # delay / stall only
        "retryable": true,        # error only (default true)
        "code": 137,              # exit only (default 137, = kill -9)
        "bits": 1}]}              # corrupt only: bits to flip (default 1)

Plans parse and print exactly as the JAX package's (`from_spec`,
`to_dict`, `to_json`), and a rule fires at the same message as there:
counting is per process and per (when, type), and the host-side RPC ops
emit their messages in a deterministic order. Actions:

- ``drop``  (send): the message is never sent; the connection is closed
  so the failure surfaces immediately -- replay must re-apply it.
- ``close`` (send): the message IS sent, then the connection closes
  before the reply -- replay of an applied mutation must be deduped.
- ``delay``: sleep `secs`, then proceed normally.
- ``error``: raise `RetryableRPCError` or `FatalRPCError` in place.
- ``exit``: `os._exit(code)` -- the process dies instantly, no cleanup:
  kill -9 at an exact point in the message sequence.
- ``corrupt`` (send only): the frame is sent with `bits` bits flipped
  inside its CRC-covered region; the receiver's CRC check rejects it
  (FrameCorruptError) and the retry resends a clean copy.
- ``nan`` (send or step): on send, the dense float payload is replaced
  with NaNs BEFORE framing (a valid CRC: a numeric fault, not a
  transport fault) so the pserver's finite-gradient guard rejects it;
  on step, the Trainer poisons one float feed value so the
  numeric-anomaly guard sees a non-finite loss.
- ``stall`` (send or recv): hold the connection open for `secs`
  without letting the message proceed -- the gray-failure primitive;
  it writes an audit line to stderr when it fires.

The wire layer cooperates on ``close``/``corrupt``/``nan``: `on_send`
returns a `SendEffect` whose `action` tells `wire.write_msg` what to do
to the frame. The hook fires exactly once per send, so the counters
advance past a fired rule and the retry goes clean. On the recv side,
``drop`` discards the parsed message and reads the next one. ``step``
rules fire in `Trainer.train` just before a step executes (`on_step`
returns ``'nan'`` when a nan step rule fires).
"""
from __future__ import annotations

import json
import os
import random
import threading
import time

__all__ = ['RetryableRPCError', 'FatalRPCError', 'TransientError',
           'StaleIncarnationError', 'RetryPolicy', 'FaultRule',
           'FaultPlan', 'SendEffect', 'install_plan', 'clear_plan',
           'active_plan', 'current_plan', 'fired_faults', 'on_send',
           'on_recv', 'on_send_vars', 'on_recv_vars', 'on_step']


class RetryableRPCError(ConnectionError):
    """Transient RPC failure: reconnect + idempotent replay is safe."""


# alias: injected transient faults and server-side transient rejections
TransientError = RetryableRPCError


class FatalRPCError(RuntimeError):
    """Non-retryable failure: the server rejected the request, retries
    were escalated, or the Trainer's anomaly guard gave up; replay cannot
    help."""


class StaleIncarnationError(FatalRPCError):
    """A message carried an incarnation older than the one the pserver
    has registered for that trainer id: a zombie process from before a
    restart. Non-retryable by definition — the fresh incarnation owns
    the trainer id now, and replaying a stale message can only corrupt
    its rounds."""


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

class RetryPolicy(object):
    """Exponential backoff with jitter, shared by every RPC client.

    `schedule()` yields the sleep-before-attempt time for each attempt:
    0.0 for the first try, then backoff * multiplier^k (capped at
    max_backoff) with up to `jitter` fractional randomization so a
    cluster of replaying trainers doesn't thundering-herd the pserver.
    """

    def __init__(self, max_attempts=5, backoff=0.05, max_backoff=2.0,
                 multiplier=2.0, jitter=0.25, reconnect_secs=3.0,
                 seed=None):
        self.max_attempts = max(1, int(max_attempts))
        self.backoff = float(backoff)
        self.max_backoff = float(max_backoff)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.reconnect_secs = float(reconnect_secs)
        self.seed = seed

    @classmethod
    def from_flags(cls):
        from ..flags import get_flag
        return cls(max_attempts=int(get_flag('rpc_max_retries', 5)),
                   backoff=float(get_flag('rpc_retry_backoff', 0.05)),
                   max_backoff=float(get_flag('rpc_retry_max_backoff',
                                              2.0)),
                   reconnect_secs=float(get_flag('rpc_reconnect_secs',
                                                 3.0)))

    def schedule(self):
        rng = random.Random(self.seed)
        delay = self.backoff
        for attempt in range(self.max_attempts):
            if attempt == 0:
                yield 0.0
            else:
                yield delay * (1.0 + self.jitter * rng.random())
                delay = min(delay * self.multiplier, self.max_backoff)


# ---------------------------------------------------------------------------
# fault plan
# ---------------------------------------------------------------------------

_ACTIONS = ('drop', 'close', 'delay', 'error', 'exit', 'corrupt', 'nan',
            'stall')
_WHENS = ('send', 'recv', 'step')


def _type_names():
    """Message-type name -> int over the wire + master namespaces."""
    from . import wire, master
    names = {'*': '*'}
    for mod in (wire, master):
        for k, v in vars(mod).items():
            if not k.startswith('_') and k.isupper() and isinstance(v, int):
                names[k] = v
    return names


class FaultRule(object):
    def __init__(self, when, nth, action, type='*', secs=0.1,
                 retryable=True, code=137, bits=1):
        if when not in _WHENS:
            raise ValueError('bad when %r (one of %s)' % (when, _WHENS))
        if action not in _ACTIONS:
            raise ValueError('bad action %r (one of %s)'
                             % (action, _ACTIONS))
        if action == 'corrupt' and when != 'send':
            raise ValueError("action 'corrupt' requires when='send' "
                             '(bits are flipped in the outbound frame)')
        if action == 'nan' and when == 'recv':
            raise ValueError("action 'nan' requires when='send' or "
                             "'step' (the poison is injected at the "
                             'producer)')
        if action == 'stall' and when == 'step':
            raise ValueError("action 'stall' requires when='send' or "
                             "'recv' (it holds a wire connection open)")
        self.when = when
        self.type = type
        self.nth = int(nth)
        self.action = action
        self.secs = float(secs)
        self.retryable = bool(retryable)
        self.code = int(code)
        self.bits = max(1, int(bits))

    def to_dict(self):
        d = {'when': self.when, 'type': self.type, 'nth': self.nth,
             'action': self.action}
        if self.action in ('delay', 'stall'):
            d['secs'] = self.secs
        if self.action == 'error':
            d['retryable'] = self.retryable
        if self.action == 'exit':
            d['code'] = self.code
        if self.action == 'corrupt':
            d['bits'] = self.bits
        return d


class FaultPlan(object):
    """An ordered set of FaultRules; see the module docstring schema."""

    def __init__(self, rules, seed=None):
        self.rules = list(rules)
        self.seed = seed

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dict(cls, d):
        return cls([FaultRule(**r) for r in d.get('rules', [])],
                   seed=d.get('seed'))

    @classmethod
    def from_json(cls, s):
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_spec(cls, spec):
        """``seed:N`` | ``kill:ROLE:N`` | ``corrupt:N`` |
        ``grayfail:ROLE:N`` | a JSON object string | a path to a JSON
        file.

        A malformed spec fails HERE, loudly, with the offending text —
        install time is the only moment anyone is looking; a deferred
        parse error would surface mid-training as a mystery."""
        spec = spec.strip()
        try:
            if spec.startswith('seed:'):
                return cls.from_seed(int(spec[len('seed:'):]))
            if spec.startswith('kill:'):
                role, seed = spec[len('kill:'):].split(':', 1)
                return cls.from_kill_seed(int(seed), role)
            if spec.startswith('corrupt:'):
                return cls.from_corrupt_seed(int(spec[len('corrupt:'):]))
            if spec.startswith('grayfail:'):
                role, seed = spec[len('grayfail:'):].split(':', 1)
                return cls.from_grayfail_seed(int(seed), role)
            if spec.startswith('{'):
                return cls.from_json(spec)
            with open(spec) as f:
                return cls.from_json(f.read())
        except (ValueError, KeyError, TypeError, OSError,
                json.JSONDecodeError) as e:
            raise ValueError('unparseable fault plan %r: %s: %s'
                             % (spec, type(e).__name__, e))

    @classmethod
    def from_seed(cls, seed, max_rules=3, max_nth=10):
        """Deterministically generate a plan from a seed: 1..max_rules
        send-side faults over the trainer->pserver message types, mostly
        transient (drop/close/delay/retryable error) with a small chance
        of a fatal error — the chaos_sweep distribution."""
        rng = random.Random(seed)
        types = ['SEND_VAR', 'BATCH_BARRIER', 'GET_VAR', 'FETCH_BARRIER']
        rules = []
        for _ in range(rng.randint(1, max_rules)):
            roll = rng.random()
            if roll < 0.30:
                action, kw = 'drop', {}
            elif roll < 0.60:
                action, kw = 'close', {}
            elif roll < 0.80:
                action, kw = 'delay', {'secs': round(
                    0.05 + 0.25 * rng.random(), 3)}
            elif roll < 0.95:
                action, kw = 'error', {'retryable': True}
            else:
                action, kw = 'error', {'retryable': False}
            rules.append(FaultRule('send', rng.randint(1, max_nth),
                                   action, type=rng.choice(types), **kw))
        return cls(rules, seed=seed)

    @classmethod
    def from_kill_seed(cls, seed, role, max_nth=8):
        """One seeded ``exit`` rule: kill the process at the Nth message
        event of a randomly chosen type — the chaos_sweep --kill
        distribution.

        Kill points are limited to those from which recovery is EXACT:

        - pserver: any inbound mutation (``recv`` of SEND_VAR /
          BATCH_BARRIER / GET_VAR) — the journal + client replay
          restore the precise pre-kill state.
        - trainer: ``send`` of SEND_VAR / GET_VAR / FETCH_BARRIER. A
          kill between the two per-pserver BATCH_BARRIER sends is
          deliberately excluded: one shard would close the round while
          the other waits, and the restarted trainer would pull
          mixed-round params — recovery would converge but not
          bit-exactly, which the sweep cannot distinguish from a bug.
        """
        rng = random.Random(('kill', role, seed).__repr__())
        if role == 'pserver':
            when = 'recv'
            types = ['SEND_VAR', 'BATCH_BARRIER', 'GET_VAR']
        elif role == 'trainer':
            when = 'send'
            types = ['SEND_VAR', 'GET_VAR', 'FETCH_BARRIER']
        else:
            raise ValueError('bad kill role %r (trainer | pserver)'
                             % (role,))
        rule = FaultRule(when, rng.randint(2, max_nth), 'exit',
                         type=rng.choice(types))
        return cls([rule], seed=seed)

    @classmethod
    def from_grayfail_seed(cls, seed, role, max_nth=6):
        """One seeded ``stall`` rule: at the Nth inbound SRV_POLL the
        replica's data connection freezes for 20-40s — alive-but-slow,
        the chaos_sweep --grayfail distribution.

        SRV_POLL recv is the canonical gray-failure point: the stream
        was accepted, tokens are being generated, health probes (their
        own connection, their own server thread) keep passing — but the
        router's view of progress stops dead. The stall is sized to
        outlast any sane FLAGS_fleet_progress_timeout_secs, so a run
        that completes did so because the watchdog gray-marked the
        replica and failed streams over, never because the stall
        expired first. max_nth stays small relative to the polls a
        client burst actually generates (one batched SRV_POLL per
        FLAGS_fleet_poll_secs tick while streams are live) so the rule
        reliably fires before the burst drains."""
        rng = random.Random(('grayfail', role, seed).__repr__())
        rule = FaultRule('recv', rng.randint(2, max_nth), 'stall',
                         type='SRV_POLL',
                         secs=round(20.0 + 20.0 * rng.random(), 1))
        return cls([rule], seed=seed)

    @classmethod
    def from_corrupt_seed(cls, seed, max_rules=2, max_nth=10):
        """Seeded integrity faults: 1..max_rules send-side ``corrupt``
        (bit flips in a frame — the CRC must catch them) and ``nan``
        (poisoned gradient — the finite guard must catch it) rules, the
        chaos_sweep --corrupt distribution. Every rule is recoverable
        by design: the sweep expects bit-exact convergence, never
        fatal."""
        rng = random.Random(('corrupt', seed).__repr__())
        types = ['SEND_VAR', 'BATCH_BARRIER', 'GET_VAR', 'FETCH_BARRIER']
        rules = []
        for _ in range(rng.randint(1, max_rules)):
            if rng.random() < 0.7:
                rules.append(FaultRule(
                    'send', rng.randint(1, max_nth), 'corrupt',
                    type=rng.choice(types), bits=rng.randint(1, 8)))
            else:
                # nan only makes sense on a gradient push
                rules.append(FaultRule(
                    'send', rng.randint(1, max_nth), 'nan',
                    type='SEND_VAR'))
        return cls(rules, seed=seed)

    def to_json(self):
        d = {'rules': [r.to_dict() for r in self.rules]}
        if self.seed is not None:
            d['seed'] = self.seed
        return json.dumps(d)


# ---------------------------------------------------------------------------
# per-process installation + hook implementation
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_plan = None          # active FaultPlan or None
_counts = {}          # (when, type_key) -> messages seen
_fired = []           # audit log of fired rules
_names = None         # msg-type name map, resolved lazily


def install_plan(plan):
    """Activate `plan` process-wide and reset the event counters."""
    global _plan
    with _lock:
        _plan = plan
        _counts.clear()
        del _fired[:]


def clear_plan():
    install_plan(None)


def current_plan():
    return _plan


def fired_faults():
    """Audit log: [{'when','type','nth','action'}, ...] fired so far."""
    with _lock:
        return [dict(f) for f in _fired]


class active_plan(object):
    """Context manager: install a plan for the block, then restore."""

    def __init__(self, plan):
        self.plan = plan

    def __enter__(self):
        self._prev = _plan
        install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc):
        install_plan(self._prev)


def _match_locked(when, msg_type):
    """Advance counters for one event; return the rule to fire or None.
    Must run under _lock so concurrent connections count atomically."""
    global _names
    if _names is None:
        _names = _type_names()
    hit = None
    keys = (msg_type, '*') if msg_type != '*' else ('*',)
    for key in keys:
        n = _counts.get((when, key), 0) + 1
        _counts[(when, key)] = n
        for rule in _plan.rules:
            if rule.when != when or rule.nth != n:
                continue
            rtype = _names.get(rule.type, rule.type)
            if rtype != key:
                continue
            hit = rule
    if hit is not None:
        _fired.append({'when': when, 'type': hit.type, 'nth': hit.nth,
                       'action': hit.action})
        from ..obs import telemetry
        telemetry.counter('faults.injected').inc()
        # snapshot NOW, before the action takes effect: an 'exit' rule
        # (the kill -9 analog) dies with os._exit — no atexit, no final
        # periodic export — and a short-lived incarnation would
        # otherwise leave no metrics line at all. Firing a fault is the
        # one moment a chaos run's counters must be durable.
        try:
            telemetry.flush()
        except Exception:
            pass   # observability must never alter the injected fault
    return hit


def _close_quietly(sock):
    try:
        sock.close()
    except OSError:
        pass


class SendEffect(object):
    """Returned by on_send for the actions the wire layer must
    cooperate on. `action` is one of 'close' (send the frame, then run
    post_send), 'corrupt' (send mutate_frame(frame)) or 'nan' (poison
    the float payload before framing)."""

    def __init__(self, rule, sock, index=0):
        self.action = rule.action
        self.rule = rule
        # for batched sends: which contained var's rule fired ('nan'
        # poisons only that var's bytes; frame-scoped actions ignore it)
        self.index = index
        self._sock = sock

    def post_send(self):
        _close_quietly(self._sock)

    def mutate_frame(self, frame, lo):
        """Deterministically flip `rule.bits` bits in frame[lo:] — the
        CRC-covered body region. (Flipping header length fields instead
        would desync the stream, a failure the read deadline surfaces;
        body flips are what the CRC exists to catch.)"""
        rng = random.Random(
            ('corrupt-bits', self.rule.type, self.rule.nth,
             self.rule.bits).__repr__())
        buf = bytearray(frame)
        for _ in range(self.rule.bits):
            pos = rng.randrange(lo, len(buf))
            buf[pos] ^= 1 << rng.randrange(8)
        return bytes(buf)


def _raise_for(rule, where):
    msg = 'fault injection: %s at %s (rule %s)' % (rule.action, where,
                                                   rule.to_dict())
    if rule.action == 'error' and not rule.retryable:
        raise FatalRPCError(msg)
    raise RetryableRPCError(msg)


def _stall_for(rule, where):
    """The 'stall' action: freeze this connection for rule.secs while
    the process stays alive and every other connection keeps serving.
    The audit line lands on stderr BEFORE the sleep — a chaos harness
    greps for it to prove the gray failure actually fired even when the
    watchdog unwedges the victim long before the stall expires."""
    import sys
    sys.stderr.write('fault injection: stall %.1fs at %s (rule %s)\n'
                     % (rule.secs, where, rule.to_dict()))
    sys.stderr.flush()
    time.sleep(rule.secs)


def _exit_for(rule, where):
    """The 'exit' action: die NOW, with no cleanup of any kind.
    sys.stderr is flushed (it carries the audit line chaos tests grep
    for) but sockets, locks and atexit handlers are abandoned exactly
    as kill -9 would abandon them."""
    import sys
    sys.stderr.write('fault injection: exit(%d) at %s (rule %s)\n'
                     % (rule.code, where, rule.to_dict()))
    sys.stderr.flush()
    os._exit(rule.code)


def on_send(sock, msg_type, meta):
    """wire.write_msg hook, called BEFORE the frame hits the socket.
    Returns None, or a SendEffect the wire layer applies ('close':
    frame delivered then connection dies; 'corrupt': bits flipped in
    the outbound frame; 'nan': float payload poisoned before
    framing)."""
    if _plan is None:
        return None
    with _lock:
        rule = _match_locked('send', msg_type)
    if rule is None:
        return None
    if rule.action == 'delay':
        time.sleep(rule.secs)
        return None
    if rule.action == 'stall':
        _stall_for(rule, 'send of msg type %s' % msg_type)
        return None
    if rule.action == 'drop':
        _close_quietly(sock)
        raise RetryableRPCError(
            'fault injection: dropped msg type %s (rule %s)'
            % (msg_type, rule.to_dict()))
    if rule.action in ('close', 'corrupt', 'nan'):
        return SendEffect(rule, sock)
    if rule.action == 'exit':
        _exit_for(rule, 'send of msg type %s' % msg_type)
    _raise_for(rule, 'send of msg type %s' % msg_type)


def on_send_vars(sock, msg_type, entries):
    """wire.write_vars_msg hook: a SEND_VARS batch advances the 'send'
    counters once PER CONTAINED VAR — the exact logical firing points a
    per-var send loop would hit — so a seeded plan faults the same Nth
    gradient whether or not batching is on. The frame is a single
    physical send, so frame-scoped actions apply once to the whole
    batch, with precedence when several rules land in one batch: every
    'exit' first (kill determinism), 'delay' sleeps accumulate, then
    the first drop/close/corrupt/nan/error in entry order wins. A 'nan'
    SendEffect carries the index of the entry whose rule fired so only
    that var's payload is poisoned."""
    if _plan is None:
        return None
    fired = []
    with _lock:
        for i in range(len(entries)):
            rule = _match_locked('send', msg_type)
            if rule is not None:
                fired.append((i, rule))
    if not fired:
        return None
    for i, rule in fired:
        if rule.action == 'exit':
            _exit_for(rule, 'send of msg type %s (batch var %d)'
                      % (msg_type, i))
    for i, rule in fired:
        if rule.action == 'delay':
            time.sleep(rule.secs)
        elif rule.action == 'stall':
            _stall_for(rule, 'send of msg type %s (batch var %d)'
                       % (msg_type, i))
    for i, rule in fired:
        if rule.action == 'drop':
            _close_quietly(sock)
            raise RetryableRPCError(
                'fault injection: dropped batch of %d (msg type %s, '
                'rule %s)' % (len(entries), msg_type, rule.to_dict()))
        if rule.action in ('close', 'corrupt', 'nan'):
            return SendEffect(rule, sock, index=i)
        if rule.action == 'error':
            _raise_for(rule, 'send of msg type %s (batch var %d)'
                       % (msg_type, i))
    return None


def on_recv_vars(sock, msg_type, count):
    """wire.read_msg hook for an inbound SEND_VARS frame: advances the
    'recv' counters once per contained var (mirroring on_send_vars).
    'drop' discards the WHOLE batch frame — per-var dedup tokens make
    the client's replay apply each var at-most-once; exit/delay/close/
    error follow the same precedence as on_send_vars."""
    if _plan is None:
        return None
    fired = []
    with _lock:
        for i in range(count):
            rule = _match_locked('recv', msg_type)
            if rule is not None:
                fired.append((i, rule))
    if not fired:
        return None
    for i, rule in fired:
        if rule.action == 'exit':
            _exit_for(rule, 'recv of msg type %s (batch var %d)'
                      % (msg_type, i))
    for i, rule in fired:
        if rule.action == 'delay':
            time.sleep(rule.secs)
        elif rule.action == 'stall':
            _stall_for(rule, 'recv of msg type %s (batch var %d)'
                       % (msg_type, i))
    for i, rule in fired:
        if rule.action == 'drop':
            return 'drop'
        if rule.action == 'close':
            _close_quietly(sock)
            raise ConnectionError(
                'fault injection: closed on recv of msg type %s '
                '(batch var %d)' % (msg_type, i))
        if rule.action == 'error':
            _raise_for(rule, 'recv of msg type %s (batch var %d)'
                       % (msg_type, i))
    return None


def on_recv(sock, msg_type, meta):
    """wire.read_msg hook, called AFTER a full frame was parsed (framing
    stays intact). Returns 'drop' to discard the message and read the
    next one, else None."""
    if _plan is None:
        return None
    with _lock:
        rule = _match_locked('recv', msg_type)
    if rule is None:
        return None
    if rule.action == 'delay':
        time.sleep(rule.secs)
        return None
    if rule.action == 'stall':
        _stall_for(rule, 'recv of msg type %s' % msg_type)
        return None
    if rule.action == 'drop':
        return 'drop'
    if rule.action == 'close':
        _close_quietly(sock)
        raise ConnectionError(
            'fault injection: closed on recv of msg type %s' % msg_type)
    if rule.action == 'exit':
        _exit_for(rule, 'recv of msg type %s' % msg_type)
    _raise_for(rule, 'recv of msg type %s' % msg_type)


def on_step():
    """Trainer step hook: fires 'step' rules (delay sleeps; 'nan'
    returns the string 'nan' so the Trainer poisons one feed value;
    drop/close/error all raise per the rule's retryable
    classification)."""
    if _plan is None:
        return None
    with _lock:
        rule = _match_locked('step', '*')
    if rule is None:
        return None
    if rule.action == 'delay':
        time.sleep(rule.secs)
        return None
    if rule.action == 'nan':
        return 'nan'
    if rule.action == 'exit':
        _exit_for(rule, 'trainer step')
    _raise_for(rule, 'trainer step')


def _install_from_flags():
    """FLAGS_fault_plan (env-bootstrapped) activates a plan for this
    process — how subprocess cluster tests fault exactly one role."""
    from ..flags import get_flag
    spec = get_flag('fault_plan', '') or ''
    if spec:
        install_plan(FaultPlan.from_spec(spec))


_install_from_flags()
