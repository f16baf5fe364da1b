"""The step half of the resilience layer (counterpart of
paddle_tpu/distributed/resilience.py): the failure taxonomy, the retry
policy and deterministic fault injection at the Trainer's step boundary.

**Failure taxonomy** -- every failure the Trainer reacts to is either

- `RetryableRPCError` (subclass of ConnectionError): transient; the
  Trainer re-runs the step in place (FLAGS_trainer_step_retries);
- `FatalRPCError` (subclass of RuntimeError): replaying cannot help;
  `Trainer.train` rolls back to the last SUCCESS-marked checkpoint
  (FLAGS_trainer_max_rollbacks).

**RetryPolicy** -- the exponential-backoff-plus-jitter schedule the JAX
package's reconnecting RPC clients share.

**FaultPlan** -- a declarative, seeded description of faults to inject,
enabled per process by `FLAGS_fault_plan` (a JSON plan, a path to one,
``seed:N``, ``kill:ROLE:N``, ``corrupt:N`` or ``grayfail:ROLE:N``), with
the JAX package's schema::

    {"rules": [
       {"when": "step",           # send | recv | step
        "type": "*",              # wire/master msg-type name, or "*"
        "nth": 3,                 # fire on the Nth matching event
        "action": "error",        # drop | close | delay | error | exit
                                  #   | corrupt | nan | stall
        "secs": 0.2,              # delay / stall only
        "retryable": true,        # error only (default true)
        "code": 137,              # exit only (default 137, = kill -9)
        "bits": 1}]}              # corrupt only: bits to flip (default 1)

Plans parse and print exactly as the JAX package's (`from_spec`,
`to_dict`, `to_json`). Counting is per process and per (when, type).
`on_step` fires the ``step`` rules in `Trainer.train` just before a step
runs: ``delay`` sleeps, ``nan`` returns 'nan' (the Trainer poisons one
float feed value so the numeric-anomaly guard sees a non-finite loss),
``exit`` is `os._exit(code)` (kill -9 at an exact step), and the rest
raise per the rule's retryable classification.

The wire hooks (`on_send`, `on_recv`, `on_send_vars`, `on_recv_vars`,
`SendEffect`) wait for the port's distributed stack (ROADMAP.md, Queue 1
item 7); until then a rule naming a message type never matches, and
`send`/`recv` rules never fire.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time

__all__ = ['RetryableRPCError', 'FatalRPCError', 'TransientError',
           'StaleIncarnationError', 'RetryPolicy', 'FaultRule',
           'FaultPlan', 'install_plan', 'clear_plan', 'active_plan',
           'current_plan', 'fired_faults', 'on_step']


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
    """Message-type name -> its wire value. The wire and master
    namespaces come with the port's distributed stack (ROADMAP.md, Queue
    1 item 7); until then only '*' is known, and a rule naming a message
    type matches nothing."""
    return {'*': '*'}


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


def _raise_for(rule, where):
    msg = 'fault injection: %s at %s (rule %s)' % (rule.action, where,
                                                   rule.to_dict())
    if rule.action == 'error' and not rule.retryable:
        raise FatalRPCError(msg)
    raise RetryableRPCError(msg)


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
