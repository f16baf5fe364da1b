"""Process supervisor for elastic cluster recovery (counterpart of
paddle_tpu/distributed/supervisor.py, copied: it is plain Python).

Launches cluster roles (trainers, pservers, a master) as subprocesses,
watches for exits, and restarts failed roles under a backoff +
restart-budget policy — the local-process analog of what a k8s
restartPolicy or the reference's paddlecloud supervisor does for a real
cluster, sized for the subprocess cluster tests.

Restart semantics:

- exit 0 is DONE: the role finished; it is never restarted.
- nonzero exit is a FAILURE: the role is restarted after a backoff
  (exponential per role, capped), until its restart budget
  (`max_restarts`) is spent — then the role is FAILED and stays down.
- a role that stayed up for ``healthy_secs`` (FLAGS_sup_healthy_secs)
  before dying gets its restart BUDGET and backoff exponent reset
  first: a replica that crashes once a day is a healthy role having a
  bad moment, not a crash loop. The LIFETIME restart count (and the
  incarnation fence it feeds) keeps growing monotonically.
- every restart sets ``FLAGS_trainer_incarnation`` to the role's
  restart count in the child's environment, so a restarted trainer
  re-registers with a higher incarnation and the pserver's fence
  admits it while rejecting its zombie predecessor
  (param_service._fence_locked).
- ``FLAGS_fault_plan`` is STRIPPED from the restart environment by
  default: the plan that killed the process (the `exit` fault action)
  would deterministically kill the restarted process at the same
  message count again.

Output handling: each role's stdout+stderr append to a per-role log
file (pipes would deadlock once a 64 KB buffer fills with nobody
draining it — the supervisor must keep watching, not reading).

Observability: with ``obs_dir`` set, every role gets its OWN subdir
planted into its environment as ``FLAGS_obs_dir`` (plus
``FLAGS_obs_role`` = the role name), so each process's telemetry and
trace JSONL land side by side and ``paddle_tpu_torch.tools.obs_report`` can merge
the whole run into one timeline. The supervisor itself appends its
spawn/restart counters under ``<obs_dir>/supervisor/`` — written
directly (not through the process-wide registry) so supervising from
inside a test process never flips global telemetry state.
"""
from __future__ import annotations

import json
import os
import subprocess
import threading
import time

__all__ = ['Supervisor']


class _Role(object):
    def __init__(self, name, argv, env, restartable, max_restarts):
        self.name = name
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self.restartable = restartable
        self.max_restarts = max_restarts
        self.proc = None
        self.restarts = 0             # LIFETIME — feeds the incarnation
        self.budget_used = 0          # restarts since last healthy run
        self.spawned_at = None        # monotonic; healthy-secs clock
        self.state = 'pending'        # pending|running|done|failed|removed
        self.next_restart_at = None   # monotonic; backoff gate
        self.log_path = None


class Supervisor(object):
    """Launch roles, restart the ones that die, report how it went.

    usage::

        sup = Supervisor(log_dir=tmpdir)
        sup.add_role('pserver0', [sys.executable, worker], env=ps_env)
        sup.add_role('trainer0', [sys.executable, worker], env=tr_env)
        sup.start()
        states = sup.wait(timeout=120)   # {'pserver0': 'done', ...}
        sup.stop()
    """

    def __init__(self, max_restarts=3, backoff=0.5,
                 backoff_multiplier=2.0, max_backoff=10.0, log_dir=None,
                 clear_fault_plan_on_restart=True, obs_dir=None,
                 clear_env_on_restart=(), healthy_secs=None):
        from ..flags import get_flag
        self.max_restarts = int(max_restarts)
        self.healthy_secs = float(healthy_secs
                                  if healthy_secs is not None
                                  else get_flag('sup_healthy_secs'))
        self.backoff = float(backoff)
        self.backoff_multiplier = float(backoff_multiplier)
        self.max_backoff = float(max_backoff)
        self.log_dir = log_dir
        self.clear_fault_plan_on_restart = clear_fault_plan_on_restart
        # extra env vars dropped from every RESTART environment (the
        # FLAGS_fault_plan strip, generalized): anything that must only
        # apply to the FIRST incarnation — a one-shot kill trigger, a
        # cold-start-only knob — goes here
        self.clear_env_on_restart = tuple(clear_env_on_restart)
        self.obs_dir = obs_dir
        self._roles = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor = None
        self._started = False
        self.events = []   # [(monotonic, role, event_str), ...]

    # -- configuration -----------------------------------------------------
    def add_role(self, name, argv, env=None, restartable=True,
                 max_restarts=None):
        """Register a role; `env` replaces os.environ for the child
        when given; restartable=False makes any nonzero exit terminal
        (a role whose failure the test wants to SEE). After start()
        this is the fleet scale-OUT primitive: the role is spawned
        immediately and the monitor picks it up. Returns the role
        name."""
        if max_restarts is None:
            max_restarts = self.max_restarts
        role = _Role(name, argv, env, restartable, int(max_restarts))
        with self._lock:
            self._roles.append(role)
        if self._started:
            self._spawn(role)
            self._ensure_monitor()
        return name

    def remove_role(self, name, kill=True):
        """Retire a role at runtime (fleet scale-IN): the monitor stops
        watching it and — with kill=True — its process is killed. A
        removed role counts as settled for wait()."""
        with self._lock:
            role = next((r for r in self._roles if r.name == name), None)
        if role is None:
            raise ValueError('unknown role %r' % name)
        role.state = 'removed'
        self._event(role, 'removed')
        if kill and role.proc is not None and role.proc.poll() is None:
            role.proc.kill()
            try:
                role.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._started = True
        for role in list(self._roles):
            self._spawn(role)
        self._ensure_monitor()

    def _ensure_monitor(self):
        if self._monitor is not None and self._monitor.is_alive():
            return
        if self._stop.is_set():
            return
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True)
        self._monitor.start()

    def _log_file(self, role):
        if self.log_dir is None:
            return subprocess.DEVNULL
        if role.log_path is None:
            role.log_path = os.path.join(self.log_dir,
                                         '%s.log' % role.name)
        return open(role.log_path, 'ab')

    def _spawn(self, role):
        env = dict(role.env if role.env is not None else os.environ)
        if role.restarts:
            env['FLAGS_trainer_incarnation'] = str(role.restarts)
            if self.clear_fault_plan_on_restart:
                env.pop('FLAGS_fault_plan', None)
            for key in self.clear_env_on_restart:
                env.pop(key, None)
        if self.obs_dir:
            # one obs subdir per role: each incarnation appends its own
            # metrics-/events- files there (filenames carry the pid),
            # and the role name becomes the timeline lane
            role_obs = os.path.join(self.obs_dir, role.name)
            os.makedirs(role_obs, exist_ok=True)
            env['FLAGS_obs_dir'] = role_obs
            env['FLAGS_obs_role'] = role.name
        logf = self._log_file(role)
        try:
            role.proc = subprocess.Popen(role.argv, env=env,
                                         stdout=logf, stderr=logf)
        finally:
            if logf is not subprocess.DEVNULL:
                logf.close()   # the child holds its own fd now
        role.spawned_at = time.monotonic()
        role.state = 'running'
        self._event(role, 'spawned' if not role.restarts
                    else 'restarted #%d' % role.restarts)

    def _event(self, role, what):
        with self._lock:
            self.events.append((time.monotonic(), role.name, what))
        if self.obs_dir:
            self._write_obs(role, what)

    def _write_obs(self, role, what):
        """Append the supervisor's own obs records: an instant event
        per lifecycle transition plus a running metrics snapshot —
        rewritten on every event so the counters survive even if the
        supervising process is killed without a stop()."""
        d = os.path.join(self.obs_dir, 'supervisor')
        try:
            os.makedirs(d, exist_ok=True)
            pid = os.getpid()
            now = time.time()
            with open(os.path.join(
                    d, 'events-supervisor-%d.jsonl' % pid), 'a') as f:
                f.write(json.dumps(
                    {'type': 'fault', 't': now, 'role': 'supervisor',
                     'pid': pid, 'action': what,
                     'target': role.name}) + '\n')
            with self._lock:
                restarts = sum(r.restarts for r in self._roles)
                spawns = sum(1 for e in self.events
                             if e[2].startswith(('spawned', 'restarted')))
            with open(os.path.join(
                    d, 'metrics-supervisor-%d.jsonl' % pid), 'a') as f:
                f.write(json.dumps(
                    {'ts': now, 'role': 'supervisor', 'pid': pid,
                     'counters': {'supervisor.restarts': restarts,
                                  'supervisor.spawns': spawns},
                     'gauges': {}, 'hists': {}}) + '\n')
        except OSError:
            pass   # observability must never take the supervisor down

    def _monitor_loop(self):
        # runs until stop(): roles can be added at runtime (fleet
        # scale-out), so "everything settled" is never final
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                roles = list(self._roles)
            for role in roles:
                if role.state == 'running':
                    rc = role.proc.poll()
                    if rc is None:
                        continue
                    if rc == 0:
                        role.state = 'done'
                        self._event(role, 'exit 0')
                        continue
                    self._event(role, 'exit %d' % rc)
                    if (role.spawned_at is not None and self.healthy_secs
                            and now - role.spawned_at
                            >= self.healthy_secs
                            and role.budget_used):
                        # healthy long enough: this crash starts a
                        # fresh budget + backoff ladder; the lifetime
                        # count (incarnation fence) keeps climbing
                        role.budget_used = 0
                        self._event(role, 'budget reset (healthy %.1fs)'
                                    % (now - role.spawned_at))
                    if (not role.restartable
                            or role.budget_used >= role.max_restarts):
                        role.state = 'failed'
                        continue
                    role.budget_used += 1
                    role.restarts += 1
                    delay = min(
                        self.backoff * self.backoff_multiplier
                        ** (role.budget_used - 1), self.max_backoff)
                    role.state = 'backoff'
                    role.next_restart_at = now + delay
                elif role.state == 'backoff':
                    if now >= role.next_restart_at:
                        self._spawn(role)
            self._stop.wait(timeout=0.05)

    def wait(self, timeout=None):
        """Block until every role settled (done/failed) or `timeout`
        elapsed. -> {name: state} snapshot ('running'/'backoff' entries
        mean the timeout hit first — the caller's hang verdict)."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while True:
            states = self.states()
            if all(s in ('done', 'failed', 'removed')
                   for s in states.values()):
                return states
            if deadline is not None and time.monotonic() >= deadline:
                return states
            time.sleep(0.05)

    def states(self):
        return {r.name: r.state for r in self._roles}

    @property
    def restarts(self):
        return {r.name: r.restarts for r in self._roles}

    def output(self, name):
        """Accumulated log of a role across all its incarnations."""
        for r in self._roles:
            if r.name == name and r.log_path \
                    and os.path.exists(r.log_path):
                with open(r.log_path, 'rb') as f:
                    return f.read().decode('utf-8', 'replace')
        return ''

    def stop(self):
        """Kill anything still running and stop the monitor."""
        self._stop.set()
        for role in self._roles:
            if role.proc is not None and role.proc.poll() is None:
                role.proc.kill()
                try:
                    role.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    pass
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
