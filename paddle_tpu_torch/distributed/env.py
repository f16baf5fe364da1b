"""Cluster topology from environment variables (counterpart of
paddle_tpu/distributed/env.py, copied) — the bootstrap half of
the reference's Trainer env contract (reference python/paddle/fluid/
trainer.py:329-377 reads TRAINING_ROLE / PADDLE_PSERVER* /
PADDLE_TRAINER* and dispatches to pserver or trainer startup; SURVEY
§5.6). Entry scripts launched by a scheduler exporting these variables call
`cluster_from_env()` and branch on `.role`:

    env = fluid.distributed.cluster_from_env()
    if env.role == 'PSERVER':
        ParameterService(...).serve(env.current_endpoint)
    else:
        t = fluid.DistributeTranspiler()
        t.transpile(env.trainer_id, pservers=env.pserver_csv,
                    trainers=env.num_trainers)

Collective (non-pserver) jobs read `.trainer_id` /
`.trainer_endpoints` the same way.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

__all__ = ['ClusterEnv', 'cluster_from_env']


@dataclass
class ClusterEnv:
    role: str                               # 'TRAINER' | 'PSERVER'
    trainer_id: int
    num_trainers: int
    trainer_endpoints: list = field(default_factory=list)
    pserver_endpoints: list = field(default_factory=list)
    current_endpoint: str = ''

    @property
    def pserver_csv(self):
        """Comma list in the form DistributeTranspiler.transpile takes."""
        return ','.join(self.pserver_endpoints)


def _split(csv):
    return [e.strip() for e in csv.split(',') if e.strip()]


def cluster_from_env(environ=None):
    """Parse the PADDLE_* contract out of `environ` (default
    os.environ). Unset variables degrade to a single-process TRAINER —
    the same local-mode default the reference's env bootstrap has."""
    env = os.environ if environ is None else environ
    role = env.get('TRAINING_ROLE', 'TRAINER').upper()
    tid = int(env.get('PADDLE_TRAINER_ID', 0) or 0)
    n = int(env.get('PADDLE_TRAINERS_NUM',
                    env.get('PADDLE_TRAINERS', 1)) or 1)
    tr_eps = _split(env.get('PADDLE_TRAINER_ENDPOINTS', ''))
    ps_eps = _split(env.get('PADDLE_PSERVER_ENDPOINTS', ''))
    cur = env.get('PADDLE_CURRENT_ENDPOINT', '')
    if not cur:
        eps = ps_eps if role == 'PSERVER' else tr_eps
        if eps and 0 <= tid < len(eps):
            cur = eps[tid]
    if role not in ('TRAINER', 'PSERVER'):
        raise ValueError('TRAINING_ROLE must be TRAINER or PSERVER, '
                         'got %r' % role)
    return ClusterEnv(role=role, trainer_id=tid, num_trainers=n,
                      trainer_endpoints=tr_eps,
                      pserver_endpoints=ps_eps,
                      current_endpoint=cur)
