"""Distributed runtime: the parameter-server RPC layer and its services
(counterpart of paddle_tpu/distributed/).

Parameter-server mode: host-CPU parameter services over TCP, trainers on
the card pushing gradients and pulling parameters -- the sparse/CTR
half (the gRPC `operators/distributed/` analog: rpc_client.h:30,
grpc_server.h:46, listen_and_serv_op.cc:39). The pservers run on the
host, as in the JAX package: `listen_and_serv` runs its optimize blocks
on an `Executor(CPUPlace())`.

`wire` frames messages byte for byte as the JAX package does, so a port
trainer talks to a JAX pserver and back; `rpc` holds the self-healing
client (reconnect, replay, the pipelined engine) and the threaded
server; `param_service` the sync/async round state machine with its
dedup window, incarnation fencing, liveness and snapshot + journal;
`master` the data-task master; `supervisor` the process supervisor;
`env` the PADDLE_* cluster contract; `statefile` and `resilience` the
durable files and the fault plan. The wire ships SelectedRows natively
(rows + values), so a sparse embedding's gradient costs O(touched rows).
"""
from .rpc import (PSClient, PSServer, get_client, close_all_clients,
                  RetryableRPCError, FatalRPCError)
from .resilience import FaultPlan, RetryPolicy, StaleIncarnationError
from .param_service import ParameterService
from .supervisor import Supervisor
from .env import ClusterEnv, cluster_from_env
from . import resilience, statefile  # noqa: F401

__all__ = ['PSClient', 'PSServer', 'ParameterService', 'get_client',
           'close_all_clients', 'ClusterEnv', 'cluster_from_env',
           'RetryableRPCError', 'FatalRPCError',
           'StaleIncarnationError', 'FaultPlan', 'RetryPolicy',
           'Supervisor']
