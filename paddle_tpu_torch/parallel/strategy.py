"""DistributedStrategy: one config object for the parallel stack
(counterpart of paddle_tpu/parallel/strategy.py:10-41)."""
from __future__ import annotations

from .mesh import MeshConfig

__all__ = ['DistributedStrategy']


class DistributedStrategy(object):
    """Axis sizes plus engine knobs.

    dp/tp/sp/pp/ep: parallel degrees; their product is the world size
        (one process a rank).
    sharded_optimizer: ZeRO-1, optimizer state sharded over dp (the
        reference BuildStrategy.kReduce; ParallelExecutor._bcast_params).
    sharded_params: ZeRO-3, the parameters sharded over dp too (implies
        sharded_optimizer); a parameter is gathered where an op reads it
        and its gradient reduce-scattered into the shard. Parameters
        whose no dim divides dp stay replicated.
    micro_batches: pipeline microbatch count (the pipeline engine is not
        ported: pp > 1 raises in ParallelExecutor).
    """

    def __init__(self, dp=1, tp=1, sp=1, pp=1, ep=1,
                 sharded_optimizer=False, sharded_params=False,
                 micro_batches=1):
        self.dp, self.tp, self.sp, self.pp, self.ep = dp, tp, sp, pp, ep
        self.sharded_optimizer = sharded_optimizer or sharded_params
        self.sharded_params = sharded_params
        self.micro_batches = micro_batches

    def mesh_config(self, devices=None):
        return MeshConfig(devices=devices, dp=self.dp, tp=self.tp,
                          sp=self.sp, pp=self.pp, ep=self.ep)

    @property
    def world_size(self):
        return self.dp * self.tp * self.sp * self.pp * self.ep
