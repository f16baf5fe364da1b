"""Parallelism (counterpart of paddle_tpu/parallel/__init__.py): device
meshes over ranks (mesh.py), sharding annotations (api.py), the tensor-,
sequence- and expert-parallel layers (layers.py), ring attention
(ring_attention.py), the strategy object (strategy.py) and the
multi-process runtime (distributed.py). One process a rank; the layouts
and collectives of a mesh run are layout.py's and collectives.py's.
The pipeline engine (pipeline_stage_guard, pp) is not ported yet
(ROADMAP.md Queue 1 item 8's pipeline bullet)."""
from .mesh import MeshConfig, get_mesh, set_mesh, mesh_scope
from .api import shard_tensor, sharding_constraint
from . import layers as players  # noqa: F401
from . import layers  # noqa: F401
from .strategy import DistributedStrategy
from . import distributed
from .distributed import init_parallel_env

__all__ = ['MeshConfig', 'get_mesh', 'set_mesh', 'mesh_scope',
           'shard_tensor', 'sharding_constraint', 'DistributedStrategy',
           'distributed', 'init_parallel_env']
