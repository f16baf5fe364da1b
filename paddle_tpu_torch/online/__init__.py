"""Online learning: versioned trainer→serving parameter refresh
(counterpart of paddle_tpu/online/).

Pservers publish a monotonically increasing *param version* on every
closed optimizer round (distributed/param_service.py); the
ParamSubscriber here lives in the serving process, polls the published
versions, pulls fresh shards over the pipelined RPC client, verifies
them against the digest manifest, and installs them into the serving
DecodePredictor at an engine step boundary — decode keeps tracking the
training trajectory without a restart (the reference's continuous
CTR-style train→serve loop).
"""
from .subscriber import ParamSubscriber, RefreshError

__all__ = ['ParamSubscriber', 'RefreshError']
