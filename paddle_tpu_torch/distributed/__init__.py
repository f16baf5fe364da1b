"""Host-side durability and fault handling (counterpart of
paddle_tpu/distributed/): `statefile` (atomic state files, digests,
quarantine) and the step half of `resilience` (the failure taxonomy,
RetryPolicy, FaultPlan and the Trainer's step hook). The wire, RPC,
parameter service and master wait for ROADMAP.md, Queue 1 item 7."""
from . import resilience, statefile

__all__ = ['resilience', 'statefile']
