"""Fleet replica worker: one LMServer behind a ReplicaServer socket
(counterpart of tools/serve_replica.py).

The process a Supervisor role runs per serving replica: loads a
save_inference_model directory, prepares continuous-batching decode,
binds the SRV_* wire endpoint, and serves until a COMPLETE message
(clean exit 0) or a signal. serving/fleet.py's FleetRouter is the
client.

    SERVE_MODEL_DIR=model python -m paddle_tpu_torch.tools.serve_replica

Environment contract (the JAX package's, plus SERVE_PLACE):

  SERVE_MODEL_DIR       save_inference_model directory     (required)
  SERVE_PLACE           'cpu' -> serve on the host; anything else (the
                        default) serves on CUDAPlace(0), and a machine
                        without a card raises: a replica never falls
                        back to the host
  SERVE_ENDPOINT        host:port to bind    (default 127.0.0.1:0)
  SERVE_PORT_FILE       write the bound port here once listening --
                        how a launcher learns an ephemeral port
  SERVE_SLOTS           decode slots per worker      (default flags)
  SERVE_WORKERS         engine worker threads        (default 1)
  SERVE_PREFILL_BATCH   prefill batch                (default flags)
  SERVE_PAGED           '1' -> paged KV cache (copy-on-write prefix
                        sharing + chunked prefill); sized by
                        SERVE_PAGE_TOKENS / SERVE_KV_PAGES /
                        SERVE_PREFILL_CHUNK   (defaults from flags)
  SERVE_MESH_SHAPE      a mesh axis spec ('tp=2'): the replica serves
                        over a mesh of rank processes on its place
                        (serving/mesh.py); SRV_HEALTH carries
                        mesh_shape / mesh_devices   (default '': one
                        device)
  SERVE_PS_ENDPOINTS    comma-separated pserver endpoints; attaches a
                        ParamSubscriber. Default posture is PAUSED --
                        staleness is measured but only an
                        orchestrator-driven SRV_REFRESH (a rolling
                        deploy) installs weights.
  SERVE_AUTO_REFRESH    '1' -> the subscriber installs on its own
                        poll loop instead
  SERVE_SUBSCRIBER_ID   subscriber identity          (default pid)

Prints 'READY <port>' on stdout once serving, and on a clean exit one
line 'LAUNCHES <json>': the flash-attention kernels' launch counts of
this process and the forwards that ran the plain version on a CUDA
tensor (`plain_cuda_calls`, 0 on a sound replica); on a mesh the
kernels run in the rank processes, not counted here. The kernels are
built from csrc/ at first use into the checkout's build directory (a
file lock there keeps replicas that start together from building at
once). Fault plans (FLAGS_fault_plan) apply to the wire layer as
everywhere else, so a replica can be killed at a deterministic message.
"""
from __future__ import annotations

import json
import os
import sys

__all__ = ['main', 'place_from_env', 'launch_counts']


def place_from_env():
    """SERVE_PLACE=cpu -> CPUPlace(); otherwise CUDAPlace(0), which
    raises here when torch sees no card."""
    import torch
    from ..executor import CPUPlace, CUDAPlace
    if os.environ.get('SERVE_PLACE', '').lower() == 'cpu':
        return CPUPlace()
    if not torch.cuda.is_available():
        raise RuntimeError(
            'serve_replica: no CUDA device (torch.cuda.is_available() is '
            'false); set SERVE_PLACE=cpu to serve on the host')
    return CUDAPlace(0)


def launch_counts():
    """{wrapper name: launches} of the flash-attention kernels in this
    process, plus 'plain_cuda_calls'."""
    from ..kernels import flash_attention as fa
    out = {name: int(getattr(fa, name).launches) for name in (
        'flash_attention_fwd', 'flash_attention_fwd_stats',
        'flash_attention_fwd_acc', 'flash_attention_bwd_kvmajor',
        'flash_attention_bwd_dq', 'flash_attention_bwd_dkv',
        'flash_attention_bwd_onepass')}
    out['plain_cuda_calls'] = int(fa.FlashAttention.plain_cuda_calls)
    return out


def main():
    from ..serving import LMServer, ReplicaServer
    mesh = os.environ.get('SERVE_MESH_SHAPE', '')
    model_dir = os.environ['SERVE_MODEL_DIR']
    place = place_from_env()
    endpoint = os.environ.get('SERVE_ENDPOINT', '127.0.0.1:0')
    slots = os.environ.get('SERVE_SLOTS')
    workers = int(os.environ.get('SERVE_WORKERS', '1'))
    prefill = os.environ.get('SERVE_PREFILL_BATCH')
    paged = os.environ.get('SERVE_PAGED') == '1'
    page_tokens = os.environ.get('SERVE_PAGE_TOKENS')
    kv_pages = os.environ.get('SERVE_KV_PAGES')
    chunk = os.environ.get('SERVE_PREFILL_CHUNK')
    srv = LMServer(model_dir, place=place,
                   slots=int(slots) if slots else None,
                   prefill_batch=int(prefill) if prefill else None,
                   workers=workers, paged=paged,
                   page_tokens=int(page_tokens) if page_tokens else None,
                   kv_pages=int(kv_pages) if kv_pages else None,
                   prefill_chunk=int(chunk) if chunk else None,
                   mesh=mesh)
    ps_eps = os.environ.get('SERVE_PS_ENDPOINTS')
    if ps_eps:
        srv.enable_refresh(
            ps_eps.split(','),
            subscriber_id=int(os.environ.get('SERVE_SUBSCRIBER_ID',
                                             os.getpid() % 60000)),
            paused=os.environ.get('SERVE_AUTO_REFRESH') != '1')
    rep = ReplicaServer(srv, endpoint=endpoint)
    port_file = os.environ.get('SERVE_PORT_FILE')
    if port_file:
        tmp = port_file + '.tmp'
        with open(tmp, 'w') as f:
            f.write(str(rep.port))
        os.replace(tmp, port_file)
    print('READY %d' % rep.port, flush=True)
    try:
        rep.serve_forever()       # returns after a COMPLETE message
    finally:
        srv.close(drain=True, timeout=10.0)
    print('LAUNCHES ' + json.dumps(launch_counts()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
