"""Parameter-server host ops: send / recv / barriers / prefetch /
split_selected_rows / split_ids / merge_ids / slice_rows /
checkpoint_notify / listen_and_serv (counterpart of
paddle_tpu/ops/dist_ops.py, with its `host` and `no_grad` flags).

Capability analogs of the reference's RPC operators
(paddle/fluid/operators/{send_op.cc, recv_op.cc, send_barrier_op.cc,
fetch_barrier_op.cc, prefetch_op.cc:27, listen_and_serv_op.cc:39,
split_selected_rows_op.cc, split_ids_op.cc, merge_ids_op.cc}), running as
host steps between device segments. On the card a trainer's forward +
backward is a captured CUDA graph; these ops then ship gradients to the
parameter services over TCP (distributed/rpc.py) and pull fresh
parameters.

The two ends of a host step on the card:
- `send` (and the split ops, which route on host ids) moves its values
  to the host as one pinned, non-blocking copy per var, all enqueued on
  the stream the segment's work is ordered on, then synchronises that
  stream once -- not one blocking `.cpu()` per var;
- `recv` writes each received persistable into the tensor the scope
  already holds (`copy_`), the tensor the following segment and the
  next step's forward were captured reading; binding a new tensor would
  leave every later replay on stale weights. `prefetch`'s rows are a
  run-local input of the next segment, which the Executor copies into
  the captured graph's static input before each replay.

The pservers run on the host, as in the JAX package: `listen_and_serv`
runs its optimize blocks on an `Executor(CPUPlace())`.

A profiler scope, `send:wait_for_device`, times the wait inside `send`
for the segment that produced its values (a replay returns before its
work is done), which the Executor's `host_op:send` scope would
otherwise count as `send`'s own. (A pserver's sync rounds are the
service's `param_service:round` scopes.)
"""
from __future__ import annotations

import numpy as np
import torch

from .. import profiler as _prof
from ..registry import register_op
from ..selected_rows import SelectedRows


def _to_host(values):
    """The values (tensors or SelectedRows, on any device) as host
    tensors: each CUDA tensor is copied into pinned memory without
    blocking, and the stream is synchronised once after the last copy."""
    on_card = []

    def move(t):
        if isinstance(t, torch.Tensor) and t.device.type == 'cuda':
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t.detach(), non_blocking=True)
            on_card.append(t.device)
            return h
        return torch.as_tensor(t)

    out = [v.map(move) if isinstance(v, SelectedRows) else move(v)
           for v in values]
    if on_card:
        with _prof.RecordEvent('send:wait_for_device'):
            torch.cuda.current_stream(on_card[0]).synchronize()
    return out


def _client(ctx_op, endpoint):
    from ..distributed.rpc import get_client
    return get_client(endpoint, trainer_id=ctx_op.attr('trainer_id', 0))


def _fan_out(fn, items):
    """[fn(item) or the exception it raised] for each item, each call on
    a thread of its own when there are several."""
    def call(item):
        try:
            return fn(item)
        except BaseException as e:    # noqa: BLE001 -- handed back
            return e
    if len(items) < 2:
        return [call(i) for i in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        return list(pool.map(call, items))


def _drain(futs, err=None):
    """Wait for every future, re-raising the first failure only AFTER
    all have settled -- a trainer step retry must not race requests that
    are still landing on the pservers."""
    for f in futs:
        try:
            f.result()
        except BaseException as e:
            if err is None:
                err = e
    if err is not None:
        raise err


def _bind(ctx, name, value):
    """A received value into the run: a persistable the scope already
    holds is copied into that tensor (what the captured segments read),
    and must be of the value's shape and dtype on the place; anything
    else is set on the place."""
    value = torch.as_tensor(value)
    if ctx.writes_scope and ctx.is_persistable(name):
        cur = ctx.scope.find_var(name)
        if cur is not None:
            if not (isinstance(cur, torch.Tensor)
                    and cur.device == ctx.device
                    and cur.shape == value.shape
                    and cur.dtype == value.dtype):
                raise RuntimeError(
                    'recv %r: the scope holds %s, the pserver sent %s %s; '
                    'binding a new tensor would leave the captured '
                    'segments reading the old one' % (
                        name, '%s %s on %s' % (tuple(cur.shape), cur.dtype,
                                               cur.device)
                        if isinstance(cur, torch.Tensor)
                        else type(cur).__name__,
                        tuple(value.shape), value.dtype))
            cur.copy_(value)
            ctx.set(name, cur)
            return
    ctx.set(name, value.to(ctx.device))


# -- send / recv / barriers -------------------------------------------------

def _send_emit(ctx, op):
    """Push each input var to its pserver (epmap aligned with X),
    pipelined: vars are grouped by endpoint (small dense grads coalesce
    into SEND_VARS frames), streamed to every pserver concurrently, and
    the futures drained before the barrier op that follows -- the step
    pays ~1 RTT per endpoint instead of one per var. Var names are
    identical on both sides -- the service keys arrivals by
    (name, trainer_id)."""
    names = op.input('X')
    values = _to_host([ctx.get(n) for n in names])
    by_ep = {}
    for name, ep, value in zip(names, op.attr('epmap'), values):
        by_ep.setdefault(ep, []).append((name, value))
    # each endpoint's frames are written from a thread of their own: the
    # crc32 and the socket writes release the interpreter lock, so the
    # pservers receive at once (one client, one submitting thread)
    results = _fan_out(lambda ep: _client(op, ep).send_vars_async(
        by_ep[ep]), list(by_ep))
    futs, err = [], None
    for r in results:
        if isinstance(r, BaseException):  # e.g. non-finite pre-send refusal
            err = err or r
        else:
            futs.extend(r)
    _drain(futs, err)


register_op('send', emit=_send_emit, host=True, no_grad=True)


def _recv_emit(ctx, op):
    epmap = op.attr('epmap')
    pending = [(name, _client(op, ep).get_var_async(name))
               for name, ep in zip(op.output('Out'), epmap)]
    err = None
    for name, fut in pending:
        try:
            _bind(ctx, name, fut.result())
        except BaseException as e:
            if err is None:
                err = e
    if err is not None:
        raise err


register_op('recv', emit=_recv_emit, host=True, no_grad=True)


def _checkpoint_notify_emit(ctx, op):
    """Tell every pserver to checkpoint its shard (reference
    checkpoint_notify_op.cc:28); each saves into dirname/<endpoint>.
    The notifies fan out concurrently -- shards snapshot in parallel."""
    dirname = op.attr('dirname')
    _drain([_client(op, ep).checkpoint_notify_async(
                '%s/%s' % (dirname, ep.replace(':', '_')))
            for ep in op.attr('endpoints')])


register_op('checkpoint_notify', emit=_checkpoint_notify_emit, host=True,
            no_grad=True)


def _send_barrier_emit(ctx, op):
    # concurrent fan-out: every shard sees the barrier ~immediately
    # instead of shard k waiting on shard k-1's round trip
    _drain([_client(op, ep).batch_barrier_async()
            for ep in op.attr('endpoints')])


register_op('send_barrier', emit=_send_barrier_emit, host=True, no_grad=True)


def _fetch_barrier_emit(ctx, op):
    _drain([_client(op, ep).fetch_barrier_async()
            for ep in op.attr('endpoints')])


register_op('fetch_barrier', emit=_fetch_barrier_emit, host=True,
            no_grad=True)


# -- split/merge helpers for sharded values ---------------------------------

def _split_selected_rows_emit(ctx, op):
    """Route a SelectedRows grad to row-range shards (reference
    split_selected_rows_op.cc): shard i covers rows
    [offset_i, offset_i + height_sections[i]); emitted rows are LOCAL to
    the shard (global - offset) so the pserver block applies them
    directly."""
    grad = ctx.get(op.single_input('X'))
    if not isinstance(grad, SelectedRows):
        raise TypeError('split_selected_rows expects a SelectedRows input')
    grad, = _to_host([grad])
    rows = grad.rows.to(torch.int64)
    sections = op.attr('height_sections')
    offsets = np.concatenate([[0], np.cumsum(sections)]).tolist()
    for i, name in enumerate(op.output('Out')):
        m = (rows >= offsets[i]) & (rows < offsets[i + 1])
        ctx.set(name, SelectedRows(
            grad.values[m], (rows[m] - offsets[i]).to(torch.int32),
            int(sections[i])))


register_op('split_selected_rows', emit=_split_selected_rows_emit, host=True,
            no_grad=True)


def _split_ids_emit(ctx, op):
    """Shard by id modulo (reference split_ids_op.cc): shard i gets
    entries with id %% nshards == i, re-indexed locally as id // nshards
    (the distributed-lookup-table routing). Works on raw id tensors and
    on SelectedRows grads."""
    x = ctx.get(op.single_input('Ids'))
    outs = op.output('Out')
    n = len(outs)
    x, = _to_host([x])
    if isinstance(x, SelectedRows):
        rows = x.rows.to(torch.int64)
        shard_h = [(x.height + n - 1 - i) // n for i in range(n)]
        for i, name in enumerate(outs):
            m = (rows % n) == i
            ctx.set(name, SelectedRows(
                x.values[m], (rows[m] // n).to(torch.int32), shard_h[i]))
    else:
        ids = x.reshape(-1).to(torch.int64)
        for i, name in enumerate(outs):
            ctx.set(name, ids[(ids % n) == i] // n)


register_op('split_ids', emit=_split_ids_emit, host=True, no_grad=True)


def _merge_ids_emit(ctx, op):
    """Inverse of split_ids for prefetched rows (reference
    merge_ids_op.cc): scatter each shard's returned rows back to the
    original id positions."""
    ids = ctx.get(op.single_input('Ids')).reshape(-1)
    n = len(op.input('X'))
    shards = [ctx.get(name) for name in op.input('X')]
    shards = [torch.as_tensor(s).to(ids.device) for s in shards]
    width = shards[0].shape[-1]
    out = torch.zeros((ids.numel(), width), dtype=shards[0].dtype,
                      device=ids.device)
    for i in range(n):
        out[(ids % n) == i] = shards[i]
    ctx.set(op.single_output('Out'), out)


register_op('merge_ids', emit=_merge_ids_emit, host=True, no_grad=True)


def _slice_rows_emit(ctx, op):
    """x[start:end:step] along dim 0 -- used by pserver startup programs
    to carve this server's shard out of a full-parameter initialization
    (contiguous blocks: step=1; mod-sharded lookup tables: start=shard,
    step=nshards). The slice owns its memory: the full initialization is
    deleted right after."""
    x = ctx.get(op.single_input('X'))
    end = op.attr('end', None)
    ctx.set(op.single_output('Out'),
            x[op.attr('start', 0):(None if end in (None, -1) else end):
              op.attr('step', 1)].clone())


register_op('slice_rows', emit=_slice_rows_emit, host=True, no_grad=True)


# -- prefetch (distributed lookup table forward) ----------------------------

def _prefetch_emit(ctx, op):
    """Remote embedding lookup (reference prefetch_op.cc:27 +
    lookup_sparse_table semantics): split the step's ids by id %% npserver,
    fetch each shard's rows, scatter back to the original order, reshape
    to the lookup_table output shape."""
    from ..distributed.wire import torch_dtype
    epmap = op.attr('epmap')
    n = len(epmap)
    table = op.attr('table_name')
    ids, = _to_host([ctx.get(op.single_input('Ids'))])
    squeeze_last = ids.ndim > 1 and ids.shape[-1] == 1
    shaped = ids.reshape(ids.shape[:-1]) if squeeze_last else ids
    flat = shaped.reshape(-1).to(torch.int64)
    width = int(op.attr('emb_dim'))
    out = torch.zeros((flat.numel(), width),
                      dtype=torch_dtype(op.attr('dtype', 'float32')))
    # shard fan-out is pipelined: every pserver looks its rows up
    # concurrently, the step pays the slowest shard's RTT once
    pending = []
    for i, ep in enumerate(epmap):
        m = (flat % n) == i
        if not bool(m.any()):
            continue
        pending.append(
            (m, _client(op, ep).prefetch_async(table, flat[m] // n)))
    err = None
    for m, fut in pending:
        try:
            out[m] = torch.as_tensor(fut.result())
        except BaseException as e:
            if err is None:
                err = e
    if err is not None:
        raise err
    ctx.set(op.single_output('Out'),
            out.reshape(tuple(shaped.shape) + (width,)).to(ctx.device))


register_op('prefetch', emit=_prefetch_emit, host=True, no_grad=True)


# -- listen_and_serv (the pserver) ------------------------------------------

def _host_numpy(val):
    """A scope value as a numpy array for a shard file (bf16 widened to
    fp32, exactly: numpy has no bf16)."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu()
        if val.dtype == torch.bfloat16:
            val = val.float()
        return val.numpy()
    return np.asarray(val)


def _listen_and_serv_emit(ctx, op):
    """Run this process as a parameter service until every trainer sends
    COMPLETE (reference listen_and_serv_op.cc RunSyncLoop :102 /
    RunAsyncLoop :178). Blocks the executor -- exactly like the reference
    op blocks its thread. The optimize blocks run on a CPU Executor over
    this op's scope: pservers are host services.

    attrs:
      endpoint        "host:port" to bind
      Fanin           number of trainers
      sync_mode       bool
      grad_to_block_id  ["gradname:block_idx", ...] -- optimize sub-block
                        per gradient var
      lr_block_id     block of cloned LR-schedule ops run once per round
                      (-1: none)
      prefetch_table  lookup-table param name served by PREFETCH ('' if
                      none); its var in scope is this server's shard
    """
    import os
    from ..distributed.param_service import ParameterService
    from ..distributed.rpc import PSServer
    from ..executor import CPUPlace, Executor
    from .io_ops import read_tensor, write_tensor

    program = ctx.block.program
    scope = ctx.scope
    exe = Executor(CPUPlace())
    sync_mode = op.attr('sync_mode', True)
    num_trainers = op.attr('Fanin', 1)
    lr_block = op.attr('lr_block_id', -1)
    grad_to_block = [e.split(':') for e in op.attr('grad_to_block_id', [])]
    grad_to_block = {g: int(b) for g, b in grad_to_block}

    def run_block(idx):
        exe.run_block(program, idx, scope)

    def run_round(merged):
        # deterministic order: lr schedule first, then each grad's block
        if lr_block >= 0:
            run_block(lr_block)
        for g in sorted(merged):
            scope.set_var(g, merged[g])
        for g in sorted(grad_to_block):
            if g in merged:
                run_block(grad_to_block[g])

    # async mode: the LR schedule must advance once per trainer STEP, not
    # once per gradient push -- tick it on arrivals of one designated grad
    # (each trainer pushes every grad exactly once per step)
    lr_trigger = min(grad_to_block) if grad_to_block else None

    def run_one_grad(name, value):       # async mode
        if lr_block >= 0 and name == lr_trigger:
            run_block(lr_block)
        scope.set_var(name, value)
        run_block(grad_to_block[name])

    def get_param(name):
        val = scope.find_var(name)
        if val is None:
            raise KeyError('pserver has no var %r' % name)
        val = torch.as_tensor(val)
        # the optimizer ops update in place: in async mode the next
        # update may land while this reply is being framed (after the
        # service lock is released), so the reply gets its own copy. In
        # sync mode no round can close before every trainer's pull of
        # the last one was answered.
        return val if sync_mode else val.clone()

    def prefetch(table, local_ids):
        shard = torch.as_tensor(scope.find_var(op.attr('prefetch_table')))
        return shard.index_select(0, torch.as_tensor(local_ids).long())

    def persistable_state():
        # every persistable non-grad var of this shard (the reference
        # runs the kCheckpointBlockId save block; here the save set is
        # derived from the program)
        for name, var in program.global_block().vars.items():
            if not var.persistable or name in grad_to_block:
                continue
            val = scope.find_var(name)
            if val is not None:
                yield name, val

    def save_params(dirname):
        os.makedirs(dirname, exist_ok=True)
        for name, val in persistable_state():
            with open(os.path.join(dirname, name), 'wb') as f:
                write_tensor(f, _host_numpy(val))

    def dump_state():
        # elastic-recovery snapshot: the same save set as save_params
        return dict(persistable_state())

    def load_state(params):
        for name, val in params.items():
            scope.set_var(name, torch.as_tensor(val))

    # the param blocks this shard hosts = the Param input of each
    # optimize sub-block (online refresh publishes versions + digest
    # manifests over exactly these; accumulators/LR vars stay private)
    param_names = []
    for g in sorted(grad_to_block):
        for blk_op in program.blocks[grad_to_block[g]].ops:
            if blk_op.input('Param'):
                p = blk_op.single_input('Param')
                if p not in param_names:
                    param_names.append(p)

    ckpt_dir = op.attr('checkpoint_dir', '')
    if ckpt_dir:
        # restore this shard from a checkpoint_notify save (the reload
        # half of pserver checkpointing) before serving
        for fn in sorted(os.listdir(ckpt_dir)):
            with open(os.path.join(ckpt_dir, fn), 'rb') as f:
                scope.set_var(fn, torch.from_numpy(np.array(read_tensor(f))))

    # elastic recovery: with FLAGS_ps_state_path the service restores
    # its snapshot + journal in __init__ (AFTER the checkpoint_dir load
    # above, so the newer mid-session state wins) and persists every
    # round from here on
    service = ParameterService(
        num_trainers=num_trainers, sync_mode=sync_mode,
        get_param=get_param, run_round=run_round,
        run_one_grad=run_one_grad,
        prefetch=prefetch if op.attr('prefetch_table', '') else None,
        save_params=save_params,
        dump_state=dump_state, load_state=load_state,
        param_names=param_names)
    server = PSServer(op.attr('endpoint'), service)
    server.serve_forever()


register_op('listen_and_serv', emit=_listen_and_serv_emit, host=True,
            no_grad=True)
