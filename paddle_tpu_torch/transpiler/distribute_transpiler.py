"""DistributeTranspiler: rewrite a local training program into trainer +
pserver programs for parameter-server mode (counterpart of
paddle_tpu/transpiler/distribute_transpiler.py: for one source program
it gives the JAX package's trainer, pserver and startup programs, op for
op -- the same ops, attrs, var names, blocks and slicing).

Behavior parity with reference python/paddle/fluid/transpiler/
distribute_transpiler.py (transpile :180, slice_variable :70,
get_trainer_program :371, get_pserver_program :464, distributed lookup
table :926-1158):

- The trainer's forward+backward stays on the device (one captured
  segment on the card); grads leave it only at the appended host send
  ops.
- Parameters are sliced into row blocks (dim-0 aligned, min_block_size
  elements) and round-robin dispatched to pservers; trainers split grads
  (device `split` op for dense, host `split_selected_rows` for sparse),
  push, barrier, pull fresh blocks, and `concat` them back.
- Gradient merging (sum / trainer_num) happens in the parameter service
  itself (param_service.py) rather than via emitted sum/scale ops.
- A lookup table marked `is_distributed=True` is mod-sharded across
  pservers: the trainer-side `lookup_table` op is REPLACED by a host
  `prefetch` op (remote row fetch), its sparse gradient is routed with
  `split_ids`, and each pserver owns shard rows `i, i+n, i+2n, ...`
  stored compactly (global id g lives on pserver g%%n at local row g//n).

Initial values: pserver startup programs re-run the original initializer
ops and slice out the locally-owned rows, and the trainer's startup
program (`get_trainer_startup_program`) ends with the trainer program's
own tail -- `recv` of every owned block, `fetch_barrier`, `concat` -- so
a trainer starts from the pservers' values whatever device drew its own.
The port needs that pull: its random ops draw from a generator on the
place's device, and a CUDA and a CPU generator with one seed give
different numbers, so a trainer on the card and a pserver on the host
would otherwise start apart.
"""
from __future__ import annotations

import math

from ..framework import (Program, default_main_program,
                         default_startup_program, grad_var_name)
from .ps_dispatcher import RoundRobin, PSDispatcher   # noqa: F401
from .ps_dispatcher import HashName                    # noqa: F401

__all__ = ['DistributeTranspiler', 'DistributeTranspilerConfig']

LOOKUP_TABLE_TYPE = 'lookup_table'


class DistributeTranspilerConfig(object):
    """slice_var_up: split large params into row blocks across pservers.
    min_block_size: do not split below this many elements (reference
    default 8192). split_method: PSDispatcher subclass."""
    slice_var_up = True
    min_block_size = 8192
    split_method = RoundRobin


class _VarBlockInfo(object):
    """One row-slice of one (param, grad) pair, assigned to a pserver."""
    __slots__ = ('param', 'grad', 'pname', 'gname', 'offset', 'rows',
                 'ep', 'sparse', 'block_idx', 'split_count')

    def __init__(self, param, grad, pname, gname, offset, rows, sparse,
                 block_idx, split_count):
        self.param = param          # origin param Variable
        self.grad = grad            # origin grad var name
        self.pname = pname          # trainer/pserver block var name
        self.gname = gname
        self.offset = offset        # starting row in the origin param
        self.rows = rows
        self.ep = None
        self.sparse = sparse
        self.block_idx = block_idx
        self.split_count = split_count

    def __str__(self):
        # the dispatch identity (HashName hashes this): the block name
        return self.pname


class DistributeTranspiler(object):
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    # ------------------------------------------------------------------
    def checkpoint_notify_program(self, dirname):
        """A one-op program asking every pserver of this transpile to
        save its shard under dirname/<endpoint> (reference injects
        checkpoint_notify into the trainer checkpoint flow;
        Trainer/CheckpointConfig(pserver_endpoints=...) does the same
        automatically)."""
        return build_checkpoint_notify_program(
            dirname, self.pserver_endpoints, self.trainer_id)

    def transpile(self, trainer_id, program=None, pservers='', trainers=1,
                  sync_mode=True, startup_program=None):
        self.origin_program = program or default_main_program()
        self.startup_program = startup_program or default_startup_program()
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.pserver_endpoints = [e.strip() for e in pservers.split(',')
                                  if e.strip()]
        if not self.pserver_endpoints:
            raise ValueError('transpile needs at least one pserver endpoint')

        block = self.origin_program.global_block()
        self._producers = {}
        for op in block.ops:
            for n in op.output_arg_names():
                self._producers[n] = op

        self._find_opt_ops(block)
        self._find_distributed_table(block)
        self._slice_params()
        self._find_lr_chain(block)
        self._build_trainer_program()

    # ------------------------------------------------------------------
    def _find_opt_ops(self, block):
        self.opt_ops = [op for op in block.ops
                        if op.attr('op_role') == 'optimize'
                        and op.input('Param')]
        if not self.opt_ops:
            raise ValueError('no optimizer ops found — call '
                             'optimizer.minimize before transpile')
        self.opt_op_by_param = {op.single_input('Param'): op
                                for op in self.opt_ops}

    def _find_distributed_table(self, block):
        self.table_name = None
        names = set()
        for op in block.ops:
            if op.type == LOOKUP_TABLE_TYPE and op.attr('is_distributed',
                                                        False):
                names.add(op.single_input('W'))
                if not op.attr('is_sparse', False):
                    raise ValueError('a distributed lookup table requires '
                                     'is_sparse=True')
        if len(names) > 1:
            raise ValueError('only one distributed lookup table is '
                             'supported (got %s)' % sorted(names))
        if names:
            self.table_name = names.pop()
            if self.table_name not in self.opt_op_by_param:
                raise ValueError('distributed lookup table %r has no '
                                 'optimizer op' % self.table_name)

    def _grad_is_sparse(self, gname, _depth=0):
        """Does this grad var carry a SelectedRows at runtime? Walk the
        producing ops (sum of sparse is sparse; scale keeps sparsity)."""
        if _depth > 8:
            return False
        op = self._producers.get(gname)
        if op is None:
            return False
        if op.type == 'lookup_table_grad':
            return bool(op.attr('is_sparse', False))
        if op.type in ('sum', 'scale', 'clip_by_norm'):
            ins = op.input('X')
            return bool(ins) and all(
                self._grad_is_sparse(n, _depth + 1) for n in ins)
        if op.type in ('elementwise_mul', 'elementwise_div'):
            # scalar rescale keeps SelectedRows (the global-norm clip
            # path: mul(grad, 0-d scale) stays sparse in the emitter)
            try:
                y = self.origin_program.global_block().var_recursive(
                    op.single_input('Y'))
                y_scalar = len(y.shape or ()) == 0
            except KeyError:
                y_scalar = False
            return y_scalar and self._grad_is_sparse(
                op.single_input('X'), _depth + 1)
        return False

    # ------------------------------------------------------------------
    def _slice_params(self):
        """Split each non-table (param, grad) into row blocks and dispatch
        them (reference slice_variable + _init_splited_vars)."""
        eps = self.pserver_endpoints
        dispatcher = self.config.split_method(eps)
        self.var_blocks = []            # ordered _VarBlockInfo
        for op in self.opt_ops:
            p = op.single_input('Param')
            if p == self.table_name:
                continue
            param = self.origin_program.global_block().var(p)
            g = op.single_input('Grad')
            sparse = self._grad_is_sparse(g)
            shape = tuple(param.shape)
            numel = 1
            for d in shape:
                numel *= d
            split_count = 1
            if self.config.slice_var_up and len(eps) > 1:
                max_blocks = max(1, numel // self.config.min_block_size)
                split_count = min(len(eps), max_blocks, shape[0])
            rows_per = int(math.ceil(shape[0] / float(split_count)))
            # re-derive the real count after row alignment
            split_count = int(math.ceil(shape[0] / float(rows_per)))
            for j in range(split_count):
                offset = j * rows_per
                rows = min(rows_per, shape[0] - offset)
                suffix = '' if split_count == 1 else '.block%d' % j
                info = _VarBlockInfo(param, g, p + suffix,
                                     g + suffix, offset, rows, sparse,
                                     j, split_count)
                self.var_blocks.append(info)
        for info, ep in zip(self.var_blocks,
                            dispatcher.dispatch(self.var_blocks)):
            info.ep = ep

    # ------------------------------------------------------------------
    def _find_lr_chain(self, block):
        """Ops computing the optimizer LearningRate inputs (LR schedules)
        — cloned onto every pserver, run once per round (reference
        _get_lr_ops moves them; we replicate, which keeps a trainer-side
        fetch of the LR var working)."""
        lr_names = {op.single_input('LearningRate') for op in self.opt_ops}
        chain, seen = [], set()
        stack = sorted(lr_names)
        while stack:
            n = stack.pop()
            op = self._producers.get(n)
            if op is None or id(op) in seen:
                continue
            if op.attr('op_role') in ('backward', 'optimize'):
                continue
            seen.add(id(op))
            chain.append(op)
            stack.extend(op.input_arg_names())
        order = {id(op): i for i, op in enumerate(block.ops)}
        chain.sort(key=lambda op: order[id(op)])
        self.lr_chain_ops = chain
        self.lr_var_names = lr_names

    # ------------------------------------------------------------------
    # trainer side
    # ------------------------------------------------------------------
    def _build_trainer_program(self):
        prog = self.origin_program.clone()
        block = prog.global_block()
        eps = self.pserver_endpoints

        # 1. drop optimizer ops (they move to the pservers)
        block.ops[:] = [op for op in block.ops
                        if op.attr('op_role') != 'optimize'
                        or not op.input('Param')]

        # 2. distributed lookup table rewiring
        if self.table_name is not None:
            self._rewrite_table_ops(prog)

        send_names, send_eps = [], []
        recv_names, recv_eps = [], []

        # 3. split grads into blocks
        for p, infos in self._blocks_by_param().items():
            if infos[0].split_count == 1:
                info = infos[0]
                send_names.append(info.gname)
                send_eps.append(info.ep)
                recv_names.append(info.pname)
                recv_eps.append(info.ep)
                continue
            g = infos[0].grad
            sections = [i.rows for i in infos]
            for info in infos:
                if not block.has_var(info.gname):
                    block.create_var(
                        name=info.gname,
                        shape=(info.rows,) + tuple(info.param.shape[1:]),
                        dtype=info.param.dtype, persistable=False)
                if not block.has_var(info.pname):
                    block.create_var(
                        name=info.pname,
                        shape=(info.rows,) + tuple(info.param.shape[1:]),
                        dtype=info.param.dtype, persistable=False)
            if infos[0].sparse:
                block.append_op(
                    type='split_selected_rows', inputs={'X': [g]},
                    outputs={'Out': [i.gname for i in infos]},
                    attrs={'height_sections': sections, 'op_role': 'rpc'})
            else:
                block.append_op(
                    type='split', inputs={'X': [g]},
                    outputs={'Out': [i.gname for i in infos]},
                    attrs={'sections': sections, 'axis': 0,
                           'op_role': 'rpc'})
            for info in infos:
                send_names.append(info.gname)
                send_eps.append(info.ep)
                recv_names.append(info.pname)
                recv_eps.append(info.ep)

        # 4. table grad shards
        if self.table_name is not None:
            tgrad = grad_var_name(self.table_name)
            shard_names = ['%s.shard%d' % (tgrad, i)
                           for i in range(len(eps))]
            width = tuple(self._table_shape[1:])
            for i, n in enumerate(shard_names):
                rows = (self._table_shape[0] + len(eps) - 1 - i) // len(eps)
                block.create_var(name=n, shape=(rows,) + width,
                                 dtype=self._table_dtype, persistable=False)
            block.append_op(
                type='split_ids', inputs={'Ids': [tgrad]},
                outputs={'Out': shard_names}, attrs={'op_role': 'rpc'})
            send_names.extend(shard_names)
            send_eps.extend(eps)

        # 5. send / barriers / recv / concat
        rpc = {'op_role': 'rpc', 'trainer_id': self.trainer_id}
        block.append_op(type='send', inputs={'X': send_names},
                        outputs={},
                        attrs=dict(rpc, epmap=send_eps,
                                   sync_mode=self.sync_mode))
        if self.sync_mode:
            block.append_op(type='send_barrier', inputs={}, outputs={},
                            attrs=dict(rpc, endpoints=eps))
        block.append_op(type='recv', inputs={},
                        outputs={'Out': recv_names},
                        attrs=dict(rpc, epmap=recv_eps))
        if self.sync_mode:
            block.append_op(type='fetch_barrier', inputs={}, outputs={},
                            attrs=dict(rpc, endpoints=eps))
        for p, infos in self._blocks_by_param().items():
            if infos[0].split_count > 1:
                block.append_op(
                    type='concat',
                    inputs={'X': [i.pname for i in infos]},
                    outputs={'Out': [p]},
                    attrs={'axis': 0, 'op_role': 'rpc'})
        self.trainer_program = prog

    def _blocks_by_param(self):
        by_param = {}
        for info in self.var_blocks:
            by_param.setdefault(info.param.name, []).append(info)
        return by_param

    def _rewrite_table_ops(self, prog):
        """Replace lookup_table(is_distributed) with prefetch; strip W
        from its grad op; drop the table param + its initializer from the
        trainer (the trainer never materializes the table)."""
        block = prog.global_block()
        table = self.table_name
        tvar = block.var(table)
        self._table_shape = tuple(tvar.shape)
        self._table_dtype = tvar.dtype or 'float32'
        eps = self.pserver_endpoints
        for i, op in enumerate(list(block.ops)):
            if op.type == LOOKUP_TABLE_TYPE and \
                    op.input('W') == [table]:
                new = block._insert_op(
                    i, type='prefetch',
                    inputs={'Ids': op.input('Ids')},
                    outputs={'Out': op.output('Out')},
                    attrs={'table_name': table, 'epmap': eps,
                           'emb_dim': int(self._table_shape[1]),
                           'dtype': self._table_dtype,
                           'trainer_id': self.trainer_id,
                           'op_role': 'rpc'})
                block.ops.remove(op)
                assert block.ops[i] is new
            elif op.type == 'lookup_table_grad' and \
                    op.input('W') == [table]:
                op.inputs.pop('W')
                op.attrs['__table_shape__'] = list(self._table_shape)
                op.attrs['__table_dtype__'] = str(self._table_dtype)
        block.vars.pop(table, None)
        # the trainer must not materialize the table, but the pserver
        # startup still needs its initializer ops -- save them first
        sb = self.startup_program.global_block()
        self._table_init_ops = [op for op in sb.ops
                                if table in op.output_arg_names()]
        sb.ops[:] = [op for op in sb.ops
                     if table not in op.output_arg_names()]
        sb.vars.pop(table, None)

    def get_trainer_program(self):
        return self.trainer_program

    # ------------------------------------------------------------------
    # pserver side
    # ------------------------------------------------------------------
    def _owned_blocks(self, endpoint):
        return [i for i in self.var_blocks if i.ep == endpoint]

    def _acc_slots(self, opt_op, param):
        """Accumulator input slots of an optimizer op: [(slot, var, sliced
        like the param?)]. Sliced = leading dim matches the param's (Adam
        moments...); everything else (Beta1Pow...) is copied per block."""
        out = []
        block = self.origin_program.global_block()
        for slot, names in opt_op.inputs.items():
            if slot in ('Param', 'Grad', 'LearningRate'):
                continue
            for n in names:
                v = block.var_recursive(n)
                sliced = tuple(v.shape) == tuple(param.shape)
                out.append((slot, v, sliced))
        return out

    def get_pserver_program(self, endpoint):
        prog = Program()
        g0 = prog.global_block()
        eps = self.pserver_endpoints
        owned = self._owned_blocks(endpoint)
        grad_to_block_id = []

        # LR vars + schedule chain (cloned; run once per round)
        for n in sorted(self.lr_var_names):
            v = self.origin_program.global_block().var_recursive(n)
            if not g0.has_var(n):
                g0.create_var(name=n, shape=v.shape, dtype=v.dtype,
                              persistable=True)
        lr_block_id = -1
        if self.lr_chain_ops:
            lrb = prog._create_block(parent_idx=0)
            for op in self.lr_chain_ops:
                for n in list(op.input_arg_names()) + \
                        list(op.output_arg_names()):
                    src = self.origin_program.global_block().var_recursive(n)
                    if src.persistable and not g0.has_var(n):
                        g0.create_var(name=n, shape=src.shape,
                                      dtype=src.dtype, persistable=True)
                    elif not src.persistable and not lrb.has_var(n) \
                            and not g0.has_var(n):
                        lrb.create_var(name=n, shape=src.shape,
                                       dtype=src.dtype, persistable=False)
                lrb.append_op(type=op.type,
                              inputs={k: list(v) for k, v in
                                      op.inputs.items()},
                              outputs={k: list(v) for k, v in
                                       op.outputs.items()},
                              attrs=dict(op.attrs))
            lr_block_id = lrb.idx
            prog._rollback()

        # one optimize block per owned param block
        for info in owned:
            opt_op = self.opt_op_by_param[info.param.name]
            bshape = (info.rows,) + tuple(info.param.shape[1:])
            g0.create_var(name=info.pname, shape=bshape,
                          dtype=info.param.dtype, persistable=True)
            g0.create_var(name=info.gname, shape=bshape,
                          dtype=info.param.dtype, persistable=True)
            rename = {info.param.name: info.pname, info.grad: info.gname}
            for slot, v, sliced in self._acc_slots(opt_op, info.param):
                suffix = '' if info.split_count == 1 \
                    else '.block%d' % info.block_idx
                accname = v.name + suffix
                shape = ((info.rows,) + tuple(v.shape[1:]) if sliced
                         else tuple(v.shape))
                if not g0.has_var(accname):
                    g0.create_var(name=accname, shape=shape, dtype=v.dtype,
                                  persistable=True)
                rename[v.name] = accname
            ob = prog._create_block(parent_idx=0)
            ob.append_op(
                type=opt_op.type,
                inputs={k: [rename.get(n, n) for n in v]
                        for k, v in opt_op.inputs.items()},
                outputs={k: [rename.get(n, n) for n in v]
                         for k, v in opt_op.outputs.items()},
                attrs=dict(opt_op.attrs))
            grad_to_block_id.append('%s:%d' % (info.gname, ob.idx))
            prog._rollback()

        # distributed lookup table shard + its optimize block
        prefetch_table = ''
        if self.table_name is not None:
            shard_i = eps.index(endpoint)
            n = len(eps)
            shard_rows = (self._table_shape[0] + n - 1 - shard_i) // n
            tshape = (shard_rows,) + tuple(self._table_shape[1:])
            g0.create_var(name=self.table_name, shape=tshape,
                          dtype=self._table_dtype, persistable=True)
            tgrad = '%s.shard%d' % (grad_var_name(self.table_name), shard_i)
            g0.create_var(name=tgrad, shape=tshape,
                          dtype=self._table_dtype, persistable=True)
            opt_op = self.opt_op_by_param[self.table_name]
            rename = {grad_var_name(self.table_name): tgrad}
            proxy = _TableParamProxy(self._table_shape)
            for slot, v, sliced in self._acc_slots(opt_op, proxy):
                accname = v.name + '.shard%d' % shard_i
                shape = ((shard_rows,) + tuple(v.shape[1:]) if sliced
                         else tuple(v.shape))
                if not g0.has_var(accname):
                    g0.create_var(name=accname, shape=shape, dtype=v.dtype,
                                  persistable=True)
                rename[v.name] = accname
            ob = prog._create_block(parent_idx=0)
            ob.append_op(
                type=opt_op.type,
                inputs={k: [rename.get(x, x) for x in v]
                        for k, v in opt_op.inputs.items()},
                outputs={k: [rename.get(x, x) for x in v]
                         for k, v in opt_op.outputs.items()},
                attrs=dict(opt_op.attrs))
            grad_to_block_id.append('%s:%d' % (tgrad, ob.idx))
            prog._rollback()
            prefetch_table = self.table_name

        g0.append_op(
            type='listen_and_serv', inputs={}, outputs={},
            attrs={'endpoint': endpoint,
                   'Fanin': self.trainer_num,
                   'sync_mode': self.sync_mode,
                   'grad_to_block_id': grad_to_block_id,
                   'lr_block_id': lr_block_id,
                   'prefetch_table': prefetch_table,
                   'op_role': 'rpc'})
        return prog

    def get_pserver_programs(self, endpoint, checkpoint_dir=None):
        """checkpoint_dir: a directory previously written by
        checkpoint_notify (one shard subdir per pserver): the pserver
        restores its shard from it before serving — the restore half of
        pserver checkpointing (reference pservers reload via their
        startup load block). Shards resolve by this endpoint's saved
        subdir, falling back to CONTENT matching (the subdir holding
        this pserver's own uniquely-named param blocks) so a restarted
        cluster on fresh ports still restores the right shards;
        ambiguous matches raise instead of guessing."""
        main = self.get_pserver_program(endpoint)
        if checkpoint_dir:
            import os
            shard = os.path.join(checkpoint_dir,
                                 endpoint.replace(':', '_'))
            if not os.path.isdir(shard):
                subdirs = sorted(
                    d for d in os.listdir(checkpoint_dir)
                    if os.path.isdir(os.path.join(checkpoint_dir, d)))
                if len(subdirs) != len(self.pserver_endpoints):
                    raise ValueError(
                        'checkpoint %r holds %d shard dirs for %d '
                        'pservers' % (checkpoint_dir, len(subdirs),
                                      len(self.pserver_endpoints)))
                # match the shard by CONTENT: each shard holds this
                # pserver's uniquely-named param blocks (w1.block0 …).
                # A positional fallback (sorted subdir i for pserver i)
                # was WRONG: subdirs sort lexicographically by the OLD
                # endpoint strings, which orders by port STRING — when
                # the old ports' string order differed from their
                # position order, a restarted cluster silently loaded
                # SWAPPED shards (the restore-half flake this replaces).
                my_vars = set(main.global_block().vars)
                scores = []
                for d in subdirs:
                    files = set(os.listdir(
                        os.path.join(checkpoint_dir, d)))
                    scores.append((len(files & my_vars), d))
                scores.sort(reverse=True)
                best = scores[0]
                if best[0] == 0:
                    raise ValueError(
                        'no shard dir under %r contains vars of pserver '
                        '%s (vars: %r)' % (checkpoint_dir, endpoint,
                                           sorted(my_vars)[:8]))
                if len(scores) > 1 and scores[1][0] == best[0]:
                    # shared-name files (learning_rate_0 …) appear in
                    # every shard; a TIE means this pserver has no
                    # distinguishing vars and guessing would silently
                    # restore another pserver's (or a duplicate) shard
                    raise ValueError(
                        'ambiguous checkpoint restore: shard dirs %r '
                        'match pserver %s equally (%d vars) — restore '
                        'with the original endpoints instead'
                        % ([d for sc, d in scores if sc == best[0]],
                           endpoint, best[0]))
                shard = os.path.join(checkpoint_dir, best[1])
            lsv = main.global_block().ops[-1]
            assert lsv.type == 'listen_and_serv'
            lsv.attrs['checkpoint_dir'] = shard
        return main, self.get_startup_program(endpoint, main)

    # ------------------------------------------------------------------
    def get_startup_program(self, endpoint, pserver_program=None):
        """Initialize this pserver's vars by re-running the origin
        initializer ops and slicing out the owned rows (contiguous blocks
        for dense slices, strided rows for the mod-sharded table)."""
        if pserver_program is None:
            pserver_program = self.get_pserver_program(endpoint)
        eps = self.pserver_endpoints
        sp = Program()
        sp.random_seed = self.startup_program.random_seed
        blk = sp.global_block()
        origin_sb = self.startup_program.global_block()

        init_by_out = {}
        for op in list(origin_sb.ops) + list(
                getattr(self, '_table_init_ops', [])):
            for n in op.output_arg_names():
                init_by_out.setdefault(n, []).append(op)

        def origin_name_and_slice(name, var):
            """pserver var name -> (origin var name, start, end, step).
            start=None means a whole (unsliced) clone. The slice applies
            only when the pserver var is actually smaller than the origin
            — per-block copies of scalar accumulators (Beta1Pow.block1)
            share the origin's shape and clone whole."""
            if self.table_name is not None:
                shard_i = eps.index(endpoint)
                base = None
                if name == self.table_name:
                    base = name
                elif name.endswith('.shard%d' % shard_i):
                    base = name[:-len('.shard%d' % shard_i)]
                if base is not None:
                    ov = self._origin_var(base)
                    if ov is not None and tuple(ov.shape) == \
                            tuple(var.shape):
                        return base, None, None, 1
                    return base, shard_i, None, len(eps)
            if '.block' in name:
                base, bidx = name.rsplit('.block', 1)
                ov = self._origin_var(base)
                if ov is not None and tuple(ov.shape) == tuple(var.shape):
                    return base, None, None, 1
                for info in self.var_blocks:
                    if info.block_idx == int(bidx) and (
                            info.pname == name or
                            name in self._acc_names_for(info)):
                        return base, info.offset, info.offset + info.rows, 1
                return base, None, None, 1
            # unsuffixed: could still be a slice (unsplit var wholly
            # assigned here has full shape -> whole clone)
            ov = self._origin_var(name)
            if ov is not None and tuple(ov.shape) != tuple(var.shape):
                for info in self.var_blocks:
                    if info.pname == name:
                        return name, info.offset, info.offset + info.rows, 1
            return name, None, None, 1

        for name, var in pserver_program.global_block().vars.items():
            if '@GRAD' in name:
                continue    # grads arrive over RPC, not from init
            origin, start, end, step = origin_name_and_slice(name, var)
            init_ops = init_by_out.get(origin, [])
            if not init_ops:
                continue
            if start is None:
                blk.create_var(name=name, shape=var.shape, dtype=var.dtype,
                               persistable=True)
                for op in init_ops:
                    blk.append_op(type=op.type,
                                  inputs={k: list(v) for k, v in
                                          op.inputs.items()},
                                  outputs={k: [name if x == origin else x
                                               for x in v]
                                           for k, v in op.outputs.items()},
                                  attrs=dict(op.attrs))
                continue
            # full init into a temp, then slice the owned rows
            ovar = self._origin_var(origin)
            if ovar is None:
                continue
            tmp = '%s@FULLINIT.%s' % (origin, name)
            blk.create_var(name=tmp, shape=tuple(ovar.shape),
                           dtype=getattr(ovar, 'dtype', var.dtype) or
                           var.dtype, persistable=False)
            blk.create_var(name=name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
            for op in init_ops:
                blk.append_op(type=op.type,
                              inputs={k: list(v) for k, v in
                                      op.inputs.items()},
                              outputs={k: [tmp if x == origin else x
                                           for x in v]
                                       for k, v in op.outputs.items()},
                              attrs=dict(op.attrs))
            blk.append_op(type='slice_rows', inputs={'X': [tmp]},
                          outputs={'Out': [name]},
                          attrs={'start': start if start is not None else 0,
                                 'end': end if end is not None else -1,
                                 'step': step})
            blk.append_op(type='delete_var', inputs={'X': [tmp]},
                          outputs={}, attrs={})
        return sp

    def _acc_names_for(self, info):
        opt_op = self.opt_op_by_param[info.param.name]
        suffix = '' if info.split_count == 1 else '.block%d' % info.block_idx
        return {v.name + suffix
                for _, v, _s in self._acc_slots(opt_op, info.param)}

    def _origin_var(self, name):
        block = self.origin_program.global_block()
        if block.has_var(name):
            return block.var(name)
        if name == self.table_name:
            return _TableParamProxy(self._table_shape)
        sb = self.startup_program.global_block()
        return sb.vars.get(name)

    # ------------------------------------------------------------------
    def get_trainer_startup_program(self):
        """Origin startup + pull the authoritative initial parameters
        from the pservers (reference _get_trainer_startup_program)."""
        sp = self.startup_program.clone()
        block = sp.global_block()
        recv_names, recv_eps = [], []
        for p, infos in self._blocks_by_param().items():
            for info in infos:
                if not block.has_var(info.pname):
                    block.create_var(
                        name=info.pname,
                        shape=(info.rows,) + tuple(info.param.shape[1:]),
                        dtype=info.param.dtype,
                        persistable=(info.split_count == 1))
                recv_names.append(info.pname)
                recv_eps.append(info.ep)
        rpc = {'op_role': 'rpc', 'trainer_id': self.trainer_id}
        block.append_op(type='recv', inputs={}, outputs={'Out': recv_names},
                        attrs=dict(rpc, epmap=recv_eps))
        block.append_op(type='fetch_barrier', inputs={}, outputs={},
                        attrs=dict(rpc, endpoints=self.pserver_endpoints))
        for p, infos in self._blocks_by_param().items():
            if infos[0].split_count > 1:
                block.append_op(type='concat',
                                inputs={'X': [i.pname for i in infos]},
                                outputs={'Out': [p]},
                                attrs={'axis': 0, 'op_role': 'rpc'})
        return sp


class _TableParamProxy(object):
    """Shape-only stand-in for the (removed) table param when classifying
    accumulator slots."""
    def __init__(self, shape):
        self.shape = tuple(shape)
        self.name = '__table__'


def build_checkpoint_notify_program(dirname, endpoints, trainer_id=0):
    """One-op program emitting checkpoint_notify to `endpoints` — shared
    by DistributeTranspiler.checkpoint_notify_program and the Trainer
    save flow."""
    prog = Program()
    prog.global_block().append_op(
        type='checkpoint_notify', inputs={}, outputs={},
        attrs={'dirname': dirname, 'endpoints': list(endpoints),
               'trainer_id': int(trainer_id)})
    return prog
