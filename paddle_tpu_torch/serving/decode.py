"""DecodePredictor: cached prefill/decode execution over a slot pool
(counterpart of paddle_tpu/serving/decode.py).

Scope layout:

    base Predictor Scope (weights, on the device, shared)
        └── this DecodePredictor's child Scope (K/V ring caches)

Every clone() gets a fresh child Scope (private caches, zeroed) over the
same parent, so N serving workers share one copy of the weights. The
cache ops update the child Scope's tensors in place, and reset() zeroes
them in place.

Weight refresh: stage_weights() puts a {name: tensor or array} update
on the device off the decode path; install_weights() binds the staged
tensors in the parent Scope (ServingEngine.request_swap runs it at a
step boundary). param_digests() is the crc32 of each served weight's
wire payload, the digest a parameter server stamps into its manifest.
A captured graph reads the tensors it captured, so each worker's next
replay copies the newly bound value into them
(executor.Executor._replay): no worker captures again for a swap.

On a serving mesh (mesh=, serving/mesh.py) the programs run on the
group's rank processes: the K/V state lives there, heads-sharded, and
each rank holds its part of every weight under DecodeSpec's serve spec,
sent once a weight scope from this process's whole values. Host
decisions stay here. stage_weights / install_weights, load_sharded and
param_digests then act on the ranks' weights (digests over the whole
values, gathered); the base predictor's scope is not written.
"""
from __future__ import annotations

import numpy as np
import torch

from ..executor import Executor, Scope
from ..flags import get_flag

__all__ = ['DecodePredictor']


class DecodePredictor(object):
    paged = False
    speculative = False

    def __init__(self, predictor, slots=None, prefill_batch=None,
                 _clone_of=None, mesh=None):
        """predictor: a loaded Predictor/AnalysisPredictor whose program
        is a decoder-only LM (prefer AnalysisPredictor.prepare_decoding).
        slots / prefill_batch default to FLAGS_serving_slots /
        FLAGS_serving_prefill_batch. mesh (None: FLAGS_serve_mesh_shape;
        '' = one device; 'tp=2', a MeshConfig or a Mesh) runs every
        program over a serving mesh (serving/mesh.py)."""
        if _clone_of is not None:
            pair = _clone_of._pair
        else:
            from ..transpiler.decode_transpiler import DecodeTranspiler
            pair = DecodeTranspiler().transpile(
                predictor._program,
                slots=int(slots or get_flag('serving_slots')),
                prefill_batch=int(prefill_batch
                                  or get_flag('serving_prefill_batch')))
        self._setup(predictor, pair, check=_clone_of is None, mesh=mesh,
                    clone_of=_clone_of)

    def _setup(self, predictor, pair, check, mesh=None, clone_of=None):
        """Bind the transpiled `pair` to the predictor's weight Scope
        (checked unless this is a clone), with a private executor and
        cache Scope; on a serving mesh the executor is the predictor's
        station on the group's ranks."""
        from .mesh import serving_mesh
        self._base = predictor
        self._pair = pair
        if clone_of is not None:
            self._mesh, self._mesh_shape = clone_of._mesh, \
                clone_of._mesh_shape
        else:
            self._mesh, self._mesh_shape = serving_mesh(mesh)
            pair.spec.mesh = self._mesh_shape
        if check:
            self._check_weights(predictor._scope)
        self._weight_scope = predictor._scope
        self._closed = False
        if self._mesh is not None and self._mesh.size > 1:
            self._exe = self._open_station(predictor._place)
        else:
            self._exe = Executor(predictor._place)
        self._scope = Scope(parent=self._weight_scope)
        self.reset()

    def _state_shape(self):
        return self._pair.spec.cache_shape(self.slots)

    def _open_station(self, place):
        from ..parallel.mesh import fit_spec
        from .mesh import open_station
        shape = self._state_shape()
        return open_station(
            self._mesh, place, self._weight_scope, self._param_specs(),
            self.param_names(), self._pair.cache_names, shape,
            fit_spec(self._pair.spec.cache_spec(), shape, self._mesh),
            place, self)

    def _param_specs(self):
        """{param name: its spec on the serving mesh}: the serve spec
        (column-style only) fit to the mesh, None (replicated) for the
        rest."""
        from ..parallel.mesh import fit_spec
        serve = self._pair.spec.serve_param_specs()
        out = {}
        for name in self.param_names():
            spec = serve.get(name)
            val = self._weight_scope.find_var(name)
            shape = getattr(val, 'shape', None)
            out[name] = fit_spec(spec, tuple(shape), self._mesh) \
                if spec is not None and shape is not None else None
        return out

    @property
    def _remote(self):
        return not isinstance(self._exe, Executor)

    def _check_weights(self, scope):
        for name in self._pair.spec.param_names():
            if not isinstance(scope.find_var(name), torch.Tensor):
                raise RuntimeError(
                    'decode transpile references param %r that is not in '
                    'the predictor scope — was the model loaded with '
                    'load_params=True?' % name)

    def close(self):
        """Release this predictor's station on its serving mesh (the
        group's ranks exit with the last one); on a mesh it serves
        nothing after it. On one device it does nothing."""
        if self._closed:
            return
        self._closed = True
        if self._remote:
            self._exe.close()

    # -- mesh introspection ------------------------------------------------
    @property
    def mesh_shape(self):
        """'tp=2'-style axis spec ('' = one device), surfaced through
        ServingEngine.stats() and SRV_HEALTH."""
        return self._mesh_shape

    @property
    def mesh_devices(self):
        return int(self._mesh.size) if self._mesh is not None else 1

    # -- introspection -----------------------------------------------------
    @property
    def slots(self):
        return self._pair.slots

    @property
    def prefill_batch(self):
        return self._pair.prefill_batch

    @property
    def max_len(self):
        return self._pair.spec.max_len

    @property
    def vocab(self):
        return self._pair.spec.vocab

    @property
    def device(self):
        return self._exe.device

    def jit_cache_stats(self):
        """The executor's prepared programs and captured segments
        (Executor.jit_cache_stats): after a generation loop, 2 prepared
        programs (prefill, decode), each captured once on the card."""
        return self._exe.jit_cache_stats()

    # -- weights -----------------------------------------------------------
    def param_names(self):
        """The refreshable weight names: every transpile-referenced
        param minus the runtime cache vars."""
        cache_names = set(self._pair.cache_names)
        return [n for n in self._pair.spec.param_names()
                if n not in cache_names]

    def param_digests(self):
        """{name: crc32 of the param's wire payload} over the served
        weights: the digest a pserver stamps into its manifest, so a
        fleet deploy can prove a replica converged to a published
        version without shipping the bytes again. A weight on the card
        is read through its host copy, one on a mesh gathered whole from
        the ranks; bf16 hashes its 2-byte pattern, as the JAX package's
        does."""
        from ..distributed import wire
        from ..integrity import crc32
        names = self.param_names()
        if self._remote:
            vals = self._exe.weights(names)
        else:
            vals = {n: self._weight_scope.find_var(n) for n in names}
        return {name: crc32(wire._payload_of(vals[name])[1])
                for name in names}

    def stage_weights(self, params):
        """Stage a {name: tensor or array} weight update for install:
        names are checked against the decode programs' params, shapes
        against the served values, and every value is copied to the
        device OFF the decode path (a CPU tensor from the wire goes to
        the card as it is, bf16 included; a numpy array through
        torch.from_numpy). On a mesh the staged values stay whole on
        the host; install sends each rank its part. Returns an opaque
        staged dict for install_weights; raises (staging nothing) on an
        unknown name or a shape mismatch."""
        known = set(self.param_names())
        staged = {}
        for name, val in params.items():
            if name not in known:
                raise KeyError(
                    'refresh carries unknown param %r (this predictor '
                    'serves %d params)' % (name, len(known)))
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.ascontiguousarray(val))
            cur = self._weight_scope.find_var(name)
            if tuple(cur.shape) != tuple(val.shape):
                raise ValueError(
                    'refresh shape mismatch for %r: got %r, serving %r'
                    % (name, tuple(val.shape), tuple(cur.shape)))
            device = 'cpu' if self._remote else self.device
            staged[name] = val.detach().to(device=device, dtype=cur.dtype,
                                           copy=True)
        return staged

    def install_weights(self, staged):
        """Bind staged tensors in the PARENT weight Scope: a few dict
        writes, cheap enough for the serving engine's step-boundary swap
        gate. Every clone reads the new weights from its next step on
        (shared parent Scope; a captured graph gets them copied in at
        its next replay). On a mesh each rank binds its part."""
        if self._remote:
            self._exe.install(staged)
            return
        for name, val in staged.items():
            self._weight_scope.set_var(name, val)

    def load_sharded(self, ckpt_dir, mesh=None):
        """Replace the weights from a sharded checkpoint root
        (checkpoint/sharded.py's two-generation layout) saved on any
        training topology: on one device each referenced param is read
        whole to this predictor's device; on its serving mesh each rank
        reads only its own region, under the weight's SERVE spec
        (column-style only; the spec recorded at save, the training
        layout, is deliberately not used: a row-sharded weight would
        change the decode's reduction order). mesh: None or this
        predictor's own mesh. The cache vars are runtime state, never
        checkpointed, never touched here. Raises if no generation is
        loadable or a referenced param is absent."""
        from ..checkpoint import restore as restore_mod
        from .mesh import serving_mesh
        if mesh is not None and serving_mesh(mesh)[1] != self._mesh_shape:
            raise ValueError('load_sharded: this predictor serves on %r, '
                             'not %r' % (self._mesh_shape or 'one device',
                                         serving_mesh(mesh)[1]))
        ckpt = restore_mod.load_checkpoint(ckpt_dir)
        if ckpt is None:
            raise RuntimeError(
                'no committed checkpoint generation under %r' % ckpt_dir)
        names = self.param_names()
        for name in names:
            if name not in ckpt:
                raise RuntimeError(
                    'sharded checkpoint %s (generation %d) is missing '
                    'param %r' % (ckpt.dirname, ckpt.generation, name))
        if self._remote:
            self._exe.load_sharded(ckpt_dir, names)
            return
        for name in names:
            cur = self._weight_scope.find_var(name)
            self._weight_scope.set_var(name, ckpt.read(name).to(
                device=self.device, dtype=cur.dtype))

    # -- lifecycle ---------------------------------------------------------
    def _zero_state(self, shape):
        """Zero every cache var in place (a captured graph reads that
        storage), creating it on first use; on a mesh, on every rank."""
        if self._remote:
            self._exe.zero()
            return
        for name in self._pair.cache_names:
            cur = self._scope.find_var(name)
            if isinstance(cur, torch.Tensor) and tuple(cur.shape) == shape:
                cur.zero_()
            else:
                self._scope.set_var(name, torch.zeros(
                    shape, dtype=torch.float32, device=self.device))

    def reset(self):
        """Zero every ring cache (all slots forget everything)."""
        self._zero_state(self._pair.spec.cache_shape(self.slots))

    def clone(self):
        """A worker sharing this one's weights and programs, with a
        PRIVATE cache scope + executor (on a mesh, a station of its
        own on the same ranks): streams cannot cross-talk."""
        return DecodePredictor(self._base, _clone_of=self)

    # -- execution ---------------------------------------------------------
    def _pad_prompts(self, prompts, slot_ids):
        pb, T = self.prefill_batch, self.max_len
        if not prompts or len(prompts) > pb:
            raise ValueError('prefill takes 1..%d prompts, got %d'
                             % (pb, len(prompts)))
        if len(prompts) != len(slot_ids):
            raise ValueError('%d prompts for %d slots'
                             % (len(prompts), len(slot_ids)))
        tokens = np.zeros((pb, T, 1), np.int64)
        pos = np.zeros((pb,), np.int32)
        slots = np.zeros((pb,), np.int32)
        for i, (p, s) in enumerate(zip(prompts, slot_ids)):
            p = np.asarray(p).reshape(-1)
            if not 1 <= p.size <= T:
                raise ValueError('prompt length %d outside [1, %d] (max_len)'
                                 % (p.size, T))
            if not 0 <= int(s) < self.slots:
                raise ValueError('slot %r outside [0, %d)' % (s, self.slots))
            tokens[i, :p.size, 0] = p
            pos[i] = p.size - 1
            slots[i] = int(s)
        # a short batch repeats the LAST real (prompt, slot) pair: the
        # duplicate write stores identical rows and touches no idle slot
        for i in range(len(prompts), pb):
            tokens[i] = tokens[len(prompts) - 1]
            pos[i] = pos[len(prompts) - 1]
            slots[i] = slots[len(prompts) - 1]
        return tokens, pos, slots

    def prefill(self, prompts, slot_ids, return_logits=False):
        """Write the prompts' K/V into their slots and return the first
        greedy token per prompt: ids [len(prompts)] int64 (and, with
        return_logits, last-position logits [len(prompts), vocab])."""
        tokens, pos, slots = self._pad_prompts(prompts, slot_ids)
        logits, ids = self._exe.run(
            self._pair.prefill_program,
            feed={'prefill_tokens': tokens, 'prefill_pos': pos,
                  'prefill_slots': slots},
            fetch_list=self._pair.prefill_fetches,
            scope=self._scope, return_numpy=False)
        n = len(prompts)
        out_ids = ids[:n].cpu().numpy()
        if return_logits:
            return out_ids, logits[:n].cpu().numpy()
        return out_ids

    def decode_step(self, tokens, positions, return_logits=False):
        """One step for the WHOLE pool: tokens [slots] (each slot's last
        token), positions [slots] (its absolute position; the ring write
        lands at position % max_len). Returns next greedy ids [slots]
        int64 (and logits [slots, vocab] if asked). Idle slots may carry
        any values."""
        logits, ids = self._exe.run(
            self._pair.decode_program,
            feed={'decode_tokens':
                  np.asarray(tokens, np.int64).reshape(self.slots, 1, 1),
                  'decode_step_idx':
                  np.asarray(positions, np.int32).reshape(self.slots)},
            fetch_list=self._pair.decode_fetches,
            scope=self._scope, return_numpy=False)
        if return_logits:
            return ids.cpu().numpy(), logits.cpu().numpy()
        # ids only: the [slots, vocab] logits stay on the device
        return ids.cpu().numpy()

    def generate(self, prompt, max_new_tokens, eos_id=None, slot=0):
        """Solo greedy generation on one slot (the parity path; traffic
        goes through ServingEngine)."""
        tok = int(self.prefill([prompt], [slot])[0])
        out = [tok]
        pos = len(np.asarray(prompt).reshape(-1))
        toks = np.zeros((self.slots,), np.int64)
        poss = np.zeros((self.slots,), np.int32)
        while len(out) < max_new_tokens and tok != eos_id:
            toks[slot] = tok
            poss[slot] = pos
            tok = int(self.decode_step(toks, poss)[slot])
            out.append(tok)
            pos += 1
        return out
