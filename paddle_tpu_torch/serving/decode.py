"""DecodePredictor: cached prefill/decode execution over a slot pool
(counterpart of paddle_tpu/serving/decode.py, dense ring cache only).

Scope layout:

    base Predictor Scope (weights, on the device, shared)
        └── this DecodePredictor's child Scope (K/V ring caches)

Every clone() gets a fresh child Scope (private caches, zeroed) over the
same parent, so N serving workers share one copy of the weights. The
cache ops update the child Scope's tensors in place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..executor import Executor, Scope
from ..flags import get_flag

__all__ = ['DecodePredictor']


class DecodePredictor(object):
    def __init__(self, predictor, slots=None, prefill_batch=None,
                 _clone_of=None):
        """predictor: a loaded Predictor/AnalysisPredictor whose program
        is a decoder-only LM (prefer AnalysisPredictor.prepare_decoding).
        slots / prefill_batch default to FLAGS_serving_slots /
        FLAGS_serving_prefill_batch."""
        self._base = predictor
        if _clone_of is not None:
            self._pair = _clone_of._pair
        else:
            from ..transpiler.decode_transpiler import DecodeTranspiler
            self._pair = DecodeTranspiler().transpile(
                predictor._program,
                slots=int(slots or get_flag('serving_slots')),
                prefill_batch=int(prefill_batch
                                  or get_flag('serving_prefill_batch')))
            self._check_weights(predictor._scope)
        self._weight_scope = predictor._scope
        self._exe = Executor(predictor._place)
        self._scope = Scope(parent=self._weight_scope)
        self.reset()

    def _check_weights(self, scope):
        for name in self._pair.spec.param_names():
            if not isinstance(scope.find_var(name), torch.Tensor):
                raise RuntimeError(
                    'decode transpile references param %r that is not in '
                    'the predictor scope — was the model loaded with '
                    'load_params=True?' % name)

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

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Zero every ring cache (all slots forget everything)."""
        shape = self._pair.spec.cache_shape(self.slots)
        for name in self._pair.cache_names:
            self._scope.set_var(name, torch.zeros(shape, dtype=torch.float32,
                                                  device=self.device))

    def clone(self):
        """A worker sharing this one's weights and programs, with a
        PRIVATE cache scope + executor: streams cannot cross-talk."""
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
