"""High-level Inferencer (counterpart of paddle_tpu/inferencer.py; the
reference's python/paddle/fluid/inferencer.py): the deploy-side
companion of trainer.Trainer. It loads an inference model saved with
io.save_inference_model (by either package: the file format is the
same) and answers feed-dict queries. place=None is CUDAPlace(0), which
raises without a card (the JAX package's default is CPUPlace());
pass CPUPlace() for the CPU."""
from __future__ import annotations

import contextlib

from . import io
from .executor import CUDAPlace, Executor, Scope, scope_guard

__all__ = ['Inferencer']


class Inferencer(object):
    """(reference inferencer.py:27) param_path holds the model saved by
    io.save_inference_model. infer_func and parallel are accepted for the
    reference's signature and unused, as in the JAX package."""

    def __init__(self, infer_func=None, param_path=None, place=None,
                 parallel=False):
        self.param_path = param_path
        self.scope = Scope()
        self.place = place if place is not None else CUDAPlace(0)
        self.exe = Executor(self.place)
        with self._prog_and_scope_guard():
            (self.inference_program, self.feed_target_names,
             self.fetch_targets) = io.load_inference_model(
                dirname=param_path, executor=self.exe)

    @contextlib.contextmanager
    def _prog_and_scope_guard(self):
        with scope_guard(self.scope):
            yield

    def infer(self, inputs, return_numpy=True):
        if not isinstance(inputs, dict):
            raise ValueError(
                'inputs should be a map of {tensor_name: tensor}')
        with self._prog_and_scope_guard():
            results = self.exe.run(self.inference_program, feed=inputs,
                                   fetch_list=self.fetch_targets,
                                   return_numpy=return_numpy)
        return results
