"""Inference: the Predictor ABI over saved inference models
(counterpart of paddle_tpu/inference.py).

A Predictor owns a private Scope whose weights live on its place;
clone() shares that Scope, so serving workers do not duplicate the
weights in device memory. With no place given the place is CUDAPlace(0),
and a machine without a card raises (pass CPUPlace() to run on the CPU).

AnalysisPredictor runs the JAX package's offline graph pass on the
loaded program when AnalysisConfig.ir_optim is set (the default): the
InferenceTranspiler's batch-norm folding.
"""
from __future__ import annotations

from . import io as io_mod
from .executor import Executor, Scope, scope_guard

__all__ = ['Config', 'Predictor', 'create_predictor',
           'create_paddle_predictor', 'AnalysisConfig',
           'AnalysisPredictor', 'create_analysis_predictor']


class Config(object):
    """model_dir holds a save_inference_model directory;
    model_filename / params_filename follow io.py's layout."""

    def __init__(self, model_dir, model_filename=None,
                 params_filename=None, place=None):
        self.model_dir = model_dir
        self.model_filename = model_filename
        self.params_filename = params_filename
        self.place = place


class Predictor(object):
    def __init__(self, config, _clone_of=None):
        self._config = config
        self._exe = Executor(config.place)
        self._place = self._exe.place
        if _clone_of is not None:
            self._scope = _clone_of._scope
            self._program = _clone_of._program.clone(for_test=True)
            self._feed_names = list(_clone_of._feed_names)
            self._fetch_vars = [self._program.global_block().var(v.name)
                                for v in _clone_of._fetch_vars]
        else:
            self._scope = Scope()
            with scope_guard(self._scope):
                (self._program, self._feed_names,
                 self._fetch_vars) = io_mod.load_inference_model(
                    config.model_dir, self._exe,
                    model_filename=config.model_filename,
                    params_filename=config.params_filename)
        self._program._is_test = True

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def run(self, inputs, return_numpy=True):
        """inputs: dict name -> array, or a list in get_input_names()
        order. Returns numpy outputs, or tensors on the place with
        return_numpy=False."""
        if not isinstance(inputs, dict):
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    'predictor expects %d inputs %s, got %d'
                    % (len(self._feed_names), self._feed_names,
                       len(inputs)))
            inputs = dict(zip(self._feed_names, inputs))
        else:
            unknown = sorted(set(inputs) - set(self._feed_names))
            missing = sorted(set(self._feed_names) - set(inputs))
            if unknown or missing:
                parts = []
                if unknown:
                    parts.append('unknown input name(s) %s' % unknown)
                if missing:
                    parts.append('missing input name(s) %s' % missing)
                raise ValueError(
                    '%s — this model\'s inputs are get_input_names() '
                    '= %s' % ('; '.join(parts), self._feed_names))
        # scope= rather than scope_guard: run() must be safe from serving
        # threads, and the guard swaps a process-global
        return self._exe.run(self._program, feed=inputs,
                             fetch_list=self._fetch_vars, scope=self._scope,
                             return_numpy=return_numpy)

    def clone(self):
        """A predictor sharing this one's weights (same Scope) with its
        own program copy and executor."""
        return type(self)(self._config, _clone_of=self)


def create_predictor(config):
    return Predictor(config)


create_paddle_predictor = create_predictor


class AnalysisConfig(Config):
    """Config plus the IR-optimization switch AnalysisPredictor reads."""

    def __init__(self, model_dir, model_filename=None,
                 params_filename=None, place=None, ir_optim=True):
        super(AnalysisConfig, self).__init__(
            model_dir, model_filename=model_filename,
            params_filename=params_filename, place=place)
        self.ir_optim = ir_optim

    def switch_ir_optim(self, flag=True):
        self.ir_optim = flag
        return self


class AnalysisPredictor(Predictor):
    """A Predictor that folds each conv2d -> batch_norm pair of the
    loaded program (transpiler.InferenceTranspiler) when its config's
    ir_optim is set; a clone shares the folded program and weights."""

    def __init__(self, config, _clone_of=None):
        super(AnalysisPredictor, self).__init__(config, _clone_of=_clone_of)
        if _clone_of is None and getattr(config, 'ir_optim', True):
            from .transpiler import InferenceTranspiler
            InferenceTranspiler().transpile(
                self._program, self._place, scope=self._scope)

    def prepare_decoding(self, slots=None, prefill_batch=None,
                         paged=False, page_tokens=None, kv_pages=None,
                         prefill_chunk=None, speculative=False,
                         spec_k=None, draft_layers=None,
                         draft_predictor=None, mesh=None):
        """Transpile the loaded LM into the KV-cached prefill + decode
        pair and return a serving.DecodePredictor over this predictor's
        weight Scope. slots / prefill_batch default to
        FLAGS_serving_slots / FLAGS_serving_prefill_batch. paged=True
        returns a serving.PagedDecodePredictor instead: page-pool cache
        with copy-on-write prefix sharing and chunked prefill
        (page_tokens / kv_pages / prefill_chunk default from
        FLAGS_serving_*). speculative=True (implies paged) returns a
        serving.SpeculativeDecodePredictor: draft/verify greedy
        speculation (spec_k / draft_layers default from FLAGS_spec_*;
        draft_predictor supplies an explicit smaller draft LM instead
        of the layer-cut self-draft). mesh (None: FLAGS_serve_mesh_shape;
        '' = one device; 'tp=2', a MeshConfig or a Mesh) serves every
        program over a mesh of rank processes (serving/mesh.py): the K/V
        state sharded on heads, the weights by the recovered serve specs.
        Raises transpiler.DecodeTranspileError if the program is not a
        decoder-only LM."""
        if speculative:
            from .serving import SpeculativeDecodePredictor
            return SpeculativeDecodePredictor(
                self, slots=slots, spec_k=spec_k,
                draft_layers=draft_layers,
                draft_predictor=draft_predictor,
                page_tokens=page_tokens, kv_pages=kv_pages,
                prefill_chunk=prefill_chunk, mesh=mesh)
        if paged:
            from .serving import PagedDecodePredictor
            return PagedDecodePredictor(self, slots=slots,
                                        page_tokens=page_tokens,
                                        kv_pages=kv_pages,
                                        prefill_chunk=prefill_chunk,
                                        mesh=mesh)
        from .serving import DecodePredictor
        return DecodePredictor(self, slots=slots,
                               prefill_batch=prefill_batch, mesh=mesh)


def create_analysis_predictor(config):
    if not isinstance(config, AnalysisConfig):
        config = AnalysisConfig(
            config.model_dir, model_filename=config.model_filename,
            params_filename=config.params_filename, place=config.place)
    return AnalysisPredictor(config)
