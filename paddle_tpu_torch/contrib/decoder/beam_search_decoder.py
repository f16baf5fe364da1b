"""StateCell, TrainingDecoder and BeamSearchDecoder (counterpart of
paddle_tpu/contrib/decoder/beam_search_decoder.py, the reference's
python/paddle/fluid/contrib/decoder/beam_search_decoder.py API).

- TrainingDecoder wraps DynamicRNN (a recurrent op: a loop of the step
  over T on a padded batch), each StateCell state an RNN memory.
- BeamSearchDecoder unrolls max_len beam steps over the static
  [batch, beam] lattice of the beam_search op (finished beams frozen on
  end_id) and reorders the cell states that follow the beams
  (need_reorder) with the beam_gather op, Out[b, j] = X[b, parent[b, j]],
  where the reference shuffles LoD rows.
"""
from __future__ import annotations

import contextlib

from ... import layers
from ...layer_helper import LayerHelper
from ... import unique_name

__all__ = ['InitState', 'StateCell', 'TrainingDecoder',
           'BeamSearchDecoder']


class _DecoderType(object):
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial state of a decoder cell (reference :43): either an
    existing Variable (`init`, e.g. the encoder's final state) or a
    constant-filled boot shaped per batch (`shape` + `value`)."""

    def __init__(self, init=None, shape=None, value=0.0,
                 init_boot=None, need_reorder=False, dtype='float32'):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                'init_boot must be provided to infer the init state shape')
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._shape = shape
        self._value = value
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell(object):
    """Decoder step function container (reference :159): named states +
    named inputs + a user updater that maps (inputs, states) -> states.
    The same cell drives both the TrainingDecoder and the
    BeamSearchDecoder."""

    def __init__(self, inputs, states, out_state, name=None):
        self.helper = LayerHelper('state_cell', name=name)
        self._cur_states = {}
        self._state_names = list(states)
        self._states_holder = states      # name -> InitState
        self._inputs = dict(inputs)       # name -> Variable or None
        self._cur_decoder_obj = None
        self._state_updater = None
        self._out_state = out_state
        self._in_decoder = False

    # -- decoder enter/leave ------------------------------------------
    def _enter_decoder(self, decoder_obj):
        if self._in_decoder:
            raise ValueError('StateCell has already entered a decoder.')
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder or self._cur_decoder_obj is not decoder_obj:
            raise ValueError('Unmatched decoder leave.')
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._cur_states = {}

    # -- state/input access (reference :269-:314) ---------------------
    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError('Unknown state %s' % state_name)
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError('Invalid input %s' % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is not self:
                raise ValueError('Updater should only accept its own '
                                 'state cell.')
            return updater(state_cell)
        return _decorator

    def compute_state(self, inputs):
        """Run the updater with the given step inputs; the new values
        stay pending until update_states() commits them."""
        if not self._in_decoder:
            raise ValueError('compute_state must run inside a decoder')
        for name, value in inputs.items():
            if name not in self._inputs:
                raise ValueError('Unknown input %s' % name)
            self._inputs[name] = value
        self._state_updater(self)

    def update_states(self):
        """Commit pending states to the enclosing decoder (RNN memory
        update in training; no-op bookkeeping in beam search — the
        decode loop reads _cur_states directly)."""
        if self._cur_decoder_obj is not None and \
                self._cur_decoder_obj.type == _DecoderType.TRAINING:
            rnn = self._cur_decoder_obj.dynamic_rnn
            for name in self._state_names:
                mem = self._cur_decoder_obj._state_memories[name]
                rnn.update_memory(mem, self._cur_states[name])

    @property
    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder(object):
    """Teacher-forced decoder over a padded target batch (reference
    :384) — DynamicRNN underneath."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper('training_decoder', name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._state_cell = state_cell
        self._state_memories = {}
        self._seq_lens = None

    @property
    def state_cell(self):
        self._assert_in_decoder_block('state_cell')
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return _DecoderType.TRAINING

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError('decoder.block() can only be invoked once')
        self._status = TrainingDecoder.IN_DECODER
        self._state_cell._enter_decoder(self)
        with self._dynamic_rnn.block(seq_lens=self._seq_lens):
            # materialize each state as an RNN memory initialized from
            # its InitState
            for name in self._state_cell._state_names:
                init = self._state_cell._states_holder[name]
                mem = self._dynamic_rnn.memory(init=init.value)
                self._state_memories[name] = mem
                self._state_cell._cur_states[name] = mem
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    def step_input(self, x):
        """Per-timestep slice of a [B, T, ...] target tensor. Captures
        the sequence lengths of the FIRST step input for masking."""
        self._assert_in_decoder_block('step_input')
        if self._seq_lens is None:
            lens = getattr(x, 'seq_lens', None)
            if lens is not None:
                self._seq_lens = lens
                self._dynamic_rnn._rnn.seq_lens = lens
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block('static_input')
        # full-batch constant input: visible in the step block as-is
        # (the scan closes over it)
        return x

    def output(self, *outputs):
        self._assert_in_decoder_block('output')
        self._dynamic_rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError('Output of training decoder can only be '
                             'visited outside the block.')
        return self._dynamic_rnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError('%s should be invoked inside block()'
                             % method)


class BeamSearchDecoder(object):
    """Beam-search inference decoder (reference :523): statically
    unrolled max_len steps of embed -> state_cell.compute_state ->
    softmax projection -> beam_search op, with per-step state
    reordering by parent index. decode() builds the graph; calling the
    decoder returns (translation_ids [B, beam, T],
    translation_scores [B, beam])."""

    def __init__(self, state_cell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100, beam_size=1,
                 end_id=1, name=None):
        self._helper = LayerHelper('beam_search_decoder', name=name)
        self.state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = input_var_dict or {}
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._embedding_param = unique_name.generate(
            self._helper.name + '_emb_w')
        self._decoded = False
        self._outputs = None

    @property
    def type(self):
        return _DecoderType.BEAM_SEARCH

    def decode(self):
        from ...param_attr import ParamAttr
        if self._decoded:
            raise ValueError('decode() can only be called once')
        cell = self.state_cell
        cell._enter_decoder(self)
        try:
            beam = self._beam_size
            # states start as the init values broadcast over the beam:
            # [B, D] -> [B, beam, D]
            for name in cell._state_names:
                init = cell._states_holder[name].value
                expanded = layers.unsqueeze(init, axes=[1])
                expanded = layers.expand(
                    expanded, expand_times=[1, beam] +
                    [1] * (len(init.shape) - 1))
                cell._cur_states[name] = expanded

            ids = self._init_ids                      # [B, beam] int64
            scores = self._init_scores                # [B, beam] f32
            step_ids, step_parents = [], []
            for _t in range(self._max_len):
                emb = layers.embedding(
                    input=layers.unsqueeze(ids, axes=[2]),
                    size=[self._target_dict_dim, self._word_dim],
                    is_sparse=self._sparse_emb,
                    param_attr=ParamAttr(name=self._embedding_param))
                # [B, beam, word_dim]
                inputs = {'x': emb} if 'x' in cell._inputs else {}
                inputs.update(self._input_var_dict)
                cell.compute_state(inputs=inputs)
                out_state = cell.out_state            # [B, beam, D]
                probs = layers.fc(
                    input=out_state, size=self._target_dict_dim,
                    num_flatten_dims=2, act='softmax',
                    param_attr=ParamAttr(
                        name=self._helper.name + '_out_w'),
                    bias_attr=ParamAttr(
                        name=self._helper.name + '_out_b'))
                logp = layers.log(layers.scale(probs, scale=1.0,
                                               bias=1e-9))
                ids, scores, parents = layers.beam_search(
                    ids, scores, logp, beam_size=beam,
                    end_id=self._end_id)
                step_ids.append(ids)
                step_parents.append(parents)
                # shuffle beam-tracked states to follow their parents
                # (need_reorder=False states are beam-invariant by the
                # user's declaration and skip the gather)
                for name in cell._state_names:
                    if cell._states_holder[name].need_reorder:
                        cell._cur_states[name] = _beam_gather(
                            cell._cur_states[name], parents)
            all_ids = layers.stack(step_ids, axis=0)      # [T, B, beam]
            all_parents = layers.stack(step_parents, axis=0)
            sentences, sent_scores = layers.beam_search_decode(
                all_ids, all_parents, scores)
            self._outputs = (sentences, sent_scores)
            self._decoded = True
        finally:
            cell._leave_decoder(self)

    def __call__(self):
        if not self._decoded:
            raise ValueError('decode() must be called before fetching '
                             'the outputs')
        return self._outputs


def _beam_gather(x, parents):
    helper = LayerHelper('beam_gather')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='beam_gather',
                     inputs={'X': [x], 'Indices': [parents]},
                     outputs={'Out': [out]})
    return out
