"""Sequence layers over padded batches (counterpart of
paddle_tpu/layers/sequence.py, its 21 public functions).

Every layer threads the input Variable's `seq_lens` companion (set by
layers.data(lod_level > 0)) into the op's SeqLens input and carries it
to the outputs that keep the time axis, so masking follows the sequence
from its feed to its pool."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    'dynamic_lstm', 'dynamic_gru', 'sequence_conv', 'sequence_pool',
    'sequence_softmax', 'sequence_expand', 'sequence_first_step',
    'sequence_last_step', 'sequence_concat', 'cos_sim',
    'linear_chain_crf', 'crf_decoding', 'sequence_mask', 'sequence_pad',
    'sequence_unpad', 'sequence_erase', 'sequence_reshape',
    'sequence_slice', 'row_conv', 'im2sequence', 'edit_distance',
]


def _seq_inputs(inputs, var):
    if getattr(var, 'seq_lens', None) is not None:
        inputs['SeqLens'] = [var.seq_lens]
    return inputs


def _propagate_lens(src, *outs):
    lens = getattr(src, 'seq_lens', None)
    for o in outs:
        o.seq_lens = lens
        o.lod_level = max(1, src.lod_level)
    return outs[0] if len(outs) == 1 else outs


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation='sigmoid', cell_activation='tanh',
                 candidate_activation='tanh', dtype='float32', name=None):
    """An LSTM over a pre-projected input: `size` is 4 * hidden, and the
    caller projects x with an fc of size 4H. Returns (hidden, cell)."""
    helper = LayerHelper('lstm', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    hidden_size = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden_size, 4 * hidden_size],
        dtype=dtype)
    bias_size = [1, 7 * hidden_size] if use_peepholes \
        else [1, 4 * hidden_size]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    if c_0 is not None:
        inputs['C0'] = [c_0]
    helper.append_op(
        type='lstm', inputs=_seq_inputs(inputs, input),
        outputs={'Hidden': [hidden], 'Cell': [cell]},
        attrs={'use_peepholes': use_peepholes, 'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'cell_activation': cell_activation,
               'candidate_activation': candidate_activation})
    return _propagate_lens(input, hidden, cell)


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation='sigmoid',
                candidate_activation='tanh', h_0=None, name=None):
    """A GRU over a pre-projected input [*, 3H]; `size` is hidden."""
    helper = LayerHelper('gru', param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {'Input': [input], 'Weight': [weight], 'Bias': [bias]}
    if h_0 is not None:
        inputs['H0'] = [h_0]
    helper.append_op(
        type='gru', inputs=_seq_inputs(inputs, input),
        outputs={'Hidden': [hidden]},
        attrs={'is_reverse': is_reverse,
               'gate_activation': gate_activation,
               'activation': candidate_activation})
    return _propagate_lens(input, hidden)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    """A context window of `filter_size` rows within each sequence,
    projected to `num_filters`, then the bias and `act`."""
    helper = LayerHelper('sequence_conv', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type='sequence_conv',
        inputs=_seq_inputs({'X': [input], 'Filter': [filter_param]}, input),
        outputs={'Out': [out]},
        attrs={'contextStride': filter_stride,
               'contextStart': -int(filter_size // 2),
               'contextLength': filter_size})
    out = helper.append_bias_op(out, dim_start=len(out.shape) - 1)
    out = helper.append_activation(out)
    return _propagate_lens(input, out)


def sequence_pool(input, pool_type, is_test=False):
    """Pool over time: sum, average, sqrt, max, last or first. The time
    axis is reduced away, so the output has no lengths companion."""
    helper = LayerHelper('sequence_pool')
    dtype = input.dtype
    out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference('int32')
    helper.append_op(
        type='sequence_pool', inputs=_seq_inputs({'X': [input]}, input),
        outputs={'Out': [out], 'MaxIndex': [max_index]},
        attrs={'pooltype': pool_type.upper()})
    out.lod_level = 0
    out.seq_lens = None   # the sequence axis is reduced away
    return out


def sequence_first_step(input):
    return sequence_pool(input, 'first')


def sequence_last_step(input):
    return sequence_pool(input, 'last')


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper('sequence_softmax', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='sequence_softmax',
        inputs=_seq_inputs({'X': [input]}, input),
        outputs={'Out': [out]})
    return _propagate_lens(input, out)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper('sequence_expand', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='sequence_expand',
                     inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'ref_level': ref_level})
    return _propagate_lens(y, out)


def sequence_concat(input, axis=0, name=None):
    """axis=0 (the default): join sequences along time, lengths add.
    axis>=1: concatenate features."""
    helper = LayerHelper('sequence_concat', name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    out_lens = helper.create_variable_for_type_inference('int32')
    inputs = {'X': list(input)}
    lens_vars = [getattr(v, 'seq_lens', None) for v in input]
    if any(lv is not None for lv in lens_vars):
        # every input needs a lengths entry for positional pairing
        inputs['SeqLens'] = [
            lv if lv is not None else input[i]
            for i, lv in enumerate(lens_vars)]
        if any(lv is None for lv in lens_vars):
            raise ValueError('sequence_concat: all inputs need seq_lens '
                             'when any has one')
    helper.append_op(type='sequence_concat', inputs=inputs,
                     outputs={'Out': [out], 'OutLens': [out_lens]},
                     attrs={'axis': axis})
    out.seq_lens = out_lens
    out.lod_level = max(1, input[0].lod_level)
    return out


def cos_sim(X, Y):
    helper = LayerHelper('cos_sim')
    out = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type='cos_sim', inputs={'X': [X], 'Y': [Y]},
                     outputs={'Out': [out]})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """Returns each sequence's negative log-likelihood [B, 1]; the
    transition parameter is [size + 2, size], its start and stop rows
    first."""
    helper = LayerHelper('linear_chain_crf', param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    emission_exps = helper.create_variable_for_type_inference(input.dtype)
    transition_exps = helper.create_variable_for_type_inference(input.dtype)
    log_likelihood = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type='linear_chain_crf',
        inputs=_seq_inputs({'Emission': [input], 'Label': [label],
                            'Transition': [transition]}, input),
        outputs={'Alpha': [alpha], 'EmissionExps': [emission_exps],
                 'TransitionExps': [transition_exps],
                 'LogLikelihood': [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """The Viterbi path [B, T, 1] under the named transition parameter;
    with a label, 1 where the path matches it."""
    helper = LayerHelper('crf_decoding', param_attr=param_attr)
    transition = helper.get_parameter(helper.param_attr.name)
    viterbi_path = helper.create_variable_for_type_inference('int32')
    inputs = {'Emission': [input], 'Transition': [transition]}
    if label is not None:
        inputs['Label'] = [label]
    helper.append_op(type='crf_decoding',
                     inputs=_seq_inputs(inputs, input),
                     outputs={'ViterbiPath': [viterbi_path]})
    return _propagate_lens(input, viterbi_path)


def sequence_mask(x, maxlen, dtype='int64', name=None):
    """Lengths -> [B, maxlen] validity mask."""
    helper = LayerHelper('sequence_mask', name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type='sequence_mask', inputs={'X': [x]},
                     outputs={'Y': [out]},
                     attrs={'maxlen': maxlen, 'out_dtype': dtype})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """Returns (padded, lengths): the pad value past each length."""
    helper = LayerHelper('sequence_pad', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference('int64')
    inputs = _seq_inputs({'X': [x], 'PadValue': [pad_value]}, x)
    helper.append_op(type='sequence_pad', inputs=inputs,
                     outputs={'Out': [out], 'Length': [length]},
                     attrs={'padded_length': maxlen or -1})
    out.lod_level = 0
    length.stop_gradient = True
    return out, length


def sequence_unpad(x, length, name=None):
    """Re-attach lengths to a padded tensor; positions beyond each
    length are zeroed."""
    helper = LayerHelper('sequence_unpad', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='sequence_unpad',
                     inputs={'X': [x], 'Length': [length]},
                     outputs={'Out': [out]})
    out.lod_level = 1
    out.seq_lens = length
    return out


def _lens_output(helper, out, x):
    """Create the OutLens companion and attach it to out."""
    lens = helper.create_variable_for_type_inference('int32')
    lens.stop_gradient = True
    out.seq_lens = lens
    out.lod_level = max(1, getattr(x, 'lod_level', 1))
    return lens


def sequence_erase(x, tokens, name=None):
    """Drop listed token ids, left-shift survivors, shrink lengths."""
    helper = LayerHelper('sequence_erase', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    lens = _lens_output(helper, out, x)
    helper.append_op(type='sequence_erase',
                     inputs=_seq_inputs({'X': [x]}, x),
                     outputs={'Out': [out], 'OutLens': [lens]},
                     attrs={'tokens': list(tokens)})
    return out


def sequence_reshape(input, new_dim, name=None):
    helper = LayerHelper('sequence_reshape', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    lens = _lens_output(helper, out, input)
    helper.append_op(type='sequence_reshape',
                     inputs=_seq_inputs({'X': [input]}, input),
                     outputs={'Out': [out], 'OutLens': [lens]},
                     attrs={'new_dim': new_dim})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper('sequence_slice', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    lens = _lens_output(helper, out, input)
    helper.append_op(type='sequence_slice',
                     inputs=_seq_inputs({'X': [input],
                                         'Offset': [offset],
                                         'Length': [length]}, input),
                     outputs={'Out': [out], 'OutLens': [lens]})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """Lookahead convolution over the next `future_context_size` rows."""
    from ..initializer import Constant
    helper = LayerHelper('row_conv', param_attr=param_attr, name=name)
    d = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[future_context_size, d],
                                dtype=input.dtype,
                                default_initializer=Constant(0.0))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='row_conv',
                     inputs=_seq_inputs({'X': [input], 'Filter': [w]},
                                        input),
                     outputs={'Out': [out]})
    _propagate_lens(input, out)
    return out


def im2sequence(input, filter_size, stride=1, padding=0, name=None):
    """Image patches as a sequence."""
    helper = LayerHelper('im2sequence', name=name)

    def _pair(v):
        return [v, v] if isinstance(v, int) else list(v)
    pad = _pair(padding)
    if len(pad) == 2:
        pad = pad + pad
    out = helper.create_variable_for_type_inference(input.dtype)
    lens = helper.create_variable_for_type_inference('int32')
    lens.stop_gradient = True
    out.seq_lens = lens
    out.lod_level = 1
    helper.append_op(type='im2sequence', inputs={'X': [input]},
                     outputs={'Out': [out], 'OutLens': [lens]},
                     attrs={'kernels': _pair(filter_size),
                            'strides': _pair(stride), 'paddings': pad})
    return out


def edit_distance(input, label, normalized=True, name=None):
    """Batched Levenshtein distance. Returns (distances [B, 1],
    sequence_num scalar)."""
    helper = LayerHelper('edit_distance', name=name)
    out = helper.create_variable_for_type_inference('float32')
    seq_num = helper.create_variable_for_type_inference('int64')
    inputs = {'Hyps': [input], 'Refs': [label]}
    if getattr(input, 'seq_lens', None) is not None:
        inputs['HypLens'] = [input.seq_lens]
    if getattr(label, 'seq_lens', None) is not None:
        inputs['RefLens'] = [label.seq_lens]
    helper.append_op(type='edit_distance', inputs=inputs,
                     outputs={'Out': [out], 'SequenceNum': [seq_num]},
                     attrs={'normalized': normalized})
    out.stop_gradient = True
    return out, seq_num
