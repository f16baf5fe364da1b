"""Counterpart of paddle_tpu/layers/nn_extra.py: the RNN units and CTC
layers (:95-208: gru_unit, lstm_unit, dynamic_lstmp, warpctc,
ctc_greedy_decoder), fused_softmax_cross_entropy :236,
polygon_box_transform :542 and flash_attention :551."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .sequence import _seq_inputs

__all__ = ['flash_attention', 'fused_softmax_cross_entropy', 'gru_unit',
           'lstm_unit', 'dynamic_lstmp', 'warpctc', 'ctc_greedy_decoder',
           'polygon_box_transform']


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation='tanh', gate_activation='sigmoid'):
    """One GRU step; size is 3 x D. Returns (hidden, reset_hidden_prev,
    gate)."""
    helper = LayerHelper('gru_unit', param_attr=param_attr,
                         bias_attr=bias_attr)
    D = size // 3
    w = helper.create_parameter(attr=helper.param_attr, shape=[D, 3 * D],
                                dtype=input.dtype)
    inputs = {'Input': [input], 'HiddenPrev': [hidden], 'Weight': [w]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * D],
                                    dtype=input.dtype, is_bias=True)
        inputs['Bias'] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='gru_unit', inputs=inputs,
                     outputs={'Hidden': [out], 'Gate': [gate],
                              'ResetHiddenPrev': [reset]},
                     attrs={'activation': activation,
                            'gate_activation': gate_activation})
    return out, reset, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an fc over [x_t, h_prev] makes the four gates, then
    the lstm_unit op. Returns (hidden, cell)."""
    from .nn import fc
    from .tensor import concat
    helper = LayerHelper('lstm_unit', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    D = cell_t_prev.shape[-1]
    gates = fc(input=concat([x_t, hidden_t_prev], axis=1), size=4 * D,
               param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(cell_t_prev.dtype)
    h = helper.create_variable_for_type_inference(cell_t_prev.dtype)
    helper.append_op(type='lstm_unit',
                     inputs={'X': [gates], 'C_prev': [cell_t_prev]},
                     outputs={'C': [c], 'H': [h]},
                     attrs={'forget_bias': float(forget_bias)})
    return h, c


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation='sigmoid', cell_activation='tanh',
                  candidate_activation='tanh', proj_activation='tanh',
                  dtype='float32', name=None):
    """An LSTM with a recurrent projection over a padded sequence batch.
    Returns (projection, cell)."""
    helper = LayerHelper('lstmp', param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    H = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[proj_size, 4 * H], dtype=dtype)
    proj_w = helper.create_parameter(attr=helper.param_attr,
                                     shape=[H, proj_size], dtype=dtype)
    b = helper.create_parameter(
        attr=helper.bias_attr,
        shape=[1, 7 * H if use_peepholes else 4 * H], dtype=dtype,
        is_bias=True)
    projection = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = _seq_inputs({'Input': [input], 'Weight': [w],
                          'ProjWeight': [proj_w], 'Bias': [b]}, input)
    helper.append_op(type='lstmp', inputs=inputs,
                     outputs={'Projection': [projection], 'Cell': [cell]},
                     attrs={'use_peepholes': use_peepholes,
                            'is_reverse': is_reverse,
                            'gate_activation': gate_activation,
                            'cell_activation': cell_activation,
                            'candidate_activation': candidate_activation,
                            'proj_activation': proj_activation})
    for v in (projection, cell):
        v.seq_lens = getattr(input, 'seq_lens', None)
        v.lod_level = max(1, input.lod_level)
    return projection, cell


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss over padded logits: a [B, 1] loss per sequence."""
    helper = LayerHelper('warpctc')
    loss = helper.create_variable_for_type_inference(input.dtype)
    inputs = _seq_inputs({'Logits': [input], 'Label': [label]}, input)
    lab_lens = getattr(label, 'seq_lens', None)
    if lab_lens is not None:
        inputs['LabelLens'] = [lab_lens]
    helper.append_op(type='warpctc', inputs=inputs, outputs={'Loss': [loss]},
                     attrs={'blank': blank, 'norm_by_times': norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decoding: the argmax over classes at each step, then
    ctc_align's merge-repeats and drop-blanks. Returns the padded
    decoded ids, their lengths attached as seq_lens."""
    from .tensor import argmax
    helper = LayerHelper('ctc_greedy_decoder', name=name)
    ids = argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference('int32')
    out_lens = helper.create_variable_for_type_inference('int32')
    helper.append_op(type='ctc_align', inputs=_seq_inputs({'Input': [ids]},
                                                          input),
                     outputs={'Output': [out], 'OutLens': [out_lens]},
                     attrs={'blank': blank, 'padding_value': 0})
    out.seq_lens = out_lens
    out.lod_level = 1
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper('polygon_box_transform', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='polygon_box_transform',
                     inputs={'Input': [input]},
                     outputs={'Output': [out]})
    return out


def flash_attention(q, k, v, causal=True, sm_scale=None, name=None):
    """Blockwise (flash) attention over [B, H, T, dh] without the [T, T]
    score tensor (kernels/flash_attention.py)."""
    helper = LayerHelper('flash_attention', name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(type='flash_attention',
                     inputs={'Q': [q], 'K': [k], 'V': [v]},
                     outputs={'Out': [out]},
                     attrs={'causal': causal, 'sm_scale': sm_scale})
    return out


def fused_softmax_cross_entropy(input, label, num_classes, chunk=1024,
                                param_attr=None, bias_attr=None,
                                ignore_index=-100, name=None):
    """Classifier head + softmax cross-entropy as ONE op: the [N, V]
    logits are never kept across the step (chunked, recomputed in the
    backward; ops/loss_ops.py). Owns the projection weight
    [D, num_classes] (+ bias unless bias_attr=False). Returns Loss
    [..., 1] fp32."""
    helper = LayerHelper('fused_softmax_cross_entropy', input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = helper.input_dtype()
    D = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[int(D), int(num_classes)],
                                dtype=dtype)
    inputs = {'X': [input], 'W': [w], 'Label': [label]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[int(num_classes)],
                                    dtype=dtype, is_bias=True)
        inputs['Bias'] = [b]
    loss = helper.create_variable_for_type_inference('float32')
    helper.append_op(type='fused_softmax_cross_entropy', inputs=inputs,
                     outputs={'Loss': [loss]},
                     attrs={'chunk': int(chunk),
                            'ignore_index': int(ignore_index)})
    return loss
