"""Counterpart of paddle_tpu/layers/nn_extra.py, every layer of it: the
3-D convolution and pooling layers (:30-92), the RNN units and CTC
layers (:95-206), the evaluation layers (chunk_eval :209,
precision_recall :267, positive_negative_pair :295, auc :565),
fused_softmax_cross_entropy :236, the misc tensor layers (:322-514),
fake_quantize :517, polygon_box_transform :542 and flash_attention
:551. Each builds the JAX package's ops, attrs and vars."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .sequence import _seq_inputs

__all__ = [
    'conv3d', 'pool3d', 'conv3d_transpose', 'gru_unit', 'lstm_unit',
    'dynamic_lstmp', 'warpctc', 'ctc_greedy_decoder', 'chunk_eval',
    'multiplex', 'lod_reset', 'pad_constant_like', 'dice_loss',
    'image_resize', 'resize_bilinear', 'image_resize_short',
    'random_crop', 'mean_iou', 'crop', 'rank_loss', 'unstack',
    'bilinear_tensor_product', 'modified_huber_loss', 'l1_norm', 'sign',
    'fake_quantize', 'polygon_box_transform', 'flash_attention',
    'auc', 'precision_recall', 'positive_negative_pair',
    'fused_softmax_cross_entropy',
]


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v, v]


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None):
    """NCDHW 3-D convolution; filter [num_filters, C / groups, kd, kh,
    kw]."""
    helper = LayerHelper('conv3d', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    num_channels = input.shape[1]
    fsize = _triple(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, num_channels // groups] + fsize,
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='conv3d',
                     inputs={'Input': [input], 'Filter': [w]},
                     outputs={'Output': [out]},
                     attrs={'strides': _triple(stride),
                            'paddings': _triple(padding),
                            'dilations': _triple(dilation),
                            'groups': groups})
    out = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(out)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper('conv3d_transpose', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    in_c = input.shape[1]
    fsize = _triple(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[in_c, num_filters // groups] + fsize, dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='conv3d_transpose',
                     inputs={'Input': [input], 'Filter': [w]},
                     outputs={'Output': [out]},
                     attrs={'strides': _triple(stride),
                            'paddings': _triple(padding),
                            'dilations': _triple(dilation),
                            'groups': groups})
    out = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(out)


def pool3d(input, pool_size=-1, pool_type='max', pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None):
    helper = LayerHelper('pool3d', name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='pool3d', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'pooling_type': pool_type,
                            'ksize': _triple(pool_size),
                            'strides': _triple(pool_stride),
                            'paddings': _triple(pool_padding),
                            'global_pooling': global_pooling,
                            'ceil_mode': ceil_mode})
    return out




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


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk-level precision/recall/F1 (a host op). Returns (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks) for metrics.ChunkEvaluator."""
    helper = LayerHelper('chunk_eval')
    precision = helper.create_variable_for_type_inference('float32')
    recall = helper.create_variable_for_type_inference('float32')
    f1 = helper.create_variable_for_type_inference('float32')
    num_infer = helper.create_variable_for_type_inference('int64')
    num_label = helper.create_variable_for_type_inference('int64')
    num_correct = helper.create_variable_for_type_inference('int64')
    inputs = _seq_inputs({'Inference': [input], 'Label': [label]}, input)
    helper.append_op(type='chunk_eval', inputs=inputs,
                     outputs={'Precision': [precision],
                              'Recall': [recall],
                              'F1-Score': [f1],
                              'NumInferChunks': [num_infer],
                              'NumLabelChunks': [num_label],
                              'NumCorrectChunks': [num_correct]},
                     attrs={'chunk_scheme': chunk_scheme,
                            'num_chunk_types': num_chunk_types,
                            'excluded_chunk_types':
                                list(excluded_chunk_types or [])})
    return precision, recall, f1, num_infer, num_label, num_correct


def precision_recall(input, label, class_number, weights=None,
                     states_info=None):
    """Multi-class streaming precision/recall. `input` is the predicted class
    index column [N, 1] int; pass `states_info` (a persistable
    [class_number, 4] var) to accumulate across batches — the op
    writes the new accumulated states to the same var. Returns
    (batch_metrics[6], accum_metrics[6], accum_states)."""
    helper = LayerHelper('precision_recall')
    batch_metrics = helper.create_variable_for_type_inference('float32')
    accum_metrics = helper.create_variable_for_type_inference('float32')
    inputs = {'Indices': [input], 'Labels': [label]}
    if weights is not None:
        inputs['Weights'] = [weights]
    if states_info is not None:
        inputs['StatesInfo'] = [states_info]
        accum_states = states_info
    else:
        accum_states = helper.create_variable_for_type_inference(
            'float32')
    helper.append_op(type='precision_recall', inputs=inputs,
                     outputs={'BatchMetrics': [batch_metrics],
                              'AccumMetrics': [accum_metrics],
                              'AccumStatesInfo': [accum_states]},
                     attrs={'class_number': int(class_number)})
    return batch_metrics, accum_metrics, accum_states


def positive_negative_pair(score, label, query_id, weight=None,
                           accum=None, column=0):
    """Ranking concordant/discordant pair counts. `accum`, if given, is a
    (pos, neg, neu) tuple of persistable [1] vars that the op reads and
    rewrites to stream across batches. Returns (pos, neg, neu)."""
    helper = LayerHelper('positive_negative_pair')
    inputs = {'Score': [score], 'Label': [label], 'QueryID': [query_id]}
    if weight is not None:
        inputs['Weight'] = [weight]
    if accum is not None:
        pos, neg, neu = accum
        inputs['AccumulatePositivePair'] = [pos]
        inputs['AccumulateNegativePair'] = [neg]
        inputs['AccumulateNeutralPair'] = [neu]
    else:
        pos = helper.create_variable_for_type_inference('float32')
        neg = helper.create_variable_for_type_inference('float32')
        neu = helper.create_variable_for_type_inference('float32')
    helper.append_op(type='positive_negative_pair', inputs=inputs,
                     outputs={'PositivePair': [pos],
                              'NegativePair': [neg],
                              'NeutralPair': [neu]},
                     attrs={'column': int(column)})
    return pos, neg, neu


def multiplex(inputs, index):
    helper = LayerHelper('multiplex')
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type='multiplex',
                     inputs={'X': list(inputs), 'Ids': [index]},
                     outputs={'Out': [out]})
    return out


def lod_reset(x, y=None, target_lod=None):
    """New sequence boundaries for x: y's lengths (y.seq_lens), y's
    values as LoD offsets, or the target_lod offsets."""
    helper = LayerHelper('lod_reset')
    out = helper.create_variable_for_type_inference(x.dtype)
    out_lens = helper.create_variable_for_type_inference('int32')
    inputs = {'X': [x]}
    attrs = {}
    if y is not None:
        lens = getattr(y, 'seq_lens', None)
        if lens is not None:
            inputs['TargetLens'] = [lens]
        else:
            # a plain tensor Y carries target LoD offsets; the op diffs
            # them into lengths
            inputs['TargetLens'] = [y]
            attrs['target_is_offsets'] = True
    elif target_lod is not None:
        attrs['target_lod'] = list(target_lod)
    else:
        raise ValueError('lod_reset needs y or target_lod')
    helper.append_op(type='lod_reset', inputs=inputs,
                     outputs={'Out': [out], 'OutLens': [out_lens]},
                     attrs=attrs)
    out.seq_lens = out_lens
    out.lod_level = 1
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper('pad_constant_like', name=name)
    out = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op(type='pad_constant_like',
                     inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out]},
                     attrs={'pad_value': float(pad_value)})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """Dice loss for segmentation, composed of one_hot, reductions and
    elementwise layers."""
    from .nn import one_hot, reduce_sum, elementwise_mul, reduce_mean
    label_oh = one_hot(label, depth=input.shape[-1])
    reduce_dims = list(range(1, len(input.shape)))
    inse = reduce_sum(elementwise_mul(input, label_oh), dim=reduce_dims)
    dice_denominator = reduce_sum(input, dim=reduce_dims) + \
        reduce_sum(label_oh, dim=reduce_dims)
    dice_score = 1 - inse * 2 / (dice_denominator + epsilon)
    return reduce_mean(dice_score)


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    helper = LayerHelper('bilinear_interp', name=name)
    if out_shape is not None:
        out_h, out_w = int(out_shape[0]), int(out_shape[1])
    else:
        out_h = int(input.shape[2] * scale)
        out_w = int(input.shape[3] * scale)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type='bilinear_interp', inputs={'X': [input]},
                     outputs={'Out': [out]},
                     attrs={'out_h': out_h, 'out_w': out_w})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample='BILINEAR'):
    if resample != 'BILINEAR':
        raise ValueError('image_resize supports BILINEAR only')
    return resize_bilinear(input, out_shape, scale, name)


def image_resize_short(input, out_short_len, resample='BILINEAR'):
    """Resize so the short edge becomes out_short_len, keeping the aspect
    ratio."""
    in_h, in_w = input.shape[2], input.shape[3]
    short = min(in_h, in_w)
    out_h = int(round(in_h * out_short_len / float(short)))
    out_w = int(round(in_w * out_short_len / float(short)))
    return image_resize(input, out_shape=[out_h, out_w], resample=resample)


def random_crop(x, shape, seed=None):
    helper = LayerHelper('random_crop')
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='random_crop', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'shape': list(shape)})
    return out


def mean_iou(input, label, num_classes):
    """Returns (mean_iou, out_wrong, out_correct)."""
    helper = LayerHelper('mean_iou')
    miou = helper.create_variable_for_type_inference('float32')
    wrong = helper.create_variable_for_type_inference('int32')
    correct = helper.create_variable_for_type_inference('int32')
    helper.append_op(type='mean_iou',
                     inputs={'Predictions': [input], 'Labels': [label]},
                     outputs={'OutMeanIou': [miou], 'OutWrong': [wrong],
                              'OutCorrect': [correct]},
                     attrs={'num_classes': num_classes})
    return miou, wrong, correct


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper('crop', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {'X': [x]}
    attrs = {}
    if hasattr(shape, 'dtype'):     # a Variable: crop to its shape
        inputs['Y'] = [shape]
    else:
        attrs['shape'] = list(shape)
    if offsets is not None:
        attrs['offsets'] = list(offsets)
    helper.append_op(type='crop', inputs=inputs, outputs={'Out': [out]},
                     attrs=attrs)
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper('rank_loss', name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type='rank_loss',
                     inputs={'Label': [label], 'Left': [left],
                             'Right': [right]},
                     outputs={'Out': [out]})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper('unstack')
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type='unstack', inputs={'X': [x]},
                     outputs={'Y': outs}, attrs={'axis': axis})
    return outs


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper('bilinear_tensor_product', param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, x.shape[-1], y.shape[-1]],
                                dtype=x.dtype)
    inputs = {'X': [x], 'Y': [y], 'Weight': [w]}
    if bias_attr is not False:
        b = helper.create_parameter(attr=helper.bias_attr, shape=[1, size],
                                    dtype=x.dtype, is_bias=True)
        inputs['Bias'] = [b]
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='bilinear_tensor_product', inputs=inputs,
                     outputs={'Out': [out]})
    return helper.append_activation(out)


def modified_huber_loss(x, y, name=None):
    helper = LayerHelper('modified_huber_loss', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inter = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='modified_huber_loss',
                     inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [out], 'IntermediateVal': [inter]})
    return out


def l1_norm(x, name=None):
    helper = LayerHelper('l1_norm', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='l1_norm', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def sign(x, name=None):
    helper = LayerHelper('sign', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type='sign', inputs={'X': [x]},
                     outputs={'Out': [out]})
    return out


def fake_quantize(x, quantize_type='abs_max', bit_length=8, name=None):
    """Quantization-aware training's fake-quantize layer. For the
    moving-scale types the scale is a persistable var (initialised to 0)
    that the op reads (InMovingScale) and writes back (OutMovingScale)
    each step."""
    from ..initializer import Constant
    helper = LayerHelper('fake_quantize', name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {'X': [x]}
    if quantize_type == 'abs_max':
        scale = helper.create_variable_for_type_inference(x.dtype)
    else:
        scale = helper.create_global_variable(
            name=helper.name + '.moving_scale', shape=[1], dtype=x.dtype,
            persistable=True)
        helper.set_variable_initializer(scale, Constant(0.0))
        inputs['InMovingScale'] = [scale]
    helper.append_op(type='fake_quantize', inputs=inputs,
                     outputs={'Out': [out], 'OutMovingScale': [scale]},
                     attrs={'quantize_type': quantize_type,
                            'bit_length': bit_length})
    return out


def auc(input, label, curve='ROC', num_thresholds=200, topk=1, name=None):
    """Streaming AUC over threshold-bucketed confusion counts: TP, FP,
    TN and FN are persistable [num_thresholds] vars (initialised to 0)
    that the op reads and writes back each batch."""
    from ..initializer import Constant
    helper = LayerHelper('auc', name=name)
    states = {}
    for stat in ('tp', 'fp', 'tn', 'fn'):
        v = helper.create_global_variable(
            name='%s.%s' % (helper.name, stat), shape=[num_thresholds],
            dtype='float32', persistable=True)
        helper.set_variable_initializer(v, Constant(0.0))
        states[stat] = v
    auc_out = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='auc',
        inputs={'Predict': [input], 'Label': [label],
                'TP': [states['tp']], 'FP': [states['fp']],
                'TN': [states['tn']], 'FN': [states['fn']]},
        outputs={'AUC': [auc_out], 'TPOut': [states['tp']],
                 'FPOut': [states['fp']], 'TNOut': [states['tn']],
                 'FNOut': [states['fn']]},
        attrs={'curve': curve, 'num_thresholds': num_thresholds})
    return auc_out
