"""Layers beyond the 2018 reference (counterpart of
paddle_tpu/layers/nn_extra.py: fused_softmax_cross_entropy :236,
flash_attention :551)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ['flash_attention', 'fused_softmax_cross_entropy']


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
