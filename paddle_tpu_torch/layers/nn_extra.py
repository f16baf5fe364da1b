"""Layers beyond the 2018 reference (counterpart of
paddle_tpu/layers/nn_extra.py:551)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ['flash_attention']


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
