"""Inference transpiler (counterpart of
paddle_tpu/transpiler/inference_transpiler.py): batch-norm folding for
deployment.

For an inference program, conv2d -> batch_norm(is_test) becomes conv2d
with adjusted weights plus a channel bias:

    w' = w * gamma / sqrt(var + eps)        (per out-channel)
    b' = beta - mean * gamma / sqrt(var + eps)

The folded values are computed in fp32 on the scope's own tensors, on
their device, and stored in the filter's dtype: no host round trip.
"""
from __future__ import annotations

import torch

__all__ = ['InferenceTranspiler']


class InferenceTranspiler(object):
    def transpile(self, program, place=None, scope=None):
        """Fold batch_norm into the preceding conv2d, in place. `scope`
        holds the trained parameters (default: the global scope); the
        folded filters are replaced there and the biases added."""
        from ..executor import global_scope
        if scope is None:
            scope = global_scope()
        self._fuse_batch_norm(program, scope)

    def _fuse_batch_norm(self, program, scope):
        block = program.global_block()
        i = 0
        while i < len(block.ops) - 1:
            op = block.ops[i]
            next_op = block.ops[i + 1]
            if op.type == 'conv2d' and next_op.type == 'batch_norm' and \
                    next_op.single_input('X') == op.single_output('Output'):
                self._fold(block, scope, i, op, next_op)
            i += 1
        self._remove_unused_vars(program)

    def _fold(self, block, scope, conv_idx, conv_op, bn_op):
        w_name = conv_op.single_input('Filter')
        gamma = self._param(scope, bn_op.single_input('Scale'))
        beta = self._param(scope, bn_op.single_input('Bias'))
        mean = self._param(scope, bn_op.single_input('Mean'))
        var = self._param(scope, bn_op.single_input('Variance'))
        eps = bn_op.attr('epsilon', 1e-5)
        w = self._param(scope, w_name)

        inv_std = gamma.float() / torch.sqrt(var.float() + eps)
        scope.set_var(w_name, (w.float() * inv_std[:, None, None, None])
                      .to(w.dtype))
        bias = (beta.float() - mean.float() * inv_std).to(w.dtype)

        # a channel bias and an elementwise_add in place of the BN op;
        # the broadcast axis follows the conv's layout (NHWC puts the
        # channels last)
        nhwc = conv_op.attr('data_format', 'NCHW') == 'NHWC'
        bias_name = w_name + '.bn_fold_bias'
        bv = block.create_parameter(
            name=bias_name, shape=list(bias.shape),
            dtype=str(bias.dtype).replace('torch.', ''))
        bv.persistable = True
        scope.set_var(bias_name, bias)
        bn_out = bn_op.single_output('Y')
        conv_out = conv_op.single_output('Output')
        x_rank = len(block.var_recursive(conv_out).shape)
        bn_idx = conv_idx + 1
        block.remove_op(bn_idx)
        block._insert_op(bn_idx, type='elementwise_add',
                         inputs={'X': [conv_out], 'Y': [bias_name]},
                         outputs={'Out': [bn_out]},
                         attrs={'axis': x_rank - 1 if nhwc else 1})

    @staticmethod
    def _param(scope, name):
        v = scope.find_var(name)
        if v is None:
            raise ValueError(
                'batch-norm folding needs parameter %r in the scope — '
                'run the startup/load program first' % name)
        return torch.as_tensor(v)

    @staticmethod
    def _remove_unused_vars(program):
        block = program.global_block()
        used = set()
        for op in block.ops:
            for names in op.inputs.values():
                used.update(names)
            for names in op.outputs.values():
                used.update(names)
        for name in list(block.vars):
            if name not in used and not block.vars[name].is_data:
                del block.vars[name]
