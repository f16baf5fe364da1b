"""LayerHelper: parameter creation + op wiring for layer functions
(counterpart of paddle_tpu/layer_helper.py). Parameter names come from
unique_name exactly as in paddle_tpu (fc_0.w_0, ...), which is what lets
weights carry across the two packages by name."""
from __future__ import annotations

import copy

from . import unique_name
from .framework import default_main_program, default_startup_program, Variable
from .initializer import Constant, Xavier
from .param_attr import ParamAttr

__all__ = ['LayerHelper']


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if self.kwargs.get('name') is None:
            self.kwargs['name'] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs['name']

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        block = self.main_program.current_block()
        op = block.append_op(*args, **kwargs)
        self._propagate_seq_lens(block, op)
        return op

    @staticmethod
    def _propagate_seq_lens(block, op):
        """The first input var that carries a lengths companion hands it
        to every output that has none (elementwise ops, activations, fc
        keep the time axis); a layer that reduces the time axis
        (sequence_pool) clears it on its output afterwards."""
        def var(name):
            try:
                return block.var_recursive(name)
            except KeyError:
                return None

        lens = None
        for n in op.input_arg_names():
            v = var(n)
            if v is not None and v.seq_lens is not None:
                lens = v.seq_lens
                break
        if lens is None:
            return
        for n in op.output_arg_names():
            v = var(n)
            if v is not None and v.seq_lens is None and v.name != lens.name:
                v.seq_lens = lens
                if v.lod_level == 0:
                    v.lod_level = 1

    # -- inputs ------------------------------------------------------------
    def multiple_input(self, input_param_name='input'):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('param_attr'))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get('bias_attr'))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError('parameter number mismatch')
        elif len(param_attr) == 1 and length != 1:
            param_attr = [copy.deepcopy(param_attr[0]) for _ in range(length)]
        return param_attr

    def iter_inputs_and_params(self, input_param_name='input'):
        inputs = self.multiple_input(input_param_name)
        param_attrs = self.multiple_param_attr(len(inputs))
        return zip(inputs, param_attrs)

    def input_dtype(self, input_param_name='input'):
        dtype = None
        for each in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError('data types of inputs differ: %s vs %s'
                                 % (dtype, each.dtype))
        return dtype

    # -- parameters --------------------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        """Create the Parameter var in the main program's global block AND
        append its init op to the startup program. A WeightNormParamAttr
        gives the weight-normalised w = g * v / ||v|| instead."""
        from .param_attr import WeightNormParamAttr
        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normalized(
                attr, shape, dtype, default_initializer)
        attr = copy.deepcopy(attr) if attr is not None else ParamAttr()
        if attr is False:
            return None
        if default_initializer is None:
            attr.set_default_initializer(Constant(0.0) if is_bias
                                         else Xavier())
        else:
            attr.set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate('.'.join([self.name, 'w']))

        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(attr.name):
            sp_var = startup_block.create_var(
                name=attr.name, shape=shape, dtype=dtype, persistable=True)
            attr.initializer(sp_var, startup_block)

        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            return main_block.var(attr.name)
        return main_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr.to_kwargs().items() if k != 'name'})

    def _create_weight_normalized(self, attr, shape, dtype,
                                  default_initializer):
        """Parameters v (the weight's shape) and g (shape[dim], or [1]
        when dim is None), named <name>.wn.v and <name>.wn.g, and the
        ops that make w from them in the main program, so autograd
        reaches both. g starts at 1, as in the JAX package."""
        base = attr.name or unique_name.generate(
            '.'.join([self.name, 'w']))
        dim = attr.dim
        if dim is not None and dim < 0:
            dim = dim % len(shape)
        v = self.create_parameter(
            ParamAttr(name=base + '.wn.v', initializer=attr.initializer,
                      learning_rate=attr.learning_rate,
                      regularizer=attr.regularizer,
                      trainable=attr.trainable,
                      gradient_clip=attr.gradient_clip),
            shape, dtype, default_initializer=default_initializer)
        g = self.create_parameter(
            ParamAttr(name=base + '.wn.g',
                      learning_rate=attr.learning_rate,
                      trainable=attr.trainable,
                      initializer=Constant(1.0)),
            [1] if dim is None else [shape[dim]], dtype)
        from . import layers as L
        sq = L.elementwise_mul(v, v)
        if dim is None:
            norm_sq = L.reduce_sum(sq, dim=None, keep_dim=False)
        else:
            axes = [i for i in range(len(shape)) if i != dim]
            norm_sq = L.reduce_sum(sq, dim=axes, keep_dim=False)
        norm = L.sqrt(norm_sq)
        scale = L.elementwise_div(g, L.scale(norm, scale=1.0, bias=1e-12))
        if dim is None:
            return L.elementwise_mul(v, scale)
        return L.elementwise_mul(v, scale, axis=dim)

    def set_variable_initializer(self, var, initializer):
        """Also create the var + its init op in the startup program."""
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(var.name):
            sp_var = startup_block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype,
                persistable=True)
            initializer(sp_var, startup_block)
        return var

    def create_variable(self, **kwargs):
        return self.main_program.current_block().create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def create_or_get_global_variable(self, name, **kwargs):
        """A var of the main program's global block (batch norm's running
        statistics, the step counter), created on first use."""
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        return self.create_global_variable(name=name, **kwargs)

    def get_parameter(self, name):
        return self.main_program.global_block().var(name)

    # -- intermediate vars -------------------------------------------------
    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate('.'.join([self.name, 'tmp'])),
            dtype=dtype, stop_gradient=stop_gradient)

    # -- activation / bias epilogue ---------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type='elementwise_add',
            inputs={'X': [input_var], 'Y': [b]},
            outputs={'Out': [tmp]},
            attrs={'axis': dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get('act')
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {'type': act}
        else:
            act = copy.deepcopy(act)
        act_type = act.pop('type')
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={'X': [input_var]},
                       outputs={'Out': [tmp]}, attrs=act)
        return tmp
