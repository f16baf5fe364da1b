"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Same Program IR, layers and serving surface as the JAX package, run
eagerly op by op with PyTorch; the TPU's Pallas kernels become kernels
written by hand for Hopper (kernels/, csrc/). Usage mirrors the JAX
package:

    import paddle_tpu_torch as fluid
    exe = fluid.Executor()               # CUDAPlace(0); CPUPlace() on request
    pred = fluid.inference.AnalysisPredictor(
        fluid.inference.AnalysisConfig(model_dir))
    with fluid.serving.LMServer(model_dir) as srv:
        tokens = srv.generate([1, 2, 3], max_new_tokens=16)

    opt = fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.Momentum(learning_rate=0.001, momentum=0.9))
    opt.minimize(avg_cost)               # append_backward + momentum ops
    pe = fluid.ParallelExecutor(use_cuda=True, loss_name=avg_cost.name)
    loss, = pe.run(fetch_list=[avg_cost.name])

This package imports neither jax nor paddle_tpu. What is ported so far
is the serving path and the training step of the transformer LM
(py_reader feed, backward, Momentum/SGD under bf16 AMP, one device) and
ResNet training through the fused conv + BN op (models.resnet, NCHW);
ROADMAP.md lists the rest.
"""
from . import ops            # registers every operator (import side effect)
from . import parallel       # registers sharding_constraint
from . import framework
from .framework import (Program, Block, Operator, Variable, Parameter,
                        default_main_program, default_startup_program,
                        program_guard, get_var)
from . import layers
from . import initializer
from . import unique_name
from .param_attr import ParamAttr
from . import executor
from .executor import (Executor, Scope, global_scope, scope_guard,
                       CPUPlace, CUDAPlace, fetch_var, OpExecutionError)
from . import io
from . import backward
from .backward import append_backward, calc_gradient
from . import regularizer
from . import clip
from . import optimizer
from . import contrib
from . import reader
from . import core
from .parallel_executor import ParallelExecutor
from . import flags
from .flags import set_flags, get_flag, get_flags
from . import inference
from . import models
from . import transpiler
from . import serving

__all__ = [
    'Program', 'Block', 'Operator', 'Variable', 'Parameter',
    'default_main_program', 'default_startup_program', 'program_guard',
    'get_var', 'layers', 'initializer', 'unique_name', 'ParamAttr',
    'Executor', 'Scope', 'global_scope', 'scope_guard', 'CPUPlace',
    'CUDAPlace', 'fetch_var', 'OpExecutionError', 'io', 'flags',
    'set_flags', 'get_flag', 'get_flags', 'inference', 'models',
    'transpiler', 'serving', 'backward', 'append_backward',
    'calc_gradient', 'regularizer', 'clip', 'optimizer', 'contrib',
    'reader', 'core', 'ParallelExecutor',
]
