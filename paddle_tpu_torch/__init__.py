"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Same Program IR, layers and serving surface as the JAX package, run
with PyTorch: on the card the Executor captures each device segment of
a program once as a CUDA graph and replays it (where the JAX package
jit-compiles it), on the CPU it runs op by op; the TPU's Pallas kernels
become kernels written by hand for Hopper (kernels/, csrc/). Usage
mirrors the JAX package:

    import paddle_tpu_torch as fluid
    exe = fluid.Executor()               # CUDAPlace(0); CPUPlace() on request
    pred = fluid.inference.AnalysisPredictor(
        fluid.inference.AnalysisConfig(model_dir))
    with fluid.serving.LMServer(model_dir) as srv:
        tokens = srv.generate([1, 2, 3], max_new_tokens=16)

    lr = fluid.layers.noam_decay(d_model=2048, warmup_steps=4000)
    opt = fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.Adam(learning_rate=lr, beta2=0.98, epsilon=1e-9))
    opt.minimize(avg_cost)               # append_backward + adam ops
    pe = fluid.ParallelExecutor(use_cuda=True, loss_name=avg_cost.name)
    loss, = pe.run(fetch_list=[avg_cost.name])

    trainer = fluid.Trainer(train_func, optimizer_func,   # CUDAPlace(0)
                            checkpoint_config=fluid.CheckpointConfig(
                                checkpoint_dir=ckpt, step_interval=100))
    trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                  feed_order=['tokens', 'labels'])
    outs = fluid.Inferencer(param_path=model_dir).infer(feed)

This package imports neither jax nor paddle_tpu. What is ported so far
is the serving path; the training step of the transformer LM (py_reader
feed, backward, bf16 AMP, one device; the default TransformerConfig's
tensor- and sequence-parallel layers in their one-device form); ResNet
training through the fused conv + BN op (models.resnet, NCHW); and the
training core a plain Fluid program reaches: the eleven optimizers (SGD,
Momentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl, ProximalGD, ProximalAdagrad), on dense gradients and on a sparse
embedding's SelectedRows (lazy Adam and Adagrad touch its rows only), the six
learning-rate schedules, the Variable operators, and the math, tensor,
loss and dropout ops with their layers; rematerialization
(layers.recompute, TransformerConfig(remat=)); the high-level Trainer
(step and epoch events, checkpoints with exact resume, the anomaly guard,
step-fault retry and rollback) and Inferencer; and `obs`, the
observability they and the Executor report into (telemetry, trace
spans, the merged report, the perf and device-memory gauges, the SLO
watchdog), with `memory` and `distributed.{statefile,resilience}`; the
small one-device modules (memory_optimize, Print, average, op, the dot
drawers) and the dense book chapters with their feeding (fluid.batch,
DataFeeder, the reader decorators, the synthetic datasets, nets, the
image models); and sequences: LoD feeds (LoDTensor, a (padded, lengths)
tuple, DataFeeder's LoD slots) lowered to a padded tensor with a lengths
companion, the sequence ops and layers (LSTM, GRU, CRF, sequence
pooling and convolution, ...), models.stacked_lstm and the sequence
book chapters; control flow, beam search and machine_translation; and
the detection ops and layers (SSD's multi_box_head, ssd_loss and
detection_output, detection_map, Faster R-CNN's anchors, proposals and
RoI ops); the 3-D and indexed pooling ops, the misc tensor layers, the
evaluation ops with `metrics` and `evaluator`, fake quantization, the
one-device mixture-of-experts FFN (parallel.layers.moe_layer,
TransformerConfig(moe_experts=)) and the flowers, voc2012, mq2007 and
image dataset modules; `profiler` (the host table and chrome trace, a
torch.profiler device trace whose kernels carry the ops that launched
them, tools.timeline and tools.obs_report), RecordIO files with their
native readers (recordio, layers.open_files with the native image
decode, the datasets' convert) and the CSP channels (make_channel, Go);
and parameter-server training (`distributed`: the wire, RPC, parameter
service, master and supervisor; the send/recv/prefetch/listen_and_serv
ops; DistributeTranspiler), whose pservers run on the host while the
trainers run on the card.
The JAX package's place names TPUPlace and XLAPlace are CUDAPlace here.
ROADMAP.md lists the rest.
"""
from . import ops            # registers every operator (import side effect)
from . import parallel       # registers sharding_constraint
from . import framework
from .framework import (Program, Block, Operator, Variable, Parameter,
                        default_main_program, default_startup_program,
                        program_guard, name_scope, grad_var_name, get_var)
from . import layers
from . import initializer
from . import unique_name
from .param_attr import ParamAttr, WeightNormParamAttr
from . import executor
from .executor import (Executor, Scope, global_scope, scope_guard,
                       _switch_scope, CPUPlace, CUDAPlace, TPUPlace,
                       XLAPlace, CUDAPinnedPlace, fetch_var,
                       OpExecutionError)
from . import lod_tensor
from .lod_tensor import (LoDTensor, create_lod_tensor,
                         create_random_int_lodtensor)
Tensor = LoDTensor      # fluid.Tensor is LoDTensor, as in the JAX package
from . import io
from . import backward
from .backward import append_backward, calc_gradient
from . import regularizer
from . import clip
from . import optimizer
from . import contrib
from . import reader
from .batch import batch  # noqa: F401
from . import dataset
from . import nets
from .data_feeder import DataFeeder
from . import core
from . import parallel_executor
from .parallel_executor import (ParallelExecutor, ExecutionStrategy,
                                BuildStrategy)
from . import flags
from .flags import set_flags, get_flag, get_flags
from . import inference
from . import models
from . import transpiler
from .transpiler import (InferenceTranspiler, memory_optimize,
                         release_memory, DistributeTranspiler,
                         DistributeTranspilerConfig)
from . import serving
from . import obs
from . import memory
from . import distributed
from .trainer import (Trainer, CheckpointConfig, BeginEpochEvent,
                      EndEpochEvent, BeginStepEvent, EndStepEvent,
                      FaultEvent)
from .inferencer import Inferencer
from . import average
from . import annotations
from . import default_scope_funcs
from . import debugger
from . import graphviz
from . import net_drawer
from . import op
from . import metrics
from . import evaluator
from . import profiler
from . import recordio
from .recordio import (convert_reader_to_recordio_file,
                       convert_reader_to_recordio_files)
from . import recordio_writer
from . import channels
from .channels import make_channel
from . import concurrency
from .concurrency import Go

__all__ = [
    'Program', 'Block', 'Operator', 'Variable', 'Parameter',
    'default_main_program', 'default_startup_program', 'program_guard',
    'name_scope', 'grad_var_name', 'get_var', 'layers', 'initializer',
    'unique_name', 'ParamAttr', 'WeightNormParamAttr',
    'Executor', 'Scope', 'global_scope', 'scope_guard', '_switch_scope',
    'CPUPlace', 'TPUPlace', 'XLAPlace', 'CUDAPlace', 'fetch_var', 'OpExecutionError', 'LoDTensor', 'Tensor',
    'create_lod_tensor', 'create_random_int_lodtensor', 'io', 'flags',
    'set_flags', 'get_flag', 'get_flags', 'inference', 'models',
    'transpiler', 'serving', 'backward', 'append_backward',
    'calc_gradient', 'regularizer', 'clip', 'optimizer', 'contrib',
    'reader', 'batch', 'dataset', 'nets', 'DataFeeder', 'core',
    'ParallelExecutor', 'ExecutionStrategy', 'BuildStrategy',
    'InferenceTranspiler', 'memory_optimize', 'release_memory',
    'DistributeTranspiler', 'DistributeTranspilerConfig', 'obs',
    'memory', 'distributed', 'Trainer', 'CheckpointConfig',
    'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent', 'EndStepEvent',
    'FaultEvent', 'Inferencer', 'average', 'annotations',
    'default_scope_funcs', 'graphviz', 'net_drawer', 'op', 'metrics',
    'evaluator', 'profiler', 'Go',
]
