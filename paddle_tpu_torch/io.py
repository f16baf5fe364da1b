"""Model persistence (counterpart of paddle_tpu/io.py).

As in the JAX package, saving and loading are save/load ops that the
Executor runs, and the `__model__` JSON plus the tensor file format are
the same byte for byte, so a directory saved by either package loads in
the other. `load_numpy_params` is the second route for weights: it fills
a Scope from {name: ndarray}, e.g. the JAX package's parameters read with
np.asarray(scope.find_var(name)).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .executor import torch_dtype
from .framework import (Program, Parameter, Variable, convert_np_dtype,
                        default_main_program)

__all__ = ['save_vars', 'save_params', 'save_persistables', 'load_vars',
           'load_params', 'load_persistables', 'save_inference_model',
           'load_inference_model', 'get_inference_program',
           'load_numpy_params']

_MODEL_FILENAME = '__model__'


def is_persistable(var):
    # cache vars (serving K/V rings) are persistable so the executor
    # writes them back to the Scope, but they are runtime state, not
    # weights: never saved or loaded
    return var.persistable and not var.is_cache


def is_parameter(var):
    return isinstance(var, Parameter)


def _build_io_program(vars, dirname, filename, op_type):
    prog = Program()
    block = prog.global_block()
    names = []
    for var in vars:
        v = block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                             persistable=True)
        names.append(v.name)
        if filename is None:
            block.append_op(
                type=op_type,
                inputs={'X': [v.name]} if op_type == 'save' else {},
                outputs={} if op_type == 'save' else {'Out': [v.name]},
                attrs={'file_path': os.path.join(dirname, v.name)})
    if filename is not None:
        block.append_op(
            type=op_type + '_combine',
            inputs={'X': names} if op_type == 'save' else {},
            outputs={} if op_type == 'save' else {'Out': names},
            attrs={'file_path': os.path.join(dirname, filename)})
    return prog


def _select_vars(main_program, vars, predicate, filter_fn):
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    else:
        vars = [main_program.global_block().var(v) if isinstance(v, str)
                else v for v in vars]
    if filter_fn is not None:
        vars = [v for v in vars if filter_fn(v)]
    return vars


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, filter_fn=None):
    main_program = main_program or default_main_program()
    vars = _select_vars(main_program, vars, predicate, filter_fn)
    executor.run(_build_io_program(vars, dirname, filename, 'save'))


def save_params(executor, dirname, main_program=None, filename=None,
                filter_fn=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename, filter_fn=filter_fn)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      filter_fn=None):
    save_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename, filter_fn=filter_fn)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, filter_fn=None):
    main_program = main_program or default_main_program()
    vars = _select_vars(main_program, vars, predicate, filter_fn)
    executor.run(_build_io_program(vars, dirname, filename, 'load'))


def load_params(executor, dirname, main_program=None, filename=None,
                filter_fn=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename, filter_fn=filter_fn)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      filter_fn=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename, filter_fn=filter_fn)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune to the inference subgraph, write `__model__` and the
    persistables."""
    main_program = main_program or default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    os.makedirs(dirname, exist_ok=True)
    pruned = main_program.clone(for_test=True)._prune(
        target_vars, feeds=feeded_var_names)
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME),
              'w') as f:
        f.write(json.dumps({
            'program': pruned.to_json(),
            'feed_names': list(feeded_var_names),
            'fetch_names': [v.name for v in target_vars],
        }))
    save_persistables(executor, dirname, pruned, params_filename)
    return [v.name for v in target_vars]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, load_params=True):
    """Returns (program, feed_names, fetch_vars). load_params=False skips
    the weights (a clone whose scope already holds them)."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILENAME)) as f:
        d = json.loads(f.read())
    program = Program.from_json(d['program'])
    if load_params:
        load_persistables(executor, dirname, program, params_filename)
    fetch_vars = [program.global_block().var(n) for n in d['fetch_names']]
    return program, d['feed_names'], fetch_vars


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    return main_program.clone(for_test=True)._prune(target_vars)


def load_numpy_params(scope, params, place, program=None):
    """Fill `scope` from {name: ndarray}: each array is copied into a
    tensor on `place`. With `program`, every name must be one of its persistable
    vars with the same shape, and the array is cast to the declared
    dtype; a mismatch raises before anything is written."""
    tensors = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if program is not None:
            var = program.global_block().vars.get(name)
            if var is None or not is_persistable(var):
                raise KeyError('%r is not a persistable var of the program'
                               % name)
            if var.shape is not None and tuple(var.shape) != arr.shape:
                raise ValueError('%r: got shape %s, the program declares %s'
                                 % (name, arr.shape, tuple(var.shape)))
            dtype = torch_dtype(var.dtype)
        else:
            dtype = torch_dtype(convert_np_dtype(arr.dtype))
        # a copy, never a view of the caller's array: the optimizer ops
        # update parameters in place
        tensors[name] = torch.tensor(arr, dtype=dtype, device=place.device)
    for name, t in tensors.items():
        scope.set_var(name, t)
