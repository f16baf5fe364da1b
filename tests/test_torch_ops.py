"""paddle_tpu_torch ops against the JAX package's, one op at a time.

The same numpy inputs (made from a seed) go through a one-op Program in
both packages' executors on the CPU; float outputs must agree to
atol=1e-5 (fp32, sums taken in another order), integer outputs exactly.
The random initializers cannot match jax.random's streams, so they are
checked on their own; the tensor file format is checked byte for byte
across the two packages.
"""
import io as pyio

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.ops import io_ops as jio_ops
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import unique_name as tunique_name
from paddle_tpu_torch.ops import io_ops as tio_ops

ATOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_torch_programs():
    """The JAX package's fixture (conftest.py) resets only its own
    default programs; reset the port's too."""
    prev_main = tframework.switch_main_program(tframework.Program())
    prev_startup = tframework.switch_startup_program(tframework.Program())
    old_gen = tunique_name.switch()
    with tfluid.scope_guard(tfluid.Scope()):
        yield
    tframework.switch_main_program(prev_main)
    tframework.switch_startup_program(prev_startup)
    tunique_name.switch(old_gen)


def _f(rng, *shape):
    return rng.randn(*shape).astype('float32')


def _cases():
    r = np.random.RandomState(0)
    return [
        ('fill_constant', {}, {'shape': [2, 3], 'dtype': 'float32',
                               'value': 1.5}, ['Out']),
        ('reshape2', {'X': _f(r, 2, 3, 4)}, {'shape': [0, -1]}, ['Out']),
        ('transpose2', {'X': _f(r, 2, 3, 4)}, {'axis': [0, 2, 1]},
         ['Out']),
        ('slice', {'Input': _f(r, 3, 8, 5)},
         {'axes': [1], 'starts': [2], 'ends': [-1]}, ['Out']),
        ('mul', {'X': _f(r, 2, 3, 4), 'Y': _f(r, 4, 5)},
         {'x_num_col_dims': 2, 'y_num_col_dims': 1}, ['Out']),
        ('matmul', {'X': _f(r, 2, 3, 4, 5), 'Y': _f(r, 2, 3, 6, 5)},
         {'transpose_X': False, 'transpose_Y': True, 'alpha': 0.5},
         ['Out']),
        ('elementwise_add', {'X': _f(r, 2, 3, 4), 'Y': _f(r, 3, 4)},
         {'axis': 1}, ['Out']),
        ('gelu', {'X': _f(r, 4, 16) * 3}, {}, ['Out']),
        ('scale', {'X': _f(r, 3, 4)},
         {'scale': 2.0, 'bias': 0.5, 'bias_after_scale': False}, ['Out']),
        ('argmax', {'X': _f(r, 3, 7)}, {'axis': -1}, ['Out']),
        ('layer_norm', {'X': _f(r, 2, 3, 8), 'Scale': _f(r, 8),
                        'Bias': _f(r, 8)},
         {'epsilon': 1e-5, 'begin_norm_axis': 2},
         ['Y', 'Mean', 'Variance']),
        ('softmax', {'X': _f(r, 2, 3, 9) * 4}, {}, ['Out']),
        ('lookup_table', {'Ids': r.randint(0, 10, (2, 5, 1)).astype('int64'),
                          'W': _f(r, 10, 4)},
         {'is_sparse': False, 'is_distributed': False, 'padding_idx': 3},
         ['Out']),
        ('causal_mask', {'X': _f(r, 2, 2, 5, 5)}, {}, ['Out']),
        ('position_embedding', {'X': _f(r, 2, 5, 4), 'Pos': _f(r, 8, 4)},
         {}, ['Out']),
        ('flash_attention', {'Q': _f(r, 1, 2, 8, 16), 'K': _f(r, 1, 2, 8, 16),
                             'V': _f(r, 1, 2, 8, 16)},
         {'causal': True, 'sm_scale': None}, ['Out']),
        ('kv_cache_write', {'Cache': _f(r, 4, 6, 2, 3),
                            'X': _f(r, 2, 6, 2, 3),
                            'Slots': np.array([3, 1], 'int32')},
         {}, ['Out']),
        ('kv_cache_append', {'Cache': _f(r, 3, 4, 2, 2),
                             'X': _f(r, 3, 1, 2, 2),
                             'StepIdx': np.array([0, 5, 3], 'int32')},
         {}, ['Out']),
        ('decode_mask', {'X': _f(r, 3, 2, 1, 4),
                         'StepIdx': np.array([2, 5, 0], 'int32')},
         {}, ['Out']),
        ('position_embedding_at', {'Pos': _f(r, 5, 4),
                                   'Index': np.array([0, 3, 7], 'int32')},
         {}, ['Out']),
        ('gather_time', {'X': _f(r, 3, 5, 4),
                         'Index': np.array([0, 4, 2], 'int32')},
         {}, ['Out']),
        ('sharding_constraint', {'X': _f(r, 2, 3)},
         {'spec': [None, None]}, ['Out']),
        # the paged-cache ops: at most one dead row a case (dead rows
        # all land on the null page's row 0, in no set order)
        ('kv_page_cow', {'Pool': _f(r, 4, 2, 2, 2),
                         'Src': np.array([2, 0, 3], 'int32'),
                         'Dst': np.array([1, 0, 2], 'int32')},
         {}, ['Out']),
        ('kv_page_write', {'Pool': _f(r, 5, 2, 2, 3),
                           'X': _f(r, 1, 4, 2, 3),
                           'Table': np.array([[3, 1]], 'int32'),
                           'Positions': np.array([1, 2, 3, 4], 'int32'),
                           'Len': np.array([3], 'int32')},
         {}, ['Out']),
        ('kv_page_append', {'Pool': _f(r, 4, 2, 2, 2),
                            'X': _f(r, 3, 1, 2, 2),
                            'Table': np.array([[2, 3], [0, 0], [1, 0]],
                                              'int32'),
                            'Positions': np.array([3, 0, 1], 'int32')},
         {}, ['Out']),
        ('kv_page_append', {'Pool': _f(r, 6, 2, 2, 2),
                            'X': _f(r, 2, 3, 2, 2),
                            'Table': np.array([[2, 3], [4, 5]], 'int32'),
                            'Positions': np.array([[1, 2, 3], [2, 3, 4]],
                                                  'int32')},
         {}, ['Out']),
        ('kv_page_gather', {'Pool': _f(r, 4, 2, 2, 2),
                            'Table': np.array([[1, 3], [2, 0]], 'int32')},
         {}, ['Out']),
        ('paged_decode_mask', {'X': _f(r, 2, 2, 1, 6),
                               'Positions': np.array([1, 5], 'int32')},
         {}, ['Out']),
        ('spec_verify_mask', {'X': _f(r, 2, 2, 3, 6),
                              'Positions': np.array([[1, 2, 3], [3, 4, 9]],
                                                    'int32')},
         {}, ['Out']),
        ('paged_prefill_mask', {'X': _f(r, 1, 2, 3, 6),
                                'Positions': np.array([2, 3, 4], 'int32')},
         {}, ['Out']),
    ]


CASES = _cases()


def _run_one_op(fluid, op_type, inputs, attrs, out_slots):
    prog = fluid.Program()
    block = prog.global_block()
    ins = {}
    for slot, arr in inputs.items():
        ins[slot] = [block.create_var(
            name='in_' + slot.lower(), shape=arr.shape, dtype=arr.dtype.name,
            is_data=True)]
    outs = {slot: [block.create_var(name='out_' + slot.lower())]
            for slot in out_slots}
    block.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {v[0].name: inputs[slot] for slot, v in ins.items()}
    got = exe.run(prog, feed=feed,
                  fetch_list=[outs[s][0].name for s in out_slots],
                  scope=fluid.Scope())
    declared = [(tuple(outs[s][0].shape), outs[s][0].dtype)
                for s in out_slots]
    return [np.asarray(g) for g in got], declared


@pytest.mark.parametrize('case', CASES, ids=[
    c[0] + ('_rows' if c[0] == 'kv_page_append' and c[1]['Positions'].ndim
            == 2 else '') for c in CASES])
def test_op_matches_jax(case):
    op_type, inputs, attrs, out_slots = case
    want, want_decl = _run_one_op(jfluid, op_type,
                                  {k: v.copy() for k, v in inputs.items()},
                                  attrs, out_slots)
    got, got_decl = _run_one_op(tfluid, op_type,
                                {k: v.copy() for k, v in inputs.items()},
                                attrs, out_slots)
    assert got_decl == want_decl
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize('op_type,attrs', [
    ('uniform_random', {'min': -0.5, 'max': 2.0}),
    ('gaussian_random', {'mean': 1.0, 'std': 0.5}),
])
def test_random_initializer(op_type, attrs):
    """Shape, dtype and moments of the startup random ops, and that a
    program seed makes them repeat."""
    def draw(seed):
        prog = tfluid.Program()
        prog.random_seed = seed
        block = prog.global_block()
        out = block.create_var(name='w')
        block.append_op(type=op_type, outputs={'Out': [out]},
                        attrs=dict(attrs, shape=[200, 300],
                                   dtype='float32'))
        exe = tfluid.Executor(tfluid.CPUPlace())
        return exe.run(prog, fetch_list=['w'], scope=tfluid.Scope())[0]
    a, b, c = draw(11), draw(11), draw(12)
    assert a.shape == (200, 300) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    if op_type == 'uniform_random':
        assert a.min() >= -0.5 and a.max() < 2.0
        assert abs(a.mean() - 0.75) < 0.02
    else:
        assert abs(a.mean() - 1.0) < 0.01 and abs(a.std() - 0.5) < 0.01


@pytest.mark.parametrize('dtype', ['float32', 'int64', 'int32'])
def test_tensor_file_format_is_shared(dtype):
    arr = (np.random.RandomState(5).randn(3, 4) * 100).astype(dtype)
    jbuf, tbuf = pyio.BytesIO(), pyio.BytesIO()
    jio_ops.write_tensor(jbuf, arr)
    tio_ops.write_tensor(tbuf, arr)
    assert jbuf.getvalue() == tbuf.getvalue()
    np.testing.assert_array_equal(
        tio_ops.read_tensor(pyio.BytesIO(jbuf.getvalue())), arr)


def test_save_load_ops_round_trip(tmp_path):
    """save_persistables in the JAX package, load_persistables in the
    port, and back."""
    arrays = {'p.a': np.arange(6, dtype='float32').reshape(2, 3),
              'p.b': np.array([7, 8], dtype='int64')}

    def program(fluid):
        prog = fluid.Program()
        for name, arr in arrays.items():
            prog.global_block().create_var(name=name, shape=arr.shape,
                                           dtype=arr.dtype.name,
                                           persistable=True)
        return prog

    jscope = jfluid.Scope()
    for name, arr in arrays.items():
        jscope.set_var(name, arr)
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(jfluid.Executor(jfluid.CPUPlace()),
                                    str(tmp_path / 'j'), program(jfluid))
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tscope):
        tfluid.io.load_persistables(texe, str(tmp_path / 'j'),
                                    program(tfluid))
        tfluid.io.save_persistables(texe, str(tmp_path / 't'),
                                    program(tfluid))
    for name, arr in arrays.items():
        got = tscope.find_var(name)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), arr)
        assert (tmp_path / 'j' / name).read_bytes() == \
            (tmp_path / 't' / name).read_bytes()
