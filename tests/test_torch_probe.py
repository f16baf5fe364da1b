"""The exp/exp2 probe P (paddle_tpu_torch/tools/probe_exp2.py): its plain
version against the JAX probe's kernel body (tools/probe_exp2.py
`_kernel`) run through pl.pallas_call in interpret mode, at
atol = rtol = 2e-5 (fp32 exp and exp2 of two libraries, a few ulps
apart; the chain shrinks errors); the kernel wrapper's checks; the
answer's arithmetic. The kernel itself is held to the plain version on
the card by chip_smoke.py (phase p)."""
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu_torch.tools import probe_exp2 as probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        'jax_probe_exp2', os.path.join(ROOT, 'tools', 'probe_exp2.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('reps', [4, 8])
@pytest.mark.parametrize('fn', ['exp', 'exp2'])
def test_plain_version_matches_the_pallas_probe_kernel(fn, reps):
    jp = _jax_probe()
    blocks, bq, bk = 2, 8, 128
    x = np.random.RandomState(0).rand(blocks, bq, bk).astype('float32')
    call = pl.pallas_call(
        functools.partial(jp._kernel, reps=reps,
                          fn={'exp': jnp.exp, 'exp2': jnp.exp2}[fn]),
        grid=(blocks,),
        in_specs=[pl.BlockSpec((1, bq, bk), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, bk), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)
    want = np.asarray(call(jnp.asarray(x)))
    got = probe.exp_chain_reference(torch.from_numpy(x), reps, fn)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_wrapper_refuses_cpu_tensors_and_unknown_functions():
    x = probe.probe_input((2, 3), device='cpu')
    before = probe.exp_chain_kernel.launches
    with pytest.raises(ValueError, match='CUDA tensor'):
        probe.exp_chain_kernel(x, 4, 'exp2')
    with pytest.raises(ValueError, match='not one of'):
        probe.exp_chain_kernel(x, 4, 'exp10')
    assert probe.exp_chain_kernel.launches == before


def test_probe_input_is_the_jax_probes():
    x = probe.probe_input((2, 4, 8), device='cpu')
    np.testing.assert_array_equal(
        x.numpy(), np.random.RandomState(0).rand(2, 4, 8).astype('float32'))


def test_report_answers_from_the_long_pair(capsys):
    rows = [{'fn': fn, 'reps': reps, 'ms': [1.0, 2.0], 'ns_per_elem': ns,
             'gsteps_per_s': 1.0 / ns}
            for reps, (e, e2) in (([4, 8], (1.0, 2.0)),
                                  ([64, 128], (3.0, 2.0)))
            for fn, ns in (('exp', e), ('exp2', e2))]
    assert probe.report(rows, 4e12) == 1.5
    assert 'exp2f saves time' in capsys.readouterr().out


def test_main_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    out = subprocess.run(
        [sys.executable, '-m', 'paddle_tpu_torch.tools.probe_exp2'],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert 'no CUDA device' in out.stderr
