"""Port tests: the probes of ``probes/probe_pgemm.py`` (P1 ``pgemm_ib``, P2
``fma_peak``) against their ports in ``rslqr_tpu_torch/ops/probe.py``.

The JAX probes compile for the TPU only ("Only interpret mode is supported
on CPU backend"), so the reference runs the probe's own kernel bodies
(``_gemm_kernel_ib``, ``_fma_peak_kernel``) through ``pl.pallas_call(...,
interpret=True)`` with the probe's block specs and grid. The port takes its
plain versions on CPU tensors. Inputs are f32 from one numpy seed, the
probe's type; bar ``1e-5 * (1 + max|ref|)`` (f32 sums in another order).

Importing the probe sets JAX's persistent-cache options
(probe_pgemm.py:17, 24-25); the fixture restores them, so that the other
tests of the same worker run as before.
"""

import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

from rslqr_tpu_torch.ops import probe

BAR = 1e-5
PROBE = Path(__file__).resolve().parent.parent / "probes" / "probe_pgemm.py"
P1, P2 = 16, 128
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


@pytest.fixture(scope="module")
def tpu_probe():
    """``probes/probe_pgemm.py`` as a module, with JAX's cache options and
    the cache variable of the environment as they were before."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    env = os.environ.get(CACHE_ENV)
    spec = importlib.util.spec_from_file_location("tpu_probe_pgemm", PROBE)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = env
    return mod


def jax_pgemm_ib(mod, A, B, ib, t1):
    """The probe's ``pgemm_ib`` (probe_pgemm.py:54-71) in interpret mode."""
    p, K, P1_, P2_ = A.shape
    q = B.shape[1]
    t2 = min(128, P2_)
    spec = lambda d0, d1: pl.BlockSpec((d0, d1, t1, t2),
                                       lambda i, j: (0, 0, i, j))
    return pl.pallas_call(
        functools.partial(mod._gemm_kernel_ib, p=p, K=K, ib=ib,
                          unroll_i=False),
        grid=(P1_ // t1, P2_ // t2),
        in_specs=[spec(p, K), spec(K, q)],
        out_specs=spec(p, q),
        out_shape=jax.ShapeDtypeStruct((p, q, P1_, P2_), A.dtype),
        interpret=True,
    )(A, B)


def jax_fma_peak(mod, A, reps, t1=8):
    """The probe's ``fma_peak`` (probe_pgemm.py:83-94) in interpret mode."""
    _, P1_, P2_ = A.shape
    t2 = 128
    spec = pl.BlockSpec((1, t1, t2), lambda i, j: (0, i, j))
    return pl.pallas_call(
        functools.partial(mod._fma_peak_kernel, reps=reps),
        grid=(P1_ // t1, P2_ // t2),
        in_specs=[spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(A.shape, A.dtype),
        interpret=True,
    )(A)


def test_probe_import_leaves_jax_cache_options(tpu_probe):
    assert tpu_probe.N_BLK == 36
    assert jax.config.jax_compilation_cache_dir != "/tmp/jax_cache"


@pytest.mark.parametrize("ib", [1, 2, 4])
@pytest.mark.parametrize("t1", [8, 16])
def test_pgemm_ib_plain_matches_probe(tpu_probe, ib, t1):
    rng = np.random.default_rng(10 * ib + t1)
    p = K = q = 12
    A = rng.standard_normal((p, K, P1, P2)).astype(np.float32)
    B = rng.standard_normal((K, q, P1, P2)).astype(np.float32)
    want = np.asarray(jax_pgemm_ib(tpu_probe, jnp.asarray(A),
                                   jnp.asarray(B), ib, t1))
    got = probe.pgemm_ib(torch.as_tensor(A), torch.as_tensor(B), ib=ib,
                         t1=t1)
    assert got.shape == (p, q, P1, P2) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < BAR
    # The same bytes as [p, K, F] planes.
    flat = probe.pgemm_ib(torch.as_tensor(A.reshape(p, K, -1)),
                          torch.as_tensor(B.reshape(K, q, -1)), ib=ib, t1=t1)
    assert torch.equal(flat.reshape(got.shape), got)


def test_fma_peak_plain_matches_probe(tpu_probe):
    rng = np.random.default_rng(3)
    X = rng.uniform(0.1, 0.5, (1, P1, P2)).astype(np.float32)
    want = np.asarray(jax_fma_peak(tpu_probe, jnp.asarray(X), 16))
    got = probe.fma_peak(torch.as_tensor(X), reps=16)
    assert got.shape == X.shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < BAR
    assert not np.allclose(want, X)


def test_probe_wrappers_contract():
    """Options checked on every route; the plain route counts no launch and
    leaves the operands as they are; ``reps=0`` is a copy."""
    A = torch.randn(4, 4, 32)
    B = torch.randn(4, 3, 32)
    A0, B0 = A.clone(), B.clone()
    probe.reset_launch_counts()
    for bad in (dict(ib=3), dict(t1=4)):
        with pytest.raises(ValueError):
            probe.pgemm_ib(A, B, **bad)
    with pytest.raises(ValueError):
        probe.fma_peak(A, reps=-1)
    with pytest.raises(ValueError):
        probe.pgemm_ib(A, B, kernels="on")
    C = probe.pgemm_ib(A, B, ib=4, kernels="off")
    assert torch.allclose(C, torch.einsum("ikf,kjf->ijf", A, B), atol=1e-6)
    x = probe.fma_peak(A, reps=0)
    assert torch.equal(x, A) and x.data_ptr() != A.data_ptr()
    assert torch.equal(A, A0) and torch.equal(B, B0)
    assert probe.launch_counts() == {"pgemm_ib": 0, "fma_peak": 0}
