"""Port tests: mixed-precision refinement (``rslqr_tpu_torch.refine``)
against ``rslqr_tpu``, on the same f64 problems on the CPU.

* ``kkt_apply`` / ``kkt_rhs`` against ``rslqr_tpu.refine``'s on a random
  batch-last f64 batch, atol ``1e-12 * max|ref|`` (the same sums in another
  order).
* The four refined entry points on a small-block batch (N=32, B=4, the em
  schedule) and on a flat-plane batch (N=16, B=1024, ``flat_planes``),
  each against JAX's f64 ``solve_kkt(pallas="off")`` of the same problem
  within ``1e-8 * (1 + max|ref|)``: the f32 factorization refined to f64
  accuracy. The problems hold f32-representable values, so the f32 copy the
  device half (and ``refined_kkt_device``) works with is the same problem.
"""

import collections

import jax
import numpy as np
import pytest
import torch

import torch_port_setup  # noqa: F401  (one torch thread per worker)
from torch_port_setup import rel_err

import rslqr_tpu as rt
from rslqr_tpu import refine as jref
from rslqr_tpu.config import SolveOptions as JaxOptions

import rslqr_tpu_torch as pt
from rslqr_tpu_torch.ops import flat

BAR = 1e-8
FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")
_jax_ref = jax.jit(lambda p: rt.solve_kkt(p, options=JaxOptions(pallas="off")))


def _arrays(N, n, m, B, seed, lead=True):
    """A well-conditioned random f64 batch with f32-representable values
    (numpy-seeded); leading batch axis, or batch-last with ``lead=False``."""
    rng = np.random.default_rng(seed)
    shapes = dict(A=(N, n, n), B=(N, n, m), f=(N, n), Qdiag=(N, n),
                  Rdiag=(N, m), q=(N, n), r=(N, m), c=(N,), x0=(n,))
    draw = dict(
        A=lambda s: np.eye(n) + 0.1 * rng.standard_normal(s),
        B=lambda s: 0.2 * rng.standard_normal(s),
        f=lambda s: 0.1 * rng.standard_normal(s),
        Qdiag=lambda s: 0.5 + rng.random(s),
        Rdiag=lambda s: 0.1 + rng.random(s),
        q=rng.standard_normal, r=rng.standard_normal,
        c=np.zeros, x0=rng.standard_normal,
    )
    out = {}
    for k in FIELDS:
        x = draw[k]((B,) + shapes[k]).astype(np.float32).astype(np.float64)
        out[k] = x if lead else np.moveaxis(x, 0, -1).copy()
    return out


def _jax(arrs):
    return rt.LQRProblem(**{k: jax.numpy.asarray(v) for k, v in arrs.items()})


def _torch(arrs):
    return pt.LQRProblem(**{k: torch.as_tensor(v) for k, v in arrs.items()})


def test_kkt_apply_and_rhs_match_jax():
    arrs = _arrays(8, 3, 2, 5, seed=1, lead=False)
    rng = np.random.default_rng(2)
    Y, X, U = (rng.standard_normal(s) for s in ((8, 3, 5), (8, 3, 5),
                                                 (8, 2, 5)))
    want = jref.kkt_apply(_jax(arrs), Y, X, U) + jref.kkt_rhs(_jax(arrs))
    tY, tX, tU = (torch.as_tensor(v) for v in (Y, X, U))
    got = pt.kkt_apply(_torch(arrs), tY, tX, tU) + pt.kkt_rhs(_torch(arrs))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-12 * np.abs(w).max())


@pytest.fixture(scope="module", params=["small", "flat"])
def case(request):
    """(port problem, options, JAX f64 reference KKT vectors)."""
    if request.param == "small":
        arrs, opts = _arrays(32, 6, 3, 4, seed=3), pt.SolveOptions()
    else:
        arrs, opts = _arrays(16, 3, 2, 1024, seed=4), pt.SolveOptions(
            flat_planes=True)
    ref = np.asarray(_jax_ref(_jax(arrs)))
    return request.param, _torch(arrs), opts, ref


def _close(got, ref, what):
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= BAR * (1.0 + np.abs(ref).max()), f"{what}: {err:.3e}"


def test_solve_refined(case, monkeypatch):
    """f32 factorization + 2 iterations; on the flat batch, the flat
    kernels only: B11 once, B10 per level, B12 for the initial solve and
    each iteration."""
    name, prob, opts, ref = case
    counter = collections.Counter()
    for k in ("leaf_schur_level0_flat", "schur_update_level_flat",
              "rhs_update_level_flat"):
        def counted(*a, _fn=getattr(flat, k), _k=k, **kw):
            counter[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(flat, k, counted)
    sol = pt.solve_refined(prob, iterations=2, solve_dtype=torch.float32,
                           options=opts)
    calls = dict(counter)
    kkt = sol.kkt_vector()
    assert kkt.dtype == torch.float64 and tuple(kkt.shape) == ref.shape
    assert sol.U.shape == prob.r[:, :-1].shape
    _close(kkt.numpy(), ref, f"{name} solve_refined")
    # One f32 solve alone misses the bar by orders of magnitude.
    assert rel_err(pt.solve_kkt(prob.to(dtype=torch.float32),
                                options=opts).double().numpy(), ref) > 1e-7
    if name == "flat":
        assert calls == {"leaf_schur_level0_flat": 1,
                         "schur_update_level_flat": 2,
                         "rhs_update_level_flat": 12}
    else:
        assert not calls


@pytest.mark.parametrize("entry", ["host", "device"])
def test_solve_refined_host_and_device(case, entry):
    """numpy float64 ``[B, nvars]`` out, with the final max-norm KKT
    residual; the single-problem call returns ``[nvars]``."""
    name, prob, opts, ref = case
    fn = {"host": pt.solve_refined_host,
          "device": pt.solve_refined_device}[entry]
    kkt, res = fn(prob, iterations=3, options=opts)
    assert isinstance(kkt, np.ndarray) and kkt.dtype == np.float64
    assert kkt.shape == ref.shape
    assert isinstance(res, float) and res < 1e-9
    _close(kkt, ref, f"{name} {entry}")
    one, res1 = fn(prob.map(lambda x: x[0]), iterations=3, options=opts)
    assert one.shape == ref.shape[1:]
    _close(one, ref[0], f"{name} {entry} single")


def test_refined_kkt_device(case):
    """``(hi, lo, residual)``: f32 ``[B, nvars]`` halves whose f64 sum is
    the refined solution, and a device scalar residual."""
    name, prob, _, ref = case
    hi, lo, res = pt.refined_kkt_device(prob, iterations=3,
                                        options=pt.SolveOptions(kernels="off"))
    assert hi.dtype == lo.dtype == torch.float32
    assert tuple(hi.shape) == tuple(lo.shape) == ref.shape
    assert res.dim() == 0 and float(res) < 1e-9
    assert float(lo.abs().max()) <= 1e-6 * float(hi.abs().max())
    _close((hi.double() + lo.double()).numpy(), ref, f"{name} kkt_device")
