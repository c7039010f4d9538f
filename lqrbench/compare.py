"""The comparison that decides ``correct``: numbers computed from the
program's KKT vectors ``out [B, nvars]`` against the reference's ``ref``
(f64) for the same pool batch. Each is infinite where ``out`` has another
shape or is not finite.

* ``kkt_rel_err``: the worst instance's ``max|out - ref| / (1 + max|ref|)``.
* ``kkt_dev_err``: the same on each instance's deviation from the batch
  mean, ``(out_i - mean(out)) - (ref_i - mean(ref))`` over
  ``1 + max|ref_i - mean(ref)|``. The instances of a batch share one base
  problem, so the part of the rounding error they share cancels, and what
  sets one instance apart (its own x0, q, r) is held to its own size: an
  answer handed to the wrong instance fails it even where the shared part
  of the solution is large (the double integrator's ~2e4).
"""

import math

import torch


def _usable(out, ref):
    return (tuple(out.shape) == tuple(ref.shape)
            and bool(torch.isfinite(out).all()))


def kkt_rel_err(out, ref) -> float:
    if not _usable(out, ref):
        return math.inf
    out = out.to(ref.dtype)
    num = (out - ref).abs().amax(-1)
    return float((num / (1.0 + ref.abs().amax(-1))).amax())


def kkt_dev_err(out, ref) -> float:
    if not _usable(out, ref):
        return math.inf
    out = out.to(ref.dtype)
    dev_out, dev_ref = out - out.mean(0), ref - ref.mean(0)
    num = (dev_out - dev_ref).abs().amax(-1)
    return float((num / (1.0 + dev_ref.abs().amax(-1))).amax())


NUMBERS = {"kkt_rel_err": kkt_rel_err, "kkt_dev_err": kkt_dev_err}


def numbers(out, ref) -> dict:
    return {name: fn(out, ref) for name, fn in NUMBERS.items()}
