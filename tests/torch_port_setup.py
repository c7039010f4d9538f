"""Shared setup for the PyTorch-port tests (``tests/test_torch_*.py``).

Importing this module caps PyTorch at one intra-op thread, so that the
several pytest-xdist workers of a suite run do not oversubscribe the cores.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def rel_err(got, ref) -> float:
    """``max|got - ref| / (1 + max|ref|)``: the relative bar of the
    cross-solver checks."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / (1.0 + np.abs(ref).max()))


def to_numpy(t):
    """A torch tensor (or a list/tuple of them) as numpy."""
    if isinstance(t, (list, tuple)):
        return [to_numpy(x) for x in t]
    return t.detach().cpu().numpy()


FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")


def problem_arrays(prob) -> dict:
    """A problem (of either package) as a mapping of numpy arrays: what the
    parent hands the spawned ranks."""
    return {k: np.asarray(getattr(prob, k)) for k in FIELDS}


def spawn_cases(cases: dict) -> dict:
    """Run the sharded-solver cases ``{name: (world_size, case)}`` on the
    CPU, one spawn of ranks per world size
    (``rslqr_tpu_torch.parallel.dryrun.solve_cases``); returns ``{name:
    [each rank's result]}``."""
    from rslqr_tpu_torch.parallel.dryrun import solve_cases
    from rslqr_tpu_torch.parallel.launch import run_ranks

    out = {}
    for world in sorted({w for w, _ in cases.values()}):
        names = [k for k, (w, _) in cases.items() if w == world]
        res = run_ranks(solve_cases, world, "cpu",
                        args=([cases[k][1] for k in names],))
        for i, k in enumerate(names):
            out[k] = [r[i] for r in res]
    return out


def spawn_cases_beside(cases: dict, compute):
    """:func:`spawn_cases` in a thread while ``compute()`` (the parent's
    JAX references) runs in this one; returns both results."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        got = pool.submit(spawn_cases, cases)
        refs = compute()
        return got.result(), refs
