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
