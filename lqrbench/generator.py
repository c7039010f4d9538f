"""The request pool: P distinct batches of perturbed LQR problems, made on
the device from the run's seed.

Each pool entry is a base problem (``problems/<kind>.py``, named by the
configuration's ``problem`` key) perturbed into ``B`` instances the way
the repo's ``batch_problems`` does it: every field copied per instance,
then ``x0``, ``q`` and ``r`` shifted by ``SCALE * N(0, 1)`` noise drawn in
bulk. A random base (``problem: "random"``) is drawn anew for each pool
entry; a fixed one (the double integrator) differs only by its noise.
The same seed gives the same pool on the same device.
"""

import importlib
from pathlib import Path

import torch

FIELDS = ("A", "B", "f", "Qdiag", "Rdiag", "q", "r", "c", "x0")
PERTURBED = ("x0", "q", "r")
SCALE = 0.1  # the perturbation of ``batch_problems``
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def problem_module(kind: str):
    """``problems/<kind>.py``, found by name."""
    path = Path(__file__).parent / "problems" / f"{kind}.py"
    if not path.exists():
        raise ValueError(f"no problem kind {kind!r} ({path} is missing)")
    return importlib.import_module(f"lqrbench.problems.{kind}")


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number that
    fits 64 unsigned bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def perturb(base: dict, batch: int, gen: torch.Generator) -> dict:
    """``batch`` copies of ``base`` on a new leading axis, ``x0``, ``q`` and
    ``r`` shifted by ``SCALE * N(0, 1)``."""
    out = {}
    for k in FIELDS:
        x = base[k].unsqueeze(0).expand((batch,) + base[k].shape)
        if k in PERTURBED:
            x = x + SCALE * torch.randn(x.shape, generator=gen,
                                        device=x.device, dtype=x.dtype)
        out[k] = x.contiguous()
    return out


def make_pool(config: dict, traffic: dict, seed: int, device,
              batch: int = None) -> list:
    """The cell's pool: ``traffic["pool"]`` batches of ``batch`` (default
    ``traffic["batch"]``) instances of the configuration's problem, in the
    configuration's dtype, on ``device``."""
    gen = generator(seed, device)
    mod = problem_module(config["problem"])
    dtype = DTYPES[config["dtype"]]
    batch = batch or traffic["batch"]
    return [perturb(mod.base(config, gen, device, dtype), batch, gen)
            for _ in range(traffic.get("pool", 4))]
