"""Spawn ranks: one helper for the tests, ``chip_smoke.py``,
``bench_scaling_torch.py`` and ``examples/multichip_torch.py``.

:func:`run_ranks` starts ``world_size`` processes with the ``spawn``
method. Each joins one process group through a ``FileStore`` in a fresh
temporary directory (no TCP port to race for), caps PyTorch at one
intra-op thread, runs ``fn(rank, world_size, device_type, *args)`` and
hands its return value back to the parent (through ``torch.save``). A rank
that raises fails the whole run: the others are stopped and the parent
raises.

``fn`` must be a module-level function of a module that imports no JAX:
a spawned child re-imports the module of its function. Backend: NCCL when
``device_type="cuda"`` and every rank has a card of its own, else gloo
(several ranks on one card run gloo on that card; see :mod:`.comm`). On
the card the parent builds the kernel library first, so the ranks only
load it.
"""

from __future__ import annotations

import datetime
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT = datetime.timedelta(seconds=600)


def default_backend(device_type: str, world_size: int) -> str:
    """NCCL for one card a rank, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, world_size, device_type, backend, tmp, args):
    torch.set_num_threads(1)
    device = None
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=TIMEOUT,
                            device_id=device if backend == "nccl" else None)
    try:
        out = fn(rank, world_size, device_type, *args)
        dist.barrier()
    except BaseException:
        # The parent names one failed rank, often one that only lost its
        # peer; print each rank's own traceback so the cause shows.
        print(f"rank {rank} of {world_size} failed:\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def run_ranks(fn, world_size: int, device_type: str = "cuda", args=()):
    """Run ``fn(rank, world_size, device_type, *args)`` on ``world_size``
    spawned ranks; returns their return values in rank order."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' without a CUDA device")
        from ..ops import _build

        _build.build()
    backend = default_backend(device_type, world_size)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, nprocs=world_size, start_method="spawn", join=True,
            args=(fn, world_size, device_type, backend, tmp, tuple(args)),
        )
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
