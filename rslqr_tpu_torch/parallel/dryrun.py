"""Multi-rank runs of the sharded solvers: the dry run and the case
runner.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip`` (:23-84): the same mesh choice,
sizes, 1e-4 parity bars against the port's single-device solves
(:func:`dryrun_report`), and print line. :func:`solve_cases` is the rank
function with which the tests and ``chip_smoke.py`` drive the sharded
solvers (the dry run's ranks among them): each case's output, its
collectives, the hand-kernel launches of its solve and its walls come back
to the parent. The ranks are spawned (:func:`.launch.run_ranks`): on one
card they share it (gloo on the card, see :mod:`.comm`).
"""

from __future__ import annotations

import time

import torch

from .launch import run_ranks

BAR = 1e-4


def mesh_shape(n_devices: int):
    """The dry run's ``(dp, sp)`` mesh: ``(n // 4, 4)`` when 4 divides
    ``n``, else ``(1, the largest power of two <= n)``, so that several
    tree levels cross ranks."""
    if n_devices >= 4 and n_devices % 4 == 0:
        return (n_devices // 4, 4)
    return (1, 1 << (n_devices.bit_length() - 1))


def _rel(out, ref) -> float:
    scale = float(ref.abs().max()) + 1.0
    return float((out - ref).abs().max()) / scale


def _dryrun_rank(rank, world, device_type, shape):
    """One rank of the dry run: the sharded rsLQR solve of a batch on the
    ``(dp, sp)`` mesh and the sharded scan of one problem on an sp mesh of
    every rank, each against the single-device solve."""
    import rslqr_tpu_torch as pt
    from .mesh import make_mesh
    from .pscan_seq import solve_pscan_sharded
    from .seq import solve_seq_sharded

    dev = torch.device(device_type)
    mesh = make_mesh(shape, ("dp", "sp"), device_type)
    batch_size, nhorizon = max(2, 2 * shape[0]), max(64, 16 * shape[1])
    prob = pt.double_integrator_problem(nhorizon, dtype=torch.float32,
                                        device=dev)
    batch = pt.batch_problems(prob, batch_size,
                              torch.Generator(device=dev).manual_seed(0))
    out = solve_seq_sharded(batch, mesh, "sp", "dp")
    err = _rel(out, pt.solve_kkt(batch))
    sp_mesh = make_mesh((world,), ("sp",), device_type)
    out2 = solve_pscan_sharded(prob, sp_mesh, "sp")
    err2 = _rel(out2, pt.solve_pscan_kkt(prob))
    return {"shape": tuple(out.shape), "err": err,
            "shape2": tuple(out2.shape), "err2": err2}


def dryrun_report(n_devices: int, shape, res) -> str:
    """Hold the dry run's rank results ``res`` to the 1e-4 bars (raises
    ``AssertionError``) and return its print line."""
    err = max(r["err"] for r in res)
    err2 = max(r["err2"] for r in res)
    assert err < BAR, f"sharded rslqr vs single-device: rel max diff = {err}"
    assert err2 < BAR, f"sharded pscan vs single-device: rel max diff = " \
                       f"{err2}"
    return (f"dryrun_multichip({n_devices}): ok, rslqr mesh "
            f"{dict(zip(('dp', 'sp'), shape))} out {res[0]['shape']} "
            f"parity {err:.2e}; pscan mesh {{'sp': {len(res)}}} out "
            f"{res[0]['shape2']} parity {err2:.2e}")


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """Run BOTH horizon-sharded solvers over an ``n_devices``-rank mesh and
    hold them to the single-device solves (1e-4 relative, as the JAX dry
    run): rsLQR on a ``(dp, sp)`` mesh, batch over dp and horizon over sp;
    pscan on a pure sp mesh."""
    shape = mesh_shape(n_devices)
    res = run_ranks(_dryrun_rank, shape[0] * shape[1], device_type,
                    args=(shape,))
    print(dryrun_report(n_devices, shape, res))


def _case_problem(case, dev):
    """A case's global problem: ``case["problem"]``, a mapping of numpy
    arrays, or ``case["baseline"] = (N, B, dtype)``, the BASELINE batch
    (the double integrator perturbed into ``B`` instances from the CPU
    generator seeded ``N``, as ``chip_smoke.py`` builds it)."""
    import rslqr_tpu_torch as pt

    if "problem" in case:
        return pt.problem_from_numpy(case["problem"], device=dev)
    N, B, dtype = case["baseline"]
    prob = pt.double_integrator_problem(N, dtype=getattr(torch, dtype),
                                        device=dev)
    return pt.batch_problems(prob, B, torch.Generator().manual_seed(N))


def solve_cases(rank, world, device_type, cases):
    """Rank function of :func:`.launch.run_ranks`: run each case (a dict:
    ``solver`` "seq", "pscan" or "batch"; ``mesh`` shape and ``axes``
    names; ``sp``/``dp`` axis names; the problem as in
    :func:`_case_problem`; ``reps`` timed repeats, default 0) and return,
    per case, the KKT vector(s) this rank got (its shard for "batch"), the
    recorder's collectives and transports, the hand-kernel launches of the
    solve (counts set to 0 just before it) and the walls in ms. A case
    ``{"solver": "dryrun", "mesh": (dp, sp)}`` runs this rank's part of
    the dry run on every rank instead (:func:`dryrun_report` reads it)."""
    from ..ops import flat, planes, schur
    from . import comm
    from .mesh import make_mesh, solve_batch_sharded
    from .pscan_seq import solve_pscan_sharded
    from .seq import solve_seq_sharded

    dev = torch.device(device_type)
    sync = torch.cuda.synchronize if device_type == "cuda" else lambda: None
    results = []
    for case in cases:
        if case["solver"] == "dryrun":
            results.append(_dryrun_rank(rank, world, device_type,
                                        case["mesh"]))
            continue
        prob = _case_problem(case, dev)
        mesh = make_mesh(case["mesh"], case["axes"], device_type)
        sp, dp = case.get("sp"), case.get("dp")
        solve = {
            "seq": lambda p: solve_seq_sharded(p, mesh, sp, dp),
            "pscan": lambda p: solve_pscan_sharded(p, mesh, sp, dp),
            "batch": lambda p: solve_batch_sharded(p, mesh,
                                                   dp).kkt_vector(),
        }[case["solver"]]
        for ops in (schur, planes, flat):
            ops.reset_launch_counts()
        sync()
        with comm.recording() as rec:
            kkt = solve(prob)
        sync()
        launches = {k: v for ops in (schur, planes, flat)
                    for k, v in ops.launch_counts().items() if v}
        walls = []
        for _ in range(case.get("reps", 0)):
            sync()
            t0 = time.perf_counter()
            solve(prob)
            sync()
            walls.append(1e3 * (time.perf_counter() - t0))
        results.append({"kkt": kkt.cpu().numpy(), "calls": rec.calls,
                        "transports": sorted(rec.transports),
                        "launches": launches, "walls_ms": walls})
    return results
