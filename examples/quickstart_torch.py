"""Quickstart for the PyTorch port: solve an LQR problem three ways, check
optimality, solve a batch, and re-solve from one factorization.

The counterpart of ``examples/quickstart.py`` on ``rslqr_tpu_torch``. Run
from the repo root, on the card (the default) or on the CPU:

    python examples/quickstart_torch.py [path/to/lqr_prob.json]
    python examples/quickstart_torch.py --device cpu
"""

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rslqr_tpu_torch as pt  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", help="problem file (reference JSON)")
    ap.add_argument("--device", default="cuda",
                    help="device to solve on (default: the card)")
    args = ap.parse_args(argv)

    if args.path:
        prob, golden = pt.read_lqr_problem_json(args.path, device=args.device)
        print(f"loaded problem: N={prob.nhorizon} n={prob.nstates} "
              f"m={prob.ninputs}")
    else:
        prob = pt.double_integrator_problem(64, device=args.device)
        golden = None
        print("built double-integrator problem: N=64 n=6 m=3")

    # 1. rsLQR (recursive Schur complement): the flagship solver.
    vec = pt.solve(prob).kkt_vector()
    print(f"rsLQR    KKT residual: {float(pt.kkt_residual(prob, vec)):.3e}")

    # 2. Serial Riccati recursion: also yields gains and cost-to-go.
    ric = pt.solve_riccati(prob)
    print(f"riccati  KKT residual: "
          f"{float(pt.kkt_residual(prob, ric.kkt_vector())):.3e}")
    print(f"first feedback gain K0 row 0: {ric.K[0][0].tolist()}")

    # 3. Parallel-scan Riccati (log-depth associative scan).
    par = pt.solve_pscan(prob)
    print(f"pscan    KKT residual: "
          f"{float(pt.kkt_residual(prob, par.kkt_vector())):.3e}")

    if golden is not None:
        err = float((vec.cpu() - torch.as_tensor(golden)).abs().max())
        print(f"max |rsLQR - golden|: {err:.3e}")

    # Batched MPC-style solve: 256 perturbed scenarios in one call.
    batch = pt.batch_problems(prob, 256, torch.Generator().manual_seed(0))
    vecs = pt.solve_kkt(batch)
    print(f"batched solve: {vecs.shape[0]} instances -> "
          f"{tuple(vecs.shape)}, max KKT residual "
          f"{float(pt.kkt_residual(batch, vecs).max()):.3e}")

    # Multi-RHS: reuse the factorization for a new initial state.
    prob2 = dataclasses.replace(prob, x0=prob.x0 + 0.1)
    fact, _ = pt.factorize(prob)
    sol2 = pt.solve_rhs(prob2, fact, pt.leaf_solve_rhs(prob2))
    res2 = float(pt.kkt_residual(prob2, sol2.kkt_vector()))
    print(f"multi-RHS KKT residual: {res2:.3e}")
    return res2


if __name__ == "__main__":
    main()
