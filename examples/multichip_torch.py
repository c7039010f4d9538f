"""Multi-rank example of the port: batch and horizon sharding over a mesh
(the counterpart of examples/multichip.py).

Spawns its own ranks (several ranks share one card, gloo on the card):

    python examples/multichip_torch.py [--ranks 4] [--device cpu]

or runs under torchrun, one process a rank:

    torchrun --nproc-per-node 4 examples/multichip_torch.py [--device cpu]
"""

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run(rank, world, device_type):
    """Every rank runs this, with the same global batch; rank 0 prints."""
    import rslqr_tpu_torch as pt
    from rslqr_tpu_torch.parallel import (make_mesh, solve_batch_sharded,
                                          solve_pscan_sharded,
                                          solve_seq_sharded)

    say = print if rank == 0 else (lambda *a, **k: None)
    dev = torch.device(device_type)
    say(f"{world} ranks: {device_type}")
    prob = pt.double_integrator_problem(256, dtype=torch.float32, device=dev)
    batch = pt.batch_problems(prob, 64, torch.Generator().manual_seed(0))

    # Pure data parallelism: instances sharded, no communication.
    dp_mesh = make_mesh((world,), ("dp",), device_type)
    sol = solve_batch_sharded(batch, dp_mesh).kkt_vector()
    say("dp-sharded batch (this rank's shard):", tuple(sol.shape))

    # Horizon sharding: knot points distributed; the top log2(D) tree
    # levels exchange boundary blocks by all_gather.
    if world >= 2:
        ndp = 2 if world % 2 == 0 else 1
        mesh = make_mesh((ndp, world // ndp), ("dp", "sp"), device_type)
        out = solve_seq_sharded(batch, mesh, "sp", "dp")
        say("dp x sp sharded (tree solver):", tuple(out.shape))
        ref = pt.solve_kkt(batch)
        scale = float(ref.abs().max())
        say("rel max diff vs single-device:",
            float((out - ref).abs().max()) / scale)

        # Horizon-sharded parallel scan: chunk-local scans, one segment
        # all_gather, O(n^2 D) traffic independent of N.
        out2 = solve_pscan_sharded(batch, mesh, "sp", "dp")
        say("dp x sp sharded (pscan):", tuple(out2.shape), "rel max diff:",
            float((out2 - ref).abs().max()) / scale)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks to spawn (ignored under torchrun)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if "RANK" in os.environ:  # under torchrun
        from rslqr_tpu_torch.parallel.launch import default_backend

        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                                  % torch.cuda.device_count())
        dist.init_process_group(default_backend(args.device, world))
        try:
            run(rank, world, args.device)
        finally:
            dist.destroy_process_group()
        return 0
    from rslqr_tpu_torch.parallel.launch import run_ranks

    run_ranks(run, args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
