"""Faults planted under the timed path, to show that the check catches
them (``tests/test_faults.py`` on the CPU, ``calibrate.py --faults`` on
the card). Each wraps the traffic's entry point."""

import torch


def half_batch(solve):
    """Half of the batch left out: the first half solved, its answers
    handed out again for the rest."""
    def run(prob, options=None):
        B = prob.A.shape[0]
        h = max(B // 2, 1)
        out = solve(prob.map(lambda x: x[:h]), options=options)
        return torch.cat([out, out[:B - h]])
    return run


def altered(solve, rel: float = 0.05):
    """One answer altered where it is produced: one element of one
    instance's KKT vector moved by ``rel`` of that instance's largest."""
    def run(prob, options=None):
        out = solve(prob, options=options).clone()
        i, j = out.shape[0] // 2, out.shape[1] // 2
        out[i, j] += rel * (1.0 + out[i].abs().max())
        return out
    return run


FAULTS = {"half_batch": half_batch, "altered": altered}
