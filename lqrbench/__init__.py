"""The benchmark of the PyTorch and CUDA port ``rslqr_tpu_torch``: batched
LQR solves per second and per-call latency on the card (see ``README.md``).
It imports neither JAX nor the JAX package."""
