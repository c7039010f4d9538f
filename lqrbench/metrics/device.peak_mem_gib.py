"""Peak device memory allocated during the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start), in GiB."""


def read(run):
    if not run.window_peak:
        return None
    return run.window_peak / 2 ** 30
