"""peak_gb: the largest device memory the program's tensors held during
the window (``torch.cuda.max_memory_allocated`` after a reset at the
window's start), in GB."""


def read(run):
    return run.window_peak / 1e9 if run.window_peak else None
