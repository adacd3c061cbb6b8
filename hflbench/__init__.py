"""A benchmark of the PyTorch and CUDA port (``repro_torch``): simulated
HFL rounds per second. See README.md."""
