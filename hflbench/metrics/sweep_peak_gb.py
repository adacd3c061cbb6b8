"""sweep_peak_gb: ``peak_gb`` of the sweep cell, which reports
``rounds_per_s`` end to end where the round cells report
``device_ms_per_round``."""
from hflbench.metrics.peak_gb import read  # noqa: F401
