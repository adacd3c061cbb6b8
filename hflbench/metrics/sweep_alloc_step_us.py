"""sweep_alloc_step_us: ``alloc_step_us`` of the sweep cell, which reports
``rounds_per_s`` end to end where the round cells report
``device_ms_per_round``."""
from hflbench.metrics.alloc_step_us import read  # noqa: F401
