"""sweep_idle_pct: ``idle_pct`` of the sweep cell, which reports
``rounds_per_s`` end to end where the round cells report
``device_ms_per_round``."""
from hflbench.metrics.idle_pct import read  # noqa: F401
