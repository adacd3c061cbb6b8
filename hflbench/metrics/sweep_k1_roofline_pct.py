"""sweep_k1_roofline_pct: ``k1_roofline_pct`` of the sweep cell, which reports
``rounds_per_s`` end to end where the round cells report
``device_ms_per_round``."""
from hflbench.metrics.k1_roofline_pct import read  # noqa: F401
