"""sweep_pad_share_pct: ``pad_share_pct`` of the sweep cell, which reports
``rounds_per_s`` end to end where the round cells report
``device_ms_per_round``."""
from hflbench.metrics.pad_share_pct import read  # noqa: F401
