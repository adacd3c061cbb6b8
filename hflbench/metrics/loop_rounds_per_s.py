"""loop_rounds_per_s: ``rounds_per_s`` of a round cell, read per layer in
the traced run: the host loop's pace, which the allocator's host-paced
dispatch sets and which moves from run to run with the host's load
(PERF.md, section 2)."""
from hflbench.metrics.rounds_per_s import read  # noqa: F401
