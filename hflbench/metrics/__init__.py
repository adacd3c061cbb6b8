"""Metric readers, end-to-end and per-layer: ``<metric>.py`` holds
``read(run)``, which returns the metric's value from what the run
recorded, or None where it finds nothing to read (the harness then
leaves the metric out)."""


def phase_ms(run, phase: str):
    """Mean milliseconds a window round spent in a program phase."""
    recs = getattr(run.driver, "records", None)
    if not recs:
        return None
    return 1e3 * sum(r["seconds"].get(phase, 0.0) for r in recs) / len(recs)
