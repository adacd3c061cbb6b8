from repro_torch.core.assignment.geo import GeoAssigner  # noqa: F401
