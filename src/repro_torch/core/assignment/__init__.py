from repro_torch.core.assignment.geo import GeoAssigner  # noqa: F401
from repro_torch.core.assignment.hfel import HFELAssigner  # noqa: F401
from repro_torch.core.assignment.drl import DRLAssigner  # noqa: F401
