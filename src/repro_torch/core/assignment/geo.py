"""Geographical-distribution baseline: nearest edge (host path).

Port of ``repro.core.assignment.geo.GeoAssigner``: float64 numpy on the
host, so it gives the reference's assignment exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cost_model as cm


@dataclasses.dataclass
class GeoAssigner:
    sp: cm.SystemParams

    def assign(self, pop: cm.Population, sched_idx, rng=None):
        d = np.linalg.norm(pop.dev_pos[np.asarray(sched_idx)][:, None]
                           - pop.edge_pos[None], axis=-1)
        return np.argmin(d, axis=1), None
