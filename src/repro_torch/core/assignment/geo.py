"""Geographical-distribution baseline: nearest edge.

Port of ``repro.core.assignment.geo``: ``GeoAssigner`` is float64 numpy
on the host, so it gives the reference's assignment exactly;
``geo_assign_traced`` is its device twin for the fused sweep.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cost_model as cm


def geo_assign_traced(dev_pos, edge_pos, sched_idx):
    """Nearest edge of every scheduled device, lane by lane, on the
    device: dev_pos (S, N, 2), edge_pos (S, M, 2) f32, sched_idx (S, H)
    -> (S, H) int64 edge ids. Squared f32 distances as the reference's
    traced twin computes them; ties break to the first minimum, as
    ``np.argmin`` and ``torch.argmin`` do."""
    pos = torch.take_along_dim(dev_pos, sched_idx[..., None], dim=1)
    d2 = torch.sum(torch.square(pos[:, :, None] - edge_pos[:, None]), dim=-1)
    return torch.argmin(d2, dim=-1)


@dataclasses.dataclass
class GeoAssigner:
    sp: cm.SystemParams

    def assign(self, pop: cm.Population, sched_idx, rng=None):
        d = np.linalg.norm(pop.dev_pos[np.asarray(sched_idx)][:, None]
                           - pop.edge_pos[None], axis=-1)
        return np.argmin(d, axis=1), None
