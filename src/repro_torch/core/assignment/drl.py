"""Deployment wrapper: assign devices with a trained D3QN agent (greedy);
port of ``repro.core.assignment.drl``. The agent runs on the device its
parameters live on."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.drl.d3qn import q_values_all_t
from repro_torch.utils import tree_leaves


@dataclasses.dataclass
class DRLAssigner:
    sp: cm.SystemParams
    params: dict                   # trained D3QN parameters (tensors)

    @torch.no_grad()
    def _greedy(self, feats: np.ndarray) -> np.ndarray:
        dev = tree_leaves(self.params)[0].device
        q = q_values_all_t(self.params, torch.as_tensor(feats, device=dev))
        return q.argmax(dim=-1).cpu().numpy()

    def assign(self, pop: cm.Population, sched_idx,
               rng=None) -> Tuple[np.ndarray, None]:
        from repro_torch.drl.train import drl_features
        return self._greedy(drl_features(pop, sched_idx)), None

    def assign_batch(self, pops, sched_idx=None,
                     rng=None) -> Tuple[np.ndarray, None]:
        """Greedy assignments for E populations in one batched pass.

        pops: a ``cost_model.PopulationBatch`` or a sequence of
        same-shape ``Population``s; sched_idx: shared (H,) indices,
        per-population (E, H), or None for all devices. Returns
        ((E, H) edge ids, None); row e equals ``assign(pops[e], ...)``.
        """
        from repro_torch.drl.train import drl_features_batch
        popb = (pops if isinstance(pops, cm.PopulationBatch)
                else cm.PopulationBatch.stack(pops))
        return self._greedy(drl_features_batch(popb, sched_idx)), None
