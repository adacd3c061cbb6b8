"""Deployment wrapper: assign devices with a trained D3QN agent (greedy);
port of ``repro.core.assignment.drl``. The agent runs on the device its
parameters live on; ``drl_assign_traced`` deploys it on lane-batched
device tensors for the fused sweep."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.drl.d3qn import q_values_all_t
from repro_torch.utils import tree_leaves


_INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


def drl_features_traced(u, D, p, g, sched_idx):
    """The agent's features of each lane's scheduled cohort, on the
    device (the reference's traced twin of ``drl.train.drl_features``):
    u/D/p (S, N), g (S, N, M), sched_idx (S, H) -> (S, H, M+3) f32. The
    same column order (g | u | D | p), gains in dB and the eq. (24)
    min-max normalisation over the cohort, in f32."""
    feats = torch.cat([g, u[..., None], D[..., None], p[..., None]], dim=-1)
    feats = torch.take_along_dim(feats, sched_idx[..., None], dim=1)
    M = g.shape[-1]
    # log10 as XLA lowers it, ln(x) times an f32 1/ln(10): agrees with the
    # reference's f32 features in ~99.6 % of elements where torch.log10
    # agrees in ~73 % (each off by an ulp of ~120 dB, ~1e-6 normalised)
    gains_db = 10.0 * (torch.log(torch.clamp_min(feats[..., :M], 1e-30))
                       * _INV_LN10)
    feats = torch.cat([gains_db, feats[..., M:]], dim=-1)
    lo = feats.amin(dim=-2, keepdim=True)
    hi = feats.amax(dim=-2, keepdim=True)
    return ((feats - lo) / torch.clamp_min(hi - lo, 1e-12)).float()


@torch.no_grad()
def drl_assign_traced(params, u, D, p, g, sched_idx):
    """Greedy (argmax-Q) edge per scheduled device for S lanes, on the
    device with no host round trip: (S, H) int64."""
    q = q_values_all_t(params, drl_features_traced(u, D, p, g, sched_idx))
    return q.argmax(dim=-1)


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
