"""The world of ``world.py`` in the program's own types, and what the
drivers share. This is the only place besides the drivers that imports
the program (``repro_torch``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from hflbench.world import World


def system_params(cfg: Dict):
    from repro_torch.core import cost_model as cm
    return cm.SystemParams(
        n_devices=cfg["n_devices"], n_edges=cfg["n_edges"],
        area_km=cfg["area_km"], u_range=(cfg["u_min"], cfg["u_max"]),
        d_range=(cfg["d_min"], cfg["d_max"]),
        edge_bw_range=(cfg["edge_bw_min"], cfg["edge_bw_max"]),
        cloud_bw=cfg["cloud_bw"],
        p_dbm_range=(cfg["p_dbm_min"], cfg["p_dbm_max"]),
        p_edge_dbm=cfg["p_edge_dbm"], f_max=cfg["f_max"],
        noise_dbm_hz=cfg["noise_dbm_hz"], alpha=cfg["alpha"],
        shadow_db=cfg["shadow_db"], L=cfg["L"], Q=cfg["Q"], lam=cfg["lam"],
        model_bits=float(cfg["parameters"] * 32))


def population(cfg: Dict, world: World, device):
    from repro_torch.core import cost_model as cm

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return cm.Population(
        u=f32(world.u), D=f32(world.D), p=f32(world.p),
        f_max=torch.full((cfg["n_devices"],), cfg["f_max"],
                         dtype=torch.float32, device=device),
        g=f32(world.g), g_cloud=f32(world.g_cloud), B_m=f32(world.B_m),
        dev_pos=world.dev_pos, edge_pos=world.edge_pos)


def federated(cfg: Dict, world: World):
    from repro_torch.data.partition import FederatedData
    return FederatedData(world.X, world.y, world.majority, world.X_test,
                         world.y_test, cfg["n_classes"])


def aggregation_launches() -> int:
    """K1's launch counter (CUDA launches of the masked aggregation)."""
    from repro_torch.kernels.hier_agg import ops
    return ops.masked_aggregate_leaves_batched_cuda.launches


def on_host(tree) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}
