"""Device meshes (port of ``repro.launch.mesh``).

JAX's meshes become ``torch.distributed`` ``DeviceMesh``es over the
default process group: every factory is a FUNCTION that needs an
initialised group (``init_group`` reads torchrun's environment, the
counterpart of what ``jax.make_mesh`` gets from the runtime) whose size
fits the mesh, and raises otherwise; nothing here runs at import.

Mesh semantics (HFL mapping):
  pod   (2)  — cloud tier: each pod is one edge-server cohort
  data  (16) — devices within an edge cohort (batch / FSDP axis)
  model (16) — tensor/expert parallel within a cohort
  lane       — the sweep's 1-D mesh of independent seed lanes

``device_type`` is ``"cuda"`` (each rank on ``cuda:{LOCAL_RANK}``)
unless the caller passes ``"cpu"`` (gloo ranks, the CPU tests).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def init_group(device_type: str = "cuda") -> torch.device:
    """Initialise the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless
    one exists, and return this rank's device: ``cuda:{LOCAL_RANK}``
    (made current) with NCCL, or the CPU with gloo."""
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", init_method="env://")
    return device


def _check_group(shape, what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs an initialised process group (launch under "
            "torchrun and call repro_torch.launch.mesh.init_group(), or "
            "torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"{what} of shape {tuple(shape)} needs {n} ranks; "
                         f"the group has {dist.get_world_size()}")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(data 16, model 16) over 256 ranks, or (pod 2, data 16, model 16)
    over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _check_group(shape, "make_production_mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """One-rank mesh with the production axis names."""
    shape = (1, 1, 1) if multi_pod else (1, 1)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _check_group(shape, "make_debug_mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def sweep_mesh(n_devices=None, device_type: str = "cuda"):
    """1-D ``("lane",)`` mesh over every rank of the group, for
    lane-parallel sweeps (``SweepRunner(shard=True)``): seed lanes are
    independent, so the sweep only ever shards the stacked lane axis.
    ``n_devices``, when given, must be the group's size (the reference
    takes the first n local devices; a torch mesh spans its group)."""
    if not dist.is_initialized():
        _check_group((1,), "sweep_mesh")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"sweep_mesh: asked for {n_devices} ranks, the "
                         f"group has {n}")
    return init_device_mesh(device_type, (n,), mesh_dim_names=("lane",))
