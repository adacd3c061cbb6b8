"""Pairwise squared distances for K-means: plain version, CUDA kernel
wrapper and dispatcher.

Replaces ``repro.kernels.kmeans_dist``'s ``pairwise_sq_dists_pallas``
(``src/repro/kernels/kmeans_dist/kmeans_dist.py``, body ``_kernel``) and
its ``ops.pairwise_sq_dists``: ``‖x‖² + ‖c‖² − 2x·c`` clamped at 0, in
f32. The kernel is ``csrc/kmeans_dist.cu`` (see its header for what
bounds it on the card and how the design answers that); its launch plan
is :func:`launch_plan`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build


def pairwise_sq_dists_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version. x (N, P), c (K, P) -> (N, K) f32."""
    x, c = x.float(), c.float()
    xx = torch.sum(x * x, dim=1, keepdim=True)
    cc = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(xx + cc - 2.0 * (x @ c.T), 0.0)


ROW_TILE = 32       # x rows per output tile
MAX_SPLITS = 8      # blocks of a cluster (the portable size)
P_STEP = 64         # feature columns a block stages at once


class LaunchPlan(NamedTuple):
    row_tiles: int  # output tiles along N (ROW_TILE rows each)
    col_tile: int   # output columns a tile: 16 when K <= 16, else 32
    col_tiles: int
    splits: int     # blocks of one cluster, each over `chunk` columns of P
    chunk: int


def launch_plan(N: int, K: int, P: int, sms: int = 132) -> LaunchPlan:
    """How the kernel covers (N, K) outputs over P features on a card of
    ``sms`` SMs: output tiles of ROW_TILE x col_tile, each split along P
    across the blocks of a thread-block cluster. Split only while the
    tiles alone leave SMs idle, into at most MAX_SPLITS slices of at
    least P_STEP columns; every column of P lies in exactly one slice."""
    col_tile = 16 if K <= 16 else 32
    row_tiles, col_tiles = -(-N // ROW_TILE), -(-K // col_tile)
    tiles = row_tiles * col_tiles
    splits = 1
    if tiles < sms:
        splits = max(1, min(MAX_SPLITS, -(-sms // tiles), P // P_STEP))
    chunk = -(-P // splits)
    splits = max(1, -(-P // chunk)) if chunk else 1
    return LaunchPlan(row_tiles, col_tile, col_tiles, splits, chunk)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("kmeans_dist").pairwise_sq_dists_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pairwise_sq_dists_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Takes contiguous f32
    CUDA tensors of one device, x (N, P) and c (K, P); raises on anything
    else and on a refused launch."""
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"expected x (N, P) and c (K, P), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    for name, t in (("x", x), ("c", c)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be on x's CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    (N, P), K = x.shape, c.shape[0]
    out = torch.empty((N, K), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(N, K, P, sm_count(x.device))
    if (max(plan.row_tiles, plan.col_tiles) > 65535
            or max(N, K, P) >= 2 ** 31):
        raise ValueError(f"sizes beyond the kernel's grid: N={N}, K={K}, "
                         f"P={P}")
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), c.data_ptr(), out.data_ptr(), N, K, P,
                        plan.col_tile, plan.splits, plan.chunk,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_sq_dists kernel launch failed: CUDA "
                           f"error {err}")
    pairwise_sq_dists_cuda.launches += 1
    return out


pairwise_sq_dists_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x (N, P), c (K, P) -> (N, K) f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (cast to contiguous f32)."""
    if x.device.type == "cpu":
        return pairwise_sq_dists_ref(x, c)
    return pairwise_sq_dists_cuda(x.float().contiguous(),
                                  c.float().contiguous())
