"""Pairwise squared distances for K-means: plain version, CUDA kernel
wrapper and dispatcher.

Replaces ``repro.kernels.kmeans_dist``'s ``pairwise_sq_dists_pallas``
(``src/repro/kernels/kmeans_dist/kmeans_dist.py``, body ``_kernel``) and
its ``ops.pairwise_sq_dists``: ``‖x‖² + ‖c‖² − 2x·c`` clamped at 0, in
f32. The kernel is ``csrc/kmeans_dist.cu`` (see its header for what
bounds it on the card and how the design answers that).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def pairwise_sq_dists_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version. x (N, P), c (K, P) -> (N, K) f32."""
    x, c = x.float(), c.float()
    xx = torch.sum(x * x, dim=1, keepdim=True)
    cc = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(xx + cc - 2.0 * (x @ c.T), 0.0)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("kmeans_dist").pairwise_sq_dists_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
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
    if -(-N // 32) > 65535 or max(N, K, P) >= 2 ** 31:
        raise ValueError(f"sizes beyond the kernel's grid: N={N}, K={K}, "
                         f"P={P}")
    out = torch.empty((N, K), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), c.data_ptr(), out.data_ptr(), N, K, P,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pairwise_sq_dists kernel launch failed: CUDA "
                           f"error {err}")
    pairwise_sq_dists_cuda.launches += 1
    return out


pairwise_sq_dists_cuda.launches = 0


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x (N, P), c (K, P) -> (N, K) f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (cast to contiguous f32)."""
    if x.device.type == "cpu":
        return pairwise_sq_dists_ref(x, c)
    return pairwise_sq_dists_cuda(x.float().contiguous(),
                                  c.float().contiguous())
