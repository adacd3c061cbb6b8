"""Masked hierarchical aggregation, eqs. (2)-(3): plain version, CUDA
kernel wrapper and dispatcher.

Replaces ``repro.kernels.hier_agg``'s ``masked_aggregate_batched_pallas``
(``src/repro/kernels/hier_agg/hier_agg.py``, body
``_masked_kernel_batched``) and its ``ops.masked_aggregate``. Row m of
the output is ``Σ_h mask[m,h]·sizes[h]·deltas[h] / max(Σ_h mask[m,h]·
sizes[h], 1)``: eq. (2) per edge, and eq. (3) with ``mask=ones(1, M)``
and ``sizes=D_{N_m}``. All-zero mask rows give zero rows.

The kernel is ``csrc/hier_agg.cu`` (see its header for what bounds it on
the card and how the design answers that). The lane-batched ``(S, ...)``
entry takes the place of the reference's ``custom_vmap`` rule; the
unbatched entry is its S=1 case.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def masked_aggregate_batched_ref(mask: torch.Tensor, sizes: torch.Tensor,
                                 deltas: torch.Tensor) -> torch.Tensor:
    """Plain version. mask (S, M, H); sizes (S, H); deltas (S, H, P) ->
    (S, M, P) f32: build the normalised panel, then one batched matmul."""
    w = mask.float() * sizes.float()[:, None, :]
    w = w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1.0)
    return torch.bmm(w, deltas.float())


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.library("hier_agg").masked_aggregate_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_aggregate_batched_cuda(mask: torch.Tensor, sizes: torch.Tensor,
                                  deltas: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Takes contiguous f32
    CUDA tensors of one device, mask (S, M, H), sizes (S, H) and deltas
    (S, H, P); raises on anything else and on a refused launch."""
    if deltas.dim() != 3 or mask.dim() != 3 or sizes.dim() != 2:
        raise ValueError("expected mask (S, M, H), sizes (S, H), "
                         "deltas (S, H, P)")
    S, M, H = mask.shape
    P = deltas.shape[2]
    if sizes.shape != (S, H) or deltas.shape[:2] != (S, H):
        raise ValueError(f"shape mismatch: mask {tuple(mask.shape)}, sizes "
                         f"{tuple(sizes.shape)}, deltas {tuple(deltas.shape)}")
    for name, t in (("mask", mask), ("sizes", sizes), ("deltas", deltas)):
        if t.device.type != "cuda" or t.device != deltas.device:
            raise ValueError(f"{name} must be on deltas' CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if S > 65535 or max(M, H, P) >= 2 ** 31:
        raise ValueError(f"sizes beyond the kernel's grid: S={S}, M={M}, "
                         f"H={H}, P={P}")
    out = torch.empty((S, M, P), dtype=torch.float32, device=deltas.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(deltas.device):
        err = _kernel()(mask.data_ptr(), sizes.data_ptr(), deltas.data_ptr(),
                        out.data_ptr(), S, M, H, P,
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"masked_aggregate kernel launch failed: CUDA "
                           f"error {err}")
    masked_aggregate_batched_cuda.launches += 1
    return out


masked_aggregate_batched_cuda.launches = 0


def masked_aggregate_batched(mask: torch.Tensor, sizes: torch.Tensor,
                             deltas: torch.Tensor) -> torch.Tensor:
    """(S, M, H), (S, H), (S, H, P) -> (S, M, P) f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel (inputs of any float
    type are cast to contiguous f32 first)."""
    if deltas.device.type == "cpu":
        return masked_aggregate_batched_ref(mask, sizes, deltas)
    return masked_aggregate_batched_cuda(
        mask.float().contiguous(), sizes.float().contiguous(),
        deltas.float().contiguous())


def masked_aggregate(mask: torch.Tensor, sizes: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """mask (M, H); sizes (H,); deltas (H, P) -> (M, P) f32: the S=1 lane
    of :func:`masked_aggregate_batched`."""
    return masked_aggregate_batched(mask[None], sizes[None], deltas[None])[0]
