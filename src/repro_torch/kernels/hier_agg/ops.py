"""Hierarchical aggregation, eqs. (2)-(3): plain versions, CUDA kernel
wrappers and dispatchers for three kernels of ``repro.kernels.hier_agg``
(``src/repro/kernels/hier_agg/hier_agg.py``):

* K1 ``masked_aggregate`` replaces ``masked_aggregate_batched_pallas``.
  Row m is ``Σ_h mask[m,h]·sizes[h]·deltas[h] / max(Σ_h mask[m,h]·
  sizes[h], 1)``: eq. (2) per edge, and eq. (3) with ``mask=ones(1, M)``
  and ``sizes=D_{N_m}``. All-zero mask rows give zero rows.
* K3 ``weighted_aggregate`` replaces ``weighted_aggregate_batched_pallas``:
  a caller-supplied (M, H) panel times the (H, P) deltas.
  :func:`aggregate_pytrees` applies it to every leaf of a parameter dict.
* K4 ``masked_decode_aggregate`` replaces
  ``masked_decode_aggregate_batched_pallas``: K1 over the wire form of
  compressed updates, ``Σ_h mask·sizes·scales[h]·q[h] / max(Σ_h
  mask·sizes, 1)`` with q int8, bf16 or f32. The kernel folds the scales
  into its weight panel and widens q as it loads it, so the dense
  decoded matrix is never built; the dispatcher passes q in its own
  dtype for that reason.

The kernels are ``csrc/hier_agg.cu`` (see its header for what bounds them
on the card and how the design answers that). The lane-batched
``(S, ...)`` entries take the place of the reference's ``custom_vmap``
rules; the unbatched entries are their S=1 case. On CPU tensors each
dispatcher takes the plain version; on CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.utils import Params

# K4's wire dtypes and the C entry of each
_DECODE_ENTRIES = {torch.float32: "masked_decode_aggregate_f32",
                   torch.bfloat16: "masked_decode_aggregate_bf16",
                   torch.int8: "masked_decode_aggregate_i8"}


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ptrs: int):
    fn = getattr(build.library("hier_agg"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, tensors, operand: torch.Tensor, M: int):
    """Check the f32 ``tensors`` and the (S, H, P) ``operand`` (dtype
    checked by the caller), allocate the (S, M, P) output and launch
    entry ``name`` on the current stream; raise on a refused launch."""
    S, H, P = operand.shape
    for label, t in (*tensors.items(), ("operand", operand)):
        if t.device.type != "cuda" or t.device != operand.device:
            raise ValueError(f"{label} must be on the operand's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{label} must be contiguous")
        if label != "operand" and t.dtype != torch.float32:
            raise ValueError(f"{label} must be contiguous float32")
    if S > 65535 or max(M, H, P) >= 2 ** 31:
        raise ValueError(f"sizes beyond the kernel's grid: S={S}, M={M}, "
                         f"H={H}, P={P}")
    out = torch.empty((S, M, P), dtype=torch.float32, device=operand.device)
    if out.numel() == 0:
        return out
    ptrs = [t.data_ptr() for t in tensors.values()]
    with torch.cuda.device(operand.device):
        err = _entry(name, len(ptrs) + 2)(
            *ptrs, operand.data_ptr(), out.data_ptr(), S, M, H, P,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _check_masked(mask, sizes, operand, extra=()):
    if operand.dim() != 3 or mask.dim() != 3 or sizes.dim() != 2:
        raise ValueError("expected mask (S, M, H), sizes (S, H), "
                         "operand (S, H, P)")
    S, M, H = mask.shape
    if (sizes.shape != (S, H) or operand.shape[:2] != (S, H)
            or any(t.shape != (S, H) for t in extra)):
        raise ValueError(f"shape mismatch: mask {tuple(mask.shape)}, sizes "
                         f"{tuple(sizes.shape)}, operand "
                         f"{tuple(operand.shape)}")
    return M


# ------------------------------------------------- K1 masked_aggregate

def masked_aggregate_batched_ref(mask: torch.Tensor, sizes: torch.Tensor,
                                 deltas: torch.Tensor) -> torch.Tensor:
    """Plain version. mask (S, M, H); sizes (S, H); deltas (S, H, P) ->
    (S, M, P) f32: build the normalised panel, then one batched matmul."""
    w = mask.float() * sizes.float()[:, None, :]
    w = w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1.0)
    return torch.bmm(w, deltas.float())


def masked_aggregate_batched_cuda(mask: torch.Tensor, sizes: torch.Tensor,
                                  deltas: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Takes contiguous f32
    CUDA tensors of one device, mask (S, M, H), sizes (S, H) and deltas
    (S, H, P); raises on anything else and on a refused launch."""
    M = _check_masked(mask, sizes, deltas)
    if deltas.dtype != torch.float32:
        raise ValueError("deltas must be contiguous float32")
    out = _launch("masked_aggregate_f32", {"mask": mask, "sizes": sizes},
                  deltas, M)
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


# ----------------------------------------- K4 masked_decode_aggregate

def masked_decode_aggregate_batched_ref(mask: torch.Tensor,
                                        sizes: torch.Tensor,
                                        scales: torch.Tensor,
                                        q: torch.Tensor) -> torch.Tensor:
    """Plain version, as the reference's oracle: decode densely
    (``q.float() * scales``), then K1's plain version. mask (S, M, H);
    sizes, scales (S, H); q (S, H, P) -> (S, M, P) f32."""
    dec = q.float() * scales.float()[..., None]
    return masked_aggregate_batched_ref(mask, sizes, dec)


def masked_decode_aggregate_batched_cuda(mask: torch.Tensor,
                                         sizes: torch.Tensor,
                                         scales: torch.Tensor,
                                         q: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. mask (S, M, H),
    sizes and scales (S, H) contiguous f32; q (S, H, P) contiguous int8,
    bfloat16 or float32, read in that dtype; all on one CUDA device.
    Raises on anything else and on a refused launch."""
    M = _check_masked(mask, sizes, q, (scales,))
    if q.dtype not in _DECODE_ENTRIES:
        raise ValueError(f"q must be int8, bfloat16 or float32, got "
                         f"{q.dtype}")
    out = _launch(_DECODE_ENTRIES[q.dtype],
                  {"mask": mask, "sizes": sizes, "scales": scales}, q, M)
    masked_decode_aggregate_batched_cuda.launches += 1
    return out


masked_decode_aggregate_batched_cuda.launches = 0


def masked_decode_aggregate_batched(mask: torch.Tensor, sizes: torch.Tensor,
                                    scales: torch.Tensor,
                                    q: torch.Tensor) -> torch.Tensor:
    """(S, M, H), (S, H), (S, H), (S, H, P) -> (S, M, P) f32. CPU tensors
    take the plain version; CUDA tensors launch the kernel (mask, sizes
    and scales cast to contiguous f32, q kept in its wire dtype)."""
    if q.device.type == "cpu":
        return masked_decode_aggregate_batched_ref(mask, sizes, scales, q)
    return masked_decode_aggregate_batched_cuda(
        mask.float().contiguous(), sizes.float().contiguous(),
        scales.float().contiguous(), q.contiguous())


def masked_decode_aggregate(mask: torch.Tensor, sizes: torch.Tensor,
                            scales: torch.Tensor,
                            q: torch.Tensor) -> torch.Tensor:
    """mask (M, H); sizes, scales (H,); q (H, P) -> (M, P) f32: the S=1
    lane of :func:`masked_decode_aggregate_batched`."""
    return masked_decode_aggregate_batched(mask[None], sizes[None],
                                           scales[None], q[None])[0]


# ----------------------------------------------- K3 weighted_aggregate

def weighted_aggregate_batched_ref(weights: torch.Tensor,
                                   deltas: torch.Tensor) -> torch.Tensor:
    """Plain version. weights (S, M, H) as given (rows already
    normalised by the caller); deltas (S, H, P) -> (S, M, P) f32."""
    return torch.bmm(weights.float(), deltas.float())


def weighted_aggregate_batched_cuda(weights: torch.Tensor,
                                    deltas: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Takes contiguous f32
    CUDA tensors of one device, weights (S, M, H) and deltas (S, H, P);
    raises on anything else and on a refused launch."""
    if weights.dim() != 3 or deltas.dim() != 3:
        raise ValueError("expected weights (S, M, H), deltas (S, H, P)")
    S, M, H = weights.shape
    if deltas.shape[:2] != (S, H):
        raise ValueError(f"shape mismatch: weights {tuple(weights.shape)}, "
                         f"deltas {tuple(deltas.shape)}")
    if deltas.dtype != torch.float32:
        raise ValueError("deltas must be contiguous float32")
    out = _launch("weighted_aggregate_f32", {"weights": weights}, deltas, M)
    weighted_aggregate_batched_cuda.launches += 1
    return out


weighted_aggregate_batched_cuda.launches = 0


def weighted_aggregate_batched(weights: torch.Tensor,
                               deltas: torch.Tensor) -> torch.Tensor:
    """(S, M, H), (S, H, P) -> (S, M, P) f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel (inputs cast to contiguous
    f32 first)."""
    if deltas.device.type == "cpu":
        return weighted_aggregate_batched_ref(weights, deltas)
    return weighted_aggregate_batched_cuda(weights.float().contiguous(),
                                           deltas.float().contiguous())


def weighted_aggregate(weights: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """weights (M, H); deltas (H, P) -> (M, P) f32: the S=1 lane of
    :func:`weighted_aggregate_batched`."""
    return weighted_aggregate_batched(weights[None], deltas[None])[0]


def aggregate_pytrees(weights: torch.Tensor, device_params: Params) -> Params:
    """weights (M, H); every leaf of ``device_params`` has a leading
    device axis H. Returns the M aggregated models, each leaf (M, ...)
    in the leaf's dtype."""
    M = weights.shape[0]
    return {k: weighted_aggregate(weights, x.reshape(x.shape[0], -1))
            .reshape((M,) + x.shape[1:]).to(x.dtype)
            for k, x in device_params.items()}
