"""Grouped-query flash attention (causal, sliding window), forward only:
plain version, CUDA kernel wrapper and dispatcher.

Replaces ``repro.kernels.flash_attention``'s ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/flash_attention.py``, body
``_kernel``) and its oracle ``ref.flash_attention_ref``. q is
(B, S, Hq, d), k and v (B, S, Hkv, d) with Hq % Hkv == 0; q head h reads
KV head h // (Hq // Hkv). Key j is kept for query i when j <= i (causal),
j > i - window (window > 0) and j < S; the softmax is f32 and the output
has q's dtype. The kernels are in ``csrc/flash_attention.cu`` (see its
header for what bounds them on the card and how the design answers
that), one per path that :func:`kernel_path` picks from the inputs:
``"wgmma"`` (bf16 whose layout TMA can read: warpgroup MMAs on tiles
that TMA loads), ``"wgmma_staged"`` (any other bf16 layout: the same
kernel on copies, :func:`tma_ready`, of the tensors TMA cannot read) and
``"tf32x3"`` (f32: mma.sync on TF32 operands split in two, three
products a pair), all with f32 softmax statistics. They read the layout
through its strides, so the reference's transposes and its padding of S
exist nowhere here; d is padded (to a multiple of 8, not of 128) only in
the copies of ``"wgmma_staged"``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
PATHS = ("wgmma", "wgmma_staged", "tf32x3")
_ENTRIES = {"wgmma": "flash_attention_bf16_wgmma",
            "wgmma_staged": "flash_attention_bf16_wgmma",
            "tf32x3": "flash_attention_f32"}
# host-side failures of the wgmma launch (negative return codes)
_HOST_ERRORS = {-1: "the driver has no cuTensorMapEncodeTiled",
                -2: "the driver refused a TMA tensor map"}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version: the materialised softmax in f32 (the CPU path and
    the kernel's oracle). Scores are divided by sqrt(d); masked pairs
    take the finite ``NEG_INF``."""
    B, S, Hq, d = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, S, Hkv, G, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(d)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    scores = scores.masked_fill_(~ok, NEG_INF).softmax(dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", scores, v.float())
    return out.reshape(B, S, Hq, d).to(q.dtype)


def tma_reads(t: torch.Tensor) -> bool:
    """Whether TMA can read the (B, S, H, d) tensor ``t`` through a tensor
    map: its base address 16-byte aligned and each b, s, h stride of a
    dimension longer than 1 a positive multiple of 16 bytes."""
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or (st > 0 and st * t.element_size() % 16 == 0)
               for n, st in zip(t.shape[:3], t.stride()[:3]))


def tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when TMA can read it, else a copy that TMA can read: a
    fresh (B, S, H, dp) buffer, dp = d rounded up to a multiple of 8,
    holding ``t`` in its first d columns, returned as the view of those
    columns (the tensor map is d wide, so the pad is never read). A
    broadcast (stride 0) dimension is materialised."""
    if tma_reads(t):
        return t
    B, S, H, d = t.shape
    out = torch.empty((B, S, H, -(-d // 8) * 8), dtype=t.dtype,
                      device=t.device)[..., :d]
    return out.copy_(t)


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that :func:`flash_attention_cuda` launches for these
    inputs, from their dtype, shapes, strides and base addresses alone:
    ``"tf32x3"`` for f32; for bf16 ``"wgmma"`` when TMA can read all three
    (:func:`tma_reads`), else ``"wgmma_staged"`` (the same kernel on
    :func:`tma_ready` copies of those it cannot read). Works on tensors on
    any device."""
    if q.dtype != torch.bfloat16:
        return "tf32x3"
    if all(tma_reads(t) for t in (q, k, v)):
        return "wgmma"
    return "wgmma_staged"


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.library("flash_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_no_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> None:
    """Raise if autograd would differentiate through the kernel: it has
    no backward, so its output would carry no gradient to q, k and v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward kernel (the reference's "
            "flash_attention_pallas has no custom_vjp either): a gradient "
            "through it would silently be dropped. Train through the plain "
            "attention (impl='plain'), or call the kernel under "
            "torch.no_grad() or torch.inference_mode()")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the CUDA kernel of :func:`kernel_path` on the current
    stream. Takes q (B, S, Hq, d) and k, v (B, S, Hkv, d) on one CUDA
    device, all f32 or all bf16, unit stride in d, Hq % Hkv == 0 and
    d <= 128; raises on anything else and on a refused launch. Returns a
    contiguous (B, S, Hq, d) tensor. On ``"wgmma_staged"`` it first
    copies the inputs that TMA cannot read (:func:`tma_ready`), on the
    same stream. Counts each launch in ``launches`` and in
    ``launches_by_path[path]``.

    The kernel is forward only, as the reference's is (it has no
    ``custom_vjp``): under grad mode with any of q, k, v requiring grad
    it raises (:func:`check_no_grad`) instead of returning an output
    that autograd would treat as a constant."""
    check_no_grad(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, Hq, d) and k, v (B, S, Hkv, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, d = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside the kernel's 1..."
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride in d, got "
                             f"{t.stride()}")
    if window < 0:
        raise ValueError(f"window={window} is negative")
    if -(-S // 128) * Hq * B >= 2 ** 31:
        raise ValueError(f"B={B}, S={S}, Hq={Hq} beyond the kernel's grid")
    path = kernel_path(q, k, v)
    out = torch.empty((B, S, Hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if path == "wgmma_staged":
        q, k, v = (tma_ready(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    fn = _entry(_ENTRIES[path])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Hq, Hkv, d, ctypes.addressof(strides),
                 int(bool(causal)), int(window),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        why = _HOST_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {path} kernel launch failed: "
                           f"{why}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_path[path] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, Hq, d) attention output in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise). DTensors
    raise: the kernel sees local tensors only, so a mesh-sharded caller
    runs it per rank through ``local_map``
    (``repro_torch.models.attention._per_rank``)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes local tensors; run it on "
                        "DTensors through torch.distributed.tensor."
                        "experimental.local_map")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window)
    return flash_attention_cuda(q, k, v, causal, window)
