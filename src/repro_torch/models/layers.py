"""Core layer primitives (functional: params are plain dicts of tensors)."""
from __future__ import annotations

import math

import torch


def he_normal(generator: torch.Generator, shape, fan_in=None,
              device="cpu", dtype=torch.float32) -> torch.Tensor:
    """He/Kaiming init [41]. Drawn on the CPU from ``generator`` and then
    moved, so a seed gives the same weights on every device."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = math.sqrt(2.0 / fan_in)
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)
