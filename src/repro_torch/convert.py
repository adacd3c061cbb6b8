"""Carrying parameters between ``repro``'s pytrees and the port.

The port keeps ``repro``'s layouts (HWIO conv weights, the same dict
keys), so a conversion is a per-leaf copy through numpy: nothing is
transposed or renamed, and a round trip is exact.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.utils import Params, resolve_device


def params_from_numpy(tree: Mapping, device="cuda") -> Params:
    """A dict of array-likes (e.g. ``repro`` params passed through
    ``np.asarray``) -> a dict of f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in tree.items()}


def params_to_numpy(params: Params) -> dict:
    """The port's parameter dict -> a dict of numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
