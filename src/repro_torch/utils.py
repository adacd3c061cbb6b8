"""Shared small utilities: device resolution, parameter-dict helpers,
unit conversions and a synchronising stopwatch."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return device


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts/lists/tuples (``rest``:
    trees of the same structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts/lists in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in params.values())


def tree_flatten_to_vector(params: Params) -> torch.Tensor:
    """Concatenate all leaves (in sorted key order, as JAX flattens a
    dict) into one f32 vector (for clustering)."""
    return torch.cat([params[k].reshape(-1).float() for k in sorted(params)])


def dbm_to_watt(dbm: float) -> float:
    return 10 ** (dbm / 10.0) / 1000.0


def db_to_linear(db) -> float:
    return 10 ** (db / 10.0)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Stopwatch:
    """Accumulates wall seconds per phase name. Each phase ends with a
    device synchronise, so a phase's time includes the device work it
    queued."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.seconds[name] += time.perf_counter() - t0


def phase(stopwatch: Optional[Stopwatch], name: str):
    """``stopwatch.phase(name)``, or a no-op context without a stopwatch."""
    if stopwatch is None:
        return contextlib.nullcontext()
    return stopwatch.phase(name)
