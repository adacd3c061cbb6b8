"""Shared small utilities: device resolution, parameter-dict helpers,
unit conversions and a device synchronise."""
from __future__ import annotations

from typing import Dict, Sequence

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


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding 32-bit values, in
    16-bit halves of ``c`` so that no product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_keys(words: torch.Tensor, extra: Sequence[int],
                 n: int) -> torch.Tensor:
    """Counter-based random keys: (S, W) int64 ``words`` (each taken mod
    2^32) and the integers ``extra`` -> (S, n) int64 keys in [0, 2^63),
    key [s, i] a hash of (words[s], extra, i) alone. Torch integer ops on
    the words' device: no generator state and no host round trip, and a
    row's keys do not depend on the other rows."""
    def chain(h, w):
        return _mix32((h ^ (w & _M32)) + 0x9E3779B9 & _M32)

    h = torch.full((words.shape[0], 1), 0x811C9DC5, dtype=torch.int64,
                   device=words.device)
    for j in range(words.shape[1]):
        h = chain(h, words[:, j:j + 1])
    for w in extra:
        h = chain(h, int(w))
    idx = torch.arange(n, dtype=torch.int64, device=words.device)[None]
    h = chain(h, idx)
    return (chain(h, 1) << 31) | (chain(h, 2) >> 1)


def permutation_prefix(words: torch.Tensor, extra: Sequence[int], n: int,
                       k: int) -> torch.Tensor:
    """(S, k) int64: the first ``k`` entries of a uniform random
    permutation of ``range(n)`` per row, drawn from :func:`counter_keys`
    (the order of its keys; ties, ~n^2 / 2^63 likely, go to the lower
    index)."""
    keys = counter_keys(words, extra, n)
    return torch.argsort(keys, dim=-1, stable=True)[:, :k]


def dbm_to_watt(dbm: float) -> float:
    return 10 ** (dbm / 10.0) / 1000.0


def db_to_linear(db) -> float:
    return 10 ** (db / 10.0)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
