"""Batching pipeline for the HFL trainer and the LM trainer.

A numpy copy of ``repro.data.pipeline``: the same
``np.random.default_rng`` draws in the same order, so one seed gives
bitwise-equal batches in both packages. The LM trainer
(``repro_torch.launch.train``) moves each batch to its device.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def batch_iterator(X: np.ndarray, y: np.ndarray, batch_size: int,
                   seed: int = 0, drop_last: bool = False
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite shuffled epochs."""
    rng = np.random.default_rng(seed)
    n = len(y)
    while True:
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            sel = order[i:i + batch_size]
            if drop_last and len(sel) < batch_size:
                break
            yield X[sel], y[sel]


def sample_batch(X: np.ndarray, y: np.ndarray, batch_size: int,
                 rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """IID sample with replacement (local SGD step, eq. (1))."""
    idx = rng.integers(0, len(y), batch_size)
    return X[idx], y[idx]


def token_batch_iterator(vocab: int, batch: int, seq: int, seed: int = 0):
    """Synthetic LM token stream: a random sparse bigram table (each token
    has 4 successors) with 10 % uniform noise, so the loss can go down.
    Yields ``{"tokens": (batch, seq), "labels": (batch, seq)}`` int32, the
    labels the tokens shifted by one."""
    rng = np.random.default_rng(seed)
    next_tok = rng.integers(0, vocab, size=(vocab, 4))
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, batch)
        choice = rng.integers(0, 4, size=(batch, seq))
        noise = rng.random((batch, seq)) < 0.1
        rand = rng.integers(0, vocab, size=(batch, seq))
        for t in range(seq):
            nxt = next_tok[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
