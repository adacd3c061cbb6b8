"""Class-structured synthetic datasets (offline stand-ins).

A numpy copy of ``repro.data.synthetic``. Images (``make_dataset``):
each class k has a smooth random prototype image; a sample is
``clip(prototype + pixel noise + global brightness jitter, 0, 1)``.
Sequences (``make_seq_dataset``, the task of the model-zoo payloads):
each class k has a random token distribution over the vocabulary; a
sample is ``seq_len`` i.i.d. tokens from it. The draw order is the
reference's, so the same seed gives bitwise-equal arrays. Classes are
learnably separable by a small model, and models trained locally on a
majority class have weights that cluster by that class (what IKC
clustering and its ARI rely on).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    name: str
    image_hw: Tuple[int, int]
    channels: int
    n_classes: int = 10
    noise: float = 0.35
    proto_smooth: int = 3       # prototype low-frequency scale


DATASETS = {
    "fmnist_syn": SyntheticSpec("fmnist_syn", (28, 28), 1),
    "cifar_syn": SyntheticSpec("cifar_syn", (32, 32), 3),
}


def _smooth(rng: np.random.Generator, hw, channels, k: int) -> np.ndarray:
    """Low-frequency random image in [0,1]: upsampled coarse noise."""
    H, W = hw
    coarse = rng.random((k + 2, k + 2, channels))
    ys = np.linspace(0, k + 1, H)
    xs = np.linspace(0, k + 1, W)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = ys - yi, xs - xi
    yi1 = np.minimum(yi + 1, k + 1)
    xi1 = np.minimum(xi + 1, k + 1)
    a = coarse[yi][:, xi] * (1 - yf)[:, None, None] + coarse[yi1][:, xi] * yf[:, None, None]
    b = coarse[yi][:, xi1] * (1 - yf)[:, None, None] + coarse[yi1][:, xi1] * yf[:, None, None]
    img = a * (1 - xf)[None, :, None] + b * xf[None, :, None]
    return img


def class_prototypes(spec: SyntheticSpec, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([_smooth(rng, spec.image_hw, spec.channels, spec.proto_smooth)
                     for _ in range(spec.n_classes)])


def make_dataset(name: str, n_train: int = 20_000, n_test: int = 2_000,
                 seed: int = 0):
    """Returns (X_train, y_train, X_test, y_test), images NHWC f32 in [0,1]."""
    spec = DATASETS[name]
    protos = class_prototypes(spec, seed)
    rng = np.random.default_rng(seed + 1)

    def draw(n):
        y = rng.integers(0, spec.n_classes, n)
        noise = rng.normal(0, spec.noise, (n, *spec.image_hw, spec.channels))
        bright = rng.normal(0, 0.08, (n, 1, 1, 1))
        X = np.clip(protos[y] + noise + bright, 0.0, 1.0).astype(np.float32)
        return X, y.astype(np.int32)

    X_tr, y_tr = draw(n_train)
    X_te, y_te = draw(n_test)
    return X_tr, y_tr, X_te, y_te


@dataclasses.dataclass(frozen=True)
class SeqSpec:
    """Synthetic sequence-classification task for the model-zoo payloads.

    vocab_size 257 is at most the smallest smoke-config vocab, so one
    dataset feeds every arch's embedding table; seq_len 16 is a multiple
    of the mamba2 smoke SSD chunk.
    """
    name: str
    seq_len: int = 16
    vocab_size: int = 257
    n_classes: int = 10
    sharpness: float = 2.0      # spread of the per-class token logits


SEQ_DATASETS = {
    "seqcls_syn": SeqSpec("seqcls_syn"),
}


def class_token_dists(spec: SeqSpec, seed: int = 0) -> np.ndarray:
    """(n_classes, vocab) token distributions, one per class."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, spec.sharpness,
                        (spec.n_classes, spec.vocab_size))
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


def make_seq_dataset(name: str = "seqcls_syn", n_train: int = 4096,
                     n_test: int = 512, seed: int = 0, *,
                     seq_len: int | None = None,
                     vocab_size: int | None = None,
                     n_classes: int | None = None):
    """Returns (X_train, y_train, X_test, y_test); X int32 (n, seq_len)."""
    spec = SEQ_DATASETS[name]
    if seq_len or vocab_size or n_classes:
        spec = dataclasses.replace(
            spec, seq_len=seq_len or spec.seq_len,
            vocab_size=vocab_size or spec.vocab_size,
            n_classes=n_classes or spec.n_classes)
    cdf = class_token_dists(spec, seed).cumsum(axis=1)
    rng = np.random.default_rng(seed + 1)

    def draw(n):
        y = rng.integers(0, spec.n_classes, n)
        u = rng.random((n, spec.seq_len))
        # inverse-CDF sampling against each sample's class distribution
        X = (u[:, :, None] >= cdf[y][:, None, :]).sum(axis=2)
        return (np.minimum(X, spec.vocab_size - 1).astype(np.int32),
                y.astype(np.int32))

    X_tr, y_tr = draw(n_train)
    X_te, y_te = draw(n_test)
    return X_tr, y_tr, X_te, y_te
