"""The benchmark's traffic generator: one Table-I world from a seed.

A world is what a simulated HFL experiment starts from: the IoT
population (positions, CPU cycles a sample, transmit powers, channel
gains, edge bandwidths), the non-IID federated partition of a synthetic
image pool, the test set and the CNN's initial weights. Everything is
drawn from the run's seed and handed, unchanged, to both the program
and the plain reference (``reference.py``). The arithmetic follows the
paper's model (arXiv:2402.02506 sec. III-B, VI): path loss 128.1 + 37.6
log10(d_km) with log-normal shadowing, class-prototype images, a
majority class a device. It imports nothing of the program.

Every seed gives the same sizes: the device dataset sizes are one fixed
set spread over [d_min, d_max], permuted by the seed, so each seed pads
to the same largest dataset and trains the same shapes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class World:
    """Host arrays of one world (float64 where the paper's model draws
    them, float32 images)."""
    dev_pos: np.ndarray        # (N, 2) km
    edge_pos: np.ndarray       # (M, 2) km
    u: np.ndarray              # (N,) CPU cycles a sample
    D: np.ndarray              # (N,) samples a device (its dataset size)
    p: np.ndarray              # (N,) transmit power [W]
    g: np.ndarray              # (N, M) mean uplink gain to each edge
    g_cloud: np.ndarray        # (M,) edge -> cloud gain
    B_m: np.ndarray            # (M,) edge bandwidth [Hz]
    X: List[np.ndarray]        # N device datasets (D_n, H, W, C) f32
    y: List[np.ndarray]        # N label vectors (D_n,) int32
    majority: np.ndarray       # (N,) majority class of each device
    X_test: np.ndarray         # (n_test, H, W, C) f32
    y_test: np.ndarray         # (n_test,) int32


def seed_words(seed: int) -> List[int]:
    """Any whole number as non-negative 32-bit words (numpy's seed
    sequence takes a list of them)."""
    seed = int(seed)
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def torch_seed(seed: int, stream: int) -> int:
    """A non-negative 31-bit seed (for a ``torch.Generator`` or numpy)
    for ``stream`` of ``seed``."""
    ss = np.random.SeedSequence(seed_words(seed) + [stream])
    return int(ss.generate_state(1)[0]) >> 1


def dataset_sizes(cfg: Dict) -> np.ndarray:
    """The fixed set of N dataset sizes, spread evenly over
    [d_min, d_max] (both ends included)."""
    N, lo, hi = cfg["n_devices"], cfg["d_min"], cfg["d_max"]
    return lo + (np.arange(N) * (hi - lo)) // max(N - 1, 1)


def _gain(rng, dist_km, shadow_db):
    d = np.maximum(dist_km, 0.01)
    pl_db = 128.1 + 37.6 * np.log10(d)
    shadow = rng.normal(0.0, shadow_db, d.shape)
    return 10 ** (-(pl_db + shadow) / 10.0)


def _dbm_to_watt(dbm):
    return 10 ** (np.asarray(dbm) / 10.0) / 1000.0


def _smooth(rng, H, W, C, k):
    """A low-frequency random image in [0, 1]: coarse noise, bilinearly
    upsampled."""
    coarse = rng.random((k + 2, k + 2, C))
    ys, xs = np.linspace(0, k + 1, H), np.linspace(0, k + 1, W)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = ys - yi, xs - xi
    yi1, xi1 = np.minimum(yi + 1, k + 1), np.minimum(xi + 1, k + 1)
    a = (coarse[yi][:, xi] * (1 - yf)[:, None, None]
         + coarse[yi1][:, xi] * yf[:, None, None])
    b = (coarse[yi][:, xi1] * (1 - yf)[:, None, None]
         + coarse[yi1][:, xi1] * yf[:, None, None])
    return a * (1 - xf)[None, :, None] + b * xf[None, :, None]


def make_world(cfg: Dict, seed: int) -> World:
    """The world of ``seed`` for configuration ``cfg`` (a dict of the
    configuration file's keys)."""
    N, M = cfg["n_devices"], cfg["n_edges"]
    H, W, C = cfg["image_h"], cfg["image_w"], cfg["channels"]
    n_cls = cfg["n_classes"]
    base = seed_words(seed)
    rng = np.random.default_rng(base + [1])            # the population

    dev_pos = rng.uniform(0, cfg["area_km"], (N, 2))
    edge_pos = rng.uniform(0, cfg["area_km"], (M, 2))
    cloud = np.full(2, cfg["area_km"] / 2)
    d_ne = np.linalg.norm(dev_pos[:, None] - edge_pos[None], axis=-1)
    d_mc = np.linalg.norm(edge_pos - cloud, axis=-1)
    u = rng.uniform(cfg["u_min"], cfg["u_max"], N)
    D = rng.permutation(dataset_sizes(cfg)).astype(np.int64)
    p = _dbm_to_watt(rng.uniform(cfg["p_dbm_min"], cfg["p_dbm_max"], N))
    g = _gain(rng, d_ne, cfg["shadow_db"])
    g_cloud = _gain(rng, d_mc, cfg["shadow_db"])
    B_m = rng.uniform(cfg["edge_bw_min"], cfg["edge_bw_max"], M)

    rng = np.random.default_rng(base + [2])            # the image pool
    protos = np.stack([_smooth(rng, H, W, C, cfg["proto_smooth"])
                       for _ in range(n_cls)]).astype(np.float32)

    def draw(n):
        y = rng.integers(0, n_cls, n)
        X = rng.standard_normal((n, H, W, C), dtype=np.float32)
        X *= np.float32(cfg["pixel_noise"])
        X += protos[y]
        X += (rng.standard_normal(n, dtype=np.float32)
              * np.float32(0.08))[:, None, None, None]
        np.clip(X, 0.0, 1.0, out=X)
        return X, y.astype(np.int32)

    X_pool, y_pool = draw(cfg["n_train"])
    X_test, y_test = draw(cfg["n_test"])

    rng = np.random.default_rng(base + [3])            # the partition
    by_class = [np.flatnonzero(y_pool == c) for c in range(n_cls)]
    majority = rng.permutation(np.arange(N) % n_cls)
    Xs, ys = [], []
    for n in range(N):
        d_n = int(D[n])
        n_major = int(round(cfg["majority_frac"] * d_n))
        idx = np.concatenate([
            rng.choice(by_class[majority[n]], n_major, replace=True),
            rng.integers(0, len(y_pool), d_n - n_major)])
        rng.shuffle(idx)
        Xs.append(X_pool[idx])
        ys.append(y_pool[idx])
    return World(dev_pos, edge_pos, u, D, p, g, g_cloud, B_m, Xs, ys,
                 majority.astype(np.int32), X_test, y_test)


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """The CNN's leaves (HWIO convs, (in, out) linears) and shapes."""
    k, C = cfg["kernel"], cfg["channels"]
    c1, c2 = cfg["conv1_channels"], cfg["conv2_channels"]
    h = ((cfg["image_h"] - k + 1) // 2 - k + 1) // 2
    w = ((cfg["image_w"] - k + 1) // 2 - k + 1) // 2
    return {"conv1": (k, k, C, c1), "conv2": (k, k, c1, c2),
            "fc1": (h * w * c2, cfg["hidden"]),
            "fc2": (cfg["hidden"], cfg["n_classes"])}


def init_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """He-normal initial weights, drawn in one call on ``device`` from a
    ``torch.Generator`` there, seeded from ``seed``."""
    device = torch.device(device)
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 4))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        fan_in = math.prod(shape[:-1])
        out[name] = (flat[at:at + n].reshape(shape)
                     * math.sqrt(2.0 / fan_in)).contiguous()
        at += n
    return out
