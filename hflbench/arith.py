"""The yardstick's arithmetic: the CNN's model flops from its shapes,
the bytes an aggregation launch has to move, and the card's published
peaks. Counted from the configuration alone, never from the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12       # HBM3


def cnn_layer_matmuls(cfg: Dict):
    """(m, n, k) of each layer's forward matmul for one sample, in
    order: conv1 and conv2 as im2col GEMMs over their output positions,
    then fc1 and fc2."""
    k, C = cfg["kernel"], cfg["channels"]
    c1, c2 = cfg["conv1_channels"], cfg["conv2_channels"]
    h1, w1 = cfg["image_h"] - k + 1, cfg["image_w"] - k + 1
    h2, w2 = h1 // 2 - k + 1, w1 // 2 - k + 1
    flat = (h2 // 2) * (w2 // 2) * c2
    return [(h1 * w1, c1, k * k * C), (h2 * w2, c2, k * k * c1),
            (1, cfg["hidden"], flat), (1, cfg["n_classes"], cfg["hidden"])]


def forward_flops(cfg: Dict) -> int:
    """2·m·n·k summed over the layers: one sample's forward."""
    return sum(2 * m * n * k for m, n, k in cnn_layer_matmuls(cfg))


def train_flops(cfg: Dict) -> int:
    """One sample's forward and backward: the forward, the weight
    gradient of every layer (as many flops as its forward) and the input
    gradient of every layer but the first."""
    mm = cnn_layer_matmuls(cfg)
    fwd = [2 * m * n * k for m, n, k in mm]
    return 2 * sum(fwd) + sum(fwd[1:])


def round_flops(cfg: Dict, real_samples: int) -> int:
    """Model flops of one global round: L·Q local steps over the
    scheduled devices' real samples (padding is not useful work), then
    the forward over the test set."""
    steps = cfg["L"] * cfg["Q"]
    return (steps * real_samples * train_flops(cfg)
            + cfg["n_test"] * forward_flops(cfg))


def agg_bytes(S: int, M: int, H: int, widths: Sequence[int],
              itemsize: int = 4, n_rows: int = 1) -> int:
    """Bytes an aggregation launch must move: the (S, M, H) mask,
    ``n_rows`` (S, H) vectors (sizes; scales too for a decode), the
    (S, H, P) operand at its itemsize and the (S, M, P) f32 output, each
    once."""
    P = sum(widths)
    return 4 * (S * M * H + n_rows * S * H + S * M * P) + itemsize * S * H * P


def round_agg_bytes(S: int, M: int, H: int, Q: int, P: int) -> int:
    """The bytes of one round's K1 launches: Q edge hops (S, M, H) over
    the devices' P-wide updates, then the cloud hop (S, 1, M) over the
    edge models."""
    return Q * agg_bytes(S, M, H, [P]) + agg_bytes(S, 1, M, [P])
