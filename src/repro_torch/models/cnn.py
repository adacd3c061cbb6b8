"""The paper's HFL models (port of ``repro.models.cnn``).

* ``cnn``  — the HFL task model (Section VI): two 5x5 conv layers with 15
  and 28 output channels, each followed by 2x2 max-pool, then two linear
  layers. Hidden width 226 (28x28x1) / 294 (32x32x3) makes the f32
  parameter size match the paper's Table I message sizes.
* ``mini`` — the IKC mini model ξ: one 2x2 conv (+2x2 max-pool) and one
  linear layer over a 1x10x10 crop; ~10 KB as in Table I.

Layouts are ``repro``'s: NHWC images and HWIO conv weights, so params
and inputs cross between the packages unchanged. ``cnn_apply`` runs each
conv -> ReLU -> pool block through ``kernels.conv_pool.ops``
``conv_relu_pool``: the fused kernel K6 on a CUDA input, and on any
other the plain composition, an im2col matmul and a reshape max as in
the reference (``im2col_conv``, ``maxpool2``), plain tensor ops that
``torch.func.vmap`` batches over a device axis. ``mini_apply``'s 2x2
conv always takes the plain composition.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.conv_pool import ops as conv_pool
from repro_torch.models.layers import he_normal
from repro_torch.utils import Params


def cnn_init(generator: torch.Generator, image_hw: Tuple[int, int],
             channels: int, n_classes: int = 10, hidden: Optional[int] = None,
             device="cuda") -> Params:
    """hidden=None picks the paper-size width (226 for 28x28x1, 294 for
    32x32x3)."""
    H, W = image_hw
    if hidden is None:
        hidden = 226 if channels == 1 else 294
    h1, w1 = (H - 4) // 2, (W - 4) // 2
    h2, w2 = (h1 - 4) // 2, (w1 - 4) // 2
    flat = h2 * w2 * 28
    g, d = generator, device
    return {
        "conv1": he_normal(g, (5, 5, channels, 15), 5 * 5 * channels, d),
        "conv2": he_normal(g, (5, 5, 15, 28), 5 * 5 * 15, d),
        "fc1": he_normal(g, (flat, hidden), flat, d),
        "fc2": he_normal(g, (hidden, n_classes), hidden, d),
    }


def cnn_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) in [0,1] -> logits (B, n_classes)."""
    x = conv_pool.conv_relu_pool(x, params["conv1"])
    x = conv_pool.conv_relu_pool(x, params["conv2"])
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"])
    return x @ params["fc2"]


def mini_init(generator: torch.Generator, n_classes: int = 10,
              channels_out: int = 10, device="cuda") -> Params:
    """Mini model ξ on a 1x10x10 crop: 2x2 conv -> 2x2 pool -> linear."""
    flat = 4 * 4 * channels_out  # (10-1)//2 = 4 after VALID conv + pool
    return {
        "conv": he_normal(generator, (2, 2, 1, channels_out), 4, device),
        "fc": he_normal(generator, (flat, n_classes), flat, device),
    }


def mini_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 10, 10, 1) single-channel random crop."""
    x = conv_pool.maxpool2(torch.relu(conv_pool.im2col_conv(
        x, params["conv"])))
    x = x.reshape(x.shape[0], -1)
    return x @ params["fc"]


def crop_offsets(generator: torch.Generator, n: int, image_hw) -> torch.Tensor:
    """(n, 2) random top-left offsets of a 10x10 crop, one per device."""
    H, W = image_hw
    ox = torch.randint(0, H - 10 + 1, (n,), generator=generator)
    oy = torch.randint(0, W - 10 + 1, (n,), generator=generator)
    return torch.stack([ox, oy], dim=1)


def mini_preprocess(X: torch.Tensor, offsets) -> torch.Tensor:
    """IKC preprocessing: keep channel 0 and crop device n's samples to
    10x10 at ``offsets[n]``. X: (N, Dmax, H, W, C) -> (N, Dmax, 10, 10, 1).

    ``offsets`` (N, 2) comes from :func:`crop_offsets`, or from the
    reference's ``jax.random`` draws when a test injects them."""
    offsets = torch.as_tensor(offsets, dtype=torch.int64).cpu()
    return torch.stack([X[n, :, ox:ox + 10, oy:oy + 10, :1]
                        for n, (ox, oy) in enumerate(offsets.tolist())])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (lse - gold).mean()
