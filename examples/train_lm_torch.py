"""Train a language model end-to-end for a few hundred steps on the
synthetic bigram stream through the PyTorch port's train step (grad
accumulation, mixed precision where the config asks for it) and verify
that the loss drops. The counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--size 25m|100m] \
        [--steps 150] [--device cuda|cpu]

It runs on the card (``--device cuda``, the default; without one it
raises) unless ``--device cpu`` is given. 25m fits a CPU run's step
budget; 100m is the same code at the reference size for real hardware.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import token_batch_iterator
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.utils import resolve_device, tree_leaves

SIZES = {
    "25m": ModelConfig("lm-25m", "dense", n_layers=6, d_model=384,
                       n_heads=6, n_kv_heads=2, d_ff=1536, vocab_size=8192,
                       dtype="float32", microbatches=2),
    "100m": ModelConfig("lm-100m", "dense", n_layers=12, d_model=768,
                        n_heads=12, n_kv_heads=4, d_ff=3072,
                        vocab_size=32768, dtype="float32", microbatches=2),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="25m", choices=list(SIZES))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = SIZES[args.size]
    params = T.init(torch.Generator(device=device).manual_seed(0), cfg,
                    device=device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params on {device}")
    step_fn, opt = S.make_train_step(cfg, lr=3e-3)
    opt_state = opt.init(params)
    it = token_batch_iterator(cfg.vocab_size, args.batch, args.seq, seed=0)
    losses = []
    t0 = time.time()
    for i in range(1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(it).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"({(time.time() - t0) / i:.2f}s/step)", flush=True)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.3 else 'no progress?'})")


if __name__ == "__main__":
    main()
