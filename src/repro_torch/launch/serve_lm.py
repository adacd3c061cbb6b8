"""Batched LM decode serving CLI (port of ``repro.launch.serve_lm``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm \
        --arch chatglm3-6b --batch 8 --prompt-len 32 --gen 64

Draws random weights from ``--seed``, feeds a random prompt batch through
the decode step (teacher-forced, filling the KV and SSM caches), then
decodes
``--gen`` tokens per sequence, greedy or with ``--temperature``, and
prints tokens/s. It runs on the card (``--device cuda``, the default;
without one it raises) unless ``--device cpu`` is given.

On the card the weights are drawn by a ``torch.Generator`` on the card:
at full width (chatglm3-6b: 6.2e9 f32 parameters) a host draw would need
25 GB of host memory. ``jax.random`` draws cannot be matched in torch
anyway, so the weights, the prompt and the samples differ from the
reference's for the same seed; the loop is the same. Every registry
arch serves: dense, vlm, audio, MoE, SSM (mamba2-2.7b) and hybrid.

``--production-mesh`` (the reference's flag) runs under ``torchrun``
over 256 ranks (``launch.mesh.init_group``, each rank on
``cuda:{LOCAL_RANK}``) on ``make_production_mesh()``: weights and caches
placed by the sharding rules (drawn whole on every rank, as the
reference draws them, then each keeps its block), the mesh-sharded
decode step, rank 0 printing. Without it the CLI runs on one device, as
the reference does on its one-device debug mesh.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.mesh import init_group, make_production_mesh
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as shd
from repro_torch.utils import resolve_device, synchronize


def serve(params, cfg: ModelConfig, prompt: torch.Tensor, gen: int, *,
          temperature: float = 0.0, generator: Optional[torch.Generator]
          = None, keep_prompt_logits: bool = False, mesh=None) -> Dict:
    """The serving loop on ``prompt`` (B, P) or (B, P, K) tokens, on the
    prompt's device: P teacher-forced decode steps, then ``gen`` sampled
    ones. Returns the generated ``tokens`` (B, gen) or (B, gen, K),
    ``prefill_s``/``decode_s`` (host clock ending in a device
    synchronise), ``tok_s`` and, when asked, the teacher-forced
    ``prompt_logits`` (B, P, ...). With ``mesh``, ``params`` are placed
    on it (``launch.steps.shard_tree``) and so are the caches and each
    step's tokens; the prompt and the results are whole on every
    rank."""
    device = prompt.device
    B, P = prompt.shape[:2]
    serve_step = S.make_serve_step(cfg, mesh=mesh)
    cache = T.init_cache(cfg, B, P + gen, device=device)
    if mesh is not None:
        cache = S.shard_tree(cache, shd.cache_shardings(cache, cfg, mesh))

    def step(cache, tok, t):
        if mesh is None:
            return serve_step(params, cache, tok, t)
        logits, cache = serve_step(
            params, cache, S.shard_tree(tok, S.input_shardings(tok, mesh)), t)
        return logits.full_tensor(), cache

    def sample(logits):
        lg = logits[:, 0].float()
        if temperature <= 0:
            return lg.argmax(dim=-1)
        probs = torch.softmax(lg / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(
            probs.shape[:-1])

    synchronize(device)
    t0 = time.perf_counter()
    kept = []
    for t in range(P):
        logits, cache = step(cache, prompt[:, t:t + 1], t)
        if keep_prompt_logits:
            kept.append(logits[:, 0])
    synchronize(device)
    prefill_s = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    cur = sample(logits)
    for t in range(P, P + gen):
        logits, cache = step(cache, cur[:, None], t)
        cur = sample(logits)
        out.append(cur)
    synchronize(device)
    decode_s = time.perf_counter() - t0
    res = {"tokens": torch.stack(out, dim=1) if out else None,
           "prefill_s": prefill_s, "decode_s": decode_s,
           "tok_s": B * gen / decode_s if gen else 0.0}
    if keep_prompt_logits:
        res["prompt_logits"] = torch.stack(kept, dim=1)
    return res


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="under torchrun over 256 ranks: the sharded step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = None
    if args.production_mesh:
        device = init_group(torch.device(args.device).type)
        mesh = make_production_mesh(device_type=device.type)
    else:
        device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init(gen, cfg, device=device)
    if mesh is not None:
        params = S.shard_tree(params, shd.param_shardings(params, cfg, mesh))
    tok_shape = ((args.batch, args.prompt_len) if cfg.n_codebooks == 1
                 else (args.batch, args.prompt_len, cfg.n_codebooks))
    prompt = torch.randint(0, cfg.vocab_size, tok_shape, generator=gen,
                           device=device)
    res = serve(params, cfg, prompt, args.gen,
                temperature=args.temperature, generator=gen, mesh=mesh)
    if mesh is not None and torch.distributed.get_rank() != 0:
        return res
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prefill={res['prefill_s']:.2f}s decode={res['decode_s']:.2f}s "
          f"({res['tok_s']:,.1f} tok/s)")
    if res["tokens"] is not None:
        first = res["tokens"][0].reshape(args.gen, -1)[:16, 0]
        print(f"sample tokens[0,:{len(first)}]:", first.tolist())
    return res


if __name__ == "__main__":
    main()
