"""LM trainer CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \
        --smoke --steps 200 --batch 16 --seq 128 --ckpt-dir /tmp/ckpt

Trains ``--arch`` (``--smoke``: its reduced same-family config) with
``launch.steps.make_train_step`` (microbatch grad accumulation, adam or
adafactor, remat) on the synthetic bigram stream of
``data.pipeline.token_batch_iterator``, on ``--device`` (``cuda``
unless ``cpu`` is asked for; a missing card raises). The weights are
drawn from ``--seed`` by a ``torch.Generator`` on the device (the
reference's ``jax.random`` draws cannot be matched); the token stream is
the reference's, bitwise. vlm configs get zero prefix embeddings and
audio configs the token stream on every codebook, as in the reference.
Checkpoints go through ``repro_torch.checkpoint`` every ``--ckpt-every``
steps and at the end; a run whose ``--ckpt-dir`` holds one resumes from
its latest step with those params and a fresh optimizer state, as the
reference does.

``--production-mesh`` (the reference's flag) runs under ``torchrun``
over 256 ranks (``launch.mesh.init_group``, each rank on
``cuda:{LOCAL_RANK}``) with ``make_production_mesh()`` and the
mesh-sharded step: weights drawn whole on every rank (as the reference
draws them) and each rank keeping its block, the batch split over
``data``, checkpoints gathered and written by rank 0, rank 0 printing.
Without it the CLI runs on one device, as the reference does on its
one-device debug mesh. With fewer ranks, call ``launch.steps`` with a
mesh of your own.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch.checkpoint import latest_step, restore_pytree, save_pytree
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import token_batch_iterator
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import init_group, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as shd
from repro_torch.utils import resolve_device, tree_leaves


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the CLI; returns the final ``params`` and the logged
    ``(step, loss, tok/s)`` lines."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
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
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.microbatches:
        cfg = dataclasses.replace(cfg, microbatches=args.microbatches)
    n_params = sum(x.numel() for x in tree_leaves(S.params_struct(cfg)))
    where = device if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape))
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={where}",
        flush=True)

    step_fn, opt = S.make_train_step(cfg, mesh=mesh, lr=args.lr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init(gen, cfg, device=device)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        start = latest_step(args.ckpt_dir)
        params = params_from_numpy(restore_pytree(params, args.ckpt_dir),
                                   device)
        say(f"restored step {start}", flush=True)
    if mesh is not None:
        params = S.shard_tree(params, shd.param_shardings(params, cfg, mesh))
    opt_state = opt.init(params)

    def save(step):
        whole = params if mesh is None else S.full_tree(params)
        if lead:
            save_pytree(whole, args.ckpt_dir, step)

    it = token_batch_iterator(cfg.vocab_size, args.batch, args.seq,
                              seed=args.seed)
    log = []
    t0 = time.time()
    tokens_seen = 0
    for i in range(start + 1, args.steps + 1):
        raw = next(it)
        batch = {k: torch.from_numpy(raw[k]).to(device)
                 for k in ("tokens", "labels")}
        if cfg.n_prefix_embeds:
            batch["prefix_embeds"] = torch.zeros(
                (args.batch, cfg.n_prefix_embeds, cfg.d_model),
                dtype=cfg.compute_dtype, device=device)
        if cfg.n_codebooks > 1:
            for k in ("tokens", "labels"):
                batch[k] = batch[k][..., None].expand(
                    batch[k].shape + (cfg.n_codebooks,))
        if mesh is not None:
            batch = S.shard_tree(batch, S.input_shardings(batch, mesh))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        tokens_seen += args.batch * args.seq
        if i % args.log_every == 0:
            loss = float(metrics["loss"])
            tps = tokens_seen / (time.time() - t0)
            log.append((i, loss, tps))
            say(f"step {i:5d} loss={loss:.4f} tok/s={tps:,.0f}", flush=True)
        if args.ckpt_dir and i % args.ckpt_every == 0:
            save(i)
    if args.ckpt_dir:
        save(args.steps)
    say("done", flush=True)
    return {"params": params, "log": log}


if __name__ == "__main__":
    main()
