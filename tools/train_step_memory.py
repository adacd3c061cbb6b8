"""Where a train step's card memory goes at its peak, with and without a
one-rank mesh.

Runs chatglm3-6b at full width and 4 of its 28 layers (B=8 x 4096, 8
microbatches, bf16, adam, remat: ``chip_smoke.py``'s phases 15a and 16c)
on one card, three ways:

* ``plain``: ``make_train_step(cfg)``, each step's result rebinding the
  params and the moments (phase 15a);
* ``mesh-hold``: ``make_train_step(cfg, mesh=make_debug_mesh())`` with
  the first step's input params kept alive through the later steps
  (what a caller's stray reference to them costs);
* ``mesh``: the mesh step rebinding like ``plain``.

For each it records the caching allocator's history from before the
weights are drawn, replays it to the moment the allocated bytes peak,
and prints the blocks live then, summed by the first frame in the
repo's code that allocated them, largest first, next to the peak that
``torch.cuda.max_memory_allocated`` reports.

Usage (needs a card and the PyTorch port on the path):
    PYTHONPATH=src python3 tools/train_step_memory.py [--steps 3] [--top 12]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import tempfile

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS, BATCH, SEQ, LR, SEED = 4, 8, 4096, 1e-4, 0


def _site(frames) -> str:
    """The innermost frame in the repo's own code (the port or this
    script), as ``path:line function``."""
    for f in frames:
        name = f.get("filename", "")
        if name.startswith(REPO) and "/torch/" not in name:
            return (f"{os.path.relpath(name, REPO)}:{f['line']} "
                    f"{f.get('name', '')}")
    return "(outside the repo)"


def _peak_breakdown(snap):
    """(peak bytes, {site: bytes live at the peak}) from an allocator
    snapshot whose history covers every live block."""
    trace = snap["device_traces"][torch.cuda.current_device()]
    live, cur, peak, at = {}, 0, 0, -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev["size"]
            cur += ev["size"]
            if cur > peak:
                peak, at = cur, i
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])
    sites, blocks = collections.Counter(), {}
    for ev in trace[:at + 1]:
        if ev["action"] == "alloc":
            blocks[ev["addr"]] = (ev["size"], _site(ev.get("frames", [])))
        elif ev["action"] == "free_completed":
            blocks.pop(ev["addr"], None)
    for size, site in blocks.values():
        sites[site] += size
    return peak, sites


def run(kind: str, cfg, batch_np, steps: int):
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as shd

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=2_000_000)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    params = T.init(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                    device="cuda")
    if kind == "plain":
        step, opt = S.make_train_step(cfg, lr=LR)
    else:
        mesh = make_debug_mesh()
        params = S.shard_tree(params, shd.param_shardings(params, cfg, mesh))
        batch = S.shard_tree(batch, S.input_shardings(batch, mesh))
        step, opt = S.make_train_step(cfg, mesh=mesh, lr=LR)
    state = opt.init(params)
    held = params if kind == "mesh-hold" else None
    for _ in range(steps):
        params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    loss = float(m["loss"])
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_stat = torch.cuda.max_memory_allocated()
    del params, state, m, held, batch
    peak, sites = _peak_breakdown(snap)
    return loss, peak_stat, peak, sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_memory: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs.registry import get_config
    from repro_torch.data import token_batch_iterator

    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=LAYERS)
    batch_np = next(token_batch_iterator(cfg.vocab_size, BATCH, SEQ,
                                         seed=SEED))
    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="train_step_memory_")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "group"), rank=0, world_size=1)
    try:
        print(f"{cfg.name} n_layers={LAYERS}, B={BATCH} x {SEQ}, "
              f"microbatches {cfg.microbatches}, {cfg.dtype}, remat "
              f"{cfg.remat}, {args.steps} steps; "
              f"{torch.cuda.get_device_name(0)}")
        for kind in ("plain", "mesh-hold", "mesh"):
            loss, stat, peak, sites = run(kind, cfg, batch_np, args.steps)
            print(f"\n{kind}: loss {loss:.6f}, max_memory_allocated "
                  f"{stat / 1e9:.3f} GB, replayed peak {peak / 1e9:.3f} GB; "
                  "live at the peak by site:")
            for site, n in sites.most_common(args.top):
                print(f"  {n / 1e9:9.3f} GB  {site}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
