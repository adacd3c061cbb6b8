"""Where a dry run's per-rank flops come from: ``repro_torch.launch.dryrun``
on one step, with each counted local op (a matmul, a convolution, an
attention) attributed to the DTensor op that ran it, with that op's
global input shapes and placements.

    PYTHONPATH=src python3 tools/dryrun_ops.py [--arch A] [--shape S]
        [--hfl-step] [--smoke] [--top N] [--out FILE]

Without ``--smoke`` the step runs on the production mesh over a fake
group (16x16; ``--hfl-step``: the two-tier step on 2x16x16), as
``dryrun_one`` / ``dryrun_hfl`` run it; ``--smoke`` takes the arch's
smoke config on a (2, 2, 2) pod x data x model mesh over 8 fake ranks
and a (B=8, S=64) shape. Prints the torch version, the record's flops,
temp bytes and collective counts, then the ``--top`` rows (flops,
count, DTensor op with its inputs' global shapes and placements, local
op with its local shapes); ``--out`` writes every row as JSON. Needs no
card. Two torch releases give two schedules: run it under each to see
where they part.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh


class OpAccount(D.StepAccount):
    """StepAccount that also sums its flops by (DTensor op, local op)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rows = collections.Counter()
        self.calls = collections.Counter()
        self._dtensor_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op = (str(func), tuple(
                (tuple(a.shape), str(tuple(a.placements)))
                for a in args if isinstance(a, DTensor)))
            return NotImplemented
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.flops != before:
            key = (self._dtensor_op, str(func), tuple(
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))
            self.rows[key] += self.flops - before
            self.calls[key] += 1
        return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--hfl-step", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    accounts = []
    real = D.StepAccount

    def account(*a, **k):
        accounts.append(OpAccount(*a, **k))
        return accounts[-1]
    D.StepAccount = account
    t0 = time.perf_counter()
    try:
        if args.smoke:
            with D.fake_group(8):
                mesh = init_device_mesh(
                    "cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
                kind = "train" if args.hfl_step else INPUT_SHAPES[
                    args.shape].kind
                rec = D.dryrun_step(get_smoke_config(args.arch),
                                    InputShape("smoke", 64, 8, kind), mesh,
                                    hfl=args.hfl_step)
        elif args.hfl_step:
            rec = D.dryrun_hfl(args.arch)
        else:
            rec = D.dryrun_one(args.arch, args.shape, multi_pod=False)
    finally:
        D.StepAccount = real
    (acct,) = accounts
    rows = [{"flops": v, "calls": acct.calls[k], "dtensor_op": k[0],
             "local_op": k[1], "local_shapes": k[2]}
            for k, v in acct.rows.most_common()]
    res = {"torch": torch.__version__, "arch": args.arch,
           "step": "hfl" if args.hfl_step else args.shape,
           "smoke": args.smoke, "flops": rec["cost"]["flops"],
           "temp_bytes": rec["memory"]["temp_bytes"],
           "collectives": {k: v["count"]
                           for k, v in rec["collectives"].items()},
           "wall_s": round(time.perf_counter() - t0, 1), "rows": rows}
    print(f"torch {res['torch']} {args.arch} {res['step']}"
          f"{' (smoke)' if args.smoke else ''}: flops {res['flops']:.5e}, "
          f"temp {res['temp_bytes']:,} B, collectives "
          f"{res['collectives']}, {res['wall_s']} s")
    for r in rows[:args.top]:
        print(f"{r['flops']:12.5e} {r['calls']:5d} {r['dtensor_op']} -> "
              f"{r['local_op']} {r['local_shapes']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=0)
    return res


if __name__ == "__main__":
    main()
