"""One process of ``tests/test_torch_dryrun.py``: it owns its ``fake``
process group (one per process, so the test workers never share one)
and writes its results as JSON.

    PYTHONPATH=src python tests/_torch_dryrun_child.py JOB OUT [ARCH]

Jobs: ``smoke`` (ARCH's smoke config on a (2, 2, 2) pod x data x model
mesh over 8 fake ranks: train and decode steps, and for chatglm3-6b the
two-tier HFL step), ``synthetic`` (one DTensor matmul on 2x16x16 over
512 ranks, and the live-bytes account of plain tensors) and ``cli``
(``dryrun.main`` with every config replaced by its smoke config, on the
production meshes). The devices of every leaf of a step's arguments
and results are recorded, and whether CUDA was initialised. No JAX.
"""
import json
import sys

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as D

TRAIN = InputShape("smoke_train", 64, 8, "train")
DECODE = InputShape("smoke_decode", 64, 8, "decode")
LEAVES = set()        # devices of the leaves of its arguments and results

_step_and_args = D._step_and_args


def _leaf_devices(tree):
    for x in D.tree_flatten(tree)[0]:
        if isinstance(x, D.DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            LEAVES.add(x.device.type)


def _spied_step(*args, **kwargs):
    step, xs, parts, grad = _step_and_args(*args, **kwargs)

    def spy(*a):
        out = step(*a)
        _leaf_devices(a)
        _leaf_devices(out)
        return out
    return spy, xs, parts, grad


D._step_and_args = _spied_step


def smoke(arch: str) -> dict:
    out = {}
    with D.fake_group(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        cfg = get_smoke_config(arch)
        out["train"] = D.dryrun_step(cfg, TRAIN, mesh)
        out["decode"] = D.dryrun_step(cfg, DECODE, mesh)
        if arch == "chatglm3-6b":
            out["hfl"] = D.dryrun_step(cfg, TRAIN, mesh, hfl=True)
    return out


def synthetic() -> dict:
    """x (64, 128, 4096), its batch split over pod, times w (4096, 13696)
    split over model (columns), with x's model split on two dims:
    ``seq`` (its sequence): DTensor gathers x over model once and
    multiplies local (32, 128, 4096) by (4096, 856) (torch 2.11's DTensor
    refuses to flatten a sequence-sharded x; the refusal is recorded);
    ``hidden`` (the contraction): DTensor gathers w over model once and
    multiplies local (32, 128, 256) by (256, 13696) into a partial sum
    over model, on torch 2.11 as on 2.13."""
    out = {"torch": torch.__version__}
    with D.fake_group(512):
        mesh = init_device_mesh("cpu", (2, 16, 16),
                                mesh_dim_names=("pod", "data", "model"))
        w = distribute_tensor(torch.empty(4096, 13696, device="meta"), mesh,
                              (Replicate(), Replicate(), Shard(1)),
                              src_data_rank=None)
        for case, split in (("seq", Shard(1)), ("hidden", Shard(2))):
            x = distribute_tensor(torch.empty(64, 128, 4096, device="meta"),
                                  mesh, (Shard(0), Replicate(), split),
                                  src_data_rank=None)
            acct = D.StepAccount(D._axis_names(mesh))
            try:
                with acct:
                    y = x @ w
            except RuntimeError as e:
                out[case] = {"refused": str(e)}
                continue
            out[case] = {"local": list(y.to_local().shape),
                         "placements": [repr(p) for p in y.placements],
                         "flops": acct.flops,
                         "collectives": acct.collectives}
    acct = D.StepAccount()
    with acct:
        kept = [torch.empty(1024, device="meta") for _ in range(4)]
        view = kept[0][:10]
        kept = [k * 2 for k in kept]        # 4 more; the first 4 die
        out["plain"] = [acct.peak, acct.live]
        del kept, view
    out["plain"].append(acct.live)
    return out


def cli(out_dir: str) -> dict:
    D.get_config = get_smoke_config
    path = f"{out_dir}/records.json"
    args = ["--arch", "chatglm3-6b", "--shape", "decode_32k", "--out", path]
    first = D.main(args)
    again = D.main(args)
    forced = D.main(args + ["--force"])
    hfl = D.main(["--hfl-step", "--arch", "chatglm3-6b", "--out", path])
    with open(path) as f:
        stored = json.load(f)
    return {"first": first, "again": again, "forced": forced, "hfl": hfl,
            "stored": stored}


def main() -> None:
    job, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    res = {"smoke": lambda: smoke(sys.argv[3]), "synthetic": synthetic,
           "cli": lambda: cli(out)}[job]()
    res["leaf_devices"] = sorted(LEAVES)
    res["cuda_initialized"] = torch.cuda.is_initialized()
    name = job if job != "smoke" else f"smoke_{sys.argv[3]}"
    with open(f"{out}/{name}.json", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
