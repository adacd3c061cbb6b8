"""Multi-config HFL launcher on the PyTorch port: arch x scheduler x
codec sweep matrix (the counterpart of ``examples/model_zoo_launcher.py``).

maxtext-style job launcher over the model-zoo registry: one flat
``BASE_CONFIG`` dict, per-job override dicts validated against it
(unknown keys are an assert, not a silent typo), and a ``run_job``
that builds the world, resolves the arch through
``configs.registry.get_hfl_spec``, and drives one fused
``SweepRunner`` sweep on the kernel routes (``agg_kernel=True``; the IKC
clustering with ``use_kernel=True``). Every job appends a JSON line to
``results/model_zoo_runs_torch.jsonl`` so a matrix of runs is one
greppable file.

    PYTHONPATH=src python examples/model_zoo_launcher_torch.py            # full matrix
    PYTHONPATH=src python examples/model_zoo_launcher_torch.py --smoke    # CI subset
    PYTHONPATH=src python examples/model_zoo_launcher_torch.py --dryrun   # print jobs

Jobs run on the card (``--device cuda``, the default; without one it
raises) unless ``--device cpu`` is given; ``device`` is a key of
``BASE_CONFIG`` like any other.

The full matrix crosses every ``HFL_SMOKE_ARCHS`` payload (paper CNN,
dense transformer, SSM, MoE) with the paper's schedulers (FedAvg /
IKC) and the uplink codecs (none / int8). ``--smoke`` runs one job per
arch family at tiny shapes — the examples-smoke CI lane. ``main``
returns the records (``--dryrun``: none).
"""
import argparse
import copy
import json
import os
import time

BASE_CONFIG = {
    "arch": "hfl-cnn",        # configs.registry payload id
    "scheduler": "fedavg",    # fedavg | ikc | vkc
    "codec": "none",          # none | bf16_delta | int8 | topk
    "assign": "geo",          # geo | mod | hfel
    "rounds": 6,
    "n_devices": 8,
    "n_edges": 2,
    "H": 4,
    "lr": 0.3,
    "n_train": 600,
    "n_test": 128,
    "alloc_steps": 25,
    "seed": 0,
    "device": "cuda",         # cuda | cpu
}


def update_config_fields(base, updates, allow_new_keys=False):
    """Copy ``base`` with ``updates`` applied; unknown keys assert."""
    cfg = copy.deepcopy(base)
    for key, value in updates.items():
        if not allow_new_keys:
            assert key in cfg, f"unknown config key: {key!r}"
        cfg[key] = value
    return cfg


def _world(cfg):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.cost_model import SystemParams, sample_population
    from repro_torch.data import (make_dataset, make_seq_dataset,
                                  partition_noniid)

    sp = SystemParams(n_devices=cfg["n_devices"], n_edges=cfg["n_edges"],
                      d_range=(6, 10))
    pop = sample_population(sp, seed=cfg["seed"], device=cfg["device"])
    if cfg["arch"] == "hfl-cnn":
        X, y, Xt, yt = make_dataset("fmnist_syn", n_train=cfg["n_train"],
                                    n_test=cfg["n_test"], seed=cfg["seed"])
    else:
        vocab = min(257, get_smoke_config(cfg["arch"]).vocab_size)
        X, y, Xt, yt = make_seq_dataset(n_train=cfg["n_train"],
                                        n_test=cfg["n_test"],
                                        seed=cfg["seed"],
                                        vocab_size=vocab)
    fed = partition_noniid(X, y, Xt, yt, n_devices=cfg["n_devices"],
                           size_range=(6, 10), seed=cfg["seed"])
    return sp, pop, fed


def run_job(run_name, out_jsonl="results/model_zoo_runs_torch.jsonl",
            dryrun=False, **overrides):
    cfg = update_config_fields(BASE_CONFIG, overrides)
    if dryrun:
        print(f"DRYRUN {run_name}: {cfg}")
        return None

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.sweep import SweepRunner, build_scheduler
    from repro_torch.utils import tree_leaves

    t0 = time.time()
    sp, pop, fed = _world(cfg)
    comp_cfg = CompressionConfig(codec=cfg["codec"])
    runner = SweepRunner(sp, [(pop, fed)], lr=cfg["lr"],
                         alloc_steps=cfg["alloc_steps"], arch=cfg["arch"],
                         compression=comp_cfg, agg_kernel=True,
                         device=cfg["device"])
    sched, cstats = build_scheduler(cfg["scheduler"], fed, sp, cfg["H"],
                                    seed=cfg["seed"], pop=pop,
                                    arch=cfg["arch"], use_kernel=True,
                                    device=cfg["device"])
    res = runner.run([sched], cfg["rounds"], assign=cfg["assign"],
                     fused=True)
    rec = {
        "run_name": run_name, **cfg,
        "accs": [float(a) for a in res["acc"][0]],
        "final_acc": float(res["acc"][0, -1]),
        "T_total": float(res["T_i"][0].sum()),
        "E_total": float(res["E_i"][0].sum()),
        "model_bits": float(runner.model_bits),
        "n_leaves": len(tree_leaves(runner.params_b)),
        "uplink_bits_per_msg": float(res["uplink_bits_per_msg"]),
        "n_dispatches": int(res["n_dispatches"]),
        "clustering": {k: float(v) for k, v in cstats.items()},
        "wall_s": time.time() - t0,
    }
    os.makedirs(os.path.dirname(out_jsonl) or ".", exist_ok=True)
    with open(out_jsonl, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    print(f"{run_name}: acc={rec['final_acc']:.3f} "
          f"T={rec['T_total']:.0f}s E={rec['E_total']:.0f}J "
          f"uplink={rec['uplink_bits_per_msg']:.0f}b "
          f"({rec['wall_s']:.1f}s wall)")
    return rec


def matrix_jobs(smoke=False):
    """(run_name, overrides) pairs for the sweep matrix."""
    from repro_torch.configs.registry import HFL_SMOKE_ARCHS

    if smoke:
        # one job per arch family, tiny shapes, codec + scheduler mixed
        # in so the CI lane exercises every axis of the matrix
        tiny = {"rounds": 2, "n_train": 240, "n_test": 64}
        jobs = [
            ("cnn_ikc_none", {"arch": "hfl-cnn", "scheduler": "ikc",
                              "lr": 0.01, **tiny}),
            ("dense_fedavg_int8", {"arch": "mistral-nemo-12b",
                                   "codec": "int8", **tiny}),
            ("ssm_fedavg_none", {"arch": "mamba2-2.7b", **tiny}),
            ("moe_fedavg_topk", {"arch": "qwen3-moe-235b-a22b",
                                 "codec": "topk", **tiny}),
        ]
        return jobs
    jobs = []
    for arch in HFL_SMOKE_ARCHS:
        short = arch.split("-")[0]
        for scheduler in ("fedavg", "ikc"):
            for codec in ("none", "int8"):
                name = f"{short}_{scheduler}_{codec}"
                over = {"arch": arch, "scheduler": scheduler,
                        "codec": codec}
                if arch == "hfl-cnn":
                    over["lr"] = 0.01
                jobs.append((name, over))
    return jobs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="one tiny job per arch family (CI lane)")
    ap.add_argument("--dryrun", action="store_true",
                    help="print the job matrix without running")
    ap.add_argument("--out", default="results/model_zoo_runs_torch.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    jobs = matrix_jobs(smoke=args.smoke)
    print(f"launching {len(jobs)} jobs "
          f"({'smoke' if args.smoke else 'full matrix'})")
    recs = [run_job(name, out_jsonl=args.out, dryrun=args.dryrun,
                    device=args.device, **over)
            for name, over in jobs]
    if args.dryrun:
        return None
    assert all(r is not None for r in recs)
    if args.smoke:
        # the CI gate: every family's job really trained and accounted
        assert all(0.0 <= r["final_acc"] <= 1.0 for r in recs)
        assert all(r["n_dispatches"] == 1 for r in recs)
        for r in recs:
            if r["codec"] != "none":
                assert r["uplink_bits_per_msg"] < r["model_bits"]
        print(f"smoke pass: {len(recs)} jobs, "
              f"families={[r['arch'] for r in recs]}")
    return recs


if __name__ == "__main__":
    main()
