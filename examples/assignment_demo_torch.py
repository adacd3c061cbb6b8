"""Device-assignment shootout on one sampled IoT population on the
PyTorch port: geographic vs HFEL-100 vs HFEL-300 — the Fig. 6
comparison interactively (the counterpart of
``examples/assignment_demo.py``).

    PYTHONPATH=src python examples/assignment_demo_torch.py [--H 20] [--device cuda|cpu]

It runs on the card (``--device cuda``, the default; without one it
raises) unless ``--device cpu`` is given. Returns, per strategy, the
objective E + λT, the slowest edge's T, the summed E, the wall latency
of the search and the assignment.
"""
import argparse
import time

import numpy as np

from repro_torch.core.assignment import GeoAssigner, HFELAssigner
from repro_torch.core.assignment.hfel import total_objective
from repro_torch.core.cost_model import SystemParams
from repro_torch.drl.train import make_training_population
from repro_torch.utils import resolve_device, synchronize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--H", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sp = SystemParams(n_edges=5, lam=1.0)
    pop = make_training_population(sp, args.H, seed=args.seed, device=device)
    sched = np.arange(args.H)
    rng = np.random.default_rng(0)

    print(f"population: H={args.H} devices, M={sp.n_edges} edges, λ={sp.lam}")
    print(f"{'strategy':12s} {'obj E+λT':>12s} {'T_i (s)':>10s} "
          f"{'E_i (J)':>10s} {'latency':>10s}")
    out = {}
    for name, strat in (
            ("geo", GeoAssigner(sp)),
            ("hfel-100", HFELAssigner(sp, 100, 100, alloc_steps=120)),
            ("hfel-300", HFELAssigner(sp, 100, 300, alloc_steps=120))):
        t0 = time.perf_counter()
        a, _ = strat.assign(pop, sched, rng)
        synchronize(device)
        lat = time.perf_counter() - t0
        a = np.asarray(a)
        obj, T_m, E_m = total_objective(sp, pop, sched, a, alloc_steps=120)
        counts = np.bincount(a, minlength=sp.n_edges)
        print(f"{name:12s} {obj:12.1f} {T_m.max():10.1f} {E_m.sum():10.1f} "
              f"{lat*1e3:8.0f}ms  edge loads={counts.tolist()}")
        out[name] = {"obj": obj, "T": float(T_m.max()),
                     "E": float(E_m.sum()), "latency_s": lat, "assign": a}
    return out


if __name__ == "__main__":
    main()
