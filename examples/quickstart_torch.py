"""Quickstart on the PyTorch port: the paper's full pipeline on a
pocket-sized world (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--smoke] [--device cuda|cpu]

1. builds a synthetic non-IID federated dataset (40 IoT devices),
2. clusters devices with the IKC mini model (Algorithm 2; the distance
   passes through the ``pairwise_sq_dists`` kernel on a card),
3. schedules a cohort (Algorithm 4), assigns it to edge servers,
4. allocates bandwidth/CPU (problem 27), prices the round (eqs. 4-14),
5. runs a few HFL global iterations (Algorithm 1, the eq. (2)/(3)
   aggregations through the ``masked_aggregate`` kernel on a card) and
   prints accuracy.

It runs on the card (``--device cuda``, the default; without one it
raises) unless ``--device cpu`` is given. ``--smoke`` shrinks the world
to CI-guard size: the point is that the public entry points still
execute, not the accuracy it reaches.
"""
import argparse
import time

from repro_torch.core.cost_model import SystemParams, sample_population
from repro_torch.core.framework import FrameworkConfig, HFLFramework
from repro_torch.data import make_dataset, partition_noniid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny world / 2 rounds (CI smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.time()
    n_dev = 12 if args.smoke else 40
    sp = SystemParams(n_devices=n_dev, n_edges=5, d_range=(50, 90))
    pop = sample_population(sp, seed=0, device=args.device)
    n_train, n_test = (600, 150) if args.smoke else (5000, 800)
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=n_train,
                                n_test=n_test, seed=0)
    fed = partition_noniid(X, y, Xt, yt, n_devices=n_dev,
                           size_range=(20, 40) if args.smoke else (50, 90),
                           seed=0)
    print(f"[{time.time()-t0:5.1f}s] world ready: {fed.n_devices} devices, "
          f"{sp.n_edges} edges")

    cfg = FrameworkConfig(scheduler="ikc", assigner="geo",
                          H=6 if args.smoke else 20, K=4 if args.smoke else 10,
                          target_acc=0.70, max_iters=2 if args.smoke else 6,
                          seed=0, agg_kernel=True, use_kernel=True,
                          device=args.device)
    fw = HFLFramework(sp, pop, fed, cfg)
    cs = fw.clustering_stats
    print(f"[{time.time()-t0:5.1f}s] IKC clustering: ARI={cs['ari']:.2f} "
          f"delay={cs['delay_s']:.1f}s energy={cs['energy_j']:.1f}J "
          f"(mini model {cs['aux_bits']/8e3:.1f} KB)")

    summary = fw.run(verbose=True)
    print(f"[{time.time()-t0:5.1f}s] finished: {summary['iters']} rounds, "
          f"acc={summary['final_acc']:.3f}, E+λT={summary['objective']:.0f}")
    summary["K"], summary["Q"], summary["L"] = cfg.K, sp.Q, sp.L
    summary["n_test"] = len(yt)
    return summary


if __name__ == "__main__":
    main()
