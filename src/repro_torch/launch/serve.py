"""Long-running streaming HFL service: the async engine under traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --rounds 50 \\
        --traffic diurnal --buffer-size 4 \\
        --ckpt-dir /tmp/hfl_ckpt --ckpt-every 10

Port of ``repro.launch.serve``. Drives
:class:`repro_torch.core.async_engine.AsyncHFLEngine` round by round on
a virtual clock, on ``--device`` (``cuda`` unless ``cpu`` is asked for;
a missing card raises): every round streams one JSON line to stdout
(round id, virtual time, accuracy, staleness and waste accounting), the
model is evaluated every ``--eval-every`` rounds and checkpointed every
``--ckpt-every`` rounds through ``repro_torch.checkpoint.ckpt``
(``<dir>/step_<round>/``, the reference's layout). Traffic presets:

* ``always-on``  the degenerate sync-parity fleet (no churn),
* ``stationary`` alternating-renewal dropouts + 20% 4x stragglers,
* ``diurnal``    non-homogeneous Poisson joins, sinusoidal load,
* ``bursty``     diurnal plus periodic burst windows.

The LM decode serving CLI is ``repro_torch.launch.serve_lm``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.core import compression as comp
from repro_torch.core import cost_model as cm
from repro_torch.core.async_engine import AsyncConfig, AsyncHFLEngine
from repro_torch.core.traffic import TrafficGenerator, TrafficParams
from repro_torch.data import make_dataset, partition_noniid

TRAFFIC = ("always-on", "stationary", "diurnal", "bursty")
# the stationary preset's availability: 10 % offline at t=0, sessions of
# 900 s, gaps of 120 s, 20 % of the devices 4x slower
STATIONARY = cm.AvailabilityParams(p_offline0=0.1, mean_up_s=900.0,
                                   mean_down_s=120.0, straggler_frac=0.2,
                                   straggler_scale=4.0)


def build_world(n_devices: int, n_edges: int, n_train: int, n_test: int,
                seed: int, L: Optional[int] = None,
                Q: Optional[int] = None, device="cuda"):
    """Population (on ``device``) + synthetic non-IID federated dataset
    (the quickstart recipe) sized for a streaming run."""
    sp = cm.SystemParams(n_devices=n_devices, n_edges=n_edges,
                         d_range=(50, 90))
    if L is not None:
        sp = dataclasses.replace(sp, L=L)
    if Q is not None:
        sp = dataclasses.replace(sp, Q=Q)
    pop = cm.sample_population(sp, seed=seed, device=device)
    X, y, Xt, yt = make_dataset("fmnist_syn", n_train=n_train,
                                n_test=n_test, seed=seed)
    fed = partition_noniid(X, y, Xt, yt, n_devices=n_devices,
                           size_range=(20, 40), seed=seed)
    return sp, pop, fed


def build_trace(traffic: str, n_devices: int, seed: int,
                horizon_s: float = 2e4) -> cm.AvailabilityTrace:
    """Availability trace for a named traffic preset."""
    if traffic == "always-on":
        return cm.AvailabilityTrace.always_on(n_devices)
    if traffic == "stationary":
        return cm.sample_availability(STATIONARY, n_devices, seed=seed)
    if traffic in ("diurnal", "bursty"):
        tp = TrafficParams(
            join_rate=n_devices / 600.0, mean_session_s=600.0,
            diurnal_amp=0.8, diurnal_period_s=3600.0, p_online0=0.5,
            burst_mult=5.0 if traffic == "bursty" else 1.0,
            burst_every_s=3600.0 if traffic == "bursty" else float("inf"),
            burst_len_s=300.0 if traffic == "bursty" else 0.0)
        return TrafficGenerator(tp, n_devices, seed=seed).make_trace(
            horizon_s)
    raise ValueError(f"unknown traffic preset {traffic!r}")


def run_serve(n_devices: int = 40, n_edges: int = 5, H: int = 20,
              rounds: int = 10, scheduler: str = "fedavg",
              traffic: str = "always-on",
              buffer_size: Optional[int] = None,
              staleness_exp: float = 0.5, eval_every: int = 1,
              ckpt_every: int = 0, ckpt_dir: Optional[str] = None,
              out_json: Optional[str] = None, seed: int = 0,
              n_train: int = 2000, n_test: int = 500,
              alloc_steps: int = 100, L: Optional[int] = None,
              Q: Optional[int] = None, codec: str = "none",
              topk_frac: float = 0.05, log=print, device="cuda",
              trace: Optional[cm.AvailabilityTrace] = None,
              init_params: Optional[Mapping] = None,
              engine_out: Optional[list] = None) -> Dict:
    """Stream ``rounds`` async HFL rounds; returns the engine summary.

    The importable core of the CLI: ``log`` receives one JSON line per
    round (with an uplink ``codec`` it carries the compressed
    ``msg_bits``/``uplink_bytes``/``codec`` accounting). ``trace``
    replaces the ``traffic`` preset's trace and ``init_params`` the
    model's drawn initial weights (e.g. the reference's, whose
    ``jax.random`` draws torch cannot replay); ``engine_out``, a list,
    receives the engine.
    """
    sp, pop, fed = build_world(n_devices, n_edges, n_train, n_test, seed,
                               L=L, Q=Q, device=device)
    if trace is None:
        trace = build_trace(traffic, n_devices, seed)
    cfg = AsyncConfig(H=H, scheduler=scheduler, buffer_size=buffer_size,
                      staleness_exp=staleness_exp, seed=seed,
                      alloc_steps=alloc_steps, device=device,
                      compression=comp.CompressionConfig(
                          codec=codec, topk_frac=topk_frac, seed=seed))
    engine = AsyncHFLEngine(sp, pop, fed, cfg, trace=trace,
                            init_params=init_params)
    if engine_out is not None:
        engine_out.append(engine)

    n_ckpts = 0
    for r in range(1, rounds + 1):
        rec = engine.step_round(
            collect_eval=eval_every > 0 and r % eval_every == 0)
        log(json.dumps(rec))
        if ckpt_every > 0 and ckpt_dir and r % ckpt_every == 0:
            ckpt.save_pytree(engine.model_params, ckpt_dir, r)
            n_ckpts += 1

    summary = engine.summary()
    summary["n_checkpoints"] = n_ckpts
    summary["traffic"] = traffic
    if out_json:
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as fh:
            json.dump(summary, fh, indent=1)
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny world / 3 rounds (CI smoke)")
    ap.add_argument("--devices", type=int, default=40)
    ap.add_argument("--edges", type=int, default=5)
    ap.add_argument("--H", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--scheduler", default="fedavg",
                    choices=("fedavg", "ikc", "vkc"))
    ap.add_argument("--traffic", default="stationary", choices=TRAFFIC)
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="edge flush threshold (default: wait-for-all)")
    ap.add_argument("--staleness-exp", type=float, default=0.5)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None, help="summary JSON path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codec", default="none", choices=comp.CODECS,
                    help="uplink update codec (error-feedback residuals)")
    ap.add_argument("--topk-frac", type=float, default=0.05,
                    help="kept fraction per tensor for --codec topk")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless cpu is asked for)")
    args = ap.parse_args(argv)

    kw = dict(n_devices=args.devices, n_edges=args.edges, H=args.H,
              rounds=args.rounds, scheduler=args.scheduler,
              traffic=args.traffic, buffer_size=args.buffer_size,
              staleness_exp=args.staleness_exp,
              eval_every=args.eval_every, ckpt_every=args.ckpt_every,
              ckpt_dir=args.ckpt_dir, out_json=args.out, seed=args.seed,
              codec=args.codec, topk_frac=args.topk_frac,
              device=args.device)
    if args.smoke:
        kw.update(n_devices=10, n_edges=3, H=6, rounds=3, n_train=300,
                  n_test=120, alloc_steps=40, L=2, Q=3)
    summary = run_serve(**kw)
    acc = summary["final_acc"]
    print(f"served {summary['rounds']} rounds to t={summary['t_virtual']:.1f}s "
          f"virtual: acc={'-' if acc is None else f'{acc:.3f}'} "
          f"updates={summary['n_updates']} stale={summary['n_stale']} "
          f"wasted={summary['wasted_j']:.1f}J "
          f"ckpts={summary['n_checkpoints']}")


if __name__ == "__main__":
    main()
