"""The readings the correctness limits are set from
(``limits/<cell>.json``).

    python3 hflbench/calibrate.py --workload NAME --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 8] [--alloc-only] [--out FILE]

For every seed, in one process: the cell's set-up and a short window on
its own driver (the timed path), then its lane-rounds judged against
the reference as a run judges them: the *sound* readings. For each
control seed also:
- ``control``: the reference in the configuration's
  ``control_precision`` put in the program's place (its local training,
  its round and its evaluation of its own result on the lane-rounds
  whose training the run recomputes, and its pricing of the program's
  (b, f) with rounded operands on all), judged against the reference;
- ``fault_unchanged``: the round, and each device's local training,
  return their parameters unchanged;
- ``fault_half_batch``: each device trains on the first half of its
  samples (the reference in the program's place);
- ``fault_alloc_unchanged``: the allocation left at the solver's start
  (equal bandwidth shares, f = f_max·sigmoid(1)), priced as such;
- ``fault_alloc_cut``: the allocation solved in float32 by the reference
  in the program's place, stopped after half its steps, mid-anneal;
- ``fault_stale_cost``: the costs left as the lane's previous round
  priced them;
- ``fault_altered``: a cluster label, a cohort entry, an edge id, the
  parameters a round starts from (by 1e-3), the bandwidths (by 1 %) and
  the accuracy (by one test answer) altered where they are produced.
``--alloc-only`` leaves out every recomputed training (and the
readings that need one). Prints one JSON object a reading and, last,
the largest sound reading and the smallest control or fault reading of
every number.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]


def readings(cell, seed: int, seconds: float, device, control: bool,
             training: bool = True):
    """[(kind, numbers)] of one seed (without ``training``, none that
    needs a recomputed training)."""
    import numpy as np
    import torch
    from hflbench import check, harness
    from hflbench import reference as ref
    cfg = cell.cfg
    drv = harness.driver(cell.traffic["driver"]).Driver(cell, seed, device)
    drv.setup()
    drv.run(seconds)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sampled = set(drv.sampled()) if training else set()
    numbers, _ = check.judge_run(cfg, device, drv.worlds, drv.fw_seeds,
                                 drv.labels, drv.replay, drv.lanes,
                                 sorted(sampled))
    out = [("sound", numbers)]
    if not control:
        return out
    worlds, lanes = drv.worlds, drv.lanes
    judge = check.Judge(cfg, device)
    low = check.Judge(cfg, device, cfg["control_precision"])
    cpu = torch.device("cpu")
    kinds = {k: {} for k in ("control", "fault_unchanged",
                             "fault_half_batch", "fault_alloc_unchanged",
                             "fault_alloc_cut", "fault_stale_cost",
                             "fault_altered")}

    def note(kind, row):
        for k, v in row.items():
            kinds[kind][k] = max(kinds[kind].get(k, 0.0), v)

    def alloc_numbers(lrs):
        return {k: v for k, v in check.worst(judge.allocations(worlds, lrs))
                .items() if k.startswith("alloc")}

    def priced(lr, b, f):
        T, E = judge.cm.round_cost(worlds[lr["lane"]], lr["sched"],
                                   lr["assign"], torch.from_numpy(b),
                                   torch.from_numpy(f), cpu)
        return dict(lr, b=b, f=f, T_i=T, E_i=E)

    def stack(devs):
        return {k: torch.stack([d[k] for d in devs]).cpu() for k in devs[0]}

    # the control: the lower-precision reference in the program's place
    ctl = []
    for lr in lanes:
        b = torch.from_numpy(np.asarray(lr["b"], np.float64))
        f = torch.from_numpy(np.asarray(lr["f"], np.float64))
        T, E = low.cm.round_cost(worlds[lr["lane"]], lr["sched"],
                                 lr["assign"], low.operand(b),
                                 low.operand(f), cpu)
        ctl.append(dict(lr, T_i=T, E_i=E))
    note("control", check.worst(judge.allocations(worlds, ctl)))
    for i in sorted(sampled):
        lr, w = lanes[i], worlds[lanes[i]["lane"]]
        c = dict(ctl[i])
        with low.prec.active():
            c["local"] = stack(low.local(w, lr))
        c["params_out"] = low.train(w, lr)
        c["acc"] = low.evaluate(w, c["params_out"])[0] / len(w.y_test)
        note("control", {**judge.training(w, c),
                         "acc_gap": judge.acc_gap(w, c)})
        # the training faults, on the same lane-rounds
        with judge.prec.active():
            want_local = judge.local(w, lr)
            p_in = {k: v.to(device) for k, v in lr["params_in"].items()}
            half_local = [ref.local_gd(
                ref.cnn_apply, p_in, *ref.device_data(w, n, device, 0.5),
                cfg["L"], cfg["lr"], judge.prec) for n in lr["sched"]]
        want = judge.train(w, lr)
        unchanged = {k: v[None].expand((len(lr["sched"]),) + v.shape)
                     for k, v in lr["params_in"].items()}
        note("fault_unchanged", {
            "update_gap": check.update_gap(lr["params_in"], lr["params_in"],
                                           want),
            "local_gap": check.local_gap(lr["params_in"], unchanged,
                                         want_local)})
        note("fault_half_batch", {
            "update_gap": check.update_gap(
                lr["params_in"], judge.train(w, lr, sample_frac=0.5), want),
            "local_gap": check.local_gap(lr["params_in"], stack(half_local),
                                         want_local)})
    # the allocation's start: equal shares, f = f_max·sigmoid(1)
    start = []
    for lr in lanes:
        a = np.asarray(lr["assign"])
        counts = np.bincount(a, minlength=cfg["n_edges"])
        start.append(priced(lr, worlds[lr["lane"]].B_m[a] / counts[a],
                            np.full(len(a), cfg["f_max"]
                                    / (1.0 + math.exp(-1.0)))))
    note("fault_alloc_unchanged", alloc_numbers(start))
    cut = judge.solve(worlds, lanes, torch.float32,
                      stop=cfg["alloc_steps"] // 2)
    note("fault_alloc_cut", alloc_numbers(
        [priced(lr, b, f) for lr, (b, f) in zip(lanes, cut)]))
    # the costs left as the lane's last round priced them
    prev = {}
    for lr in lanes:
        if lr["lane"] in prev:
            stale = dict(lr, T_i=prev[lr["lane"]]["T_i"],
                         E_i=prev[lr["lane"]]["E_i"])
            note("fault_stale_cost",
                 {"cost_gap": judge.cost_gap(worlds[lr["lane"]], stale)})
        prev[lr["lane"]] = lr
    # one answer altered where it is produced
    over = [dict(lr, b=np.asarray(lr["b"]) * 1.01) for lr in lanes]
    note("fault_altered", {"alloc_infeasible": check.worst(
        judge.allocations(worlds, over))["alloc_infeasible"]})
    n_test = cfg["n_test"]
    for i, lr in enumerate(lanes):
        w = worlds[lr["lane"]]
        alt_sched = np.array(lr["sched"]).copy()
        alt_sched[0] = (alt_sched[0] + 1) % cfg["n_devices"]
        alt_assign = np.array(lr["assign"]).copy()
        alt_assign[0] = (alt_assign[0] + 1) % cfg["n_edges"]
        row = {"cohort_mismatch": judge.mismatch(alt_sched, lr["sched"]),
               "assign_mismatch": judge.mismatch(
                   alt_assign, ref.geo_assign(w, lr["sched"])),
               "chain_gap": check.chain_gap(
                   {k: v + 1e-3 for k, v in lr["params_in"].items()},
                   lr["want_in"])}
        if i in sampled:
            row["acc_gap"] = judge.acc_gap(
                w, dict(lr, acc=lr["acc"] + 1.0 / n_test))
        note("fault_altered", row)
    labels = drv.labels[0].copy()
    labels[0] = (labels[0] + 1) % cfg["K"]
    note("fault_altered", {"labels_mismatch": check.Judge.mismatch(
        labels, drv.labels[0])})
    out += list(kinds.items())
    return out


TRAINING_FAULTS = ("fault_unchanged", "fault_half_batch")


def summary(rows):
    """{number: {"lower", "upper", "upper_from"}}: the largest sound
    reading; the smallest reading of the control or of a fault where it
    is three times the lower or more, ten times for a fault of the
    training (one that reads less is another number's to catch)."""
    out = {}
    for kind, numbers in rows:
        if kind == "sound":
            for k, v in numbers.items():
                o = out.setdefault(k, {"lower": 0.0, "upper": None,
                                       "upper_from": None})
                o["lower"] = max(o["lower"], v)
    for kind, numbers in rows:
        if kind == "sound":
            continue
        for k, v in numbers.items():
            o = out[k]
            factor = 10.0 if kind in TRAINING_FAULTS else 3.0
            if v > 0 and v >= factor * o["lower"] and (
                    o["upper"] is None or v < o["upper"]):
                o["upper"], o["upper_from"] = v, kind
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--alloc-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from hflbench import harness
    from repro_torch.kernels import build
    build.build()
    cell = harness.find_cell(args.workload)
    tf32 = cell.cfg["precision"] == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds + sorted(ctl - set(seeds)):
        t = time.perf_counter()
        for kind, numbers in readings(cell, seed, args.seconds,
                                      torch.device("cuda"), seed in ctl,
                                      not args.alloc_only):
            rows.append((kind, numbers))
            print(json.dumps({"seed": seed, "kind": kind, **numbers}),
                  flush=True)
        print(f"# seed {seed}: {time.perf_counter() - t:.1f} s", flush=True)
    s = summary(rows)
    print(json.dumps({"workload": args.workload, "summary": s}))
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": s},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
