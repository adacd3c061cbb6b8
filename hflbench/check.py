"""The comparison that decides ``correct``: what the program produced in
the rounds it ran, against the plain reference (``reference.py``), in
the configuration's ``precision``.

A *lane-round* is one world's global round: its cohort, assignment,
allocation (b, f), priced costs (T_i, E_i), parameters in and out and
test accuracy, as ``recorder.Recorder`` read them off the program.
Every lane-round is held to the reference's cohort, assignment,
allocation, pricing and evaluation, and to the program's own chain of
parameters (each round starts where the last one ended, the first from
the benchmark's initial weights); the lane-rounds that the driver picks
(``sampled``) also have their training recomputed.

Numbers (a cell compares those that ``limits/<cell>.json`` lists, each
with its limit there; how each limit was set: PERF.md):
- ``labels_mismatch``: devices whose Algorithm-2 cluster differs.
- ``cohort_mismatch``, ``assign_mismatch``: scheduled devices, and edge
  ids of scheduled devices, that differ.
- ``chain_gap``: the largest |difference| between a round's parameters
  in and what they should be.
- ``alloc_excess``: how much worse, as a share, the program's (b, f)
  does on an edge's objective (27) than the reference's own solve of
  the same problem, at the worst edge of the run;
  ``alloc_excess_mean``: the same, the mean over every edge that holds
  devices in every lane-round. 200 Adam steps end within a few per cent
  of the optimum, at a point that float32 and float64 reach apart, so
  single edges scatter both ways; a solve cut short lies above on
  average.
- ``alloc_infeasible``: edges whose bandwidths overrun B_m or whose
  frequencies leave [0, f_max].
- ``cost_gap``: T_i and E_i against the reference's float64 pricing
  (eqs. (4)-(14)) of the program's own (b, f), relative, in units of
  what float32 can resolve there: 2^-24 (16 + max_n 1/ln(1 + snr_n))
  over the cohort, since eq. (6)'s log2(1 + snr) loses float32's
  precision in proportion to 1/ln(1 + snr) at a weak device's SNR.
- ``local_gap``: the first edge iteration's local training (L steps a
  device from the round's parameters), device by device, against the
  reference's: per leaf the norm of the difference over the larger of
  the reference's norm of that leaf's change and of the median leaf's;
  the worst leaf of a device, the median device. (Near-ties in a 2x2
  max-pool window, which rounding breaks either way, move a few
  devices' updates by 1e-4-5e-3 from any other float32 or float64
  computation; the median device has none.)
- ``update_gap``: the round's parameter update against the reference's
  from the same parameters, by the same measure. Q·L steps and Q
  averages amplify rounding far more than L steps do, so this limit
  lies far above ``local_gap``'s.
- ``acc_gap``: test answers by which the program's accuracy differs
  from the reference's evaluation of the program's parameters, beyond
  the answers whose two best logits tie to rounding.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from hflbench import reference as ref
from hflbench.world import World

LIMITS_DIR = Path(__file__).resolve().parent / "limits"

# numbers of a whole run: when one fails, every lane-round has
RUN_LEVEL = ("labels_mismatch", "alloc_excess_mean")


def limits(cell: str) -> Dict[str, float]:
    """The numbers cell ``cell`` compares, each with its limit
    (``limits/<cell>.json``, which also keeps the readings each limit
    was set from)."""
    rows = json.loads((LIMITS_DIR / f"{cell}.json").read_text())
    return {k: v["limit"] for k, v in rows.items()}


def _cpu(tree):
    return {k: v.detach().double().cpu() for k, v in tree.items()}


def update_gap(params_in, out, want) -> float:
    """Worst leaf of ||Δ_out − Δ_want|| / max(||Δ_want||, median leaf's
    ||Δ_want||), Δ taken from ``params_in``."""
    p, o, w = _cpu(params_in), _cpu(out), _cpu(want)
    ref_norm = {k: float((w[k] - p[k]).norm()) for k in p}
    floor = float(np.median(list(ref_norm.values())))
    return max(float((o[k] - w[k]).norm()) / max(ref_norm[k], floor, 1e-30)
               for k in p)


def local_gap(params_in, devices, wants) -> float:
    """``update_gap`` of each device's local training; the median
    device's."""
    return float(np.median([
        update_gap(params_in, {k: v[h] for k, v in devices.items()}, want)
        for h, want in enumerate(wants)]))


def chain_gap(got, want) -> float:
    g, w = _cpu(got), _cpu(want)
    return max(float((g[k] - w[k]).abs().max()) for k in w)


def _padded(rows: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D tensors as the rows of an (E, n) tensor, zero-padded, and the
    mask of the real entries."""
    n = max(len(r) for r in rows)
    out = torch.zeros(len(rows), n, dtype=rows[0].dtype)
    mask = torch.zeros(len(rows), n, dtype=torch.bool)
    for i, r in enumerate(rows):
        out[i, :len(r)], mask[i, :len(r)] = r, True
    return out, mask


class Judge:
    """Recomputes lane-rounds with the reference and compares.

    ``device``: where the reference trains and evaluates; its
    allocation solves run on the host in float64. ``prec``: the
    reference's precision, the configuration's ``precision`` unless
    given (the control's is its ``control_precision``)."""

    def __init__(self, cfg: Dict, device, prec: str = None):
        self.cfg, self.device = cfg, torch.device(device)
        self.prec = ref.Precision(prec or cfg["precision"])
        self.cm = ref.CostModel(cfg)

    # ------------------------------------------------- cheap numbers

    def labels(self, world: World, gen_seed: int) -> np.ndarray:
        return ref.cluster_labels(self.cfg, world, gen_seed, self.device,
                                  self.prec)

    @staticmethod
    def mismatch(got, want) -> int:
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            return max(got.size, want.size)
        return int((got != want).sum())

    def _edges(self, worlds: List[World], lrs: List[Dict]):
        """Every edge that holds devices in every lane-round, as the rows
        of padded (E, n) float64 inputs of problem (27): u, D, p, g, mask,
        B (E,), and for each edge its lane-round and its devices' places
        in that lane-round's cohort."""
        cpu = torch.device("cpu")
        cols = {k: [] for k in ("u", "D", "p", "g")}
        B, where = [], []
        for i, lr in enumerate(lrs):
            world = worlds[lr["lane"]]
            x = self.cm.cohort(world, lr["sched"], lr["assign"], cpu)
            a = np.asarray(lr["assign"])
            for m in range(self.cfg["n_edges"]):
                idx = np.flatnonzero(a == m)
                if len(idx):
                    for k, v in zip(cols, x):
                        cols[k].append(v[torch.from_numpy(idx)])
                    B.append(float(world.B_m[m]))
                    where.append((i, idx))
        (u, mask), (D, _), (p, _), (g, _) = (_padded(cols[k]) for k in cols)
        return u, D, p, g, mask, torch.tensor(B, dtype=torch.float64), where

    def solve(self, worlds: List[World], lrs: List[Dict],
              dtype=torch.float64, stop: int = None) -> List[Tuple]:
        """The reference's (b, f) of each lane-round, (H,) float64 each,
        solved in ``dtype``; ``stop`` ends the solve early (a planted
        fault)."""
        u, D, p, g, mask, B, where = self._edges(worlds, lrs)
        b, f = ref.allocate(self.cm, *(x.to(dtype) for x in (u, D, p, g)),
                            B.to(dtype), mask, self.cfg["alloc_steps"], stop)
        out = [(np.zeros(len(lr["sched"])), np.zeros(len(lr["sched"])))
               for lr in lrs]
        for e, (i, idx) in enumerate(where):
            out[i][0][idx] = b[e, :len(idx)].double().numpy()
            out[i][1][idx] = f[e, :len(idx)].double().numpy()
        return out

    def allocations(self, worlds: List[World], lrs: List[Dict]) -> List[Dict]:
        """For each lane-round: ``excess``, the share by which each edge
        that holds devices does worse under the lane-round's (b, f) than
        under the reference's own float64 solve (all edges of all
        lane-rounds in one batched solve), ``alloc_infeasible`` and
        ``cost_gap``."""
        rows = [{"excess": [], "alloc_infeasible": 0,
                 "cost_gap": self.cost_gap(worlds[lr["lane"]], lr)}
                for lr in lrs]
        u, D, p, g, mask, B, where = self._edges(worlds, lrs)
        b_ref, f_ref = ref.allocate(self.cm, u, D, p, g, B, mask,
                                    self.cfg["alloc_steps"])
        b, f = torch.zeros_like(u), torch.ones_like(u)
        for e, (i, idx) in enumerate(where):
            b[e, :len(idx)] = torch.as_tensor(
                np.asarray(lrs[i]["b"], np.float64)[idx])
            f[e, :len(idx)] = torch.as_tensor(
                np.asarray(lrs[i]["f"], np.float64)[idx])
        want = self.cm.edge_objective(u, D, p, g, b_ref, f_ref, mask)
        got = self.cm.edge_objective(u, D, p, g, b, f, mask)
        f_max = self.cfg["f_max"]
        infeasible = ((torch.where(mask, b, 0.0).sum(-1) > B * (1 + 1e-5))
                      | ((b < 0) & mask).any(-1) | ((f < 0) & mask).any(-1)
                      | ((f > f_max * (1 + 1e-6)) & mask).any(-1))
        for (i, _), x, bad in zip(where, ((got - want) / want).tolist(),
                                  infeasible.tolist()):
            rows[i]["excess"].append(x)
            rows[i]["alloc_infeasible"] += int(bad)
        return rows

    def cost_gap(self, world: World, lr: Dict) -> float:
        """T_i and E_i against the reference's pricing of the lane-round's
        own (b, f), in float32-resolution units."""
        cpu = torch.device("cpu")
        u, D, p, g = self.cm.cohort(world, lr["sched"], lr["assign"], cpu)
        b = torch.from_numpy(np.asarray(lr["b"], np.float64))
        f = torch.from_numpy(np.asarray(lr["f"], np.float64))
        T, E = self.cm.round_cost(world, lr["sched"], lr["assign"],
                                  self.operand(b), self.operand(f), cpu)
        snr = (g * p / self.cm.n0) / b.clamp_min(1.0)
        unit = 2.0 ** -24 * (16.0 + float((1.0 / torch.log1p(snr)).max()))
        return max(abs(lr["T_i"] - T) / T, abs(lr["E_i"] - E) / E) / unit

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """The pricing's operand at the reference's precision."""
        return self.prec.operand(x.float()).double()

    def acc_gap(self, world: World, lr: Dict) -> int:
        correct, ties = self.evaluate(world, lr["params_out"])
        n = len(world.y_test)
        return max(0, abs(round(lr["acc"] * n) - correct) - ties)

    # ------------------------------------------------ full recompute

    def train(self, world: World, lr: Dict, sample_frac: float = 1.0):
        """The reference's parameters after the lane-round's Algorithm 1
        from its parameters in."""
        return ref.hfl_round(self.cfg, world, lr["params_in"], lr["sched"],
                             lr["assign"], self.device, self.prec,
                             sample_frac)

    def local(self, world: World, lr: Dict) -> List:
        """The reference's L local steps of every cohort device from the
        lane-round's parameters in."""
        return [ref.local_gd(ref.cnn_apply,
                             {k: v.to(self.device)
                              for k, v in lr["params_in"].items()},
                             *ref.device_data(world, n, self.device),
                             self.cfg["L"], self.cfg["lr"], self.prec)
                for n in lr["sched"]]

    def evaluate(self, world: World, params) -> tuple:
        return ref.correct_and_ties(self.cfg, world, params, self.device,
                                    self.prec)

    def training(self, world: World, lr: Dict) -> Dict[str, float]:
        """local_gap (where the first hop was kept) and update_gap of one
        lane-round."""
        out = {}
        if lr.get("local") is not None:
            with self.prec.active():
                wants = self.local(world, lr)
            out["local_gap"] = local_gap(lr["params_in"], lr["local"], wants)
        out["update_gap"] = update_gap(lr["params_in"], lr["params_out"],
                                       self.train(world, lr))
        return out


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Every number of a run: the worst over its lane-rounds' rows, and
    over every edge ``alloc_excess`` and their mean
    ``alloc_excess_mean``."""
    out: Dict[str, float] = {}
    edges = []
    for row in rows:
        for k, v in row.items():
            if k == "excess":
                edges += v
            else:
                out[k] = max(out.get(k, 0.0), v)
    if edges:
        out["alloc_excess"] = max(edges)
        out["alloc_excess_mean"] = float(np.mean(edges))
    return out


def verdict(numbers: Dict[str, float], lim: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) with every number the cell
    compares beside its limit; a number it compares that the run did
    not produce fails, and is named."""
    rows = {k: {"value": numbers[k], "limit": lim[k]} for k in lim
            if k in numbers}
    missing = [k for k in lim if k not in numbers]
    if missing:
        print("hflbench: the run produced no " + ", ".join(missing),
              file=sys.stderr)
    ok = not missing and all(r["value"] <= r["limit"] for r in rows.values())
    return ok, rows


def failed(numbers: Dict[str, float], rows: List[Dict[str, float]],
           lim: Dict[str, float]) -> Set[int]:
    """The lane-rounds that fail a limit (all of them where a number of
    the whole run does)."""
    bad = {i for i, row in enumerate(rows)
           for k, v in worst([row]).items()
           if k not in RUN_LEVEL and k in lim and v > lim[k]}
    if any(numbers.get(k, 0.0) > lim[k] for k in RUN_LEVEL if k in lim):
        bad = set(range(len(rows)))
    return bad


def judge_run(cfg: Dict, device, worlds: List[World], gen_seeds: List[int],
              prog_labels: List[np.ndarray], replay, lane_rounds: List[Dict],
              sampled: List[int]):
    """(numbers of the run, one row of numbers a lane-round).

    ``replay(lane, labels) -> cohorts``: the reference's cohorts of a
    lane, in the order the lane drew them, from the reference's own
    labels of that lane. ``lane_rounds[i]`` carries ``lane``, ``draw`` (the
    index of its cohort in its lane's draws), ``sched``, ``assign``,
    ``b``, ``f``, ``T_i``, ``E_i``, ``params_in``, ``params_out``,
    ``want_in``, ``acc`` and ``local`` (the first hop's devices, or
    None); ``sampled`` lists the ones whose training is recomputed."""
    judge = Judge(cfg, device)
    labels_mismatch = 0
    cohorts = []
    for lane, world in enumerate(worlds):
        labels = judge.labels(world, gen_seeds[lane])
        labels_mismatch = max(labels_mismatch,
                              judge.mismatch(prog_labels[lane], labels))
        cohorts.append(replay(lane, labels))
    rows = judge.allocations(worlds, lane_rounds)
    for i, (lr, row) in enumerate(zip(lane_rounds, rows)):
        world = worlds[lr["lane"]]
        row.update(
            cohort_mismatch=judge.mismatch(
                lr["sched"], cohorts[lr["lane"]][lr["draw"]]),
            assign_mismatch=judge.mismatch(
                lr["assign"], ref.geo_assign(world, lr["sched"])),
            chain_gap=chain_gap(lr["params_in"], lr["want_in"]),
            acc_gap=judge.acc_gap(world, lr))
        if i in sampled:
            row.update(judge.training(world, lr))
    numbers = worst(rows)
    numbers["labels_mismatch"] = labels_mismatch
    return numbers, rows
