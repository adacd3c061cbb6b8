"""Traffic driver ``sweep``: a seed sweep, ``SweepRunner.run(fused=True)``
over ``lanes`` worlds as the lanes of one run (lane seeds lanes·seed ..
lanes·seed + lanes - 1), each dispatch ``rounds_per_dispatch`` rounds
with no host synchronisation between its first round and its last.

Set-up builds the worlds, the runner and one scheduler a lane (each
clusters its lane's devices, Algorithm 2) and runs one dispatch to warm
every shape; the window runs whole dispatches back to back until its
time is up. Every dispatch starts from the lanes' initial weights with
fresh host generators, and the schedulers carry their rotation state
from one dispatch to the next. Every lane-round's cohort, assignment,
allocation, costs, accuracy and chain of parameters are checked; the
reference recomputes the training of every lane in the window's first
dispatch, each lane at one of its rounds, drawn from the seed so that
the lanes share the rounds out evenly (each dispatch starts from the
lanes' initial weights, so that checks the start too).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from hflbench import arith, check
from hflbench.drivers import program
from hflbench.recorder import Recorder
from hflbench.ref_ikc import IKCScheduler
from hflbench.world import init_params, make_world, seed_words, torch_seed


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.cfg, self.traffic = cell, cell.cfg, cell.traffic
        self.seed, self.device = seed, device
        S = self.traffic["lanes"]
        self.lane_seeds = [S * seed + j for j in range(S)]
        self.fw_seeds = [torch_seed(s, 5) for s in self.lane_seeds]
        self.walls: List[float] = []
        self.results: List[Dict] = []          # run() results, warm-up first

    def setup(self):
        from repro_torch.core.framework import build_scheduler
        from repro_torch.core.sweep import SweepRunner
        cfg, tr = self.cfg, self.traffic
        t = time.perf_counter()
        self.worlds = [make_world(cfg, s) for s in self.lane_seeds]
        self.stages = [("worlds", time.perf_counter() - t)]
        t = time.perf_counter()
        self.inits = [init_params(cfg, s, self.device)
                      for s in self.lane_seeds]
        self.rec = Recorder(self.keep,
                            self.traffic["rounds_per_dispatch"]).install()
        sp = program.system_params(cfg)
        self.runner = SweepRunner(
            sp, [(program.population(cfg, w, self.device),
                  program.federated(cfg, w)) for w in self.worlds],
            lr=cfg["lr"], alloc_steps=cfg["alloc_steps"], agg_kernel=True,
            init_params=self.inits, device=str(self.device))
        r = self.runner
        self.scheds = []
        for j, w in enumerate(self.worlds):
            self.scheds.append(build_scheduler(
                tr["scheduler"], r.feds[j], sp, tr["H"], K=cfg["K"],
                lr=cfg["lr"], seed=self.fw_seeds[j], use_kernel=True,
                device=self.device, params=self.inits[j],
                data=(r.X_b[j], r.y_b[j], r.mask_b[j])))
        self.labels = [np.asarray(s.state.clusters).copy()
                       for s in self.scheds]
        self.keys = [self.rec.watch_scheduler(s) for s in self.scheds]
        self.stages.append(("program", time.perf_counter() - t))
        t = time.perf_counter()
        self._dispatch()
        self.stages.append(("warm-up", time.perf_counter() - t))
        self.rec.expect_seen()

    def _dispatch(self):
        self.results.append(self.runner.run(
            self.scheds, self.traffic["rounds_per_dispatch"],
            assign=self.traffic["assigner"], seeds=self.fw_seeds,
            fused=True))

    def run(self, seconds: float):
        """Whole dispatches back to back until ``seconds`` have passed;
        returns the lane-rounds completed."""
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self._dispatch()
            t1 = time.perf_counter()
            self.walls.append(t1 - t0)
            if t1 - start >= seconds:
                return (len(self.walls) * self.traffic["lanes"]
                        * self.traffic["rounds_per_dispatch"])

    def window_flops(self) -> int:
        return sum(arith.round_flops(
            self.cfg, int(self.worlds[j].D[c].sum()))
            for j, k in enumerate(self.keys)
            for c in self.rec.cohorts[k][self.traffic["rounds_per_dispatch"]:])

    def window_agg_bytes(self) -> int:
        cfg, tr = self.cfg, self.traffic
        per = arith.round_agg_bytes(tr["lanes"], cfg["n_edges"], tr["H"],
                                    cfg["Q"], cfg["parameters"])
        return per * len(self.walls) * tr["rounds_per_dispatch"]

    def window_launches(self) -> int:
        """One K1 launch a hop for all lanes: Q + 1 a round."""
        return ((self.cfg["Q"] + 1) * len(self.walls)
                * self.traffic["rounds_per_dispatch"])

    # ------------------------------------------------------- the check

    def lane_rounds(self) -> List[Dict]:
        R = self.traffic["rounds_per_dispatch"]
        out = []
        for i, r in enumerate(self.rec.rounds):
            d, k = divmod(i, R)
            p_in = program.on_host(r["params_in"])
            p_out = program.on_host(r["params_out"])
            acc = self.results[d]["acc"]
            local = (program.on_host(self.rec.local[i])
                     if i in self.rec.local else None)
            H = self.traffic["H"]
            for j in range(self.traffic["lanes"]):
                want_in = (program.on_host(self.inits[j]) if k == 0
                           else out[-self.traffic["lanes"]]["params_out"])
                out.append(dict(
                    lane=j, draw=i, dispatch=d,
                    sched=self.rec.cohorts[self.keys[j]][i],
                    assign=r["assign"][j].cpu().numpy(),
                    b=r["b"][j].cpu().numpy(), f=r["f"][j].cpu().numpy(),
                    T_i=float(r["T_i"][j]), E_i=float(r["E_i"][j]),
                    params_in={n: v[j] for n, v in p_in.items()},
                    params_out={n: v[j] for n, v in p_out.items()},
                    want_in=want_in, acc=float(acc[j, k]),
                    local=(None if local is None else
                           {n: v[j * H:(j + 1) * H]
                            for n, v in local.items()})))
        return out

    def release(self):
        self.lanes = self.lane_rounds()
        self.rec.uninstall()
        del self.runner, self.scheds
        self.rec.rounds.clear()
        self.rec.local.clear()

    @staticmethod
    def keep(d: int) -> bool:
        """Whether the reference recomputes training in dispatch ``d``
        (the window's first)."""
        return d == 1

    def sampled(self) -> List[int]:
        """Lane j's round ``perm[j] % R`` of the window's first
        dispatch, ``perm`` a permutation of the lanes drawn from the
        seed."""
        R, S = self.traffic["rounds_per_dispatch"], self.traffic["lanes"]
        perm = np.random.default_rng(seed_words(self.seed) + [9]) \
            .permutation(S)
        return [i for i, lr in enumerate(self.lanes)
                if self.keep(lr["dispatch"])
                and lr["draw"] % R == perm[lr["lane"]] % R]

    def replay(self, lane: int, labels):
        """Lane ``lane``'s cohorts: one scheduler across the dispatches,
        a fresh generator from the lane's seed in each."""
        R = self.traffic["rounds_per_dispatch"]
        sched = IKCScheduler(labels, max(1, self.traffic["H"]
                                         // self.cfg["K"]))
        out = []
        for _ in range(len(self.walls) + 1):
            rng = np.random.default_rng(self.fw_seeds[lane])
            out += [sched.schedule(rng) for _ in range(R)]
        return out

    def judge(self):
        return check.judge_run(
            self.cfg, self.device, self.worlds, self.fw_seeds, self.labels,
            self.replay, self.lanes, self.sampled())
