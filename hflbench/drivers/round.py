"""Traffic driver ``round``: a closed loop of ``HFLFramework.run_round``,
one world, rounds back to back with no early stop.

Set-up builds the world, the framework (which clusters the devices,
Algorithm 2) and runs round 0 to warm every shape the window uses; the
window runs rounds 1, 2, ... until its time is up. The traffic file
gives the scheduler, the assigner, the cohort size H and the share of
the window's later rounds whose training the reference recomputes
(``check_share``, each round drawn from the seed). Round 0, which
starts from the benchmark's own weights, and round 1, the window's
first, are always recomputed; every round's cohort, assignment,
allocation, costs and accuracy are checked.
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
        self.fw_seeds = [torch_seed(seed, 5)]
        self.records: List[Dict] = []          # the window's round records
        self.walls: List[float] = []

    # ------------------------------------------------------------ set-up

    def setup(self):
        from repro_torch.core.framework import FrameworkConfig, HFLFramework
        cfg, tr = self.cfg, self.traffic
        t = time.perf_counter()
        self.world = make_world(cfg, self.seed)
        self.worlds = [self.world]
        self.stages = [("world", time.perf_counter() - t)]
        t = time.perf_counter()
        self.init = init_params(cfg, self.seed, self.device)
        self.rec = Recorder(self.keep).install()
        fcfg = FrameworkConfig(
            arch="hfl-cnn", scheduler=tr["scheduler"], assigner=tr["assigner"],
            H=tr["H"], K=cfg["K"], lr=cfg["lr"],
            alloc_steps=cfg["alloc_steps"], seed=self.fw_seeds[0],
            use_kernel=True, agg_kernel=True, device=str(self.device))
        self.fw = HFLFramework(program.system_params(cfg),
                               program.population(cfg, self.world,
                                                  self.device),
                               program.federated(cfg, self.world), fcfg,
                               init_params=self.init)
        self.sched_key = self.rec.watch_scheduler(self.fw.scheduler)
        self.labels = [np.asarray(self.fw.scheduler.state.clusters).copy()]
        self.setup_seconds = dict(self.fw.setup_seconds)
        self.stages.append(("program", time.perf_counter() - t))
        t = time.perf_counter()
        self.warm = self.fw.run_round(0)
        self.stages.append(("warm-up", time.perf_counter() - t))
        self.rec.expect_seen()

    # ------------------------------------------------------------ window

    def run(self, seconds: float):
        """Rounds back to back until ``seconds`` have passed; returns the
        lane-rounds completed."""
        start = time.perf_counter()
        i = 1
        while True:
            t0 = time.perf_counter()
            self.records.append(self.fw.run_round(i))
            t1 = time.perf_counter()
            self.walls.append(t1 - t0)
            i += 1
            if t1 - start >= seconds:
                return len(self.walls)

    def window_flops(self) -> int:
        """Model flops of the window's rounds (real samples only)."""
        cohorts = self.rec.cohorts[self.sched_key][1:]
        return sum(arith.round_flops(self.cfg, int(self.world.D[c].sum()))
                   for c in cohorts)

    def window_agg_bytes(self) -> int:
        cfg = self.cfg
        per = arith.round_agg_bytes(1, cfg["n_edges"], self.traffic["H"],
                                    cfg["Q"], cfg["parameters"])
        return per * len(self.walls)

    def window_launches(self) -> int:
        """K1 launches the window's rounds make: Q edge hops and one
        cloud hop a round."""
        return (self.cfg["Q"] + 1) * len(self.walls)

    # ------------------------------------------------------- the check

    def lane_rounds(self) -> List[Dict]:
        """Every recorded round (round 0 first) on the host."""
        out = []
        cohorts = self.rec.cohorts[self.sched_key]
        accs = [self.warm["acc"]] + [r["acc"] for r in self.records]
        want_in = program.on_host(self.init)
        for i, r in enumerate(self.rec.rounds):
            params_in = {k: v[0] for k, v in program.on_host(
                r["params_in"]).items()}
            params_out = {k: v[0] for k, v in program.on_host(
                r["params_out"]).items()}
            out.append(dict(
                lane=0, draw=i, sched=cohorts[i],
                assign=r["assign"][0].cpu().numpy(),
                b=r["b"][0].cpu().numpy(), f=r["f"][0].cpu().numpy(),
                T_i=float(r["T_i"][0]), E_i=float(r["E_i"][0]),
                params_in=params_in, params_out=params_out,
                want_in=want_in, acc=accs[i],
                local=(program.on_host(self.rec.local[i])
                       if i in self.rec.local else None)))
            want_in = params_out
        return out

    def release(self):
        """Drop the program's state (the recorded rounds stay, on the
        host)."""
        self.lanes = self.lane_rounds()
        self.rec.uninstall()
        del self.fw
        self.rec.rounds.clear()
        self.rec.local.clear()

    def keep(self, i: int) -> bool:
        """Whether the reference recomputes round ``i``'s training."""
        return i <= 1 or np.random.default_rng(
            seed_words(self.seed) + [9, i]).random() < \
            self.traffic["check_share"]

    def sampled(self) -> List[int]:
        return [i for i in range(len(self.lanes)) if self.keep(i)]

    def replay(self, lane: int, labels):
        h = max(1, self.traffic["H"] // self.cfg["K"])
        sched = IKCScheduler(labels, h)
        rng = np.random.default_rng(self.fw_seeds[lane])
        return [sched.schedule(rng) for _ in range(len(self.lanes))]

    def judge(self):
        """(numbers of the run, a row of numbers a lane-round)."""
        return check.judge_run(
            self.cfg, self.device, self.worlds, self.fw_seeds, self.labels,
            self.replay, self.lanes, self.sampled())
