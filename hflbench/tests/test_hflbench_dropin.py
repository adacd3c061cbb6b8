"""A whole configuration drops in: its configuration file with its cuts
stated, its own driver, plain reference, limits, cell, end-to-end rate
and per-layer metric go in as new files and appended entries of ``BENCHMARK.json``,
and a run of its cell is judged correct, with no file that was there
edited.

    python -m pytest -q hflbench/tests
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "hflbench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hflbench.tests import contract  # noqa: E402

SEED = 2 ** 31 + 977          # larger than 32 signed bits hold

CONFIG = {
    "name": "toy-payload",
    "source": "a toy payload of the drop-in test: a stack of tanh layers",
    "precision": "f32",
    "control_precision": "tf32",
    "n_layers": 2,
    "width": 16,
    "lr": 0.1,
    "published": {"n_layers": 40},
    "deployment": "40 layers as 20 pipeline stages of 2, one chip a stage;"
                  " this chip holds one stage's 2 layers whole",
}

TRAFFIC = {"driver": "toy", "batch": 32, "batches": 8,
           "why": "one gradient step of the stack a unit, back to back"}

DRIVER = '''"""Traffic driver ``toy``: one gradient step of a stack of tanh
layers on the mean square of its output, from the seed's weights on
the next of the seed's batches, steps back to back."""
import time
import types

import torch

from hflbench import check
from hflbench import reference_toy as ref
from hflbench.world import torch_seed


class Driver:
    def __init__(self, cell, seed, device):
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.seed, self.device = seed, device
        self.rec = types.SimpleNamespace(spans=[])
        self.walls, self.stages, self.lanes = [], [], []
        self.out = []

    def setup(self):
        t = time.perf_counter()
        g = torch.Generator().manual_seed(torch_seed(self.seed, 1))
        n, d, tr = self.cfg["n_layers"], self.cfg["width"], self.traffic
        self.w = torch.randn(n, d, d, generator=g) / d ** 0.5
        self.x = torch.randn(tr["batches"], tr["batch"], d, generator=g)
        self.stages = [("weights", time.perf_counter() - t)]
        self.step()

    def step(self):
        x = self.x[len(self.out) % len(self.x)]
        w = self.w.clone().requires_grad_(True)
        h = x
        for i in range(len(w)):
            h = torch.tanh(h @ w[i])
        grad, = torch.autograd.grad(h.square().mean(), w)
        self.out.append((w - self.cfg["lr"] * grad).detach())

    def run(self, seconds):
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter_ns()
            self.step()
            t1 = time.perf_counter_ns()
            self.rec.spans.append(("step", t0, t1))
            self.walls.append((t1 - t0) / 1e9)
            if t1 / 1e9 - start >= seconds:
                return len(self.walls)

    def window_flops(self):
        n, d = self.cfg["n_layers"], self.cfg["width"]
        return 6 * self.traffic["batch"] * d * d * n * len(self.walls)

    def release(self):
        self.lanes = [{"x": self.x[i % len(self.x)], "w_out": w}
                      for i, w in enumerate(self.out)]

    def judge(self):
        rows = [{"step_gap": ref.step_gap(self.w, lr["w_out"], lr["x"],
                                          self.cfg["lr"])}
                for lr in self.lanes]
        return check.worst(rows), rows
'''

REFERENCE = '''"""The plain reference of the toy payload: the stack's gradient
step worked out by hand (the backward written out, no autograd), in
float64."""
import torch


def step(w, x, lr):
    w, x = w.double(), x.double()
    hs = [x]
    for i in range(len(w)):
        hs.append(torch.tanh(hs[-1] @ w[i]))
    g_h = 2 * hs[-1] / hs[-1].numel()
    grad = torch.zeros_like(w)
    for i in reversed(range(len(w))):
        g_a = g_h * (1 - hs[i + 1] ** 2)
        grad[i] = hs[i].T @ g_a
        g_h = g_a @ w[i].T
    return w - lr * grad


def step_gap(w_in, w_out, x, lr):
    """|program's step - reference's| over the reference's step, worst
    element over largest."""
    want = step(w_in, x, lr)
    return float((w_out.double() - want).abs().max()
                 / (want - w_in.double()).abs().max())
'''

METRIC = '''"""toy_mfu_pct: the window's model flops (the driver's
``window_flops()``) over the window's length times the H100's float32
peak outside the tensor cores."""
from hflbench import arith


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.driver.window_flops() / (
        run.window_s * arith.PEAK_F32_FLOPS)
'''

# the lower reading: 12 seeds, 8 batches each, on the CPU
LIMITS = {"step_gap": {
    "lower": 1.5581444499713226e-05, "limit": 1e-3, "upper": 1.0,
    "upper_from": "the step returns its weights unchanged",
    "sound_runs": 12}}

CELL = {"name": "toy-cell", "config": "toy-payload", "traffic": "toy-steps",
        "chips": 1, "why": "steps of a 2-layer stack back to back"}
CONFIG_ENTRY = {"name": "toy-payload", "source": CONFIG["source"],
                "file": "hflbench/configs/toy-payload.json",
                "reduced": ["n_layers"],
                "why": "a payload cut in depth, its own driver and reference"}
METRIC_ENTRY = {"name": "toy_mfu_pct", "unit": "%", "better": "higher",
                "source": "host_clock", "layer": "whole step",
                "moves": "toy_steps_per_s", "workloads": ["toy-cell"]}
# the accepted end-to-end rate is the sweep's alone: a new configuration
# brings its own, as a model's cell brings its tokens or steps a second
END_TO_END = {"name": "toy_steps_per_s", "unit": "steps/s",
              "better": "higher", "bound": 0.1, "source": "host_clock",
              "workloads": ["toy-cell"]}
RATE = '''"""toy_steps_per_s: the toy cell's gradient steps over the wall time
of those steps, host clock."""


def read(run):
    return run.work / sum(run.walls)
'''


def _hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(PKG, root / "hflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _drop_in(root: Path, config=CONFIG, config_entry=CONFIG_ENTRY,
             metric_entry=METRIC_ENTRY) -> None:
    """New files and appended entries only."""
    pkg = root / "hflbench"
    files = {"configs/toy-payload.json": json.dumps(config, indent=2),
             "traffic/toy-steps.json": json.dumps(TRAFFIC, indent=2),
             "drivers/toy.py": DRIVER, "reference_toy.py": REFERENCE,
             "metrics/toy_mfu_pct.py": METRIC,
             "metrics/toy_steps_per_s.py": RATE,
             "limits/toy-cell.json": json.dumps(LIMITS, indent=2)}
    for rel, text in files.items():
        assert not (pkg / rel).exists(), rel
        (pkg / rel).write_text(text)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(config_entry)
    bench["workloads"].append(CELL)
    bench["end_to_end"].append(END_TO_END)
    bench["per_layer"].append(metric_entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def _measure(root: Path):
    """``run.measure`` of the toy cell on the CPU, in a process started
    in the copy: its result line."""
    code = ("import sys, time, torch; from hflbench import harness; "
            "from hflbench.run import measure; "
            "sys.exit(measure(harness.find_cell('toy-cell'), "
            f"{SEED}, 0.5, False, torch.device('cpu'), time.perf_counter()))")
    p = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(root), str(ROOT / "src")])})
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_whole_configuration_drops_in(tmp_path):
    root = _copy(tmp_path)
    before = _hashes(root)
    bench0 = json.loads((root / "BENCHMARK.json").read_text())
    _drop_in(root)
    contract.check_contract(root)
    res = _measure(root)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"toy_steps_per_s", "setup_s"}
    assert list(res["checks"]) == ["step_gap"]

    after = _hashes(root)
    changed = [p for p, h in before.items()
               if p != Path("BENCHMARK.json") and after.get(p) != h]
    assert changed == []
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for key, old in bench0.items():
        if isinstance(old, list) and old and isinstance(old[0], dict):
            assert bench[key][:len(old)] == old, key
        else:
            assert bench[key] == old, key


def test_the_dropped_in_metric_reads_the_drivers_window_flops(tmp_path):
    root = _copy(tmp_path)
    _drop_in(root)
    code = ("import json, types; from hflbench import harness, arith; "
            "read = harness.metric_reader('toy_mfu_pct'); "
            "drv = types.SimpleNamespace(window_flops=lambda: 67e12); "
            "run = types.SimpleNamespace(driver=drv, window_s=2.0, "
            "trace={}); print(json.dumps([read(run), "
            "read(types.SimpleNamespace(trace=None)), "
            "arith.PEAK_F32_FLOPS]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, check=True).stdout
    pct, untraced, peak = json.loads(out)
    assert pct == pytest.approx(100.0 * 67e12 / (2.0 * peak))
    assert untraced is None


def test_a_step_left_unchanged_is_not_correct(tmp_path):
    """The toy's limit has a reading above it: the control of its
    comparison."""
    root = _copy(tmp_path)
    _drop_in(root)
    drv = root / "hflbench/drivers/toy.py"
    drv.write_text(drv.read_text().replace(
        "(w - self.cfg[\"lr\"] * grad).detach()", "self.w"))
    res = _measure(root)
    assert not res["correct"]
    assert res["checks"]["step_gap"]["value"] > LIMITS["step_gap"]["limit"]


def _without(d, key):
    return {k: v for k, v in d.items() if k != key}


@pytest.mark.parametrize("break_it,message", [
    (lambda root: _drop_in(root, config=_without(CONFIG, "published")),
     "published"),
    (lambda root: _drop_in(root, config=dict(CONFIG, published={})),
     "published"),
    (lambda root: _drop_in(root, config=_without(CONFIG, "deployment")),
     "deployment"),
    (lambda root: _drop_in(root, config_entry=dict(
        CONFIG_ENTRY, reduced=["n_layers", "n_experts"])),
     "reduced names no key"),
    (lambda root: _drop_in(root, config_entry=dict(
        CONFIG_ENTRY, name="toy payload")), "names outside"),
    (lambda root: _drop_cell(root, "cifar-round-h50"), "accepted cells"),
    (lambda root: _drop_in(root, metric_entry=dict(
        METRIC_ENTRY, moves="rounds_per_s")), "do not report"),
    (lambda root: _report_everywhere(root, "device_ms_per_round"),
     "profiled window"),
])
def test_the_contract_refuses(break_it, message, tmp_path):
    root = _copy(tmp_path)
    break_it(root)
    with pytest.raises(AssertionError, match=message):
        contract.check_contract(root)


def _report_everywhere(root: Path, metric: str) -> None:
    """The toy dropped in, and ``metric`` listed for every cell."""
    _drop_in(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] == metric:
            m["workloads"] = [w["name"] for w in bench["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _drop_cell(root: Path, name: str) -> None:
    _drop_in(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != name]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != name]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_dropped_in_reference_is_held_to_the_program_isolation(tmp_path):
    root = _copy(tmp_path)
    _drop_in(root)
    pkg = root / "hflbench"
    assert pkg / "reference_toy.py" in contract.reference_closure(pkg)
    assert contract.references_importing_the_program(pkg) == {}
    assert contract.program_modules_the_references_load(root) == []

    ref = pkg / "reference_toy.py"
    ref.write_text("from repro_torch.core import hfl  # noqa: F401\n"
                   + ref.read_text())
    assert contract.references_importing_the_program(pkg) == {
        ref: {"repro_torch"}}
    assert any(m.split(".")[0] == "repro_torch"
               for m in contract.program_modules_the_references_load(root))
