"""The benchmark's files, its arithmetic and its imports, on the CPU.

    python -m pytest -q hflbench/tests
"""
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

from hflbench import arith, check, harness, reference  # noqa: E402
from hflbench.tests import contract  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FMNIST = json.loads((PKG / "configs/hfl-cnn-fmnist-table1.json").read_text())
CIFAR = json.loads((PKG / "configs/hfl-cnn-cifar-table1.json").read_text())


# ------------------------------------------------------------ discovery

@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.find_cell(cell)
    assert (PKG / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert hasattr(harness.driver(c.traffic["driver"]), "Driver")
    assert c.end_to_end and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    rows = json.loads((PKG / "limits" / f"{cell}.json").read_text())
    assert rows and all(
        r["lower"] <= r["limit"] < r["upper"] or r["limit"] == r["lower"]
        == 0 < r["upper"] for r in rows.values()), rows
    assert check.limits(cell) == {k: r["limit"] for k, r in rows.items()}
    reference.Precision(c.cfg["precision"])
    reference.Precision(c.cfg["control_precision"])


def test_a_dropped_in_cell_is_found_without_a_code_edit(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "hflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((PKG / "traffic/round-ikc-h50.json").read_text())
    traffic["H"] = 20
    (tmp_path / "hflbench/traffic/round-ikc-h20.json").write_text(
        json.dumps(traffic))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fmnist-round-h20",
                               "config": "hfl-cnn-fmnist-table1",
                               "traffic": "round-ikc-h20", "chips": 1,
                               "why": "a 20 % cohort"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "hflbench/limits/fmnist-round-h20.json").write_text(
        json.dumps({"update_gap": {"limit": 0.02}}))
    code = ("from hflbench import check, harness; c = harness.find_cell("
            "'fmnist-round-h20'); print(c.traffic['H'], c.cfg['name'], "
            "check.limits(c.name)['update_gap'], "
            "harness.driver(c.traffic['driver']).__file__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)},
                         capture_output=True, text=True, check=True).stdout
    h, cfg, limit, drv = out.split()
    assert (h, cfg, limit) == ("20", "hfl-cnn-fmnist-table1", "0.02")
    assert Path(drv).resolve().is_relative_to(tmp_path.resolve())


def test_benchmark_json_keys_and_names():
    """The tree keeps the contract new cells go in under
    (``contract.check_contract``: names, the accepted cells, counts of
    cells and chips, configurations used and their cuts stated)."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    contract.check_contract(ROOT)
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "rounds_per_s", "device_ms_per_round", "setup_s"}


# ---------------------------------------------------------- arithmetic

def test_cnn_flops_match_hand_counts():
    # forward 2mnk: conv1 576x15x25, conv2 64x28x375, fc1 448x226,
    # fc2 226x10; backward: the weight gradients (= forward) and the
    # input gradients of conv2, fc1, fc2
    fwd = 2 * (576 * 15 * 25 + 64 * 28 * 375 + 448 * 226 + 226 * 10)
    assert arith.forward_flops(FMNIST) == fwd == 1_983_016
    assert arith.train_flops(FMNIST) == 2 * fwd + 2 * (
        64 * 28 * 375 + 448 * 226 + 226 * 10) == 5_517_048
    # 32x32x3: conv1 784x15x75, conv2 100x28x375, fc1 700x294, fc2 294x10
    fwd = 2 * (784 * 15 * 75 + 100 * 28 * 375 + 700 * 294 + 294 * 10)
    assert arith.forward_flops(CIFAR) == fwd
    assert arith.train_flops(CIFAR) == 2 * fwd + 2 * (
        100 * 28 * 375 + 700 * 294 + 294 * 10) == 11_080_440


def test_round_flops_counts_real_samples_and_the_test_set():
    assert arith.round_flops(FMNIST, 27_500) == (
        25 * 27_500 * 5_517_048 + 2_000 * 1_983_016)


@pytest.mark.parametrize("cfg,P", [(FMNIST, 114_383), (CIFAR, 220_365)])
def test_parameter_counts(cfg, P):
    from hflbench.world import param_shapes
    import math
    assert sum(math.prod(s) for s in param_shapes(cfg).values()) == P \
        == cfg["parameters"]
    assert cfg["model_bits"] == 32 * P


def test_k1_hop_bytes():
    # an edge hop: mask (1,5,50), sizes (1,50), deltas (1,50,P) read once,
    # output (1,5,P) written once, f32
    P = 114_383
    edge = 4 * (5 * 50 + 50 + 50 * P + 5 * P)
    cloud = 4 * (1 * 5 + 5 + 5 * P + 1 * P)
    assert arith.agg_bytes(1, 5, 50, [P]) == edge
    assert arith.round_agg_bytes(1, 5, 50, 5, P) == 5 * edge + cloud
    assert arith.agg_bytes(4, 5, 50, [375, 10_500, 101_248, 2_260]) == \
        4 * (4 * 250 + 4 * 50 + 4 * 5 * P) + 4 * 4 * 50 * P


# ------------------------------------------------------------- imports

def test_nothing_in_the_benchmark_imports_jax_or_the_reference_package():
    for path in PKG.rglob("*.py"):
        tops = {m.split(".")[0] for m in contract.imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_reference_imports_nothing_of_the_program():
    """Neither ``check.py`` nor any ``reference*.py`` or ``ref_*.py``, nor
    what they import of this package, imports the program or JAX."""
    assert contract.references_importing_the_program(PKG) == {}
    seen = contract.reference_closure(PKG)
    assert {PKG / "reference.py", PKG / "ref_ikc.py",
            PKG / "world.py"} <= seen


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "jaxtyping", "reprox"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.hfl", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "repro", "repro.core.hfl"]


def test_the_reference_loads_no_program_module_at_run_time():
    assert contract.program_modules_the_references_load(ROOT) == []


def test_run_refuses_without_a_card(tmp_path):
    """The command exits non-zero and prints no result line on a
    machine without the CUDA devices a cell needs."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "hflbench/run.py", "--workload",
                        "fmnist-round-h50", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_in_a_directory_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "hflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "hflbench/run.py", "--workload",
                        "fmnist-round-h50", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, env={k: v for k, v in os.environ.items()
                                       if k != "PYTHONPATH"})
    assert p.returncode != 0 and p.stdout.strip() == ""
