"""The contract under which a configuration, a traffic mix, a cell or a
metric goes into the benchmark, as checks on a checkout's
``BENCHMARK.json`` and ``hflbench/`` files. The benchmark's tests run
them on the tree and on copies into which they drop new files; each
raises ``AssertionError`` naming what breaks the contract.
"""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Set

# cells a later PR may add to but never take away
ACCEPTED = {"fmnist-round-h50", "cifar-round-h50", "fmnist-sweep-s4",
            "fmnist-round-h30"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MAX_CELLS = 24
# top-level module names the plain reference may not import or load
PROGRAM = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _unique(names: List[str], what: str) -> None:
    dup = sorted({n for n in names if names.count(n) > 1})
    assert not dup, f"{what} named twice: {dup}"


def check_contract(root: Path) -> None:
    """``root``'s benchmark keeps the contract: valid and unique names,
    the accepted cells, at most 24 cells of which at most a quarter
    (and at least one may) ask for 4 chips, every configuration used and
    its cuts stated, every cell's and metric's files in place, each
    cell reporting ``setup_s``, another end-to-end metric and a
    per-layer one (and no host-clock rate beside a metric of the device
    trace), and each per-layer metric moving an end-to-end one that its
    cells report."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pkg = root / "hflbench"
    cells = bench["workloads"]
    names = [w["name"] for w in cells]
    configs = {c["name"]: c for c in bench["configs"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    _unique(names, "cells")
    _unique([c["name"] for c in bench["configs"]], "configurations")
    _unique([m["name"] for m in metrics], "metrics")
    bad = [n for n in names + list(configs) + [m["name"] for m in metrics]
           + [w["traffic"] for w in cells]
           + [k for c in configs.values() for k in c["reduced"]]
           if not NAME.match(n)]
    assert not bad, f"names outside {NAME.pattern}: {bad}"
    missing = sorted(ACCEPTED - set(names))
    assert not missing, f"accepted cells missing: {missing}"
    assert len(cells) <= MAX_CELLS, f"{len(cells)} cells, over {MAX_CELLS}"
    assert {w["chips"] for w in cells} <= {1, 4}
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4), f"{four} cells ask for 4 chips"
    unused = sorted(set(configs) - {w["config"] for w in cells})
    assert not unused, f"configurations no cell names: {unused}"
    for w in cells:
        assert w["config"] in configs, w
        traffic = json.loads(
            (pkg / "traffic" / f"{w['traffic']}.json").read_text())
        assert (pkg / "drivers" / f"{traffic['driver']}.py").is_file(), w
        _check_limits(pkg / "limits" / f"{w['name']}.json")
    for c in configs.values():
        _check_cuts(root, c)
    ends = {m["name"]: m for m in bench["end_to_end"]}
    for m in metrics:
        assert (pkg / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", names)) <= set(names), m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in ends and m["layer"].strip(), m["name"]
        lost = sorted(set(m.get("workloads", names))
                      - set(ends[m["moves"]].get("workloads", names)))
        assert not lost, f"{m['name']} moves {m['moves']}, which cells " \
            f"{lost} do not report"
    for w in names:
        own = {m["name"] for m in bench["end_to_end"]
               if w in m.get("workloads", names)}
        assert "setup_s" in own and len(own) >= 2, \
            f"{w} reports the end-to-end metrics {sorted(own)}"
        assert any(w in m.get("workloads", names)
                   for m in bench["per_layer"]), f"{w}: no per-layer metric"
        # such a cell records the device trace in every run (run.py), so
        # a rate on the host's clock would be read under the profiler
        if any(ends[n]["source"] == "device_trace" for n in own):
            host = sorted(n for n in own if n != "setup_s"
                          and ends[n]["source"] == "host_clock")
            assert not host, f"{w} reads {host} in a profiled window"


def _check_cuts(root: Path, entry: Dict) -> None:
    """Every key in ``reduced`` is one of the configuration file's, and
    the file states beside them the ``published`` value of each and the
    ``deployment`` the cut stands for (model-configs guide, section 4)."""
    cfg = json.loads((root / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    cut = entry["reduced"]
    if not cut:
        return
    absent = [k for k in cut if k not in cfg]
    assert not absent, f"{entry['name']}: reduced names no key {absent}"
    published = cfg.get("published")
    assert isinstance(published, dict) and set(published) == set(cut), \
        f"{entry['name']}: published {published!r} is not one value for " \
        f"each key in reduced {cut}"
    deployment = cfg.get("deployment")
    assert isinstance(deployment, str) and deployment.strip(), \
        f"{entry['name']}: no deployment beside its cuts"


def _check_limits(path: Path) -> None:
    """Each number compared has its limit between the readings it was
    set from (or is exact: limit and lower reading 0), and says what
    gave the upper one."""
    rows = json.loads(path.read_text())
    assert rows, path
    for name, r in rows.items():
        assert {"lower", "limit", "upper", "upper_from"} <= set(r), \
            f"{path.name}: {name}"
        assert r["lower"] <= r["limit"] < r["upper"] or \
            r["limit"] == r["lower"] == 0 < r["upper"], f"{path.name}: {name}"


# ------------------------------------------------------------- imports

def imports(path: Path) -> Set[str]:
    """Names of the modules a file imports (a relative import counted as
    this package)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("hflbench" if node.level else node.module)
    return out


def internal(path: Path, pkg: Path) -> Set[Path]:
    """The files of the package at ``pkg`` that ``path`` imports."""
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "hflbench":
            mods.add(node.module)
            mods |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Import):
            mods |= {a.name for a in node.names
                     if a.name.split(".")[0] == "hflbench"}
    files = set()
    for m in mods:
        parts = m.split(".")[1:]
        if not parts:
            continue
        rel = Path(*parts)
        for cand in (pkg / rel.with_suffix(".py"), pkg / rel / "__init__.py"):
            if cand.is_file():
                files.add(cand)
    return files


def reference_files(pkg: Path) -> List[Path]:
    """``check.py`` and every plain reference, found by its file name
    (``reference*.py``, ``ref_*.py``) anywhere under ``pkg``."""
    refs = {pkg / "check.py"}
    for pattern in ("reference*.py", "ref_*.py"):
        refs |= set(pkg.rglob(pattern))
    return sorted(refs)


def reference_closure(pkg: Path) -> Set[Path]:
    """The references and every file of the package they import."""
    todo, seen = reference_files(pkg), set()
    while todo:
        path = todo.pop()
        if path not in seen:
            seen.add(path)
            todo += list(internal(path, pkg))
    return seen


def references_importing_the_program(pkg: Path) -> Dict[Path, Set[str]]:
    """The files of ``reference_closure`` that import the program or JAX,
    each with the top-level names it imports of them."""
    tops = {p: {m.split(".")[0] for m in imports(p)} & PROGRAM
            for p in reference_closure(pkg)}
    return {p: t for p, t in tops.items() if t}


def program_modules_the_references_load(root: Path) -> List[str]:
    """The modules of the program or JAX loaded, in a fresh process
    whose path holds ``root`` and the program's source, once every
    reference under ``root/hflbench`` has been imported."""
    pkg = root / "hflbench"
    mods = [".".join(p.relative_to(root).with_suffix("").parts)
            for p in reference_files(pkg)]
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in mods)
            + "print(json.dumps(sorted(m for m in sys.modules if "
            f"m.split('.')[0] in {sorted(PROGRAM)!r})))")
    src = Path(__file__).resolve().parents[2] / "src"
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, check=True,
        env={**os.environ, "PYTHONPATH": os.pathsep.join([str(root),
                                                          str(src)])})
    return json.loads(out.stdout.strip().splitlines()[-1])
