"""The PyTorch port's examples (``examples/*_torch.py``) on the CPU.

Each example's ``main(argv)`` runs in process with ``--device cpu`` at
its smoke settings (``train_hfl_e2e_torch`` at ``--rounds 1 --episodes
2 --H 6``, ``assignment_demo_torch`` at ``--H 6``) and its summary is
checked for shape and range; on the CPU the kernel routes the examples
ask for (``agg_kernel=True``, ``use_kernel=True``) take the kernels'
plain versions. The two examples that train the CNN through
``HFLFramework`` (quickstart, train_hfl_e2e) run with L = Q = 2 local
and edge iterations in place of Table I's 5 (their ``SystemParams``
patched), as the CPU parity tests do, to keep the file near a minute.
One clean interpreter imports the examples one after another; none may
add ``jax*`` or ``repro``/``repro.*`` to ``sys.modules``.

``assignment_demo_torch``'s geo assignment equals the reference's
``GeoAssigner`` on the same population (bitwise: numpy on both sides)
and its objective the reference's ``total_objective`` within rtol 1e-4,
``tests/test_torch_hfel.py``'s tolerance for ``total_objective`` (f32
allocator steps summed in another order).
"""
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.cost_model as jcm
from repro.core.assignment import GeoAssigner as JGeo
from repro.core.assignment.hfel import total_objective as j_total
from repro.drl.train import make_training_population as j_population
from repro_torch.core.cost_model import SystemParams
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart_torch", "assignment_demo_torch",
            "train_hfl_e2e_torch", "serve_demo_torch",
            "model_zoo_launcher_torch", "train_lm_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def imported():
    """{example: modules of jax / repro its import added}, from one clean
    interpreter importing the examples in turn."""
    code = f"""
import importlib.util, json, sys
def bad():
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m.startswith("jaxlib") or m == "repro"
                  or m.startswith("repro."))
out = {{}}
for name in {list(EXAMPLES)!r}:
    spec = importlib.util.spec_from_file_location(
        name, {str(ROOT / "examples")!r} + "/" + name + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out[name] = bad() if callable(mod.main) else ["no main"]
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax(imported, name):
    assert imported[name] == [], imported[name]


def _short_rounds(monkeypatch, mod):
    monkeypatch.setattr(mod, "SystemParams",
                        functools.partial(SystemParams, L=2, Q=2))


def test_quickstart_smoke(monkeypatch):
    mod = _load("quickstart_torch")
    _short_rounds(monkeypatch, mod)
    s = mod.main(["--smoke", "--device", "cpu"])
    assert s["iters"] == 2 and len(s["history"]) == 2
    assert 0.0 <= s["final_acc"] <= 1.0
    assert np.isfinite(s["objective"]) and s["objective"] > 0
    assert 0 < s["clustering"]["aux_bits"] and (s["K"], s["Q"]) == (4, 2)


def test_assignment_demo_matches_reference():
    H = 6
    out = _load("assignment_demo_torch").main(["--H", str(H), "--device",
                                               "cpu"])
    assert set(out) == {"geo", "hfel-100", "hfel-300"}
    sp = jcm.SystemParams(n_edges=5, lam=1.0)
    pop = j_population(sp, H, seed=7)
    sched = np.arange(H)
    a, _ = JGeo(sp).assign(pop, sched, np.random.default_rng(0))
    a = np.asarray(a)
    obj, _, _ = j_total(sp, pop, sched, a, alloc_steps=120)
    assert np.array_equal(out["geo"]["assign"], a)
    np.testing.assert_allclose(out["geo"]["obj"], float(obj), rtol=1e-4)
    for name in ("hfel-100", "hfel-300"):
        r = out[name]
        assert r["assign"].shape == (H,) and r["assign"].max() < sp.n_edges
        # HFEL starts from the best-gain assignment and only accepts moves
        # that lower J: it ends at most at geo's objective here
        assert r["obj"] <= out["geo"]["obj"] * (1 + 1e-6)


def test_train_hfl_e2e_smoke(monkeypatch):
    mod = _load("train_hfl_e2e_torch")
    _short_rounds(monkeypatch, mod)
    out = mod.main(
        ["--rounds", "1", "--episodes", "2", "--H", "6", "--device", "cpu"])
    res = out["results"]
    assert set(res) == {"proposed(IKC+D3QN)", "baseline(FedAvg+geo)"}
    for s in res.values():
        assert s["iters"] == 1 and 0.0 <= s["final_acc"] <= 1.0
        assert np.isfinite(s["objective"]) and s["objective"] > 0
    assert isinstance(out["reproduced"], bool)


def test_model_zoo_launcher_smoke(tmp_path):
    mod = _load("model_zoo_launcher_torch")
    out = tmp_path / "runs.jsonl"
    recs = mod.main(["--smoke", "--device", "cpu", "--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["run_name"] for r in recs] == [r["run_name"] for r in lines]
    assert len(recs) == 4 and all(r["device"] == "cpu" for r in lines)
    assert all(r["n_dispatches"] == 1 and r["n_leaves"] > 0 for r in recs)
    assert mod.main(["--smoke", "--dryrun", "--out", str(out)]) is None
    with pytest.raises(AssertionError, match="unknown config key"):
        mod.update_config_fields(mod.BASE_CONFIG, {"lr_typo": 1})


def test_serve_demo_smoke():
    ran = _load("serve_demo_torch").main(["--smoke", "--device", "cpu"])
    assert len(ran) == 1 and ran[0][-2:] == ["--device", "cpu"]
