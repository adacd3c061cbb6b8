"""The port's multi-device layer across processes, on the CPU.

Each group is a set of ``python tests/_torch_multirank_child.py``
processes, one a rank, joined in a gloo group through a ``file://``
store under ``tmp_path`` (the test workers run side by side, so no TCP
port is picked); every child runs one torch thread and imports no JAX
(checked from the module lists they write). Three groups:

* lanes (2 ranks): ``SweepRunner(shard=True)`` over S=3 geo lanes,
  padded to 4 (rank 1 holds lane 2 and a dead lane), host loop and
  fused, with early stop at a target 3 or more test samples from every
  accuracy it gates in the reference's run (18/60: lane 0 stops after
  round 4 of 5, lane 1 after round 5, lane 2 runs on). World:
  ``tests/test_torch_sweep.py``'s (N=12, M=3, L=Q=2, H=6, 30 allocation
  steps) at lane seeds 0-2, from
  the reference's initial weights. The result must equal the port's
  ``shard=False`` run and the reference's ``shard=False`` run (the
  reference's own ``shard=True`` raises on this jax: ROADMAP Queue 3),
  with ``tests/test_torch_sweep.py``'s tolerances: ``iters`` and ``H``
  exact, T_i/E_i rtol 1e-5, ``acc`` within one test sample (1/60).
* steps (4 ranks): each of the dense, MoE, Mamba-2 and hybrid smoke
  configs (f32, 2 microbatches, batch 8 x 16 tokens, the vocabulary set
  to 256 so that, as in every full config, the model axis splits the
  embedding and the logits) through
  ``make_train_step`` (adam, lr 1e-3), ``make_prefill_step`` and 3
  ``make_serve_step`` decode steps on a (2, 2) data x model mesh, and
  ``make_hfl_train_step`` (SGD, lr 0.1, unsynced then synced) on a
  (2, 1, 2) pod x data x model mesh, each against the one-process step
  on the same inputs: loss rtol 1e-5; adam params by the share more
  than 1e-6 apart (<= 1e-3) and a 2·lr cap (adam's first step is a sign
  step, ``tests/test_torch_train.py``); SGD params elementwise within
  1e-6 of each leaf's largest value plus 1e-5 of its largest step (the
  two steps start from the same params, so they differ by lr times the
  gradients' f32 sums taken in another order: at lr 0.01 jamba's
  embedding, ~0.09, moved by up to 0.029 and read 1.2e-7 apart, 1.3e-6
  of its largest; Mamba-2's ``A_log`` starts at zero and holds the step
  alone); logits
  within 1e-5 of max|logits|. After
  the step every parameter's and gradient's local block has the
  ``fit_spec`` shard shape and the parameter's placements. Also: the
  kernel prefill (``impl="kernel"``, its plain version on the CPU) run
  per rank through ``local_map`` on its q-head block, within 1e-5 of
  max|logits| of the plain prefill, including a block that cuts a kv
  group; the kernel's dispatcher refusing DTensors; ``params_struct``,
  ``opt_state_struct`` and ``input_specs`` with a mesh as meta DTensors
  of the rules' placements and shard shapes (chatglm3-6b at full
  config); ``launch.train`` and ``launch.serve_lm`` with
  ``--production-mesh`` on the (2, 2) mesh standing in for the
  production one: the one-device losses (rtol 1e-5) and greedy tokens
  (equal). The mesh
  dispatches MoE tokens in data x pod chunks (the reference's capacity
  is per data shard), so the one-process step gets the same chunks.
* production (1 process): ``make_production_mesh`` on a 256- and a
  512-rank ``fake`` group: shapes, axis names, and a mesh of the other
  size refused.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.cost_model as jcm
import repro.data as jdata
from repro.core import sweep as jsw

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "_torch_multirank_child.py"
N, M, H, S = 12, 3, 6, 3
ROUNDS, TARGET = 5, 18 / 60
FAMILIES = ("chatglm3-6b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
            "jamba-1.5-large-398b")


def _spawn(job: str, world: int, out: Path, timeout: float = 420) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(CHILD), job, str(r), str(world), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    for r in range(world):
        mods = (out / f"imports-{r}.txt").read_text().split()
        assert not [m for m in mods if m == "jax" or m.startswith("jax.")
                    or m == "repro" or m.startswith("repro.")], r


# ------------------------------------------------------------ lanes

@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """(the reference's shard=False run, the children's runs)."""
    out = tmp_path_factory.mktemp("lanes")
    worlds = []
    for seed in range(S):
        sp = jcm.SystemParams(n_devices=N, n_edges=M, L=2, Q=2)
        pop = jcm.sample_population(sp, seed=seed)
        X, y, Xt, yt = jdata.make_dataset("fmnist_syn", n_train=240,
                                          n_test=60, seed=0)
        worlds.append((pop, jdata.partition_noniid(
            X, y, Xt, yt, n_devices=N, size_range=(10, 16), seed=seed)))
    jr = jsw.SweepRunner(sp, worlds, lr=0.02, alloc_steps=30)
    scheds = [jsw.build_scheduler("fedavg", jr.feds[s], sp, H, seed=s)
              for s in range(S)]
    ref = jr.run(scheds, ROUNDS, assign="geo", target_acc=TARGET)
    init = {f"init{s}/{k}": np.asarray(v[s]) for k, v in jr.params0.items()
            for s in range(S)}
    np.savez(out / "ref.npz", target=TARGET, rounds=ROUNDS, **init)
    _spawn("lanes", 2, out)
    return ref, dict(np.load(out / "lanes.npz"))


def test_lane_target_is_clear_of_the_gated_accuracies(lanes):
    ref, _ = lanes
    for s in range(S):
        gated = ref["acc"][s, :ref["iters"][s]]
        assert np.abs(gated - TARGET).min() >= 3 / 60 - 1e-9, gated
    assert ref["iters"].min() < ROUNDS and ref["iters"].max() == ROUNDS


def _assert_lanes_equal(got, want, tag):
    np.testing.assert_array_equal(got[f"{tag}/iters"], want["iters"])
    assert int(got[f"{tag}/H"]) == want["H"]
    assert got[f"{tag}/acc"].shape == np.shape(want["acc"])
    assert np.abs(got[f"{tag}/acc"] - want["acc"]).max() <= 1 / 60 + 1e-6
    for k in ("T_i", "E_i"):
        np.testing.assert_allclose(got[f"{tag}/{k}"], np.asarray(want[k]),
                                   rtol=1e-5, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("engine", ["host", "fused"])
def test_lane_sharded_sweep_matches_unsharded(lanes, engine):
    _, got = lanes
    one = {k.split("/")[1]: v for k, v in got.items()
           if k.startswith(f"{engine}_one/")}
    _assert_lanes_equal(got, one, f"{engine}_shard")


@pytest.mark.parametrize("engine", ["host", "fused"])
def test_lane_sharded_sweep_matches_reference(lanes, engine):
    ref, got = lanes
    _assert_lanes_equal(got, ref, f"{engine}_shard")


# ------------------------------------------------------------ steps

@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("steps")
    _spawn("steps", 4, out)
    return dict(np.load(out / "steps.npz"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_train_step_matches_one_process(steps, arch):
    one, mesh = steps[f"{arch}/loss"]
    np.testing.assert_allclose(mesh, one, rtol=1e-5)
    assert steps[f"{arch}/adam_share"] <= 1e-3
    assert steps[f"{arch}/adam_max"] <= 2 * 1e-3
    assert steps[f"{arch}/local_shapes_ok"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_prefill_and_decode_match_one_process(steps, arch):
    diff, scale = steps[f"{arch}/prefill"]
    assert diff <= 1e-5 * scale
    for diff, scale in steps[f"{arch}/decode"]:
        assert diff <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "uneven"])
def test_mesh_kernel_prefill_runs_per_rank(steps, arch):
    """impl="kernel" under a mesh: each rank's q-head block and the kv
    heads it reads (``uneven``: 6 q heads over 3 kv heads, blocks of 3
    that cut a kv group)."""
    key = "uneven_kernel" if arch == "uneven" else f"{arch}/prefill_kernel"
    diff, scale = steps[key]
    assert diff <= 1e-5 * scale
    assert steps["kernel_refuses_dtensor"]


def test_mesh_structs_carry_placements(steps):
    assert steps["structs_ok"]


def test_clis_with_the_production_mesh_flag(steps):
    """``launch.train`` / ``launch.serve_lm --production-mesh`` on the
    (2, 2) mesh standing in for the production one: the losses of the
    one-device run (rtol 1e-5) and its greedy tokens."""
    one, mesh = steps["cli_train"]
    np.testing.assert_allclose(mesh, one, rtol=1e-5)
    assert steps["cli_serve_equal"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_hfl_step_matches_one_process(steps, arch):
    for sync in (False, True):
        assert steps[f"{arch}/hfl_{sync}"] <= 0, sync


# ------------------------------------------------------- production mesh

def test_production_mesh_on_fake_groups(tmp_path):
    _spawn("production", 1, tmp_path, timeout=120)
    got = np.load(tmp_path / "production.npz")
    assert tuple(got["256/shape"]) == (16, 16)
    assert tuple(got["256/names"]) == ("data", "model")
    assert tuple(got["512/shape"]) == (2, 16, 16)
    assert tuple(got["512/names"]) == ("pod", "data", "model")
    assert got["256/wrong_size_raised"] and got["512/wrong_size_raised"]
