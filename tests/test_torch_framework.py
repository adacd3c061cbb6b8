"""The slice as a whole: ``repro_torch.HFLFramework`` against
``repro.HFLFramework`` over two Algorithm-6 rounds (fused engine, and
the ``engine="sequential"`` oracle), plus the port's package rules (no
JAX and no ``repro`` import, no silent CPU fallback). Compressed rounds
are in ``tests/test_torch_compression.py``.

The port starts from the reference's initial weights and Algorithm-2
labels (injected: torch cannot replay ``jax.random``) and builds its own
world from the same seeds. Scheduling and geo assignment are numpy on
both sides, so cohorts and assignments must be identical. Measured on
this world: T_i/E_i agree to 2.4e-7 relative and the final params to
9e-8 absolute (weights of order 0.1, after 2 rounds of Q*L = 25 GD
steps), so T_i/E_i are held to rtol 1e-5 and params to rtol 1e-5 /
atol 1e-6; accuracy to one test sample (an f32 near-tie may flip one
argmax). The sequential engine is held to the same tolerances.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.data as jdata
from repro.core.framework import FrameworkConfig as JConfig
from repro.core.framework import HFLFramework as JFramework
from repro.configs.registry import get_config as j_get_config
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
from repro_torch.configs.registry import get_config as t_get_config
from repro_torch.configs.registry import get_hfl_spec
from repro_torch.configs.registry import get_smoke_config as t_get_smoke_config
from repro_torch.convert import params_to_numpy
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.framework import FrameworkConfig as TConfig
from repro_torch.core.framework import HFLFramework as TFramework

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, H, K = 12, 3, 6, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: the suite runs several
    processes at once, and PyTorch's default of one thread per core in
    each of them oversubscribes the cores (these rounds ran 10-30x
    slower than alone). Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(cm, data):
    sp = cm.SystemParams(n_devices=N, n_edges=M)
    pop = (cm.sample_population(sp, seed=0) if cm is jcm
           else cm.sample_population(sp, seed=0, device="cpu"))
    X, y, Xt, yt = data.make_dataset("fmnist_syn", n_train=500, n_test=120,
                                     seed=0)
    fed = data.partition_noniid(X, y, Xt, yt, n_devices=N,
                                size_range=(10, 20), seed=0)
    return sp, pop, fed


def _record_calls(obj, name, log):
    real = getattr(obj, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        log.append(np.array(out[0] if isinstance(out, tuple) else out))
        return out
    setattr(obj, name, spy)


def _two_rounds_match_reference(jcfg, tcfg, prepare=None, drl_params=None,
                                param_atol=1e-6):
    """Two rounds of both frameworks on the same world; ``prepare`` is
    applied to each framework before its rounds; ``drl_params`` (the
    reference's D3QN params) go to both as numpy arrays. Final params
    are held to rtol 1e-5 and ``param_atol``."""
    jf = JFramework(*_world(jcm, jdata), jcfg, drl_params=drl_params)
    labels = np.asarray(jf.scheduler.state.clusters)
    init = {k: np.asarray(v) for k, v in jf.model_params.items()}
    tf = TFramework(*_world(tcm, tdata), tcfg, init_params=init,
                    labels=labels, drl_params=None if drl_params is None
                    else jax.tree.map(np.asarray, drl_params))
    for fw in (jf, tf) if prepare else ():
        prepare(fw)
    assert tf.clustering_stats["ari"] == jf.clustering_stats["ari"]
    assert tf.clustering_stats["aux_bits"] == jf.clustering_stats["aux_bits"]
    for k in ("delay_s", "energy_j"):
        np.testing.assert_allclose(tf.clustering_stats[k],
                                   jf.clustering_stats[k], rtol=1e-6)
    assert tf.model_bits == jf.model_bits

    logs = {}
    for name, fw in (("j", jf), ("t", tf)):
        logs[name] = ([], [])
        _record_calls(fw.scheduler, "schedule", logs[name][0])
        _record_calls(fw.assigner, "assign", logs[name][1])
    n_test = len(jf.fed.y_test)
    for i in (1, 2):
        rj, rt = jf.run_round(i), tf.run_round(i)
        np.testing.assert_array_equal(logs["t"][0][-1], logs["j"][0][-1])
        np.testing.assert_array_equal(logs["t"][1][-1], logs["j"][1][-1])
        assert abs(rt["acc"] - rj["acc"]) <= 1.0 / n_test + 1e-12
        for k in ("T_i", "E_i", "obj_i"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5, err_msg=k)
        for k in ("msg_bits", "uplink_bytes", "H", "codec"):
            assert rt[k] == rj[k], k
        assert set(rt["seconds"]) == {"schedule", "assign", "allocate",
                                      "train", "aggregate", "eval"}
    final = params_to_numpy(tf.model_params)
    for k, v in jf.model_params.items():
        np.testing.assert_allclose(final[k], np.asarray(v), rtol=1e-5,
                                   atol=param_atol, err_msg=k)
    st, sj = tf.summary(), jf.summary()
    assert st["iters"] == sj["iters"] == 2
    np.testing.assert_allclose(st["objective"], sj["objective"], rtol=1e-5)


_KW = dict(H=H, K=K, alloc_steps=30, scheduler="ikc", assigner="geo", seed=0)


@pytest.mark.parametrize("agg_kernel", [False, True])
def test_two_rounds_match_reference(agg_kernel):
    _two_rounds_match_reference(
        JConfig(agg_kernel=True, **_KW),
        TConfig(agg_kernel=agg_kernel, device="cpu", **_KW))


def test_sequential_engine_matches_reference():
    """M per-edge allocations, ``round_cost`` and Algorithm 1 with the
    plain aggregation, on both sides."""
    _two_rounds_match_reference(
        JConfig(engine="sequential", **_KW),
        TConfig(engine="sequential", device="cpu", **_KW))


def test_compression_needs_the_fused_engine():
    with pytest.raises(ValueError, match="fused"):
        TConfig(device="cpu", engine="sequential",
                compression=CompressionConfig(codec="int8"))
    assert TConfig(device="cpu", engine="sequential").engine == "sequential"
    for field in ("engine", "assigner"):
        with pytest.raises(ValueError, match=f"unknown {field}"):
            TConfig(device="cpu", **{field: "no-such"})


def test_framework_runs_own_clustering_on_cpu():
    """No injection: the port draws its own init, crops and seeding."""
    cfg = TConfig(H=H, K=K, alloc_steps=5, max_iters=1, device="cpu",
                  use_kernel=True, agg_kernel=True)
    fw = TFramework(*_world(tcm, tdata), cfg)
    assert fw.setup_seconds["cluster"] > 0
    assert sorted(set(fw.scheduler.state.clusters.tolist())) == [0, 1, 2]
    out = fw.run(verbose=False)
    assert out["iters"] == 1 and np.isfinite(out["objective"])


def test_config_needs_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TConfig()
    assert TConfig(device="cpu").device == "cpu"


@pytest.mark.parametrize("field,value,match", [
    ("assigner", "nearest", "unknown assigner"),
    ("hfel_search", "magic", "unknown hfel_search")])
def test_unknown_options_raise(field, value, match):
    with pytest.raises(ValueError, match=match):
        TConfig(device="cpu", **{field: value})


def test_drl_assigner_needs_params():
    cfg = TConfig(H=H, K=K, assigner="drl", device="cpu")
    with pytest.raises(ValueError, match="drl_params"):
        TFramework(*_world(tcm, tdata), cfg, labels=np.arange(N) % K)


def test_registry():
    assert (dataclasses.asdict(t_get_config("hfl-cnn"))
            == dataclasses.asdict(j_get_config("hfl-cnn")))
    assert t_get_smoke_config("hfl-cnn") == t_get_config("hfl-cnn")
    assert get_hfl_spec("hfl-cnn") is get_hfl_spec("hfl-cnn")
    spec = get_hfl_spec("mamba2-2.7b")      # a sequence payload
    assert spec is get_hfl_spec("mamba2-2.7b") and spec.family == "ssm"
    with pytest.raises(KeyError):
        get_hfl_spec("no-such-arch")


def test_port_imports_neither_jax_nor_repro():
    """A clean interpreter imports every repro_torch module; no jax* and
    no repro / repro.* module may appear in sys.modules."""
    code = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
assert len(names) >= 20, names
assert {"repro_torch.core.sweep", "repro_torch.core.assignment.hfel",
        "repro_torch.core.scheduling.schedulers",
        "repro_torch.core.async_engine", "repro_torch.core.traffic",
        "repro_torch.checkpoint.ckpt", "repro_torch.launch.serve",
        "repro_torch.data.pipeline", "repro_torch.launch.train",
        "repro_torch.launch.mesh", "repro_torch.parallel.sharding",
        "repro_torch.parallel.sharder",
        "repro_torch.launch.dryrun"} <= set(names), names
import repro_torch.core.sweep as sweep
assert sweep.SweepRunner is repro_torch.SweepRunner
import repro_torch.core.async_engine as ae
assert ae.AsyncHFLEngine is repro_torch.AsyncHFLEngine
assert repro_torch.run_serve.__module__ == "repro_torch.launch.serve"
assert not bad, bad
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok")
