"""The streaming serve CLI and checkpoints: ``repro_torch.launch.serve``
and ``repro_torch.checkpoint.ckpt`` against ``repro``.

``run_serve`` runs at ``tests/test_launch_cli.py``'s smoke settings in
both packages, the port from the reference's initial weights (and, for
the stationary preset, the reference's trace, drawn by ``jax.random``
there). The JSON lines are held as ``tests/test_torch_async_engine.py``
holds a round's record (accounting exact, times and energies to rtol
1e-5, accuracy within one test sample), the checkpointed params to atol
1e-6. Checkpoints are bitwise: a tree written by either package
restores in the other leaf for leaf, and the manifests are equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import cost_model as jcm
from repro.core.async_engine import AsyncConfig as JConfig
from repro.core.async_engine import AsyncHFLEngine as JEngine
from repro.launch import serve as jserve
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.launch import serve as tserve
from test_torch_async_engine import _assert_record
from test_torch_async_trace import STATIONARY, port_trace
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

SMOKE = dict(n_devices=10, n_edges=3, H=6, n_train=300, n_test=120,
             alloc_steps=40, L=2, Q=3, seed=0)


def _reference_init():
    """The reference engine's initial weights at the smoke settings."""
    sp, pop, fed = jserve.build_world(10, 3, 300, 120, 0, L=2, Q=3)
    eng = JEngine(sp, pop, fed, JConfig(H=6, seed=0))
    return {k: np.asarray(v) for k, v in eng.model_params.items()}


def _serve_both(tmp_path, **kw):
    jl, tl = [], []
    js = jserve.run_serve(ckpt_dir=str(tmp_path / "j"),
                          out_json=str(tmp_path / "j.json"), log=jl.append,
                          **SMOKE, **kw)
    engines = []
    ts = tserve.run_serve(ckpt_dir=str(tmp_path / "t"),
                          out_json=str(tmp_path / "t.json"), log=tl.append,
                          device="cpu", init_params=_reference_init(),
                          engine_out=engines, **SMOKE, **kw)
    return js, ts, jl, tl, engines[0]


def test_run_serve_matches_reference(tmp_path):
    """4 always-on rounds, eval every 2, checkpoint every 2."""
    js, ts, jl, tl, eng = _serve_both(tmp_path, rounds=4, eval_every=2,
                                      ckpt_every=2)
    assert len(tl) == len(jl) == 4
    recs = [json.loads(line) for line in tl]
    for rt, rj in zip(recs, map(json.loads, jl)):
        _assert_record(rt, rj)
    assert [r["acc"] is not None for r in recs] == [False, True, False, True]
    for k in ("rounds", "n_updates", "n_stale", "n_aborted",
              "n_checkpoints", "traffic"):
        assert ts[k] == js[k], k
    for k in ("t_virtual", "T", "E", "objective", "wasted_j"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)
    assert abs(ts["final_acc"] - js["final_acc"]) <= 1 / 120 + 1e-12
    saved = json.loads((tmp_path / "t.json").read_text())
    assert saved["rounds"] == 4 and saved["final_acc"] == recs[-1]["acc"]
    assert saved.keys() == json.loads((tmp_path / "j.json").read_text()).keys()

    assert (sorted(os.listdir(tmp_path / "t"))
            == sorted(os.listdir(tmp_path / "j"))
            == ["step_00000002", "step_00000004"])
    assert tckpt.latest_step(str(tmp_path / "t")) == 4
    for step in (2, 4):
        d = f"step_{step:08d}"
        man = [json.loads((tmp_path / p / d / "manifest.json").read_text())
               for p in ("t", "j")]
        assert man[0] == man[1]
    got = tckpt.restore_pytree(eng.model_params, str(tmp_path / "t"))
    want = tckpt.restore_pytree(eng.model_params, str(tmp_path / "j"))
    for k, v in eng.model_params.items():
        np.testing.assert_array_equal(got[k], v.numpy())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_run_serve_stationary_matches_reference(tmp_path):
    """Two rounds under the stationary preset (the reference's trace,
    which the port reproduces from the reference's draws), with 2-slot
    buffers and the int8 codec off."""
    j_trace = jserve.build_trace("stationary", 10, seed=0)
    t_trace = port_trace(jcm.AvailabilityParams(**STATIONARY), 10, 0)
    np.testing.assert_array_equal(t_trace.toggles, j_trace.toggles)
    jl, tl = [], []
    jserve.run_serve(rounds=2, traffic="stationary", buffer_size=2,
                     log=jl.append, **SMOKE)
    tserve.run_serve(rounds=2, traffic="stationary", buffer_size=2,
                     log=tl.append, device="cpu", trace=t_trace,
                     init_params=_reference_init(), **SMOKE)
    for rt, rj in zip(map(json.loads, tl), map(json.loads, jl)):
        _assert_record(rt, rj)
    assert len(tl) == 2


def _ref_tree():
    """``tests/test_checkpoint.py``'s tree: nested dicts and lists, f32,
    bf16 and int leaves and a scalar."""
    return {"a": jnp.arange(6).reshape(2, 3).astype(jnp.float32),
            "b": {"c": jnp.ones((4,), jnp.bfloat16),
                  "d": [jnp.zeros(2), jnp.full((1,), 7)]},
            "step": jnp.int32(17)}


def _port_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "d": [torch.zeros(2), torch.full((1,), 7,
                                                   dtype=torch.int32)]},
            "step": torch.tensor(17, dtype=torch.int32)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.ndim else np.atleast_1d(a).view(np.uint8)


def test_checkpoints_interchange_bitwise(tmp_path):
    """A port checkpoint restores in the reference and a reference
    checkpoint in the port, every leaf's bytes equal (bfloat16 as the raw
    2-byte words both packages write); the manifests are equal."""
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_pytree(_ref_tree(), jd, step=3)
    tckpt.save_pytree(_port_tree(), td, step=3)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 7)).astype(np.float32)
    jckpt.save_pytree({"w": jnp.asarray(w), "v": [jnp.asarray(w[0])]}, jd,
                      step=12)
    tckpt.save_pytree({"w": torch.from_numpy(w),
                       "v": [torch.from_numpy(w[0])]}, td, step=12)
    for d in (jd, td):
        assert jckpt.latest_step(d) == tckpt.latest_step(d) == 12
    man = [json.loads(open(os.path.join(d, "step_00000003",
                                        "manifest.json")).read())
           for d in (jd, td)]
    assert man[0] == man[1]

    from_ref = tckpt.restore_pytree(_port_tree(), jd, step=3)
    from_port = jckpt.restore_pytree(_ref_tree(), td, step=3)
    own = tckpt.restore_pytree(_port_tree(), td, step=3)
    for a, b, c in zip(jax.tree.leaves(from_ref), jax.tree.leaves(from_port),
                       jax.tree.leaves(own)):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))
    assert int(from_ref["step"]) == 17
    latest = tckpt.restore_pytree({"w": 0, "v": [0]}, jd)
    np.testing.assert_array_equal(latest["w"], w)
    np.testing.assert_array_equal(latest["v"][0], w[0])
    assert tckpt.latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_pytree({"w": 0}, str(tmp_path / "nope"))


def test_main_smoke_on_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(line) for line in lines[:-1]]
    assert [r["round"] for r in recs] == [1, 2, 3]
    assert all(r["H"] == 6 and r["acc"] is not None for r in recs)
    assert lines[-1].startswith("served 3 rounds")


def test_main_needs_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--smoke"])
