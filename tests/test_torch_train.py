"""The port's LM training path against ``repro.launch.steps`` on the CPU.

Both packages get the same batches (numpy, from a seed) and the same
weights (``repro``'s ``init``, carried across through
``repro_torch.convert``), at each family's smoke config (f32), batch 4,
sequence 16. The reference's steps are jitted on a one-device mesh whose
axes are ``Auto``: on jax 0.9, ``make_debug_mesh()`` makes ``Explicit``
axes, which the reference's ``with_sharding_constraint`` refuses (the
mesh is otherwise the same). Tolerances:

* losses, step by step: rtol 1e-5 (measured at most 4e-7);
* adam after its first step: the first moment ``m = (1-b1)·g`` (the
  accumulated mean gradient) atol 2e-6 and the second moment atol 1e-7
  (measured 8.1e-7 and 2.5e-8: f32 sums in another order). The params
  themselves are not held elementwise: adam's first step is a sign step
  (``m̂/√v̂ = ±1`` wherever |g| ≫ eps), so an element whose gradient is
  near zero moves a full ``lr`` in either direction on ulp-level noise.
  At most 1e-3 of the elements may differ by more than 1e-6 (measured
  at most 1.2e-4), and none by more than 2·lr (measured 0.52·lr);
* adafactor (``BIG_MODEL_PARAMS`` patched to 0 in both modules, in
  memory): its update is continuous in the gradient, so params atol 1e-5
  after two steps and the moments rtol 1e-4 (measured 1.2e-7 and
  1.2e-5);
* the two-tier HFL step (plain SGD, lr 0.1, so a gradient error shows in
  the params, which move by up to 0.42): atol 1e-5 after each step
  (measured 6.6e-7);
* within the port: mb=1 against mb=2 mean gradients atol 1e-6 (families
  without MoE: an MoE layer's capacity and aux loss are per forward, so
  its gradient depends on the microbatch split in both packages); remat
  on against off, equal (the recompute runs the same ops on the same
  inputs).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint import restore_pytree as j_restore
from repro.configs import registry as jreg
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.checkpoint import latest_step, restore_pytree
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as TS
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as TT
from repro_torch.utils import tree_leaves
from test_torch_framework import one_torch_thread  # noqa: F401

FAMILIES = {"dense": "chatglm3-6b", "vlm": "internvl2-26b",
            "audio": "musicgen-medium", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-2.7b", "hybrid": "jamba-1.5-large-398b"}
LR = 1e-3
B, S = 4, 16


def _mesh(pods=False):
    shape, axes = ((1, 1, 1), ("pod", "data", "model")) if pods else \
        ((1, 1), ("data", "model"))
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(shape))


def _cfgs(arch, **changes):
    return (dataclasses.replace(jreg.get_smoke_config(arch), **changes),
            dataclasses.replace(treg.get_smoke_config(arch), **changes))


def _both(cfg, seed=0):
    jp = JT.init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    books = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    b = {k: rng.integers(0, cfg.vocab_size, (*lead, S, *books)
                         ).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.n_prefix_embeds:
        b["prefix_embeds"] = rng.standard_normal(
            (*lead, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pairs(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    return [(np.asarray(a), b.detach().numpy()) for a, b in zip(jl, tl)]


def _close(jtree, ttree, atol, rtol=0.0):
    for want, got in _pairs(jtree, ttree):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_make_optimizer_matches_reference(arch):
    jopt = JS.make_optimizer(jreg.get_config(arch))
    topt = TS.make_optimizer(treg.get_config(arch))
    p = {"b": np.zeros(4, np.float32), "w": np.zeros((8, 4), np.float32)}
    jst = jopt.init(jax.tree.map(jnp.asarray, p))
    tst = topt.init(params_from_numpy(p, "cpu"))
    assert jax.tree.structure(jst) == jax.tree.structure(tst)
    for want, got in zip(jax.tree.leaves(jst), tree_leaves(tst)):
        assert np.shape(want) == tuple(np.shape(got))
    big = treg.get_config(arch).param_count() > TS.BIG_MODEL_PARAMS
    assert ("mom" in tst) == big and ("m" in tst) != big


# ----------------------------------------------------------- train step

def _run_steps(jc, tc, n_steps, lr=LR):
    """(reference (params, state, losses), port's) after n_steps."""
    mesh = _mesh()
    jp, tp = _both(jc)
    with mesh:
        jstep, jopt = JS.make_train_step(jc, mesh, lr=lr)
        jstep = jax.jit(jstep)
        jst = jopt.init(jp)
    tstep, topt = TS.make_train_step(tc, lr=lr)
    tst = topt.init(tp)
    jl, tl = [], []
    for s in range(n_steps):
        b = _batch(jc, seed=s)
        with mesh:
            jp, jst, jm = jstep(jp, jst, _j(b))
        tp, tst, tm = tstep(tp, tst, _t(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if s == 0:
            first = (jst, tst)
    return (jp, jst, jl), (tp, tst, tl), first


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_step_matches_reference(family):
    jc, tc = _cfgs(FAMILIES[family], microbatches=2)
    assert tc.family == family and tc.dtype == "float32" and tc.remat
    (jp, _, jl), (tp, tst, tl), (jst1, tst1) = _run_steps(jc, tc, 2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(jst1["m"], tst1["m"], atol=2e-6)
    _close(jst1["v"], tst1["v"], atol=1e-7)
    assert tst["step"] == 2
    diff = np.concatenate([np.abs(got - want).ravel()
                           for want, got in _pairs(jp, tp)])
    assert (diff > 1e-6).mean() <= 1e-3, (diff > 1e-6).mean()
    assert diff.max() <= 2 * LR, diff.max()


def test_adafactor_step_matches_reference(monkeypatch):
    monkeypatch.setattr(JS, "BIG_MODEL_PARAMS", 0)
    monkeypatch.setattr(TS, "BIG_MODEL_PARAMS", 0)
    jc, tc = _cfgs("chatglm3-6b", microbatches=2)
    (jp, jst, jl), (tp, tst, tl), _ = _run_steps(jc, tc, 2)
    assert "mom" in tst and tst["step"] == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(jp, tp, atol=1e-5)
    _close(jst["mom"], tst["mom"], atol=0, rtol=1e-4)


def test_hfl_train_step_matches_reference():
    """Two pods with their own replicas: after a step without the cloud
    sync they differ, after one with it they are equal to each other and
    to the mean of that step's unsynced results."""
    lr, pods = 0.1, 2
    jc, tc = _cfgs("chatglm3-6b", microbatches=2)
    jp0, _ = _both(jc, seed=0)
    jp1, _ = _both(jc, seed=1)
    jpp = jax.tree.map(lambda a, b: jnp.stack([a, b]), jp0, jp1)
    tpp = params_from_numpy(jax.tree.map(np.asarray, jpp), "cpu")
    mesh = _mesh(pods=True)
    with mesh:
        jstep = jax.jit(JS.make_hfl_train_step(jc, mesh, lr=lr))
    tstep = TS.make_hfl_train_step(tc, lr=lr)
    for s, sync in enumerate((False, True)):
        b = _batch(jc, seed=s, lead=(pods, B // pods))
        with mesh:
            jpp = jstep(jpp, _j(b), jnp.asarray(sync))
        unsynced = TS.make_hfl_train_step(tc, lr=lr)(tpp, _t(b), False)
        tpp = tstep(tpp, _t(b), torch.tensor(sync))
        _close(jpp, tpp, atol=1e-5)
        for x, u in zip(tree_leaves(tpp), tree_leaves(unsynced)):
            if sync:
                assert torch.equal(x[0], x[1])
                torch.testing.assert_close(x[0], u.mean(0), rtol=0,
                                           atol=0)
            else:
                assert torch.equal(x, u)
        if not sync:
            assert any(not torch.equal(x[0], x[1])
                       for x in tree_leaves(tpp))


# ------------------------------------------------------- within the port

@pytest.mark.parametrize("family", ["dense", "vlm", "audio", "ssm"])
def test_microbatch_split_keeps_the_mean_gradient(family):
    _, tc = _cfgs(FAMILIES[family])
    jc = jreg.get_smoke_config(FAMILIES[family])
    _, tp = _both(jc)
    b = _t(_batch(jc, seed=3))
    g1, l1 = TS.accumulate_grads(dataclasses.replace(tc, microbatches=1),
                                 tp, b)
    g2, l2 = TS.accumulate_grads(dataclasses.replace(tc, microbatches=2),
                                 tp, b)
    torch.testing.assert_close(l2 / 2, l1, rtol=1e-6, atol=0)
    for a, c in zip(tree_leaves(g2), tree_leaves(g1)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a / 2, c, rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_changes_no_value(family):
    """Every leaf gets a gradient (the audio codebooks, the MoE router,
    the Mamba-2 per-head vectors), equal with remat on and off."""
    jc, tc = _cfgs(FAMILIES[family], microbatches=2)
    _, tp = _both(jc)
    b = _t(_batch(jc, seed=4))
    g_on, l_on = TS.accumulate_grads(tc, tp, b)
    g_off, l_off = TS.accumulate_grads(dataclasses.replace(tc, remat=False),
                                       tp, b)
    assert torch.equal(l_on, l_off)
    for a, c, p in zip(tree_leaves(g_on), tree_leaves(g_off),
                       tree_leaves(tp)):
        assert a.shape == p.shape and bool(torch.isfinite(a).all())
        assert torch.equal(a, c)


def test_train_step_decreases_loss():
    """The reference's ``test_train_step_decreases_loss`` on the port."""
    from repro_torch.data import token_batch_iterator
    cfg = dataclasses.replace(treg.get_smoke_config("chatglm3-6b"),
                              microbatches=2)
    step, opt = TS.make_train_step(cfg, lr=3e-3)
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt_state = opt.init(params)
    it = token_batch_iterator(cfg.vocab_size, batch=8, seq=32, seed=0)
    losses = []
    for _ in range(30):
        params, opt_state, m = step(params, opt_state, _t(next(it)))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


# ---------------------------------------------------------- K5 guard

def test_kernel_attention_refuses_grad():
    """The flash-attention kernel has no backward (nor has the
    reference's), so training through it raises, on the CPU too, where
    the dispatcher would take the differentiable plain version."""
    cfg = treg.get_smoke_config("chatglm3-6b")
    with pytest.raises(NotImplementedError, match="backward"):
        TS.make_train_step(cfg, impl="kernel")
    with pytest.raises(NotImplementedError, match="backward"):
        TS.make_hfl_train_step(cfg, impl="kernel")
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    mix = {k: v[0] for k, v in params["blocks"][0]["mix"].items()}
    x = torch.randn(1, 8, cfg.d_model)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.attn_forward({k: v.requires_grad_() for k, v in mix.items()},
                           x, cfg, impl="kernel")
    with torch.no_grad():
        got = tattn.attn_forward(mix, x, cfg, impl="kernel")
    want = tattn.attn_forward(mix, x, cfg, impl="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- CLI

def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU: checkpoints every 2 steps, a
    second run resumes from the latest one, and the port's checkpoint
    restores into the reference's params tree with equal leaves."""
    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--log-every", "1",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    first = ttrain.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=chatglm3-smoke params=")
    assert out[0].endswith("M device=cpu")
    assert [ln.split()[1] for ln in out[1:5]] == ["1", "2", "3", "4"]
    assert out[-1] == "done" and len(first["log"]) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]
    second = ttrain.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "restored step 4" and out[-1] == "done"
    assert [s for s, _, _ in second["log"]] == [5, 6]
    assert latest_step(str(tmp_path)) == 6
    cfg = jreg.get_smoke_config("chatglm3-6b")
    restored = j_restore(JT.init(jax.random.PRNGKey(1), cfg), str(tmp_path))
    mine = restore_pytree(TS.params_struct(treg.get_smoke_config(
        "chatglm3-6b")), str(tmp_path))
    for want, got, p in zip(jax.tree.leaves(restored), tree_leaves(mine),
                            tree_leaves(second["params"])):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(p.numpy(), want)
