"""The port's D3QN agent (``repro_torch.drl``), its optimizers
(``repro_torch.optim``) and ``DRLAssigner`` against ``repro``, with
``hidden=16`` and the reference's parameters carried across through
numpy (``convert.params_from_numpy``; torch cannot replay
``jax.random``).

Tolerances:
- Q values: atol 1e-5 (f32 products summed in another order; measured
  ~3e-7);
- TD loss and its gradients: rtol 1e-5 (atol 1e-7 for gradients near
  zero);
- optimizers and schedules, one and five steps: rtol 1e-6 / atol 1e-7
  (the same f32 arithmetic in the same order; the bias corrections may
  differ by one ulp where numpy's and XLA's pow round differently);
- replay minibatches: bitwise (the same three numpy draws);
- update waves (5 Adam steps with target syncs) on one minibatch
  stream: params atol 1e-5;
- trainer waves and the serial engine at ``alloc_steps=30``: HFEL
  targets, actions and rewards equal (host numpy decisions on
  near-equal Q values and J);
- ``DRLAssigner``: equal assignments (greedy argmax of Q values that
  agree to ~3e-7);
- ``HFLFramework(assigner="drl")``: cohorts and assignments equal, the
  framework test's record tolerances (T_i/E_i/obj_i rtol 1e-5, accuracy
  to one test sample); final params atol 1e-3 (measured 3.5e-4). The
  untrained agent's groupings put Algorithm 1 at a kink of this world's
  training (ReLU and max-pool are piecewise linear, so an f32 difference
  can send a step's gradient down another branch): on such cohorts the
  port's and the reference's params move by 6e-5 to 2.6e-4 under
  relative changes of 2e-7 to 1e-6 of the initial weights, against a
  round's update of ~1.2e-2. ``tests/test_torch_framework.py`` holds
  Algorithm 1 to atol 1e-6 on the geo world.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.optim as joptim
from repro.core.assignment.drl import DRLAssigner as JDRL
from repro.core.framework import FrameworkConfig as JConfig
from repro.drl import d3qn as jd
from repro.drl import train as jt
from repro.drl.replay import EpisodeReplay as JReplay
import repro_torch.core.cost_model as tcm
import repro_torch.optim as toptim
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.assignment.drl import DRLAssigner as TDRL
from repro_torch.core.framework import FrameworkConfig as TConfig
from repro_torch.drl import d3qn as td
from repro_torch.drl import train as tt
from repro_torch.drl.replay import EpisodeReplay as TReplay
from repro_torch.utils import tree_leaves
from test_torch_framework import _two_rounds_match_reference
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

KW = dict(n_devices=10, n_edges=3)
SP_J, SP_T = jcm.SystemParams(**KW), tcm.SystemParams(**KW)
FEAT = KW["n_edges"] + 3
TRAIN = dict(H=8, hidden=16, hfel_transfer=6, hfel_exchange=8,
             alloc_steps=30, minibatch=16, wave_size=2, seed=5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(seed=0, hidden=16, n_actions=3):
    return jd.d3qn_init(jax.random.PRNGKey(seed), FEAT, n_actions, hidden)


def _assert_trees_close(got, want, **tol):
    got, want = params_to_numpy(got), _np_tree(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, **tol)


def _fill(*replays, n=6, H=8, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        feats = rng.random((H, FEAT)).astype(np.float32)
        acts = rng.integers(0, 3, H)
        rews = np.where(acts == 0, 1.0, -1.0)
        for r in replays:
            r.push(feats, acts, rews)


def test_params_carry_across_and_back_exactly():
    pj = _np_tree(_ref_params())
    pt = params_from_numpy(pj, "cpu")
    assert set(pt) == {"bilstm", "trunk", "v_head", "a_head"}
    assert set(pt["bilstm"]) == {"fwd", "bwd"}
    assert pt["bilstm"]["fwd"]["wx"].shape == (FEAT, 64)   # (in, 4h)
    back = params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, b)
    own = td.d3qn_init(torch.Generator().manual_seed(0), FEAT, 3, 16, "cpu")
    assert jax.tree.structure(params_to_numpy(own)) == jax.tree.structure(pj)


@pytest.mark.parametrize("batched", [False, True])
def test_q_values_match(batched):
    pj = _ref_params(1)
    pt = params_from_numpy(_np_tree(pj), "cpu")
    feats = np.random.default_rng(0).random(
        (3, 8, FEAT) if batched else (8, FEAT)).astype(np.float32)
    fn = jd.q_values_batch if batched else jd.q_values_all_t
    qj = np.asarray(fn(pj, jnp.asarray(feats)))
    qt = td.q_values_all_t(pt, torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-5)


def test_td_loss_and_grads_match():
    pj, tgt_j = _ref_params(2), _ref_params(3)
    pt = params_from_numpy(_np_tree(pj), "cpu")
    tgt_t = params_from_numpy(_np_tree(tgt_j), "cpu")
    rj, rt = JReplay(), TReplay(device="cpu")
    _fill(rj, rt)
    mb = [np.asarray(a) for a in rj.sample(np.random.default_rng(4), 24)]
    lj, gj = jax.value_and_grad(jt._td_loss)(
        pj, tgt_j, *map(jnp.asarray, mb), 0.99)
    lt, gt = tt._loss_and_grads(pt, tgt_t, [torch.as_tensor(a) for a in mb],
                                0.99)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    _assert_trees_close(gt, gj, rtol=1e-5, atol=1e-7)
    # the target side carries no gradient
    assert all(not x.requires_grad for x in tree_leaves(tgt_t))


def _opt_cases():
    return [
        ("adam", lambda m: m.adam(1e-2)),
        ("adam_wd", lambda m: m.adam(3e-3, weight_decay=0.1)),
        ("adam_cosine", lambda m: m.adam(m.warmup_cosine(1e-2, 2, 6))),
        ("sgd", lambda m: m.sgd(0.05)),
        ("sgd_momentum", lambda m: m.sgd(m.cosine(0.05, 4), momentum=0.9)),
        ("adafactor", lambda m: m.adafactor(1e-2)),
    ]


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("name,make", _opt_cases(), ids=lambda c: c
                         if isinstance(c, str) else "")
def test_optimizers_match(name, make, steps):
    rng = np.random.default_rng(steps)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "blk": {"b": rng.normal(size=(3,)).astype(np.float32),
                      "m": rng.normal(size=(2, 3, 5)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape)
                          .astype(np.float32), params) for _ in range(steps)]
    oj, ot = make(joptim), make(toptim)
    pj, pt = jax.tree.map(jnp.asarray, params), params_from_numpy(params,
                                                                  "cpu")
    sj, st = oj.init(pj), ot.init(pt)
    for g in grads:
        pj, sj = oj.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pt, st = ot.update(params_from_numpy(g, "cpu"), st, pt)
    _assert_trees_close(pt, pj, rtol=1e-6, atol=1e-7)
    assert st["step"] == int(sj["step"]) == steps


def test_clip_and_schedules_match():
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(5, 4)).astype(np.float32),
         "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        cj = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
        ct = toptim.clip_by_global_norm(params_from_numpy(g, "cpu"),
                                        max_norm)
        _assert_trees_close(ct, cj, rtol=1e-6)
    for make in (lambda m: m.constant(3e-4), lambda m: m.cosine(0.1, 7),
                 lambda m: m.warmup_cosine(0.1, 3, 11, final_frac=0.2)):
        fj, ft = make(joptim), make(toptim)
        for s in (0, 1, 3, 6, 11, 20):
            np.testing.assert_allclose(
                ft(s), np.asarray(fj(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_replay_sample_updates_bitwise():
    rj, rt = JReplay(capacity_episodes=5), TReplay(capacity_episodes=5,
                                                   device="cpu")
    _fill(rj, rt, n=7)                       # wraps the ring
    assert rt.n_episodes == rj.n_episodes == 5 and len(rt) == len(rj)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for got, want in zip(rt.sample_updates(b, 4, 12, max_episodes=3),
                         rj.sample_updates(a, 4, 12, max_episodes=3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(rt.sample(b, 10), rj.sample(a, 10)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="episode shape"):
        rt.push(np.zeros((4, FEAT)), np.zeros(4), np.zeros(4))


def test_update_wave_matches_reference_and_serial_updates():
    """U=5 updates, target sync every 2, on the reference's minibatch
    stream; the port's serial ``_update_one`` loop gives the same."""
    trj = jt.D3QNTrainer(SP_J, H=8, hidden=16, minibatch=16, target_sync=2,
                         seed=3)
    trt = tt.D3QNTrainer(SP_T, H=8, hidden=16, minibatch=16, target_sync=2,
                         seed=3, device="cpu",
                         init_params=_np_tree(trj.params))
    _fill(trj.replay, trt.replay)
    U = 5
    mbs = [np.asarray(a) for a in trj.replay.sample_updates(
        np.random.default_rng(7), U, 16)]
    (pj, _, tj, step_j), lj = trj._update_wave(
        trj.params, trj.opt_state, trj.target_params,
        jnp.asarray(0, jnp.int32), *map(jnp.asarray, mbs))
    (pt, ot, tg, step_t), lt = trt._update_wave(
        trt.params, trt.opt_state, trt.target_params, 0,
        *(torch.as_tensor(a) for a in mbs))
    assert step_t == int(step_j) == U and ot["step"] == U
    assert lt.shape == (U,) and not lt.requires_grad
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    _assert_trees_close(pt, pj, rtol=0, atol=1e-5)
    _assert_trees_close(tg, tj, rtol=0, atol=1e-5)

    params, opt_state, target = trt.params, trt.opt_state, trt.target_params
    for u in range(U):
        params, opt_state, _ = trt._update(
            params, opt_state, target, *(torch.as_tensor(a[u]) for a in mbs))
        if (u + 1) % trt.target_sync == 0:
            target = {k: v for k, v in params.items()}
    for a, b in zip(tree_leaves(params), tree_leaves(pt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _trainers(engine):
    trj = jt.D3QNTrainer(SP_J, engine=engine, **TRAIN)
    trt = tt.D3QNTrainer(SP_T, engine=engine, device="cpu",
                         init_params=_np_tree(trj.params), **TRAIN)
    return trj, trt


def _same_replay(trj, trt):
    n = trj.replay.n_episodes
    assert trt.replay.n_episodes == n
    for a, b in ((trt.replay._feats, trj.replay._feats),
                 (trt.replay._actions, trj.replay._actions),
                 (trt.replay._rewards, trj.replay._rewards)):
        np.testing.assert_array_equal(a[:n].numpy(), np.asarray(b)[:n])


def test_run_wave_matches_reference():
    """Two waves: the HFEL targets, the ε-greedy actions and the rewards
    are the reference's; the second wave's updates run on the same
    minibatch stream."""
    trj, trt = _trainers("batched")
    targets = {"j": [], "t": []}
    for key, tr in (("j", trj), ("t", trt)):
        real = tr.hfel.assign_batch

        def spy(*a, _real=real, _log=targets[key], **kw):
            out = _real(*a, **kw)
            _log.append(np.array(out[0]))
            return out
        tr.hfel.assign_batch = spy
    for w in range(2):
        rj, lj = trj.run_wave()
        rt, lt = trt.run_wave()
        np.testing.assert_array_equal(targets["t"][w], targets["j"][w])
        np.testing.assert_array_equal(rt, rj)
        _same_replay(trj, trt)
    assert trt.episode == trj.episode == 4 and trt.step == trj.step == 2
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    _assert_trees_close(trt.params, trj.params, rtol=0, atol=1e-5)
    assert trt.rng.random() == trj.rng.random()


def test_serial_engine_matches_reference():
    trj, trt = _trainers("serial")
    for _ in range(3):
        rj, lj = trj.run_episode()
        rt, lt = trt.run_episode()
        assert rt == rj
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    _same_replay(trj, trt)
    assert len(trt.replay) > TRAIN["minibatch"] and trt.step == trj.step == 1
    _assert_trees_close(trt.params, trj.params, rtol=0, atol=1e-5)
    hist = trt.train(2, verbose=False)
    assert len(hist) == 5 and trt.episode == 5
    with pytest.raises(ValueError, match="engine"):
        tt.D3QNTrainer(SP_T, H=8, engine="warp", device="cpu")


def test_drl_assigner_matches_reference():
    pj = _ref_params(4)
    aj, at = JDRL(SP_J, pj), TDRL(SP_T, params_from_numpy(_np_tree(pj),
                                                          "cpu"))
    seeds = [11, 22, 33]
    bj = jcm.sample_population_batch(SP_J, seeds=seeds)
    bt = tcm.sample_population_batch(SP_T, seeds=seeds, device="cpu")
    sched = np.array([7, 1, 3, 0, 9, 4])
    np.testing.assert_array_equal(at.assign(bt.pop(0), sched)[0],
                                  aj.assign(bj.pop(0), sched)[0])
    Aj, _ = aj.assign_batch(bj, sched)
    At, _ = at.assign_batch(bt, sched)
    np.testing.assert_array_equal(At, Aj)
    for e in range(3):
        np.testing.assert_array_equal(At[e], at.assign(bt.pop(e), sched)[0])
    A2, _ = at.assign_batch(bt.populations())            # all devices
    np.testing.assert_array_equal(A2, aj.assign_batch(bj)[0])
    np.testing.assert_array_equal(
        tt.drl_features_batch(bt, np.stack([sched] * 3))[1],
        jt.drl_features(bj.pop(1), sched))


def test_framework_drl_two_rounds_match_reference():
    kw = dict(H=6, K=3, alloc_steps=30, scheduler="ikc", assigner="drl",
              seed=0)
    _two_rounds_match_reference(JConfig(**kw), TConfig(device="cpu", **kw),
                                drl_params=_ref_params(5, n_actions=3),
                                param_atol=1e-3)
