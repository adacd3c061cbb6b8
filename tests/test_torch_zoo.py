"""The port's MoE, Mamba-2 and hybrid layers and models against
``repro`` on the CPU.

Both packages get the same inputs (numpy, from a seed) and the same
weights (``repro``'s inits, carried across through
``repro_torch.convert``). Tolerances:

* ``causal_conv1d``: bitwise (the same products summed in the same
  order);
* SSD: ``ssd_reference``, ``ssd_chunked`` and ``ssd_recurrent_step``
  against the reference's, and the port's chunked form against its
  recurrence, atol 1e-5 / rtol 1e-5 (f32 sums in another order on
  outputs of order 1; measured at most 2e-6);
* the Mamba-2 block (forward and decode) and the MoE layer (output and
  aux loss, on an input whose routing drops choices): atol 1e-5 (outputs
  of order 0.1-1); the MoE routing (top-k experts, slot positions, the
  kept choices) exactly;
* whole models at their smoke configs: logits atol 1e-4 (as
  ``test_torch_lm.py``; measured at most 1.7e-5), the aux loss and the
  loss to rtol 1e-5, teacher-forced decode logits atol 1e-4.

The reference's decode is jitted with ``cfg`` static.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import frontend as jfront
from repro.models import layers as jlayers
from repro.models import mamba2 as jm2
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.launch import steps
from repro_torch.models import frontend as tfront
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tm2
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.utils import tree_leaves
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

ZOO = ("mamba2-2.7b", "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e",
       "jamba-1.5-large-398b")
SSD_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_ATOL = 1e-5
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _cfgs(arch):
    return jreg.get_smoke_config(arch), treg.get_smoke_config(arch)


# ---------------------------------------------------------- causal conv

@pytest.mark.parametrize("streaming", [False, True])
def test_causal_conv1d_bitwise(streaming):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jy, jst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(st) if streaming else None)
    ty, tst = tlayers.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(st) if streaming
                                    else None)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    # a stream fed one token at a time gives the whole sequence's output
    state = torch.from_numpy(st) if streaming else torch.zeros(2, 3, 12)
    steps_out = []
    for t in range(7):
        y, state = tlayers.causal_conv1d(torch.from_numpy(x[:, t:t + 1]),
                                         torch.from_numpy(w), state)
        steps_out.append(y)
    np.testing.assert_array_equal(torch.cat(steps_out, 1).numpy(),
                                  ty.numpy())


# ------------------------------------------------------------------ SSD

def _ssd_inputs(B=2, S=32, H=4, P=8, G=2, N=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [32, 8])
def test_ssd_forms_match_reference(chunk):
    """chunk = S (one chunk) and chunk < S (the inter-chunk recurrence)."""
    arrs = _ssd_inputs()
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    ref = jm2.ssd_reference(*j)
    _close(tm2.ssd_reference(*t), ref, **SSD_TOL)
    got = tm2.ssd_chunked(*t, chunk)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 4, 8)
    _close(got, jm2.ssd_chunked(*j, chunk), **SSD_TOL)
    _close(got, tm2.ssd_reference(*t), **SSD_TOL)
    with pytest.raises(ValueError, match="multiple"):
        tm2.ssd_chunked(*t, 12)


def test_ssd_recurrent_step_matches_reference_and_chunked():
    x, dt, A, Bm, Cm = _ssd_inputs()
    B, S, H, P = x.shape
    jstate = jnp.zeros((B, H, P, Bm.shape[-1]))
    tstate = torch.zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for s in range(S):
        jstate, jy = jm2.ssd_recurrent_step(
            jstate, *(jnp.asarray(a[:, s]) for a in (x, dt)),
            jnp.asarray(A), *(jnp.asarray(a[:, s]) for a in (Bm, Cm)))
        tstate, ty = tm2.ssd_recurrent_step(
            tstate, *(torch.from_numpy(a[:, s]) for a in (x, dt)),
            torch.from_numpy(A), *(torch.from_numpy(a[:, s])
                                   for a in (Bm, Cm)))
        _close(ty, jy, **SSD_TOL)
        _close(tstate, jstate, **SSD_TOL)
        ys.append(ty)
    chunked = tm2.ssd_chunked(*(torch.from_numpy(a)
                                for a in (x, dt, A, Bm, Cm)), 8)
    _close(torch.stack(ys, 1), chunked, **SSD_TOL)


def test_ssd_chunked_gradient_is_finite_at_large_decay_sums():
    """The masked upper triangle holds exp of positive sums: at dt ~ 40
    a chunk of 16 reaches exp(600), which is inf in f32. Exponentiating
    the masked differences keeps the forward and the gradient finite;
    the reference's ``where(causal, exp(diff), 0)`` gives a NaN
    gradient there."""
    arrs = list(_ssd_inputs(S=16))
    arrs[1] = arrs[1] + np.float32(40.0)
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in arrs)
    dt.requires_grad_()
    y = tm2.ssd_chunked(x, dt, A, Bm, Cm, 16)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(dt.grad).all()
    _close(y.detach(), tm2.ssd_reference(x, dt.detach(), A, Bm, Cm),
           atol=1e-3, rtol=1e-4)
    j = [jnp.asarray(a) for a in arrs]
    jg = jax.grad(lambda d: jm2.ssd_chunked(j[0], d, *j[2:], 16).sum())(j[1])
    assert np.isnan(np.asarray(jg)).any()


# ------------------------------------------------------------ Mamba-2

def test_mamba2_forward_and_decode_match_reference():
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=8))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                             chunk=8))
    jp = jm2.mamba2_init(jax.random.PRNGKey(0), jcfg)
    # live values for the per-head vectors (they init to constants)
    rng = np.random.default_rng(1)
    jp = dict(jp, A_log=jnp.asarray(rng.normal(0, 0.5, 8), jnp.float32),
              D_skip=jnp.asarray(rng.normal(1, 0.2, 8), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(-1, 0.3, 8), jnp.float32))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    assert sorted(tp) == sorted(jm2.mamba2_init(jax.random.PRNGKey(0),
                                                jcfg))
    h = rng.standard_normal((2, 24, 128)).astype(np.float32)
    want = jm2.mamba2_forward(jp, jnp.asarray(h), jcfg)
    got = tm2.mamba2_forward(tp, torch.from_numpy(h), tcfg)
    _close(got, want, atol=LAYER_ATOL)
    jc = jm2.init_ssm_cache(jcfg, 2)
    tc = tm2.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    for k in ("ssm", "conv"):
        assert tuple(tc[k].shape) == jc[k].shape
    outs = []
    for t in range(24):
        jo, jc = jm2.mamba2_decode(jp, jnp.asarray(h[:, t:t + 1]), jc, jcfg)
        to, tc = tm2.mamba2_decode(tp, torch.from_numpy(h[:, t:t + 1]), tc,
                                   tcfg)
        _close(to, jo, atol=LAYER_ATOL)
        outs.append(to)
    for k in ("ssm", "conv"):
        _close(tc[k], jc[k], atol=LAYER_ATOL)
    _close(torch.cat(outs, 1), got, atol=LAYER_ATOL)


# ------------------------------------------------------------------ MoE

def _moe_cfgs(E=4, k=2):
    kw = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=48, vocab_size=97, dtype="float32")
    return (JModelConfig(**kw, moe=JMoEConfig(num_experts=E, top_k=k)),
            TModelConfig(**kw, moe=MoEConfig(num_experts=E, top_k=k)))


def _reference_routing(jp, x, cfg):
    """The reference's router, top-k and slot positions
    (``repro/models/moe.py``'s formulas, one data chunk)."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ jp["router"], axis=-1)
    top_w, top_idx = jax.lax.top_k(probs, k)
    flat_e = top_idx.reshape(-1)
    pos_all = jnp.cumsum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), 0) - 1
    pos = jnp.take_along_axis(pos_all, flat_e[:, None], 1)[:, 0]
    C = jmoe.moe_capacity(xf.shape[0], cfg)
    return np.asarray(top_idx), np.asarray(pos), np.asarray(pos < C), C


@pytest.mark.parametrize("E,k", [(4, 2), (4, 1)])
def test_moe_apply_with_capacity_drops_matches_reference(E, k):
    """T = 16 tokens share one direction, so most pick the same expert
    and the capacity C = max(4, ceil(T·k/E)·1.25) drops some."""
    jcfg, tcfg = _moe_cfgs(E, k)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(32) + 0.3 * rng.standard_normal((2, 8, 32))
         ).astype(np.float32)
    top_idx, pos, keep, C = _reference_routing(jp, jnp.asarray(x), jcfg)
    r = tmoe.moe_route(tp, torch.from_numpy(x).reshape(16, 32), tcfg)
    assert r.capacity == C == tmoe.moe_capacity(16, tcfg)
    np.testing.assert_array_equal(r.top_idx.numpy(), top_idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert 0 < int((~r.keep).sum()) < 16 * k          # some drops happen
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(tout, jout, atol=LAYER_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_moe_grad_under_vmap_matches_reference():
    """Local training vmaps the gradient over the cohort: the slot
    table is built out of place, so torch.func takes it."""
    jcfg, tcfg = _moe_cfgs()
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(32) + 0.3 * rng.standard_normal((3, 1, 8, 32))
         ).astype(np.float32)

    def jloss(p, xb):
        out, aux = jmoe.moe_apply(p, xb, jcfg)
        return jnp.sum(out ** 2) + aux

    def tloss(p, xb):
        out, aux = tmoe.moe_apply(p, xb, tcfg)
        return torch.sum(out ** 2) + aux

    jg = jax.vmap(jax.grad(jloss), in_axes=(None, 0))(jp, jnp.asarray(x))
    tg = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0))(
        tp, torch.from_numpy(x))
    for key in jg:
        _close(tg[key], jg[key], atol=1e-4, rtol=1e-5)


# ------------------------------------------------------- whole models

def _batch(cfg, B=2, S=16, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@pytest.fixture(scope="module")
def models():
    """Each arch's reference params and the same weights as port params."""
    out = {}
    for arch in ZOO:
        jcfg, tcfg = _cfgs(arch)
        jp = JT.init(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, tcfg, jp, params_from_numpy(_np_tree(jp), "cpu"))
    return out


@pytest.mark.parametrize("arch", ZOO)
def test_forward_and_loss_match_reference(models, arch):
    jcfg, tcfg, jp, tp = models[arch]
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, jaux = jax.jit(JT.forward, static_argnums=2)(jp, jb, jcfg)
    jloss, jm = jax.jit(JT.loss_fn, static_argnums=2)(jp, jb, jcfg)
    for impl in ("plain", "kernel"):
        logits = steps.make_prefill_step(tcfg, impl=impl)(tp, tb)
        assert logits.shape == want.shape
        _close(logits, want)
        loss, metrics = TT.loss_fn(tp, tb, tcfg, impl=impl)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["aux"]), float(jaux),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                                   rtol=1e-5)
    if tcfg.is_moe:      # the aux loss is live and enters the loss
        assert float(metrics["aux"]) > 0
        assert float(loss) == pytest.approx(
            float(metrics["nll"])
            + tcfg.moe.router_aux_weight * float(metrics["aux"]), rel=1e-6)


@pytest.mark.parametrize("arch", ZOO)
def test_decode_matches_reference(models, arch):
    """Teacher-forced decode over 6 tokens, KV and SSM caches side by
    side (jamba holds both), against the reference's decode."""
    jcfg, tcfg, jp, tp = models[arch]
    B, S = 2, 6
    toks = _batch(jcfg, B, S, seed=5)["tokens"]
    jdec = jax.jit(JT.decode, static_argnums=4)
    jcache = JT.init_cache(jcfg, B, S)
    tcache = TT.init_cache(tcfg, B, S, device="cpu")
    for jc, tc in zip(jcache, tcache):
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
    serve = steps.make_serve_step(tcfg)
    for t in range(S):
        jl, jcache = jdec(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t), jcfg)
        tl, tcache = serve(tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        _close(tl, jl)
    for jc, tc in zip(jcache, tcache):
        for k in jc:
            _close(tc[k], jc[k])


@pytest.mark.parametrize("arch", ZOO)
def test_param_count_and_tree_match_reference(models, arch):
    """The port's init tree has the reference's structure and shapes;
    ``param_count()`` is the reference's analytic count, which counts two
    norms in every layer and two of the SSM's three per-head vectors, so
    it differs from the tree by D a layer without an MLP sublayer and by
    -n_heads an SSM layer (both packages alike)."""
    jcfg, tcfg, jp, _ = models[arch]
    tp = TT.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert list(flatten_params(tp)) == list(flatten_params(_np_tree(jp)))
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
    n = sum(x.numel() for x in tl)
    ssm = tcfg.ssm
    off = sum((tcfg.d_model if tcfg.mlp_kind(i) == "none" else 0)
              - (ssm.n_heads(tcfg.d_model) if tcfg.layer_kind(i) == "ssm"
                 else 0) for i in range(tcfg.n_layers))
    assert tcfg.param_count() == jcfg.param_count() == n + off
    full_t, full_j = treg.get_config(arch), jreg.get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert full_t.param_count() == full_j.param_count()
    assert full_t.active_param_count() == full_j.active_param_count()


def test_frontend_stubs_shapes():
    cfg_v = treg.get_smoke_config("internvl2-26b")
    cfg_a = treg.get_smoke_config("musicgen-medium")
    g = torch.Generator().manual_seed(0)
    emb = tfront.vision_patch_embeds(g, 3, cfg_v, device="cpu")
    want = jfront.vision_patch_embeds(jax.random.PRNGKey(0), 3,
                                      jreg.get_smoke_config("internvl2-26b"))
    assert tuple(emb.shape) == want.shape and emb.dtype == torch.float32
    assert 0.01 < float(emb.std()) < 0.03
    tok = tfront.encodec_tokens(g, 2, 5, cfg_a, device="cpu")
    jtok = jfront.encodec_tokens(jax.random.PRNGKey(0), 2, 5,
                                 jreg.get_smoke_config("musicgen-medium"))
    assert tuple(tok.shape) == jtok.shape and tok.dtype == torch.int32
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg_a.vocab_size
    # the stubs feed the model
    batch = {"tokens": tok, "labels": tok}
    tp = TT.init(g, cfg_a, device="cpu")
    logits, _ = TT.forward(tp, batch, cfg_a)
    assert logits.shape == (2, 5, cfg_a.n_codebooks, cfg_a.vocab_size)
