"""The port's dense-decoder serving path against ``repro`` on the CPU.

Both packages get the same inputs (numpy, from a seed) and the same
weights (``repro``'s ``init``, carried across through
``repro_torch.convert``). Tolerances:

* flash attention, the port's plain version against ``ref.py`` and
  against the Pallas kernel in interpret mode: f32 2e-5 (the reference's
  own kernel-vs-oracle figure: the kernel scales q before the dot, the
  oracle divides the scores), bf16 0.03 (its bf16 figure: one output
  rounding apart on values of order 1);
* layers (RMSNorm, RoPE, SwiGLU): 1e-6 relative / 1e-6 absolute, f32 sums
  in another order;
* attention and whole-model logits: atol 1e-4 (logits of order 1-6;
  measured at most 1.2e-5, and the reference agrees with itself to
  5e-6-7e-6 between its two attention paths), the loss to 1e-5
  relative;
* teacher-forced decode against the reference's decode and against the
  port's own forward: atol 1e-4.

The reference's decode is jitted with ``cfg`` static (unjitted, a
16-step loop costs tens of seconds), and sequences stay at 16 tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jfa_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro_torch.configs import registry as treg
from repro_torch.configs.base import INPUT_SHAPES, MoEConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import serve_lm, steps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as TT

ATOL = 1e-4
PARAMS_6B = 6_243_454_976           # chatglm3-6b, the reference's count
PORTED = ("chatglm3-6b", "mistral-nemo-12b", "internvl2-26b",
          "musicgen-medium", "llama3-405b", "mistral-large-123b")
UNPORTED = ("jamba-1.5-large-398b", "mamba2-2.7b", "llama4-scout-17b-a16e",
            "qwen3-moe-235b-a22b")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _both(cfg, seed=0):
    """(reference params, the same weights as port params on the CPU)."""
    jp = JT.init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def _tokens(cfg, B, S, seed=1):
    shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------ flash attention

@pytest.mark.parametrize("B,S,Hq,Hkv,d,window", [
    (1, 128, 4, 2, 64, 0),
    (1, 256, 8, 2, 64, 96),    # GQA + sliding window
    (1, 200, 4, 2, 64, 0),     # unaligned sequence
    (1, 128, 2, 1, 80, 50),    # unaligned head dim, window < tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_reference(B, S, Hq, Hkv, d, window,
                                                 dtype):
    rng = np.random.default_rng(S + d)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d))]
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrs)
    n0 = fa.flash_attention_cuda.launches
    got = fa.flash_attention(tq, tk, tv, causal=True, window=window)
    assert fa.flash_attention_cuda.launches == n0    # CPU: plain version
    assert got.dtype == tq.dtype and got.shape == (B, S, Hq, d)
    tol = 2e-5 if dtype == "float32" else 0.03
    got = got.float().numpy()
    for want in (jfa_ref(jq, jk, jv, causal=True, window=window),
                 flash_attention_pallas(jq, jk, jv, causal=True,
                                        window=window, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("layout", ["offset view", "132-wide slice"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_unaligned_layouts_match_reference(layout, dtype):
    """The port's plain version on views whose base lies one element past
    their storage's start, and on d = 128 cut out of (B, S, H, 132)
    buffers (layouts that the CUDA dispatcher sends to ``wgmma_staged``),
    and on the copies that path hands the kernel (``tma_ready``), against
    the reference's Pallas kernel in interpret mode on the same values;
    the tolerances above. On the CPU no kernel runs: the kernel is held
    to the plain version on these layouts by the card tests."""
    B, S, Hq, Hkv, d, window = 1, 128, 4, 2, 128, 50
    rng = np.random.default_rng(17)
    tdt = getattr(torch, dtype)
    views = []
    for h in (Hq, Hkv, Hkv):
        if layout == "offset view":
            a = rng.standard_normal(B * S * h * d + 1).astype(np.float32)
            t = torch.from_numpy(a).to(tdt)[1:].view(B, S, h, d)
            assert t.data_ptr() % 16 == t.element_size()
        else:
            a = rng.standard_normal((B, S, h, 132)).astype(np.float32)
            t = torch.from_numpy(a).to(tdt)[..., :d]
            assert t.stride(2) == 132
        views.append(t)
    want_path = "tf32x3" if dtype == "float32" else "wgmma_staged"
    assert fa.kernel_path(*views) == want_path
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(dtype)
                  for t in views)
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                  interpret=True)
    tol = 2e-5 if dtype == "float32" else 0.03
    copies = [fa.tma_ready(t) for t in views]
    for inputs in (views, copies):
        got = fa.flash_attention(*inputs, causal=True, window=window)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


# ---------------------------------------------------------------- layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    _close(tlayers.rmsnorm({"scale": torch.from_numpy(scale)},
                           torch.from_numpy(x), 1e-5),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5), atol=1e-6, rtol=1e-6)
    pos = np.arange(7) + 3
    tc, ts = tlayers.rope_freqs(16, 1e6, torch.from_numpy(pos))
    jc, js = jlayers.rope_freqs(16, 1e6, jnp.asarray(pos))
    _close(tc, jc, atol=1e-6, rtol=1e-6)
    _close(ts, js, atol=1e-6, rtol=1e-6)
    _close(tlayers.apply_rope(torch.from_numpy(x), tc, ts),
           jlayers.apply_rope(jnp.asarray(x), jc, js), atol=1e-6, rtol=1e-6)
    mlp = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
           (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    _close(tlayers.mlp_apply(params_from_numpy(mlp, "cpu"),
                             torch.from_numpy(x)),
           jlayers.mlp_apply(mlp, jnp.asarray(x)), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- attention

def _attn_cfgs(window):
    kw = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=97, dtype="float32",
              sliding_window=window)
    return JModelConfig(**kw), TModelConfig(**kw)


@pytest.mark.parametrize("window", [0, 20])
def test_attn_forward_both_impls_match_reference(window):
    jcfg, tcfg = _attn_cfgs(window)
    jp = jattn.attn_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    x = np.random.default_rng(2).standard_normal((2, 64, 64)).astype(
        np.float32)
    for timpl, jimpl in (("plain", "xla"), ("kernel", "pallas")):
        _close(tattn.attn_forward(tp, torch.from_numpy(x), tcfg, impl=timpl),
               jattn.attn_forward(jp, jnp.asarray(x), jcfg, impl=jimpl))
    with pytest.raises(ValueError, match="impl"):
        tattn.attn_forward(tp, torch.from_numpy(x), tcfg, impl="xla")


@pytest.mark.parametrize("window", [0, 20])
def test_chunked_sdpa_matches_reference(window, monkeypatch):
    """The S > CHUNK_Q_THRESHOLD branch at S=64: both modules patched to
    chunk 16-query blocks above 32 tokens."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "CHUNK_Q_THRESHOLD", 32)
        monkeypatch.setattr(mod, "CHUNK_Q", 16)
    jcfg, tcfg = _attn_cfgs(window)
    jp = jattn.attn_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    x = np.random.default_rng(3).standard_normal((2, 64, 64)).astype(
        np.float32)
    got = tattn.attn_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, jattn.attn_forward(jp, jnp.asarray(x), jcfg))
    monkeypatch.setattr(tattn, "CHUNK_Q_THRESHOLD", 8192)
    _close(got, tattn.attn_forward(tp, torch.from_numpy(x), tcfg))


# ----------------------------------------------------------- whole model

def _batch(cfg, B=2, S=16):
    toks = _tokens(cfg, B, S)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = np.random.default_rng(4).standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mistral-nemo-12b",
                                  "internvl2-26b", "musicgen-medium"])
def test_forward_and_loss_match_reference(arch):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    jp, tp = _both(jcfg)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want, _ = jax.jit(JT.forward, static_argnums=2)(jp, jb, jcfg)
    (jloss, _) = jax.jit(JT.loss_fn, static_argnums=2)(jp, jb, jcfg)
    for impl in ("plain", "kernel"):
        logits = steps.make_prefill_step(tcfg, impl=impl)(tp, tb)
        assert logits.shape == want.shape
        _close(logits, want)
        loss, metrics = TT.loss_fn(tp, tb, tcfg, impl=impl)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert float(metrics["aux"]) == 0.0


@pytest.mark.parametrize("arch,window", [("chatglm3-6b", 0),
                                         ("chatglm3-6b", 8),
                                         ("musicgen-medium", 0)])
def test_decode_matches_reference_and_forward(arch, window):
    """Teacher-forced decode over 16 tokens (window 8: a rolling cache of
    8 slots) against the reference's decode and the port's forward."""
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch),
                               sliding_window=window)
    tcfg = dataclasses.replace(treg.get_smoke_config(arch),
                               sliding_window=window)
    B, S = 2, 16
    jp, tp = _both(jcfg, seed=2)
    toks = _tokens(jcfg, B, S, seed=5)
    jdec = jax.jit(JT.decode, static_argnums=4)
    jcache = JT.init_cache(jcfg, B, S)
    tcache = TT.init_cache(tcfg, B, S, device="cpu")
    slots = window or S
    assert tcache[0]["k"].shape == (tcfg.n_layers, B, slots,
                                    tcfg.n_kv_heads, tcfg.hd)
    serve = steps.make_serve_step(tcfg)
    jout, tout = [], []
    for t in range(S):
        jl, jcache = jdec(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                          jnp.int32(t), jcfg)
        tl, tcache = serve(tp, tcache, torch.from_numpy(toks[:, t:t + 1]), t)
        jout.append(np.asarray(jl[:, 0]))
        tout.append(tl[:, 0].numpy())
    _close(np.stack(tout, 1), np.stack(jout, 1))
    full = steps.make_prefill_step(tcfg, impl="kernel")(
        tp, {"tokens": torch.from_numpy(toks)})
    _close(np.stack(tout, 1), full)


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_reference(arch):
    tcfg = treg.get_config(arch)
    assert tcfg.param_count() == jreg.get_config(arch).param_count()
    assert tcfg.active_param_count() == tcfg.param_count()
    assert tcfg.compute_dtype == torch.bfloat16


def test_chatglm3_is_the_full_width_config():
    cfg = treg.get_config("chatglm3-6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_size) == (28, 4096, 32, 2, 128, 13696, 65024)
    assert cfg.param_count() == PARAMS_6B
    assert treg.variant_for_shape(
        cfg, INPUT_SHAPES["long_500k"]).sliding_window == 8192
    assert treg.variant_for_shape(cfg, INPUT_SHAPES["train_4k"]) is cfg
    assert treg.decode_supported(cfg)


@pytest.mark.parametrize("arch", UNPORTED)
def test_moe_and_ssm_archs_raise(arch):
    """The MoE and SSM archs (ported with their layers, parity in
    ``tests/test_torch_zoo.py``) resolve to the reference's configs;
    a name the registry does not hold raises."""
    for t_get, j_get in ((treg.get_config, jreg.get_config),
                         (treg.get_smoke_config, jreg.get_smoke_config)):
        assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(
            j_get(arch))
    with pytest.raises(KeyError):
        treg.get_config(arch + "-no-such")


def test_moe_layers_raise_in_the_model():
    """An MoE config builds the reference's tree; a depth that is not a
    whole number of super-blocks raises."""
    cfg = TModelConfig("m", "moe", 2, 64, 4, 2, 96, 97, dtype="float32",
                      moe=MoEConfig(4, 2))
    p = TT.init(torch.Generator(), cfg, device="cpu")
    assert sorted(p["blocks"][0]["mlp"]) == ["router", "w_down", "w_gate",
                                             "w_up"]
    assert p["blocks"][0]["mlp"]["w_gate"].shape == (2, 4, 64, 96)
    with pytest.raises(ValueError, match="super-block"):
        TT.init(torch.Generator(), dataclasses.replace(
            cfg, moe=MoEConfig(4, 2, every=4)), device="cpu")
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


def test_nested_convert_round_trip_is_exact():
    jp = JT.init(jax.random.PRNGKey(3), jreg.get_smoke_config("chatglm3-6b"))
    want = _np_tree(jp)
    back = params_to_numpy(params_from_numpy(want, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "musicgen-medium"])
def test_serve_lm_runs_on_cpu(arch, capsys):
    res = serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "4", "--gen", "4"])
    cfg = treg.get_smoke_config(arch)
    want = (2, 4) if cfg.n_codebooks == 1 else (2, 4, cfg.n_codebooks)
    assert tuple(res["tokens"].shape) == want
    assert int(res["tokens"].min()) >= 0
    assert int(res["tokens"].max()) < cfg.vocab_size
    assert "tok/s" in capsys.readouterr().out


def test_serve_lm_needs_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(["--arch", "chatglm3-6b", "--smoke"])
    with pytest.raises(ValueError, match="impl"):
        steps.make_prefill_step(treg.get_smoke_config("chatglm3-6b"),
                                impl="pallas")
