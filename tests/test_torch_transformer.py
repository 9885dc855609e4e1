"""The port's LM serving path (repro_torch.models.transformer) against the
JAX package on the same numpy inputs, at the REDUCED configs.

Both packages get the same parameters, drawn with numpy (so nothing here
depends on ``jax.random``'s mode) and rounded once to bf16.  JAX runs
``attn_impl="pallas_interpret"`` where the port runs ``"pallas"`` (the
kernel's plain version on the CPU), and ``"xla"`` on both.

Tolerance: ``TOL`` = 0.04 of the largest |value|, for logits and caches.
Everything runs in bf16.  The two frameworks' bf16 ``tanh`` (in the gelu)
and matmul rounding differ in a few tenths of a percent of the results,
by one ulp, and the next projection spreads each flipped ulp over a
whole row: after one block ~70% of the K/V entries differ by one or two
ulps (2^-8 relative).  The measured gap is at most 0.018 of max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import lm as jlm
from repro.launch import analytics as janalytics
from repro.models import init_params as jinit
from repro.models import prefill_step as jprefill
from repro.models import serve_step as jserve
from repro.models import transformer as jtr
from repro_torch import configs, models
from repro_torch.data import lm
from repro_torch.launch import analytics
from repro_torch.models import transformer as ttr

TOL = 0.04
DECODE_REL = 0.08        # tests/test_decode_consistency.py's bound
ATTN_ARCHS = ["gemma2-2b", "yi-9b", "deepseek-67b", "starcoder2-15b",
              "internvl2-26b", "musicgen-medium"]
# rwkv6-3b is ported: tests/test_torch_rwkv6.py holds it against JAX; the
# archs that waited for ROADMAP A5 (MoE and zamba2) now run too
UNPORTED_ARCHS = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "zamba2-7b"]


def _np_params(cfg, seed=0):
    """The JAX package's parameter tree for ``cfg``, filled with numpy
    draws: dense weights normal / sqrt(fan_in), the embedding normal * 0.02
    and the norm scales 0.1 * normal (so the (1 + scale) form is live)."""
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "embedding":
            return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        fan = leaf.shape[-3] if name in ("wq", "wk", "wv") else leaf.shape[-2]
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _both(arch, jimpl, timpl, seed=0):
    jcfg = jconfigs.get_config(arch, reduced=True).replace(attn_impl=jimpl)
    tcfg = configs.get_config(arch, reduced=True).replace(attn_impl=timpl)
    P = _np_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), P)
    return jcfg, tcfg, jp, models.params_from_numpy(P, device="cpu")


def _rel(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


@pytest.mark.parametrize("jimpl,timpl", [("pallas_interpret", "pallas"),
                                         ("xla", "xla")],
                         ids=["pallas", "xla"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-9b"])
def test_prefill_and_serve_match_jax(arch, jimpl, timpl):
    """Prefill (last-token logits and every cache tensor), then six decode
    steps, against JAX."""
    jcfg, tcfg, jp, tp = _both(arch, jimpl, timpl)
    B, S0, n = 2, 64, 6
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S0 + n)).astype(np.int32)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, cfg=jcfg,
                      max_len=S0 + n)
    tl, ts = models.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S0])}, cfg=tcfg, max_len=S0 + n)
    assert tl.shape == (B, 1, tcfg.vocab_size) and tl.dtype == torch.bfloat16
    assert _rel(tl, jl) < TOL
    for name in ("k", "v"):
        assert _rel(ts["kv"][name], js["kv"][name]) < TOL
    np.testing.assert_array_equal(ts["kv"]["slot_pos"].numpy(),
                                  np.asarray(js["kv"]["slot_pos"]))
    for i in range(n):
        tok = toks[:, S0 + i:S0 + i + 1]
        jl, js = jserve(jp, js, jnp.asarray(tok), jnp.int32(S0 + i), cfg=jcfg)
        tl, ts = models.serve_step(tp, ts, torch.from_numpy(tok), S0 + i,
                                   cfg=tcfg)
        assert _rel(tl, jl) < TOL, f"decode step {i}"
    np.testing.assert_array_equal(ts["kv"]["slot_pos"].numpy(),
                                  np.asarray(js["kv"]["slot_pos"]))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_decode_matches_forward(arch, impl):
    """The port's own prefill + step-by-step decode against its full
    forward's logits, as tests/test_decode_consistency.py checks JAX."""
    cfg = configs.get_config(arch, reduced=True).replace(attn_impl=impl)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    B, S, S0 = 2, 16, 8
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)))
    h, _, _ = models.forward(params, cfg, tokens=tokens)
    want = ttr.logits_from_hidden(params, cfg, h)[:, S0 - 1:].float()
    logits, state = models.prefill_step(params, {"tokens": tokens[:, :S0]},
                                        cfg=cfg, max_len=S)
    outs = [logits[:, 0]]
    for t in range(S0, S):
        logits, state = models.serve_step(params, state, tokens[:, t:t + 1],
                                          t, cfg=cfg)
        outs.append(logits[:, 0])
    got = torch.stack(outs, dim=1).float()
    err = (got - want).abs().max() / want.abs().max().clamp(min=1e-3)
    assert float(err) < DECODE_REL, f"{arch}: decode diverges ({err:.3f})"


def test_embeds_input_matches_jax():
    """The stub-frontend archs consume precomputed embeddings."""
    jcfg, tcfg, jp, tp = _both("musicgen-medium", "xla", "xla", seed=3)
    emb = np.random.RandomState(2).randn(2, 32, jcfg.d_model).astype(
        np.float32)
    jl, _ = jprefill(jp, {"embeds": jnp.asarray(emb)}, cfg=jcfg)
    tl, _ = models.prefill_step(tp, {"embeds": torch.from_numpy(emb)},
                                cfg=tcfg)
    assert _rel(tl, jl) < TOL


@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-9b"])
def test_params_from_numpy_and_init_params_shapes(arch):
    jcfg = jconfigs.get_config(arch, reduced=True)
    cfg = configs.get_config(arch, reduced=True)
    want = jax.tree.map(lambda s: tuple(s.shape),
                        jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                                     jcfg)))
    P = _np_params(jcfg)
    for tree in (models.params_from_numpy(P, device="cpu"),
                 models.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")):
        got = jax.tree.map(lambda t: tuple(t.shape), tree)
        assert got == want
        assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(tree))
    exported = jax.tree.map(np.asarray, jax.tree.map(
        lambda a: jnp.asarray(a, jnp.bfloat16), P))   # ml_dtypes bfloat16
    direct = models.params_from_numpy(exported, device="cpu")
    via_f32 = models.params_from_numpy(P, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(direct),
                                                 jax.tree.leaves(via_f32)))


@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-9b"])
def test_init_decode_state_shapes_match_jax(arch):
    jcfg = jconfigs.get_config(arch, reduced=True)
    cfg = configs.get_config(arch, reduced=True)
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        jax.eval_shape(lambda: jtr.init_decode_state(
                            jcfg, 2, 40)))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       ttr.init_decode_state(cfg, 2, 40, device="cpu"))
    assert got == want


@pytest.mark.parametrize("cache_len", [16, 24, 40], ids=["ring", "exact",
                                                          "headroom"])
def test_kv_from_full_matches_jax(cache_len):
    rng = np.random.RandomState(4)
    k, v = (rng.randn(2, 24, 2, 8).astype(np.float32) for _ in range(2))
    want = jtr._kv_from_full(jnp.asarray(k), jnp.asarray(v), cache_len)
    got = ttr._kv_from_full(torch.from_numpy(k), torch.from_numpy(v),
                            cache_len)
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_families_raise(arch):
    """The families that raised until ROADMAP A5 was ported (MoE and
    zamba2's mamba2 hybrid) now build, hold a decode state and run a
    forward: parameter and state trees shaped as JAX's, and the forward's
    logits within ``TOL`` of JAX's (tests/test_torch_moe.py and
    test_torch_mamba2.py hold them further)."""
    jcfg, tcfg, jp, tp = _both(arch, "xla", "xla")
    want = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
        lambda: jinit(jax.random.PRNGKey(0), jcfg)))
    got = jax.tree.map(lambda t: tuple(t.shape), models.init_params(
        torch.Generator().manual_seed(0), tcfg, device="cpu"))
    assert got == want
    want = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
        lambda: jtr.init_decode_state(jcfg, 1, 8)))
    got = jax.tree.map(lambda t: tuple(t.shape), models.init_decode_state(
        tcfg, 1, 8, device="cpu"))
    assert got == want
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (1, 16))
    jh, jaux, _ = jtr.forward(jp, jcfg, tokens=jnp.asarray(toks, jnp.int32))
    th, taux, _ = models.forward(tp, tcfg, tokens=toks.astype(np.int32))
    assert _rel(ttr.logits_from_hidden(tp, tcfg, th),
                jtr.logits_from_hidden(jp, jcfg, jh)) < TOL
    assert (float(taux) > 0) == tcfg.is_moe


@pytest.mark.parametrize("arch", sorted(jconfigs.list_archs()))
def test_configs_are_copies(arch):
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.SHAPES == jconfigs.SHAPES
    for reduced in (False, True):
        assert dataclasses.asdict(configs.get_config(arch, reduced)) == \
            dataclasses.asdict(jconfigs.get_config(arch, reduced))


@pytest.mark.parametrize("shape", sorted(jconfigs.SHAPES))
def test_model_flops_match_jax(shape):
    for arch in jconfigs.list_archs():
        want = janalytics.model_flops(arch, shape)
        info = configs.SHAPES[shape]
        assert analytics.model_flops(arch, shape) == want
        assert analytics.model_flops(arch, shape, batch=info["global_batch"],
                                     seq_len=info["seq_len"]) == want


def test_model_flops_cut_shape():
    """The cut prefill the chip run makes (2 x 8192 tokens of gemma2-2b):
    core 2*N*tokens plus the local/global attention term."""
    cfg = configs.get_config("gemma2-2b")
    B, S = 2, 8192
    got = analytics.model_flops("gemma2-2b", "prefill_32k", batch=B,
                                seq_len=S)
    assert got["model_flops_core"] == 2 * cfg.n_params() * B * S
    attn = cfg.n_layers * 2 * B * cfg.n_heads * cfg.hd * (
        S * S / 2 + S * min(S, cfg.window))
    assert got["model_flops_attn"] == attn


def test_synthetic_token_batches_match_jax():
    kw = dict(vocab=1000, batch=3, seq_len=50, seed=7)
    for a, b, _ in zip(lm.synthetic_token_batches(**kw),
                       jlm.synthetic_token_batches(**kw), range(3)):
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(a[name], b[name])


# ---------------- models/layers.py ----------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layers_match_jax(dt):
    """rmsnorm, rope, softcap and the embedding: f32 within 2e-6 (the
    frameworks' rsqrt/cos/tanh differ in the last bits); bf16 within one
    bf16 ulp of the largest value."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    tol = 2e-6 if dt == "f32" else 2 ** -8
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 4, 16).astype(np.float32) * 2
    scale = (0.1 * rng.randn(16)).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    pos = np.arange(12)[None].repeat(2, 0) + 100

    def check(got, want):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert got.dtype == tdt
        assert np.abs(got.float().numpy() - want).max() <= \
            tol * max(1.0, np.abs(want).max())
    check(tl.rmsnorm({"scale": torch.from_numpy(scale)}, tx),
          jl.rmsnorm({"scale": jnp.asarray(scale)}, jx))
    check(tl.apply_rope(tx, torch.from_numpy(pos), 10_000.0),
          jl.apply_rope(jx, jnp.asarray(pos), 10_000.0))
    check(tl.softcap(tx * 20, 30.0), jl.softcap(jx * 20, 30.0))
    table = rng.randn(50, 16).astype(np.float32)
    toks = rng.randint(0, 50, (2, 7))
    got = tl.embed({"embedding": torch.from_numpy(table)},
                   torch.from_numpy(toks), scale=True)
    want = jl.embed({"embedding": jnp.asarray(table)}, jnp.asarray(toks),
                    scale=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_mlp_matches_jax(act):
    """In bf16 the activations are spelled op for op as JAX computes them:
    silu agrees bit for bit, gelu up to the frameworks' bf16 tanh (a few
    tenths of a percent of the elements, one ulp); the product through wo
    then stays within two bf16 ulps of the largest output."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 32).astype(np.float32)
    p = {"wi_gate": rng.randn(32, 64) / np.sqrt(32),
         "wi_up": rng.randn(32, 64) / np.sqrt(32),
         "wo": rng.randn(64, 32) / np.sqrt(64)}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)).bfloat16()
          for k, v in p.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    want = np.asarray(jnp.asarray(jl.glu_mlp(jp, jx, act=act), jnp.float32))
    got = tl.glu_mlp(tp, tx, act=act).float().numpy()
    assert np.abs(got - want).max() <= 2 * 2 ** -8 * np.abs(want).max()
    gate = jx @ jp["wi_gate"]
    tgate = torch.from_numpy(np.array(jnp.asarray(gate, jnp.float32))
                             ).bfloat16()
    if act == "silu":
        np.testing.assert_array_equal(
            tl.silu(tgate).float().numpy(),
            np.asarray(jnp.asarray(jax.nn.silu(gate), jnp.float32)))
    else:
        differ = (tl.gelu_tanh(tgate).float().numpy() != np.asarray(
            jnp.asarray(jax.nn.gelu(gate, approximate=True), jnp.float32)))
        assert differ.mean() < 0.02
