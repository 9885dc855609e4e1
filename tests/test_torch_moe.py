"""The port's mixture-of-experts block (repro_torch.models.moe and the MoE
branch of models/transformer.py) against the JAX package on the same numpy
inputs, at the REDUCED mixtral-8x22b and phi3.5-moe configs.

Tolerances:
* Routing: the port's ``route`` on the same bf16 input gives JAX's
  ``top_k`` indices, and its slot assignment and drop mask equal the ones
  JAX's one-hot cumsum gives, bit for bit (also at a capacity that
  overflows); the renormalised gates within 1e-6 (f32 softmax).
* ``moe_apply``'s output elementwise within one bf16 ulp of JAX's plus
  1e-3 of max|out| (``MOE_TOL``): the dispatch moves bf16 values exactly,
  the expert GEMMs are bf16 matmuls whose roundings differ between the
  frameworks in a few outputs; the aux loss within 1e-5.
* prefill + 6 decode steps: 0.04 of max|logit| (``TOL``, as for the other
  archs; measured at most 0.028); layer 0's caches within TOL, and in the
  later layers at least ``ROW_SHARE`` of the cache rows (a token near a
  routing tie may take another expert); decode against the port's own full
  forward at capacity 4.0 (no drops, tests/test_decode_consistency.py's
  setting) within 0.08.
The routing, output and decode checks each have a control that must fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import prefill_step as jprefill
from repro.models import serve_step as jserve
from repro_torch import configs, models
from repro_torch.models import moe
from repro_torch.models import transformer as ttr
from torch_lm_common import both, rel

TOL = 0.04
DECODE_REL = 0.08
MOE_TOL = (2.0 ** -7, 1e-3)
MOE_ARCHS = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b"]
# share of the cache rows held to TOL in the layers after routing (the
# measured worst is 0.957: 16 of 420 rows at REDUCED phi3.5-moe, xla)
ROW_SHARE = 0.9


def _block(arch, seed=0, B=2, S=64):
    """(cfg, JAX moe params (bf16), port moe params, x numpy f32 as bf16
    values) for one MoE block of the REDUCED config."""
    jcfg, tcfg, jp, tp = both(arch, seed=seed)
    jm = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tm = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    x = np.random.RandomState(seed + 7).randn(B, S, tcfg.d_model)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return tcfg, jm, tm, x


def _jax_slots(probs, top_k, cap):
    """JAX's slot ids and keep mask, as ``moe_apply`` computes them."""
    _, gate_idx = jax.lax.top_k(probs, top_k)
    ng, G, E = probs.shape
    oh = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    ohp = oh.transpose(0, 2, 1, 3).reshape(ng, top_k * G, E)
    pos = jnp.cumsum(ohp, axis=1) * ohp - 1.0
    keep = (pos >= 0) & (pos < cap)
    pos = pos.max(-1).reshape(ng, top_k, G).transpose(0, 2, 1)
    keep = keep.any(-1).reshape(ng, top_k, G).transpose(0, 2, 1)
    return np.asarray(gate_idx), np.asarray(pos).astype(np.int64), \
        np.asarray(keep)


def _ulp_ratio(got, want):
    rel_, tol = MOE_TOL
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    scale = np.abs(want).max()
    return float((np.abs(got - want) / (rel_ * np.abs(want) + tol * scale))
                 .max())


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "overflow"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax_bit_for_bit(arch, cf):
    """Top-k indices, slots and the drop mask equal JAX's; at capacity
    factor 0.25 the buffers overflow and tokens drop."""
    cfg, jm, tm, x = _block(arch)
    xt = torch.from_numpy(x.copy()).to(torch.bfloat16)
    r = moe.route(tm, xt, top_k=cfg.top_k, capacity_factor=cf,
                  group_size=64)
    xg = jnp.asarray(x, jnp.bfloat16).reshape(r["probs"].shape[0], -1,
                                              cfg.d_model)
    logits = jnp.einsum("gsd,de->gse", xg, jm["router"].astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    np.testing.assert_allclose(r["probs"].numpy(), np.asarray(probs),
                               rtol=0, atol=1e-6)
    idx, pos, keep = _jax_slots(probs, cfg.top_k, r["cap"])
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    dropped = int((~r["keep"]).sum())
    if cf < 1:
        assert dropped > 0 and r["cap"] == 8
    # control: slots counted in token-major order (each token's choices
    # before the next token's) must differ from JAX's choice-major slots
    cm = r["gate_idx"].reshape(r["gate_idx"].shape[0], -1)
    oh = torch.nn.functional.one_hot(cm, r["probs"].shape[-1])
    wrong = ((torch.cumsum(oh, 1) * oh).sum(-1) - 1).reshape(
        r["pos"].shape)
    assert not np.array_equal(wrong.numpy(), pos)


def test_route_keeps_jax_tie_order():
    """Exact ties in the router probabilities pick the lower expert first,
    as lax.top_k does."""
    tm = {"router": torch.zeros((4, 6), dtype=torch.bfloat16)}
    x = torch.ones((1, 8, 4), dtype=torch.bfloat16)
    r = moe.route(tm, x, top_k=2)
    assert (r["gate_idx"] == torch.tensor([0, 1])).all()
    _, jidx = jax.lax.top_k(jnp.full((8, 6), 1 / 6), 2)
    np.testing.assert_array_equal(r["gate_idx"][0].numpy(), np.asarray(jidx))


@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "overflow"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, cf):
    cfg, jm, tm, x = _block(arch)
    jy, jaux = jmoe.moe_apply(jm, jnp.asarray(x, jnp.bfloat16),
                              top_k=cfg.top_k, capacity_factor=cf,
                              group_size=64)
    ty, taux = moe.moe_apply(tm, torch.from_numpy(x.copy()).to(torch.bfloat16),
                             top_k=cfg.top_k, capacity_factor=cf,
                             group_size=64)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    assert _ulp_ratio(ty, jy) <= 1.0
    assert abs(float(taux) - float(jaux)) <= 1e-5
    if cf < 1:
        # control: the dropped tokens kept (no capacity) must fail
        big, _ = moe.moe_apply(tm, torch.from_numpy(x.copy()).to(torch.bfloat16),
                               top_k=cfg.top_k, capacity_factor=100.0,
                               group_size=64)
        assert _ulp_ratio(big, jy) > 1.0


def test_moe_apply_groups_and_raises():
    """B*S above the group size must be a multiple of it, as JAX
    asserts; ``route``'s keep mask counts the dropped choices."""
    cfg, jm, tm, x = _block("mixtral-8x22b", S=48)
    xt = torch.from_numpy(x.copy()).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        moe.moe_apply(tm, xt, top_k=2, group_size=64)
    keep = moe.route(tm, xt, top_k=2, capacity_factor=0.25,
                     group_size=32)["keep"]
    assert keep.shape == (3, 32, 2)
    assert 0 < int((~keep).sum()) < keep.numel()


def test_moe_apply_gradients_match_jax():
    """Gradients of a scalar of the output reach x, the router and the
    experts as JAX's do (the slot assignment is constant)."""
    cfg, jm, tm, x = _block("phi3.5-moe-42b-a6.6b", S=32)
    w = np.random.RandomState(3).randn(*x.shape).astype(np.float32)

    def jf(p, xx):
        y, aux = jmoe.moe_apply(p, xx, top_k=cfg.top_k, group_size=64)
        return jnp.sum(y.astype(jnp.float32) * w) + aux
    jg, jgx = jax.grad(jf, argnums=(0, 1))(jm, jnp.asarray(x, jnp.bfloat16))
    tp = {k: v.clone().requires_grad_() for k, v in tm.items()}
    xt = torch.from_numpy(x.copy()).to(torch.bfloat16).requires_grad_()
    y, aux = moe.moe_apply(tp, xt, top_k=cfg.top_k, group_size=64)
    (torch.sum(y.float() * torch.from_numpy(w)) + aux).backward()
    assert rel(xt.grad, jgx) < 0.03
    for k in tm:
        assert rel(tp[k].grad, jg[k]) < 0.03, k


@pytest.mark.parametrize("jimpl,timpl", [("pallas_interpret", "pallas"),
                                         ("xla", "xla")],
                         ids=["pallas", "xla"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_serve_match_jax(arch, jimpl, timpl):
    """Prefill (last-token logits and the caches), then six decode steps,
    against JAX; the aux loss of the forward too."""
    jcfg, tcfg, jp, tp = both(arch, jimpl, timpl)
    B, S0, n = 2, 64, 6
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S0 + n)).astype(np.int32)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, cfg=jcfg,
                      max_len=S0 + n)
    tl, ts = models.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S0])}, cfg=tcfg, max_len=S0 + n)
    assert rel(tl, jl) < TOL
    for name in ("k", "v"):
        # layer 0 is before any routing: all of it within TOL; after it a
        # token whose choice sits within bf16 noise of a tie may take
        # another expert (and move its row by O(1)), so later layers hold
        # ROW_SHARE of the (batch, position) rows within TOL
        got = ts["kv"][name].float().numpy()
        want = np.asarray(js["kv"][name].astype(jnp.float32))
        rows = np.abs(got - want).max(axis=(-1, -2)) / np.abs(want).max(
            axis=(1, 2, 3, 4))[:, None, None]
        assert rows[0].max() < TOL
        assert (rows < TOL).mean() >= ROW_SHARE, (rows >= TOL).sum()
    np.testing.assert_array_equal(ts["kv"]["slot_pos"].numpy(),
                                  np.asarray(js["kv"]["slot_pos"]))
    for i in range(n):
        tok = toks[:, S0 + i:S0 + i + 1]
        jl, js = jserve(jp, js, jnp.asarray(tok), jnp.int32(S0 + i),
                        cfg=jcfg)
        tl, ts = models.serve_step(tp, ts, torch.from_numpy(tok), S0 + i,
                                   cfg=tcfg)
        assert rel(tl, jl) < TOL, f"decode step {i}"
    from repro.models import transformer as jtr
    _, jaux, _ = jtr.forward(jp, jcfg, tokens=jnp.asarray(toks[:, :S0]))
    _, taux, _ = ttr.forward(tp, tcfg, tokens=torch.from_numpy(toks[:, :S0]))
    assert abs(float(taux) - float(jaux)) < 0.02 * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    """The port's prefill + decode against its full forward at capacity
    4.0, where no token is dropped (tests/test_decode_consistency.py's
    setting); at capacity 0.25 the forward drops tokens and the same check
    must fail (the control)."""
    def gap(cf):
        cfg = configs.get_config(arch, reduced=True).replace(
            capacity_factor=cf)
        params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        B, S, S0 = 2, 16, 8
        tokens = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (B, S)))
        h, _, _ = models.forward(params, cfg, tokens=tokens)
        want = ttr.logits_from_hidden(params, cfg, h)[:, S0 - 1:].float()
        logits, state = models.prefill_step(
            params, {"tokens": tokens[:, :S0]}, cfg=cfg, max_len=S)
        outs = [logits[:, 0]]
        for t in range(S0, S):
            logits, state = models.serve_step(params, state,
                                              tokens[:, t:t + 1], t, cfg=cfg)
            outs.append(logits[:, 0])
        got = torch.stack(outs, dim=1).float()
        return float((got - want).abs().max()
                     / want.abs().max().clamp(min=1e-3))
    assert gap(4.0) < DECODE_REL
    assert gap(0.25) > DECODE_REL
