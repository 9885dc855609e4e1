"""The port's mamba2 block (repro_torch.models.mamba2) and zamba2's hybrid
stack (the mamba2 branches of models/transformer.py) against the JAX
package on the same numpy inputs, at the REDUCED zamba2-7b config.

Tolerances:
* ``_causal_conv`` in bf16: bit for bit (every op rounds in bf16 on both
  sides); in f32 within 1e-6.
* ``ssd_chunked`` (from zero and from a state s0) and ``ssd_step`` in
  f32: y and the state within ``SSD_TOL`` = 1e-5 of their largest |value|
  (the same f32 arithmetic summed in another order); a state carried
  wrongly (s0 ignored, or the carry not decayed) must fail.
* ``mamba2_apply`` in bf16: 0.02 of max|out| (the bf16 projections round
  alike; the f32 scan sums in another order).
* zamba2 prefill + 6 decode steps: 0.04 of max|logit| (``TOL``, as for
  the other archs) for the logits and every state tensor; decode against
  the port's own full forward within tests/test_decode_consistency.py's
  0.08 (mixtral at capacity 4.0, where nothing drops), and with the SSM
  state zeroed after the prefill, or group 0's shared-attention cache
  used for every group, the same check must fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as jinit
from repro.models import mamba2 as jm
from repro.models import prefill_step as jprefill
from repro.models import serve_step as jserve
from repro.models import transformer as jtr
from repro_torch import configs, models
from repro_torch.models import mamba2 as tm
from repro_torch.models import transformer as ttr
from torch_lm_common import both, np_params, rel

TOL = 0.04
DECODE_REL = 0.08
SSD_TOL = 1e-5
ARCH = "zamba2-7b"


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    got = got.float().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)) \
        <= tol


def _ssd_inputs(seed=0, B=2, S=64, nh=3, hd=8, n=16):
    rng = np.random.RandomState(seed)
    xh = rng.randn(B, S, nh, hd).astype(np.float32)
    Bm = rng.randn(B, S, n).astype(np.float32) * 0.5
    Cm = rng.randn(B, S, n).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.randn(B, S, nh))).astype(np.float32) * 0.5
    la = (-dt * np.exp(0.3 * rng.randn(nh))).astype(np.float32)
    s0 = rng.randn(B, nh, hd, n).astype(np.float32)
    return xh, Bm, Cm, dt, la, s0


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(dt, with_state):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 24).astype(np.float32)
    w = (0.2 * rng.randn(tm.CONV_K, 24)).astype(np.float32)
    b = (0.1 * rng.randn(24)).astype(np.float32)
    st = rng.randn(2, tm.CONV_K - 1, 24).astype(np.float32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    jy, js = jm._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                             jnp.asarray(b, jdt),
                             jnp.asarray(st, jdt) if with_state else None)
    ty, ts = tm._causal_conv(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt),
                             torch.from_numpy(b).to(tdt),
                             torch.from_numpy(st).to(tdt) if with_state
                             else None)
    if dt == "bfloat16":
        np.testing.assert_array_equal(ty.float().numpy(), _np(jy))
    else:
        np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.float().numpy(), _np(js))


@pytest.mark.parametrize("chunk,S", [(32, 64), (16, 64), (32, 32), (8, 24)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_ssd_chunked_matches_jax(chunk, S, with_s0):
    xh, Bm, Cm, dt, la, s0 = _ssd_inputs(S=S)
    s0 = s0 if with_s0 else None
    jy, js = jm.ssd_chunked(*(jnp.asarray(a) for a in (xh, Bm, Cm, dt, la)),
                            None if s0 is None else jnp.asarray(s0),
                            chunk=chunk)
    t = [torch.from_numpy(a) for a in (xh, Bm, Cm, dt, la)]
    ty, ts = tm.ssd_chunked(*t, None if s0 is None else torch.from_numpy(s0),
                            chunk=chunk)
    assert ty.dtype == torch.float32 and ts.shape == (2, 3, 8, 16)
    assert _close(ty, jy, SSD_TOL) and _close(ts, js, SSD_TOL)
    if with_s0:
        # controls: s0 ignored (the early positions read it; by the end
        # it has decayed away), and the carry handed on undecayed
        ny, _ = tm.ssd_chunked(*t, None, chunk=chunk)
        assert not _close(ny, jy, SSD_TOL)
        zla = torch.zeros_like(t[4])
        uy, _ = tm.ssd_chunked(*t[:4], zla, torch.from_numpy(s0),
                               chunk=chunk)
        assert not _close(uy, jy, SSD_TOL)


def test_ssd_chunked_raises_on_ragged_chunks():
    xh, Bm, Cm, dt, la, _ = _ssd_inputs(S=40)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(*(torch.from_numpy(a) for a in (xh, Bm, Cm, dt, la)),
                       chunk=32)


def test_ssd_step_matches_jax_and_the_scan():
    """Eight steps of ``ssd_step`` equal JAX's, and equal one
    ``ssd_chunked`` over the same eight positions from the same state."""
    xh, Bm, Cm, dt, la, s0 = _ssd_inputs(S=8)
    js, ts = jnp.asarray(s0), torch.from_numpy(s0)
    ys = []
    for t in range(8):
        args = [a[:, t] for a in (xh, Bm, Cm, dt, la)]
        jy, js = jm.ssd_step(*(jnp.asarray(a) for a in args), js)
        ty, ts = tm.ssd_step(*(torch.from_numpy(a) for a in args), ts)
        assert _close(ty, jy, SSD_TOL)
        ys.append(ty)
    assert _close(ts, js, SSD_TOL)
    cy, cs = tm.ssd_chunked(*(torch.from_numpy(a)
                              for a in (xh, Bm, Cm, dt, la)),
                            torch.from_numpy(s0), chunk=8)
    assert torch.allclose(torch.stack(ys, 1), cy, atol=1e-4, rtol=1e-4)
    assert torch.allclose(ts, cs, atol=1e-4, rtol=1e-4)


def _mamba_params(seed=0):
    cfg = configs.get_config(ARCH, reduced=True)
    P = np_params(cfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0, 0], jnp.bfloat16),
                      P["blocks"]["mamba"])
    tp = models.params_from_numpy(
        jax.tree.map(lambda a: a[0, 0], P["blocks"]["mamba"]), device="cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("decode", [False, True])
def test_mamba2_apply_matches_jax(decode):
    cfg, jp, tp = _mamba_params()
    kw = dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
              n_state=cfg.ssm_state)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 1 if decode else 64, cfg.d_model).astype(np.float32)
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    st = {"conv_x": rng.randn(2, 3, d_in), "conv_bc": rng.randn(
        2, 3, 2 * cfg.ssm_state), "ssm": rng.randn(
            2, nh, cfg.ssm_head_dim, cfg.ssm_state)}
    jst = ({k: jnp.asarray(v, jnp.float32 if k == "ssm" else jnp.bfloat16)
            for k, v in st.items()} if decode else None)
    tst = ({k: torch.from_numpy(v).to(torch.float32 if k == "ssm"
                                      else torch.bfloat16)
            for k, v in st.items()} if decode else None)
    jy, jns = jm.mamba2_apply(jp, jnp.asarray(x, jnp.bfloat16), state=jst,
                              **kw)
    ty, tns = tm.mamba2_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                              state=tst, **kw)
    assert ty.dtype == torch.bfloat16
    assert rel(ty, jy) < 0.02
    for k in ("conv_x", "conv_bc"):
        np.testing.assert_array_equal(tns[k].float().numpy(), _np(jns[k]))
    assert rel(tns["ssm"], jns["ssm"]) < 1e-3


def test_init_params_and_decode_state_match_jax_shapes():
    jcfg = configs.get_config(ARCH, reduced=True)
    want = jax.tree.map(lambda s: (tuple(s.shape), "bfloat16"),
                        jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                                     jcfg)))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       models.init_params(torch.Generator().manual_seed(0),
                                          jcfg, device="cpu"))
    assert got == want
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        jax.eval_shape(lambda: jtr.init_decode_state(
                            jcfg, 2, 40)))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       ttr.init_decode_state(jcfg, 2, 40, device="cpu"))
    assert got == want


@pytest.mark.parametrize("jimpl,timpl", [("pallas_interpret", "pallas"),
                                         ("xla", "xla")],
                         ids=["pallas", "xla"])
def test_prefill_and_serve_match_jax(jimpl, timpl):
    """Prefill (last-token logits and every state tensor: the groups' conv
    and SSM states, the shared caches, the tail), then six decode steps."""
    jcfg, tcfg, jp, tp = both(ARCH, jimpl, timpl)
    B, S0, n = 2, 64, 6
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S0 + n)).astype(np.int32)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, cfg=jcfg,
                      max_len=S0 + n)
    tl, ts = models.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S0])}, cfg=tcfg, max_len=S0 + n)
    assert rel(tl, jl) < TOL
    for part in ("groups", "tail") if "tail" in js else ("groups",):
        for name in ("conv_x", "conv_bc", "ssm"):
            assert rel(ts[part][name], js[part][name]) < TOL, (part, name)
    for name in ("k", "v"):
        assert rel(ts["shared_kv"][name], js["shared_kv"][name]) < TOL
    np.testing.assert_array_equal(ts["shared_kv"]["slot_pos"].numpy(),
                                  np.asarray(js["shared_kv"]["slot_pos"]))
    for i in range(n):
        tok = toks[:, S0 + i:S0 + i + 1]
        jl, js = jserve(jp, js, jnp.asarray(tok), jnp.int32(S0 + i),
                        cfg=jcfg)
        tl, ts = models.serve_step(tp, ts, torch.from_numpy(tok), S0 + i,
                                   cfg=tcfg)
        assert rel(tl, jl) < TOL, f"decode step {i}"
    assert rel(ts["groups"]["ssm"], js["groups"]["ssm"]) < TOL


def _decode_gap(arch, impl, fault=None):
    """max |decode - forward| / max |forward| over the logits at positions
    S0-1 .. S-1 of the port's own prefill + decode; ``fault`` corrupts the
    state after the prefill (a control)."""
    cfg = configs.get_config(arch, reduced=True).replace(attn_impl=impl)
    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=4.0)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    B, S, S0 = 2, 16, 8
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S)))
    h, _, _ = models.forward(params, cfg, tokens=tokens)
    want = ttr.logits_from_hidden(params, cfg, h)[:, S0 - 1:].float()
    logits, state = models.prefill_step(params, {"tokens": tokens[:, :S0]},
                                        cfg=cfg, max_len=S)
    if fault == "ssm zeroed":
        state["groups"]["ssm"].zero_()
    elif fault == "group 0's shared cache":
        for name in ("k", "v", "slot_pos"):
            state["shared_kv"][name][1:] = state["shared_kv"][name][0]
    outs = [logits[:, 0]]
    for t in range(S0, S):
        logits, state = models.serve_step(params, state, tokens[:, t:t + 1],
                                          t, cfg=cfg)
        outs.append(logits[:, 0])
    got = torch.stack(outs, dim=1).float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-3))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x22b"])
def test_decode_matches_forward(arch, impl):
    assert _decode_gap(arch, impl) < DECODE_REL


@pytest.mark.parametrize("fault", ["ssm zeroed", "group 0's shared cache"])
def test_decode_check_catches_state_faults(fault):
    assert _decode_gap(ARCH, "xla", fault) > DECODE_REL
