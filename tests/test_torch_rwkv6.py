"""The port's rwkv6 path (repro_torch.models.rwkv6, the rwkv6 branches of
models/transformer.py and kernel B9's plain version) against the JAX
package on the same numpy inputs.

Tolerances:
* WKV in f32 (B9's plain version, the wrapper on CPU tensors,
  ``reference_wkv``, ``wkv_chunked``, ``wkv_step``): within ``WKV_TOL`` =
  1e-4 absolute, tests/test_kernels.py's bound (measured gaps are ~1e-6:
  the same f32 arithmetic summed in another order).
* WKV with bf16 streams: y is rounded once from f32 on both sides, so
  elementwise within one bf16 ulp of JAX's output plus 1e-4
  (``BF16_ULP``).
* ``_ddlerp``, ``channel_mix``, the sigmoid and ``time_mix``'s shift: bit
  for bit (every bf16 op rounds as JAX's does).  ``time_mix``'s output:
  bit for bit but where the f32 WKV output, summed in another order,
  rounds to the other bf16 neighbour (under 1% of the elements, by at
  most one bf16 ulp of max|out|); its WKV state within ``WKV_TOL``.
* REDUCED rwkv6-3b ``prefill_step`` + 6 ``serve_step``s against JAX's
  (compiled: the blocks run inside ``lax.scan``), on the attention archs'
  parameter draw: 0.04 of max|logit| (``TOL``, as for the attention
  archs; measured at most 0.026).  With parameters near rwkv6's init
  (decay_base -4, so w ~ 0.98 and the state remembers ~50 tokens) JAX's
  compiled steps and the same JAX functions run op by op differ by up to
  0.043 between themselves (XLA drops bf16 round trips inside its
  fusions); there the port is held to JAX's op-by-op evaluation within
  ``OP_BY_OP_TOL`` = 0.02 (measured at most 0.011).  Decode against the
  full forward within tests/test_decode_consistency.py's 0.08.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels import rwkv6_kernel as jkernel
from repro.models import init_params as jinit
from repro.models import layers as jl
from repro.models import prefill_step as jprefill
from repro.models import rwkv6 as jr
from repro.models import serve_step as jserve
from repro.models import transformer as jtr
from repro_torch import configs, models
from repro_torch.kernels import ref, rwkv6_kernel
from repro_torch.models import rwkv6 as tr
from repro_torch.models import transformer as ttr
from test_torch_transformer import _np_params as _generic_params

WKV_TOL = 1e-4
BF16_ULP = (2.0 ** -7, 1e-4)
TOL = 0.04
OP_BY_OP_TOL = 0.02
DECODE_REL = 0.08
ARCH = "rwkv6-3b"
# tests/test_kernels.py's (S, H, K, chunk)
WKV_SHAPES = [(64, 2, 16, 16), (128, 3, 32, 32), (64, 1, 8, 8)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _wkv_inputs(B, S, H, K, seed=0, w_near_one=False):
    """r, k, v 0.5 N; w = exp(-exp(0.5 N - 1)) as tests/test_kernels.py
    draws it (or within 1e-3 of 1, some exactly 1); u 0.3 N."""
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, S, H, K).astype(np.float32) * 0.5
               for _ in range(3))
    if w_near_one:
        w = 1.0 - 1e-3 * rng.rand(B, S, H, K)
        w[..., ::5] = 1.0
    else:
        w = np.exp(-np.exp(rng.randn(B, S, H, K) * 0.5 - 1.0))
    u = rng.randn(H, K) * 0.3
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


def _both(arrays, dtypes=None):
    dtypes = dtypes or [None] * len(arrays)
    j = [jnp.asarray(a, d and jnp.bfloat16) for a, d in zip(arrays, dtypes)]
    t = [torch.from_numpy(a).to(d and torch.bfloat16 or torch.float32)
         for a, d in zip(arrays, dtypes)]
    return j, t


def _assert_bf16_close(got, want):
    got, want = _np(got), _np(want)
    rel, tol = BF16_ULP
    assert (np.abs(got - want) <= rel * np.abs(want) + tol).all(), \
        float(np.abs(got - want).max())


# ---------------- B9: the plain versions and the wrapper ----------------

@pytest.mark.parametrize("S,H,K,chunk", WKV_SHAPES)
def test_wkv_plain_and_wrapper_match_jax(S, H, K, chunk):
    """B9's plain version and ``rwkv6_kernel.wkv`` on CPU tensors against
    JAX's Pallas kernel (interpret mode), its sequential ``reference_wkv``
    and the model's ``wkv_chunked``."""
    arrays = _wkv_inputs(2, S, H, K)
    J, T = _both(arrays)
    want = {"pallas": jkernel.wkv_pallas(*J, chunk=chunk, interpret=True),
            "sequential": jref.reference_wkv(*J),
            "chunked": jr.wkv_chunked(*J, chunk=chunk)[0]}
    for got in (ref.reference_wkv_chunked(*T, chunk=chunk),
                rwkv6_kernel.wkv(*T, chunk=chunk)):
        assert got.dtype == torch.float32 and got.shape == (2, S, H, K)
        for name, y in want.items():
            assert np.abs(_np(got) - _np(y)).max() < WKV_TOL, name


def test_wkv_bf16_matches_jax():
    """bf16 r, k, v (f32 w, as time_mix passes it): y in bf16 within one
    ulp of JAX's Pallas kernel (interpret) and of the f32 sequential
    recurrence on the same rounded inputs."""
    r, k, v, w, u = _wkv_inputs(2, 128, 2, 32, seed=1)
    J, T = _both([r, k, v, w, u], [1, 1, 1, None, None])
    got = rwkv6_kernel.wkv(*T, chunk=16)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, jkernel.wkv_pallas(*J, chunk=16, interpret=True))
    _assert_bf16_close(ref.reference_wkv_chunked(*T, chunk=16),
                       jref.reference_wkv(*J))


def test_wkv_w_near_one_carries_far():
    """w within 1e-3 of 1 (and exactly 1 on every fifth channel): the
    state carries across all 16 chunks nearly undecayed."""
    arrays = _wkv_inputs(2, 256, 2, 16, seed=2, w_near_one=True)
    J, T = _both(arrays)
    want = _np(jref.reference_wkv(*J))
    got = _np(rwkv6_kernel.wkv(*T, chunk=16))
    assert np.abs(want).max() > 5.0
    assert np.abs(got - want).max() < WKV_TOL * np.abs(want).max()


def test_reference_wkv_matches_jax():
    arrays = _wkv_inputs(2, 48, 3, 16, seed=3)
    J, T = _both(arrays)
    got = ref.reference_wkv(*T)
    assert np.abs(_np(got) - _np(jref.reference_wkv(*J))).max() < 1e-5


def test_wkv_wrapper_contract():
    """chunk = min(chunk, S); S % chunk != 0 raises; mixed stream dtypes
    raise; a tensor on neither the CPU nor a CUDA card raises."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(1, 24, 1, 8))
    y = rwkv6_kernel.wkv(r, k, v, w, u, chunk=64)           # chunk -> 24
    assert torch.equal(y, ref.reference_wkv_chunked(r, k, v, w, u, chunk=24))
    with pytest.raises(ValueError, match="multiple"):
        rwkv6_kernel.wkv(r, k, v, w, u, chunk=16)
    with pytest.raises(TypeError):
        rwkv6_kernel.wkv(r, k.bfloat16(), v, w, u, chunk=8)
    with pytest.raises(RuntimeError):
        rwkv6_kernel.wkv(*(t.to("meta") for t in (r, k, v, w, u)), chunk=8)


# ---------------- models/rwkv6.py ----------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
def test_wkv_chunked_matches_jax(dt, with_s0):
    """y and the final state, from zeros or a given state."""
    r, k, v, w, u = _wkv_inputs(2, 128, 2, 16, seed=4)
    s0 = (np.random.RandomState(5).randn(2, 2, 16, 16).astype(np.float32)
          if with_s0 else None)
    low = 1 if dt == "bf16" else None
    J, T = _both([r, k, v, w, u], [low, low, low, None, None])
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    jy, js = jr.wkv_chunked(*J, js0, chunk=32)
    ty, ts = tr.wkv_chunked(*T, ts0, chunk=32)
    assert ty.dtype == T[0].dtype and ts.dtype == torch.float32
    assert np.abs(_np(ts) - _np(js)).max() < WKV_TOL
    if dt == "bf16":
        _assert_bf16_close(ty, jy)
    else:
        assert np.abs(_np(ty) - _np(jy)).max() < WKV_TOL


def test_wkv_step_matches_jax():
    rng = np.random.RandomState(6)
    r, k, v = (rng.randn(2, 3, 16).astype(np.float32) for _ in range(3))
    w = rng.rand(2, 3, 16).astype(np.float32)
    u = rng.randn(3, 16).astype(np.float32)
    st = rng.randn(2, 3, 16, 16).astype(np.float32)
    J, T = _both([r, k, v, w, u, st])
    jy, js = jr.wkv_step(*J)
    ty, ts = tr.wkv_step(*T)
    assert np.abs(_np(ty) - _np(jy)).max() < 1e-5
    assert np.abs(_np(ts) - _np(js)).max() < 1e-5


def _tm_params(D, H, K, rng):
    """time_mix parameters off their init values, so every path is live."""
    P = {"mu_base": 0.5 + 0.1 * rng.randn(D),
         "mu": 0.5 + 0.1 * rng.randn(5, D),
         "mix_w1": rng.randn(D, 5, 32) / np.sqrt(D),
         "mix_w2": rng.randn(5, 32, D) / np.sqrt(32),
         "decay_base": -4 + 0.5 * rng.randn(D),
         "decay_w1": rng.randn(D, 64) / np.sqrt(D),
         "decay_w2": rng.randn(64, D) / 8,
         "bonus": 0.5 + 0.1 * rng.randn(H, K), "ln_x": 1 + 0.1 * rng.randn(D)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        P[name] = rng.randn(D, D) / np.sqrt(D)
    return {k: v.astype(np.float32) for k, v in P.items()}


def _bf16(P):
    return ({k: jnp.asarray(v, jnp.bfloat16) for k, v in P.items()},
            {k: torch.from_numpy(v).bfloat16() for k, v in P.items()})


def test_ddlerp_matches_jax_bit_for_bit():
    rng = np.random.RandomState(7)
    jp, tp = _bf16(_tm_params(64, 4, 16, rng))
    x, xx = (rng.randn(2, 24, 64).astype(np.float32) for _ in range(2))
    want = jr._ddlerp(jp, jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(xx, jnp.bfloat16))
    got = tr._ddlerp(tp, torch.from_numpy(x).bfloat16(),
                     torch.from_numpy(xx).bfloat16())
    for g, j in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(g), _np(j))


@pytest.mark.parametrize("mode", ["prefill", "from_state", "decode"])
def test_time_mix_matches_jax(mode):
    """From zeros (prefill), from a state over 32 positions, and one decode
    step: the output and the new shift bit for bit, the WKV state within
    WKV_TOL."""
    rng = np.random.RandomState(8)
    jp, tp = _bf16(_tm_params(64, 4, 16, rng))
    S = 1 if mode == "decode" else 32
    x = rng.randn(2, S, 64).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    jst = tst = None
    if mode != "prefill":
        sh = rng.randn(2, 1, 64).astype(np.float32)
        wkv = rng.randn(2, 4, 16, 16).astype(np.float32)
        jst = {"shift": jnp.asarray(sh, jnp.bfloat16), "wkv": jnp.asarray(wkv)}
        tst = {"shift": torch.from_numpy(sh).bfloat16(),
               "wkv": torch.from_numpy(wkv)}
    jo, js = jr.time_mix(jp, jx, 4, 16, jst, chunk=16)
    to, ts = tr.time_mix(tp, tx, 4, 16, tst, chunk=16)
    got, want = _np(to), _np(jo)
    assert (got != want).mean() < 0.01
    assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    np.testing.assert_array_equal(_np(ts["shift"]), _np(js["shift"]))
    assert np.abs(_np(ts["wkv"]) - _np(js["wkv"])).max() < WKV_TOL


def test_channel_mix_matches_jax_bit_for_bit():
    rng = np.random.RandomState(9)
    P = {"mu_k": 0.5 + 0.1 * rng.randn(64), "mu_r": 0.5 + 0.1 * rng.randn(64),
         "wk": rng.randn(64, 128) / 8, "wv": rng.randn(128, 64) / np.sqrt(128),
         "wr": rng.randn(64, 64) / 8}
    jp, tp = _bf16({k: v.astype(np.float32) for k, v in P.items()})
    x = rng.randn(2, 16, 64).astype(np.float32)
    sh = rng.randn(2, 1, 64).astype(np.float32)
    for st in (None, sh):
        jst = None if st is None else {"shift": jnp.asarray(st, jnp.bfloat16)}
        tst = (None if st is None
               else {"shift": torch.from_numpy(st).bfloat16()})
        jo, js = jr.channel_mix(jp, jnp.asarray(x, jnp.bfloat16), jst)
        to, ts = tr.channel_mix(tp, torch.from_numpy(x).bfloat16(), tst)
        np.testing.assert_array_equal(_np(to), _np(jo))
        np.testing.assert_array_equal(_np(ts["shift"]), _np(js["shift"]))


def test_bf16_activations_as_jax_rounds_them():
    """``rwkv6.sigmoid`` equals ``jax.nn.sigmoid`` in bf16 bit for bit
    (``torch.sigmoid`` differs in about a third of the outputs); torch's
    bf16 tanh already equals ``jnp.tanh`` here."""
    x = (np.random.RandomState(10).randn(100_000) * 3).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    want = _np(jax.nn.sigmoid(jx))
    np.testing.assert_array_equal(_np(tr.sigmoid(tx)), want)
    assert (_np(torch.sigmoid(tx)) != want).mean() > 0.2
    np.testing.assert_array_equal(_np(torch.tanh(tx)), _np(jnp.tanh(jx)))


# ---------------- the model: REDUCED rwkv6-3b ----------------

def _model_like_params(cfg, seed=0):
    """The JAX package's rwkv6 parameter tree filled with numpy draws:
    dense weights normal / sqrt(fan_in), the norm scales 0.1 normal, the
    lerp/bonus/decay/ln_x vectors their init value plus 0.1 normal."""
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)
    base = {"mu_base": 0.5, "mu": 0.5, "mu_k": 0.5, "mu_r": 0.5,
            "decay_base": -4.0, "bonus": 0.5, "ln_x": 1.0, "scale": 0.0}

    def fill(path, leaf):
        name = path[-1].key
        if name in base:
            return (base[name] + 0.1 * rng.randn(*leaf.shape)
                    ).astype(np.float32)
        if name == "embedding":
            return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        fan = leaf.shape[-2] if name != "mix_w1" else leaf.shape[-3]
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rel(got, want):
    want = _np(want)
    got = _np(got)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


def test_prefill_and_serve_match_jax():
    """Prefill (last-token logits and every state tensor), then six decode
    steps, against JAX's steps from the same numpy parameters (the
    attention archs' draw)."""
    jcfg = jconfigs.get_config(ARCH, reduced=True)
    cfg = configs.get_config(ARCH, reduced=True)
    P = _generic_params(jcfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), P)
    tp = models.params_from_numpy(P, device="cpu")
    B, S0, n = 2, 64, 6
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S0 + n)).astype(np.int32)
    jl, js = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, cfg=jcfg,
                      max_len=S0 + n)
    tl, ts = models.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S0])}, cfg=cfg, max_len=S0 + n)
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == torch.bfloat16
    assert _rel(tl, jl) < TOL
    for mix, name in (("tm", "shift"), ("tm", "wkv"), ("cm", "shift")):
        assert ts[mix][name].dtype == (torch.float32 if name == "wkv"
                                       else torch.bfloat16)
        assert _rel(ts[mix][name], js[mix][name]) < TOL, (mix, name)
    for i in range(n):
        tok = toks[:, S0 + i:S0 + i + 1]
        jl, js = jserve(jp, js, jnp.asarray(tok), jnp.int32(S0 + i), cfg=jcfg)
        tl, ts = models.serve_step(tp, ts, torch.from_numpy(tok), S0 + i,
                                   cfg=cfg)
        assert _rel(tl, jl) < TOL, f"decode step {i}"
    assert _rel(ts["tm"]["wkv"], js["tm"]["wkv"]) < TOL


def test_prefill_and_serve_match_jax_op_by_op():
    """With parameters near rwkv6's init: prefill + six decode steps
    against the JAX package's own block, norm and logit functions run op
    by op over the same states (``_rwkv_block_apply`` layer by layer)."""
    jcfg = jconfigs.get_config(ARCH, reduced=True)
    cfg = configs.get_config(ARCH, reduced=True)
    P = _model_like_params(jcfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), P)
    tp = models.params_from_numpy(P, device="cpu")

    def jax_op_by_op(tokens, states):
        x = jl.embed(jp["embed"], jnp.asarray(tokens))
        new = []
        for i in range(jcfg.n_layers):
            p = jax.tree.map(lambda t: t[i], jp["blocks"])
            x, st = jtr._rwkv_block_apply(
                p, x, jcfg, state=None if states is None else states[i])
            new.append(st)
        x = jl.rmsnorm(jp["final_norm"], x)
        return jtr.logits_from_hidden(jp, jcfg, x[:, -1:]), new

    B, S0, n = 2, 64, 6
    toks = np.random.RandomState(1).randint(
        0, jcfg.vocab_size, (B, S0 + n)).astype(np.int32)
    jlog, js = jax_op_by_op(toks[:, :S0], None)
    tlog, ts = models.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S0])}, cfg=cfg, max_len=S0 + n)
    assert _rel(tlog, jlog) < OP_BY_OP_TOL
    for i in range(n):
        tok = toks[:, S0 + i:S0 + i + 1]
        jlog, js = jax_op_by_op(tok, js)
        tlog, ts = models.serve_step(tp, ts, torch.from_numpy(tok), S0 + i,
                                     cfg=cfg)
        assert _rel(tlog, jlog) < OP_BY_OP_TOL, f"decode step {i}"


def test_decode_matches_forward():
    """Prefill + step-by-step decode against the full forward, as
    tests/test_decode_consistency.py checks JAX; the decode state is
    written in place and returned."""
    cfg = configs.get_config(ARCH, reduced=True)
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
        logits, new = models.serve_step(params, state, tokens[:, t:t + 1], t,
                                        cfg=cfg)
        assert new is state
        outs.append(logits[:, 0])
    got = torch.stack(outs, dim=1).float()
    err = (got - want).abs().max() / want.abs().max().clamp(min=1e-3)
    assert float(err) < DECODE_REL, f"decode diverges ({err:.3f})"


def test_params_and_decode_state_match_jax_layout():
    """init_params, params_from_numpy and init_decode_state give JAX's
    keys, shapes and dtypes (the parameters all bf16)."""
    jcfg = jconfigs.get_config(ARCH, reduced=True)
    cfg = configs.get_config(ARCH, reduced=True)
    want = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
        lambda: jinit(jax.random.PRNGKey(0), jcfg)))
    for tree in (models.params_from_numpy(_model_like_params(jcfg),
                                          device="cpu"),
                 models.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")):
        assert jax.tree.map(lambda t: tuple(t.shape), tree) == want
        assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(tree))
    want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                        jax.eval_shape(lambda: jtr.init_decode_state(
                            jcfg, 2, 40)))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       ttr.init_decode_state(cfg, 2, 40, device="cpu"))
    assert got == want


def test_init_params_values_follow_jax_init():
    """The constant leaves take JAX's init values; the LoRA factors are
    scaled by 0.1 (their std is a tenth of a dense weight's)."""
    cfg = configs.get_config(ARCH, reduced=True)
    p = models.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")["blocks"]["rwkv"]
    for name, value in (("mu_base", 0.5), ("mu", 0.5), ("decay_base", -4.0),
                        ("bonus", 0.5), ("ln_x", 1.0)):
        assert bool((p["tm"][name] == value).all()), name
    d = cfg.d_model
    std = p["tm"]["mix_w1"].float().std() * np.sqrt(d)
    assert 0.08 < float(std) < 0.12
    assert 0.9 < float(p["tm"]["wr"].float().std() * np.sqrt(d)) < 1.1
