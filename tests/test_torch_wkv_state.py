"""B9's state form on the CPU: its plain version
(``ref.reference_wkv_chunked`` from ``s0``, returning the final state) and
the wrapper ``rwkv6_kernel.wkv_state`` on CPU tensors against the JAX
package's ``repro.models.rwkv6.wkv_chunked`` on the same numpy inputs, at
the model's chunk of 64 and at 16; and the model's dispatch of prefill's
recurrence (the plain loop on the CPU, B9 on any other device).

Tolerances.  f32: y within ``WKV_TOL`` = 1e-4 absolute
(tests/test_kernels.py's bound), the final state within ``STATE_TOL`` =
1e-5 of its largest |entry|: both sides compute in f32 and differ only in
the order of sums (and in the cumsum, which torch's CPU accumulates in f64
and rounds once a position).  bf16 streams: y is rounded once from f32 on
both sides, so within one bf16 ulp of JAX's output plus 1e-4; the state
as in f32.  Inputs: r, k, v 0.5 N; w = exp(-exp(0.5 N - 1)), with one
decay in 20 at or below the 1e-12 clip (log w down to -40) and one in 20
exactly 1; u 0.5 + 0.1 N; s0 1.25 N.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jr
from repro_torch.kernels import ref, rwkv6_kernel
from repro_torch.models import rwkv6 as tr

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

WKV_TOL = 1e-4
STATE_TOL = 1e-5
BF16_ULP = (2.0 ** -7, 1e-4)


def _inputs(B, S, H, K, seed=0, clip=True):
    rng = np.random.RandomState(seed)
    r, k, v = (0.5 * rng.randn(B, S, H, K) for _ in range(3))
    lw = -np.exp(0.5 * rng.randn(B, S, H, K) - 1.0)
    if clip:
        m = rng.rand(B, S, H, K)
        lw[m < 0.05] = -40.0                  # w = 4e-18, clipped to 1e-12
        lw[m > 0.95] = 0.0                    # w = 1
    u = 0.5 + 0.1 * rng.randn(H, K)
    s0 = 1.25 * rng.randn(B, H, K, K)
    return [a.astype(np.float32) for a in (r, k, v, np.exp(lw), u, s0)]


def _torch(arrays, low):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrays)
    if low:
        r, k, v = (t.bfloat16() for t in (r, k, v))
    return r, k, v, w, u, s0


def _jax(arrays, low):
    r, k, v, w, u, s0 = (jnp.asarray(a) for a in arrays)
    if low:
        r, k, v = (t.astype(jnp.bfloat16) for t in (r, k, v))
    return r, k, v, w, u, s0


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_y(got, want, low):
    got, want = _np(got), _np(want)
    if low:
        rel, tol = BF16_ULP
        assert (np.abs(got - want) <= rel * np.abs(want) + tol).all(), \
            float(np.abs(got - want).max())
    else:
        assert np.abs(got - want).max() < WKV_TOL


def _assert_state(got, want):
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= STATE_TOL * np.abs(want).max()


@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zeros"])
@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("chunk", [64, 16])
def test_state_form_matches_jax(chunk, low, with_s0):
    """y and the final state of the plain version and of the wrapper on
    CPU tensors, against JAX's wkv_chunked, over 4 chunks of 64 (16 of
    16) with decays at the clip."""
    arrays = _inputs(2, 256, 2, 16, seed=chunk + low)
    jargs, targs = _jax(arrays, low), _torch(arrays, low)
    js0 = jargs[5] if with_s0 else None
    ts0 = targs[5] if with_s0 else None
    jy, js = jr.wkv_chunked(*jargs[:5], js0, chunk=chunk)
    for ty, ts in (ref.reference_wkv_chunked(*targs[:5], chunk=chunk, s0=ts0,
                                             return_state=True),
                   rwkv6_kernel.wkv_state(*targs[:5], ts0, chunk=chunk)):
        assert ty.dtype == targs[0].dtype and ts.dtype == torch.float32
        assert ts.shape == (2, 2, 16, 16)
        _assert_y(ty, jy, low)
        _assert_state(ts, js)


def _loop(r, k, v, w, u, chunk, s0=None, dt=torch.float32):
    """The plain loop as ``reference_wkv_chunked`` computed it before it
    took ``s0``, in ``dt``, from ``s0``: (y, final state)."""
    B, S, H, K = r.shape
    C = min(chunk, S)
    uf = u.to(dt)[None, :, None, :]
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool),
                     diagonal=-1)[None, None, :, :, None]
    state = (torch.zeros((B, H, K, K), dtype=dt) if s0 is None
             else s0.to(dt))
    ys = []
    for c0 in range(0, S, C):
        rb, kb, vb, wb = (t[:, c0:c0 + C].transpose(1, 2).to(dt)
                          for t in (r, k, v, w))
        lw = torch.log(torch.clamp(wb, 1e-12, 1.0))
        A = torch.cumsum(lw, dim=2) - lw
        Atot = A[:, :, -1] + lw[:, :, -1]
        D = A[:, :, :, None, :] - A[:, :, None, :, :] - lw[:, :, None, :, :]
        E = torch.where(tri, torch.exp(D), 0.0)
        scores = torch.einsum("bhtk,bhtik,bhik->bhti", rb, E, kb)
        diag = torch.sum(rb * uf * kb, dim=-1)
        y = scores @ vb + diag[..., None] * vb
        y = y + (rb * torch.exp(A)) @ state
        kdec = kb * torch.exp(Atot[:, :, None, :] - A - lw)
        state = state * torch.exp(Atot)[..., None] + \
            kdec.transpose(2, 3) @ vb
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1).to(r.dtype), state


def test_state_form_at_the_models_head_size():
    """rwkv6-3b's head size (K = 64) at its chunk, f32, with decays at the
    clip, where A reaches -88 and every exp of a difference of A's carries
    f32 rounding of ~ulp(88) = 8e-6 relative: the plain version and JAX
    are each held within STATE_TOL of the same loop in f64 (the limit is
    the f32 function's own accuracy, not the two frameworks' agreement)."""
    arrays = _inputs(1, 128, 2, 64, seed=5)
    r, k, v, w, u, s0 = _torch(arrays, False)
    _, exact = _loop(r, k, v, w, u, 64, s0, torch.float64)
    jy, js = jr.wkv_chunked(*_jax(arrays, False), chunk=64)
    ty, ts = rwkv6_kernel.wkv_state(r, k, v, w, u, s0, chunk=64)
    _assert_y(ty, jy, False)
    for got in (ts, js):
        _assert_state(got, exact)


@pytest.mark.parametrize("low", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (24, 64)])
def test_zero_state_form_unchanged(S, chunk, low):
    """Without s0 the plain version returns y alone, bit for bit as
    before, and equals the state form from zeros."""
    r, k, v, w, u, _ = _torch(_inputs(2, S, 3, 16, seed=S), low)
    y = ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk)
    assert isinstance(y, torch.Tensor)
    assert torch.equal(y, _loop(r, k, v, w, u, chunk)[0])
    zeros = torch.zeros(2, 3, 16, 16)
    for s0 in (None, zeros):
        ys, _ = ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk, s0=s0,
                                          return_state=True)
        assert torch.equal(ys, y)
    assert torch.equal(rwkv6_kernel.wkv(r, k, v, w, u, chunk=chunk), y)


def test_wkv_state_contract():
    """s0 is only read and the state is a new tensor; a wrong s0 shape,
    mixed stream dtypes and a chunk that does not divide S raise; a tensor
    on neither the CPU nor a CUDA card raises."""
    r, k, v, w, u, s0 = _torch(_inputs(1, 32, 2, 8, seed=1), False)
    kept = s0.clone()
    y, st = rwkv6_kernel.wkv_state(r, k, v, w, u, s0, chunk=64)  # chunk 32
    assert torch.equal(s0, kept) and st.data_ptr() != s0.data_ptr()
    want = ref.reference_wkv_chunked(r, k, v, w, u, chunk=32, s0=s0,
                                     return_state=True)
    assert torch.equal(y, want[0]) and torch.equal(st, want[1])
    with pytest.raises(ValueError, match="s0"):
        rwkv6_kernel.wkv_state(r, k, v, w, u, s0[:, :1])
    with pytest.raises(TypeError):
        rwkv6_kernel.wkv_state(r, k.bfloat16(), v, w, u, s0)
    with pytest.raises(ValueError, match="multiple"):
        rwkv6_kernel.wkv_state(r, k, v, w, u, s0, chunk=12)
    with pytest.raises(RuntimeError):
        rwkv6_kernel.wkv_state(*(t.to("meta") for t in (r, k, v, w, u, s0)))


def test_rows_aligned_copies_only_what_the_kernel_cannot_read():
    """A view whose rows start on 16 bytes is passed as it is; an offset
    view, or one strided along K, is copied contiguous."""
    base = torch.randn(2, 8, 3, 3 * 16).bfloat16()
    view = base[..., 16:32]                       # 32-byte offset rows
    assert rwkv6_kernel.rows_aligned(view) is view
    odd = base[..., 1:17]                          # 2-byte offset
    for t in (odd, base[..., ::3]):
        c = rwkv6_kernel.rows_aligned(t)
        assert c.is_contiguous() and c.data_ptr() % 16 == 0
        assert torch.equal(c, t)


def test_time_mix_sends_other_devices_to_b9(monkeypatch):
    """A CPU tensor runs the plain wkv_chunked (never B9's wrapper);
    any other device goes to B9's state form at the model's chunk."""
    calls = []

    def fake(r, k, v, w, u, s0=None, *, chunk):
        calls.append((r.device.type, chunk))
        B, S, H, K = r.shape
        return (torch.zeros_like(r),
                torch.zeros((B, H, K, K), device=r.device))
    monkeypatch.setattr(tr.rwkv6_kernel, "wkv_state", fake)
    rng = np.random.RandomState(3)
    D, H, K = 32, 2, 16
    tm = {"mu_base": torch.full((D,), 0.5), "mu": torch.full((5, D), 0.5),
          "mix_w1": torch.from_numpy(rng.randn(D, 5, 32).astype(np.float32)),
          "mix_w2": torch.from_numpy(rng.randn(5, 32, D).astype(np.float32)),
          "decay_base": torch.full((D,), -4.0),
          "decay_w1": torch.from_numpy(rng.randn(D, 64).astype(np.float32)),
          "decay_w2": torch.from_numpy(rng.randn(64, D).astype(np.float32)),
          "bonus": torch.full((H, K), 0.5), "ln_x": torch.ones(D)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        tm[name] = torch.from_numpy(rng.randn(D, D).astype(np.float32))
    tm = {n: t.bfloat16() for n, t in tm.items()}
    x = torch.from_numpy(rng.randn(2, 64, D).astype(np.float32)).bfloat16()
    out, st = tr.time_mix(tm, x, H, K)
    assert calls == [] and torch.isfinite(out.float()).all()
    tr.time_mix({n: t.to("meta") for n, t in tm.items()}, x.to("meta"), H, K)
    assert calls == [("meta", 64)]


@pytest.mark.parametrize("fault", chip_smoke.WKV_STATE_FAULTS)
def test_chip_smoke_state_faults_fail_its_limits(fault):
    """chip_smoke.py's controls, with the plain version standing in for the
    kernel: each fault moves y or the final state past the card's limits
    (WKV_TOL, WKV_STATE_TOL) at its inputs (w ~ 0.98, s0 1.25 N, three
    chunks of 64)."""
    g = torch.Generator().manual_seed(0)
    r, k, v, w, u = chip_smoke.wkv_inputs(g, 1, 192, 2, 16, torch.float32)
    s0 = 1.25 * torch.randn(1, 2, 16, 16, generator=g)
    y, st = ref.reference_wkv_chunked(r, k, v, w, u, chunk=64, s0=s0,
                                      return_state=True)
    by, bst = chip_smoke.wkv_fault_state(fault, r, k, v, w, u, 64, s0)
    assert max(chip_smoke.wkv_ratio(y, by),
               chip_smoke.state_ratio(st, bst)) > 1.0
    assert chip_smoke.wkv_ratio(y, y) == 0.0
    assert chip_smoke.state_ratio(st, st) == 0.0
