"""The port's attention (repro_torch.kernels.flash_attention and
repro_torch.models.attention) against the JAX package on the same numpy
inputs.

On the CPU the flash-attention wrapper runs the kernel's plain version
(``ref.reference_flash_attention``); tests/test_torch_cuda.py holds the
CUDA kernel against it on the card.

Tolerances are those of tests/test_kernels.py and tests/test_attention.py
(ROADMAP (b)): 2e-5 absolute in f32, where only the order of the f32 sums
differs; 3e-2 absolute in bf16, where the output is rounded to bf16 (one
ulp is 2^-8 relative) and ``mha_chunked``, ``naive_attention`` and
``decode_attention`` also round P to bf16 before PV.
"""
import math
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention as tattn

# chip_smoke.py holds B8's card limit (FLASH_TOL, flash_ratio)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

F32_TOL, BF16_TOL = 2e-5, 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _qkv(seed, B=2, S=128, H=4, Kv=2, D=32):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, n, D).astype(np.float32)
                 for n in (H, Kv, Kv))


def _jax(arrs, dtype):
    return tuple(jnp.asarray(a, dtype) for a in arrs)


def _torch(arrs, dtype):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _gap(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


# ---------------- B8: the flash-attention kernel's plain version -----------

@pytest.mark.parametrize("S,H,Kv,D", [(128, 4, 2, 32), (256, 2, 1, 64),
                                      (64, 8, 8, 16)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_matches_pallas_and_reference(S, H, Kv, D, dt):
    """tests/test_kernels.py's shapes and dtypes: the plain version against
    JAX's Pallas kernel (interpret mode) and JAX's O(S^2) reference."""
    jdt, tdt, tol = DTYPES[dt]
    arrs = _qkv(0, S=S, H=H, Kv=Kv, D=D)
    q, k, v = _jax(arrs, jdt)
    pallas = jfa.flash_attention(q, k, v, block_q=64, block_k=64,
                                 interpret=True)
    expect = jref.reference_attention(*(t.astype(jnp.float32)
                                        for t in (q, k, v)))
    got = fa.flash_attention(*_torch(arrs, tdt))
    assert got.dtype == tdt and got.shape == (2, S, H, D)
    assert _gap(got, expect) < tol
    assert _gap(got, pallas) < tol


@pytest.mark.parametrize("window,cap", [(32, 0.0), (0, 30.0), (64, 50.0)])
def test_flash_plain_window_softcap(window, cap):
    arrs = _qkv(1, B=1, S=128, H=4, Kv=2, D=32)
    q, k, v = _jax(arrs, jnp.float32)
    pallas = jfa.flash_attention(q, k, v, window=window, softcap=cap,
                                 block_q=32, block_k=32, interpret=True)
    expect = jref.reference_attention(q, k, v, window=window, softcap=cap)
    got = fa.flash_attention(*_torch(arrs, torch.float32), window=window,
                             softcap=cap)
    assert _gap(got, expect) < F32_TOL
    assert _gap(got, pallas) < F32_TOL


@pytest.mark.parametrize("D,dt", [(256, "f32"), (256, "bf16"), (128, "f32"),
                                  (112, "f32"), (112, "bf16")])
def test_flash_plain_at_model_head_dims(D, dt):
    """gemma2's head_dim (256, window + softcap), yi's (128) and zamba2's
    (112 = 7 x 16, which the tensor-core body pads to two 64-column
    chunks), where the kernel's KV tile is 32 and 64 keys."""
    jdt, tdt, tol = DTYPES[dt]
    window, cap = (48, 50.0) if D == 256 else (0, 0.0)
    arrs = _qkv(2, B=1, S=128, H=4, Kv=2, D=D)
    q, k, v = _jax(arrs, jdt)
    pallas = jfa.flash_attention(q, k, v, window=window, softcap=cap,
                                 block_q=64, block_k=64, interpret=True)
    expect = jref.reference_attention(*(t.astype(jnp.float32)
                                        for t in (q, k, v)),
                                      window=window, softcap=cap)
    got = fa.flash_attention(*_torch(arrs, tdt), window=window, softcap=cap)
    assert _gap(got, expect) < tol
    assert _gap(got, pallas) < tol


@pytest.mark.parametrize("S,window", [(100, 0), (77, 24), (130, 64)])
def test_flash_plain_ragged_length(S, window):
    """S not a multiple of the KV tile (JAX's kernel asserts instead): the
    tail tile is partial and nothing past S leaks in."""
    arrs = _qkv(3, B=2, S=S, H=4, Kv=2, D=32)
    expect = jref.reference_attention(*_jax(arrs, jnp.float32),
                                      window=window, softcap=30.0)
    got = fa.flash_attention(*_torch(arrs, torch.float32), window=window,
                             softcap=30.0)
    assert _gap(got, expect) < F32_TOL


def test_flash_plain_non_causal_window():
    """causal=False keeps only the window's lower edge, as the JAX kernel
    does (its hi is then the last tile)."""
    arrs = _qkv(4, B=1, S=128, H=2, Kv=1, D=16)
    q, k, v = _jax(arrs, jnp.float32)
    pallas = jfa.flash_attention(q, k, v, causal=False, window=40,
                                 block_q=32, block_k=32, interpret=True)
    got = fa.flash_attention(*_torch(arrs, torch.float32), causal=False,
                             window=40)
    assert _gap(got, pallas) < F32_TOL


def test_reference_attention_matches_jax():
    arrs = _qkv(5, S=96, H=6, Kv=2, D=16)
    for window, cap in ((0, 0.0), (24, 50.0)):
        expect = jref.reference_attention(*_jax(arrs, jnp.float32),
                                          window=window, softcap=cap)
        got = ref.reference_attention(*_torch(arrs, torch.float32),
                                      window=window, softcap=cap)
        assert _gap(got, expect) < F32_TOL


def test_flash_on_cpu_counts_no_launch():
    n0 = dict(fa.LAUNCHES)
    fa.flash_attention(*_torch(_qkv(6, S=64), torch.float32))
    fa.flash_attention(*_torch(_qkv(6, S=64, D=64), torch.bfloat16))
    assert fa.LAUNCHES == n0


def _wgmma_emulation(q, k, v, *, window=0, softcap=0.0, block_k=64,
                     split_p=True):
    """The arithmetic of B8's tensor-core body for bf16 (causal), in plain
    PyTorch: S = q k^T from the bf16 values with f32 sums (a bf16 x bf16
    product is exact in f32), scaled by 1/sqrt(D) afterwards; softcap,
    mask and online softmax in f32 over KV tiles of ``block_k``; P V as
    ``p_hi V + p_lo V`` with ``p_hi = bf16(p)``, ``p_lo = bf16(p - p_hi)``.
    ``split_p=False`` takes a single bf16 P instead (the control)."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    f32 = torch.float32
    qf = q.to(f32).reshape(B, S, Kv, H // Kv, D)
    m = torch.full((B, Kv, H // Kv, S), ref.NEG_INF)
    l = torch.zeros((B, Kv, H // Kv, S))
    acc = torch.zeros((B, Kv, H // Kv, S, D))
    pos = torch.arange(S)
    for k0 in range(0, S, block_k):
        kb, vb = (t[:, k0:k0 + block_k].to(f32) for t in (k, v))
        s = torch.einsum("bsgrd,bkgd->bgrsk", qf, kb) * (1.0 / math.sqrt(D))
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(ref.attention_mask(pos, pos[k0:k0 + block_k], True,
                                           window), s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        p_hi = p.to(torch.bfloat16).to(f32)
        parts = [p_hi]
        if split_p:
            parts.append((p - p_hi).to(torch.bfloat16).to(f32))
        acc = acc * corr[..., None]
        for part in parts:
            acc = acc + torch.einsum("bgrsk,bkgd->bgrsd", part, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


# (B, S, H, Kv, D, window, softcap): D 64/112/128/256, GQA rep 1/2/8,
# windows whose edge falls inside a 64-key tile, softcap on and off, ragged
# S; at D = 112 the scale 1/sqrt(112) is applied late, as at 128
WGMMA_CASES = [
    (1, 128, 2, 2, 64, 0, 0.0),
    (1, 130, 4, 2, 128, 40, 50.0),
    (1, 96, 8, 1, 256, 0, 50.0),
    (2, 200, 8, 1, 64, 72, 0.0),
    (1, 160, 4, 2, 256, 100, 30.0),
    (1, 77, 2, 1, 128, 0, 0.0),
    (1, 130, 4, 2, 112, 40, 50.0),
    (2, 77, 2, 2, 112, 0, 0.0),
]


@pytest.mark.parametrize("B,S,H,Kv,D,window,cap", WGMMA_CASES)
def test_flash_tensor_core_arithmetic_within_card_limit(B, S, H, Kv, D,
                                                        window, cap):
    """B8's bf16 tensor-core arithmetic (bf16 products, f32 sums, late
    scale, P as p_hi + p_lo) stays within chip_smoke's bf16 limit of the
    plain version, with q at 8x; a single bf16 P exceeds it."""
    rng = np.random.RandomState(S + D)
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, D).astype(np.float32)
                                * sc).to(torch.bfloat16)
               for n, sc in ((H, chip_smoke.FLASH_Q_SCALE), (Kv, 1),
                             (Kv, 1)))
    want = ref.reference_flash_attention(q, k, v, window=window, softcap=cap)
    got = _wgmma_emulation(q, k, v, window=window, softcap=cap)
    assert chip_smoke.flash_ratio(got, want) <= 1.0
    single = _wgmma_emulation(q, k, v, window=window, softcap=cap,
                              split_p=False)
    assert chip_smoke.flash_ratio(single, want) > 1.0


@pytest.mark.parametrize("fault", chip_smoke.FLASH_FAULTS["zamba2-7b"])
def test_flash_controls_at_head_dim_112_exceed_card_limit(fault):
    """chip_smoke's controls at zamba2-7b's head dim: the plain version
    given each fault (kv shifted one position; v's columns 64..111 zeroed,
    what a body that loses its padded second chunk computes) misses the
    tensor-core arithmetic by more than the card's limit, which that
    arithmetic itself meets."""
    B, S, H, Kv, D = 1, 130, 4, 4, 112
    rng = np.random.RandomState(24)
    q, k, v = (torch.from_numpy(rng.randn(B, S, n, D).astype(np.float32)
                                * sc).to(torch.bfloat16)
               for n, sc in ((H, chip_smoke.FLASH_Q_SCALE), (Kv, 1),
                             (Kv, 1)))
    got = _wgmma_emulation(q, k, v)
    assert chip_smoke.flash_ratio(
        got, ref.reference_flash_attention(q, k, v)) <= 1.0
    fk, fv, fw, fc = chip_smoke.fault_args(fault, k, v, 0, 0.0, H)
    bad = ref.reference_flash_attention(q, fk, fv, window=fw, softcap=fc)
    assert chip_smoke.flash_ratio(got, bad) > 1.0


@pytest.mark.parametrize("case", ["T!=S", "H%Kv", "f16", "mixed", "window<0",
                                  "3-d"])
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v = _torch(_qkv(7, S=64, H=4, Kv=2, D=16), torch.float32)
    kw = {}
    if case == "T!=S":
        k, v = k[:, :32], v[:, :32]
    elif case == "H%Kv":
        q = q[:, :, :3]
    elif case == "f16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "window<0":
        kw = {"window": -1}
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v, **kw)


# ---------------- models/attention.py ----------------

@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 32, 0.0), (True, 0, 50.0),
    (False, 0, 0.0), (True, 64, 30.0)])
def test_mha_chunked_and_naive_match_jax(causal, window, cap):
    arrs = _qkv(10)
    jq, jk, jv = _jax(arrs, jnp.float32)
    tq, tk, tv = _torch(arrs, torch.float32)
    kw = dict(causal=causal, window=window, softcap_val=cap)
    j_chunk = jattn.mha_chunked(jq, jk, jv, q_block=32, kv_block=32, **kw)
    t_chunk = tattn.mha_chunked(tq, tk, tv, q_block=32, kv_block=32, **kw)
    assert _gap(t_chunk, j_chunk) < F32_TOL
    j_naive = jattn.naive_attention(jq, jk, jv, **kw)
    t_naive = tattn.naive_attention(tq, tk, tv, **kw)
    assert _gap(t_naive, j_naive) < F32_TOL
    assert _gap(t_chunk, t_naive) < F32_TOL


@pytest.mark.parametrize("qb,kb,q_offset", [(16, 64, 0), (64, 16, 0),
                                            (32, 32, 64)])
def test_mha_chunked_blocks_and_offset_match_jax(qb, kb, q_offset):
    arrs = _qkv(11)
    got = tattn.mha_chunked(*_torch(arrs, torch.float32), q_block=qb,
                            kv_block=kb, q_offset=q_offset, window=48)
    expect = jattn.mha_chunked(*_jax(arrs, jnp.float32), q_block=qb,
                               kv_block=kb, q_offset=q_offset, window=48)
    assert _gap(got, expect) < F32_TOL


@pytest.mark.parametrize("Kv", [1, 4])
def test_mha_chunked_bf16_and_grouping_match_jax(Kv):
    """bf16 (P rounded to bf16 before PV in both) and MQA / MHA grouping."""
    arrs = _qkv(12, Kv=Kv)
    got = tattn.mha_chunked(*_torch(arrs, torch.bfloat16), q_block=32,
                            kv_block=32, softcap_val=50.0)
    expect = jattn.mha_chunked(*_jax(arrs, jnp.bfloat16), q_block=32,
                               kv_block=32, softcap_val=50.0)
    assert got.dtype == torch.bfloat16
    assert _gap(got, expect) < BF16_TOL


def test_mha_chunked_refuses_ragged_blocks():
    q, k, v = _torch(_qkv(13, S=100), torch.float32)
    with pytest.raises(ValueError):
        tattn.mha_chunked(q, k, v, q_block=32, kv_block=32)


@pytest.mark.parametrize("window,cache_len", [(0, 33), (8, 8)],
                         ids=["full", "ring"])
def test_cache_write_and_decode_match_jax(window, cache_len):
    """Token-by-token cache writes, then one decode query: full cache and a
    ring buffer of ``window`` slots, against JAX and against the port's
    own full attention over the sequence."""
    B, S, H, Kv, D = 2, 40 if window else 33, 4, 2, 16
    arrs = _qkv(14, B=B, S=S, H=H, Kv=Kv, D=D)
    jq, jk, jv = _jax(arrs, jnp.float32)
    tq, tk, tv = _torch(arrs, torch.float32)
    jc = jattn.init_kv_cache(B, cache_len, Kv, D, dtype=jnp.float32)
    tc = tattn.init_kv_cache(B, cache_len, Kv, D, dtype=torch.float32,
                             device="cpu")
    for t in range(S):
        jc = jattn.cache_write(jc, jk[:, t:t + 1], jv[:, t:t + 1],
                               jnp.int32(t))
        assert tattn.cache_write(tc, tk[:, t:t + 1], tv[:, t:t + 1], t) is tc
    for name in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(_np(tc[name]), _np(jc[name]))
    kw = dict(window=window, softcap_val=30.0, cur_pos=S - 1)
    got = tattn.decode_attention(tq[:, -1:], tc, **kw)
    expect = jattn.decode_attention(jq[:, -1:], jc, **kw)
    assert _gap(got, expect) < F32_TOL
    full = tattn.naive_attention(tq, tk, tv, window=window, softcap_val=30.0)
    assert _gap(got[:, 0], full[:, -1]) < F32_TOL


def test_decode_attention_bf16_matches_jax():
    B, C, H, Kv, D = 2, 24, 8, 2, 32
    rng = np.random.RandomState(15)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    k, v = (rng.randn(B, C, Kv, D).astype(np.float32) for _ in range(2))
    slot = np.where(np.arange(C) < 20, np.arange(C), -1).astype(np.int32)
    jc = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16),
          "slot_pos": jnp.asarray(slot)}
    tc = {"k": torch.from_numpy(k).bfloat16(),
          "v": torch.from_numpy(v).bfloat16(),
          "slot_pos": torch.from_numpy(slot)}
    expect = jattn.decode_attention(jnp.asarray(q, jnp.bfloat16), jc,
                                    cur_pos=jnp.int32(19))
    got = tattn.decode_attention(torch.from_numpy(q).bfloat16(), tc,
                                 cur_pos=19)
    assert got.dtype == torch.bfloat16
    assert _gap(got, expect) < BF16_TOL


# ---------------- the training pair (flash_attention_train) ----------------
# On the CPU flash_attention_train runs the kernels' plain versions
# (ref.reference_flash_train_fwd / _bwd) under autograd; the card tests hold
# the kernels against them.  Against mha_chunked's autograd the plain
# arithmetic differs only in where bf16 rounds: P relative to the running
# max of 64 keys (mha_chunked: of 512) and normalised before the rounding
# in backward (mha_chunked: after), and each gradient cast to bf16 once.
# Readings at these shapes: o up to 7.2e-4 and the gradients up to 3.5e-3
# of the norm (the card read up to 1.28e-3 and 3.9e-3 at S = 1024), one
# bf16 ulp (2^-8) of the norm; a skipped diagonal tile reads 0.13-0.38.
TRAIN_O_TOL, TRAIN_GRAD_TOL = 2.0 ** -9, 2.0 ** -7


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def _train_inputs(seed, B, S, H, Kv, D):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(B, S, n, D).astype(
        np.float32)).to(torch.bfloat16) for n in (H, Kv, Kv, H))
    return (q * 2).to(torch.bfloat16), k, v, do


@pytest.mark.parametrize("B,S,H,Kv,D", [(2, 128, 4, 4, 64),
                                        (2, 192, 4, 2, 64),
                                        (1, 128, 4, 1, 128)],
                         ids=["mha", "gqa", "mqa-128"])
def test_train_plain_matches_mha_chunked_autograd(B, S, H, Kv, D):
    """flash_attention_train's output and gradients on the CPU (the plain
    versions: lse, D = rowsum(dO o O), bf16 P, dS as hi + lo) against
    mha_chunked's under autograd, at H = Kv and with GQA."""
    q, k, v, do = _train_inputs(20 + Kv, B, S, H, Kv, D)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_train(*ins)
    out.backward(do)
    chk = [t.clone().requires_grad_() for t in (q, k, v)]
    want = tattn.mha_chunked(*chk)
    want.backward(do)
    assert out.dtype == torch.bfloat16
    assert _rel(out, want) < TRAIN_O_TOL
    for a, b in zip(ins, chk):
        assert a.grad.dtype == torch.bfloat16
        assert _rel(a.grad, b.grad) < TRAIN_GRAD_TOL
    # the plain forward's lse is the log-sum-exp of the masked scores
    _, lse = ref.reference_flash_train_fwd(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(H // Kv, dim=2))
    s = s / math.sqrt(D)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                      float("-inf"))
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) < 1e-4


@pytest.mark.parametrize("fault", ["skip_tile", "split_ds"])
def test_train_plain_faults_move_the_gradients(fault):
    """The card checks' two faulty plain versions: a skipped diagonal tile
    moves every output far beyond mha_chunked's gap; a single bf16 dS moves
    dq and dk by ~2.6e-3 of their norm (the card's limit is 7e-4)."""
    q, k, v, do = _train_inputs(30, 2, 128, 4, 2, 64)
    o, lse = ref.reference_flash_train_fwd(q, k, v)
    good = ref.reference_flash_train_bwd(q, k, v, o, lse, do)
    if fault == "skip_tile":
        bad_o, _ = ref.reference_flash_train_fwd(q, k, v, skip_tile=1)
        assert _rel(bad_o, o) > 0.05
        bad = ref.reference_flash_train_bwd(q, k, v, o, lse, do, skip_tile=1)
        assert all(_rel(a, b) > 0.05 for a, b in zip(bad, good))
    else:
        bad = ref.reference_flash_train_bwd(q, k, v, o, lse, do,
                                            split_ds=False)
        assert all(_rel(a, b) > 1.5e-3 for a, b in zip(bad[:2], good[:2]))
        assert torch.equal(bad[2], good[2])


@pytest.mark.parametrize("case,takes", [
    ("musicgen", True), ("head 128 gqa", True), ("head 112", False),
    ("head 32", False), ("f32", False), ("f16", False), ("T!=S", False),
    ("S % 64", False), ("H % Kv", False), ("3-d", False)])
def test_train_route_by_shape_and_dtype(case, takes):
    """The training pair's shapes (training_shape): bf16, head dim 64 or
    128, T == S a multiple of 64, H % Kv == 0."""
    B, S, H, Kv, D, dt = 2, 1024, 24, 24, 64, torch.bfloat16
    if case == "head 128 gqa":
        H, Kv, D = 32, 4, 128
    elif case == "head 112":
        D = 112
    elif case == "head 32":
        D = 32
    elif case == "f32":
        dt = torch.float32
    elif case == "f16":
        dt = torch.float16
    elif case == "S % 64":
        S = 1000
    elif case == "H % Kv":
        Kv = 5
    qs, ks = (B, S, H, D), (B, S, Kv, D)
    if case == "T!=S":
        ks = (B, S // 2, Kv, D)
    if case == "3-d":
        qs = qs[1:]
    assert fa.training_shape(dt, qs, ks, ks) is takes


@pytest.mark.parametrize("window,cap,on_card,fused", [
    (0, 0.0, True, True), (32, 0.0, True, False), (0, 50.0, True, False),
    (0, 0.0, False, False)])
def test_train_route_by_softcap_window_and_device(monkeypatch, window, cap,
                                                 on_card, fused):
    """attn_apply's "xla" route: the pair only on the card (a CUDA device
    that ``use_kernel`` takes) with no window and no softcap; every CPU
    tensor takes mha_chunked.  The card's operands are stand-ins with a
    CUDA device, a dtype and a shape, ``use_kernel`` answering for an
    sm_90 card."""
    q, k, v, _ = _train_inputs(40, 1, 64, 2, 2, 64)
    assert tattn.fused_route(q, k, v, window=0, softcap=0.0) is False
    if on_card:
        q, k, v = (types.SimpleNamespace(device=torch.device("cuda", 0),
                                         dtype=t.dtype, shape=t.shape)
                   for t in (q, k, v))
        monkeypatch.setattr(tattn, "use_kernel", lambda *a: True)
    assert tattn.fused_route(q, k, v, window=window, softcap=cap) is fused


def test_train_pair_check_rehearsed_on_cpu():
    """chip_smoke's check of the pair (phase 3 and the card tests) on the
    CPU, where the wrapper runs the plain versions: every gap 0, the same
    bits twice, both faults beyond the limit in the outputs they move, and
    the one problem it reports that no kernel launched."""
    q, k, v, do = _train_inputs(42, 2, 128, 4, 2, 64)
    res = chip_smoke.train_pair_check(q, k, v, do)
    assert set(res["gaps"].values()) == {0.0} and res["lse"] == 0.0
    assert res["same_bits"]
    assert {f: set(g) for f, g in res["controls"].items()} == {
        f: set(moved) for f, moved in chip_smoke.TRAIN_FLASH_FAULTS.items()}
    assert chip_smoke.train_pair_problems(res) == [
        "launches {'flash_train_fwd': 0, 'flash_train_bwd': 0}"]


def test_train_wrapper_refuses_what_the_pair_does_not_take():
    q, k, v, _ = _train_inputs(41, 1, 64, 2, 2, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_train(q[:, :, :, :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError):
        fa.flash_attention_train(q.float(), k.float(), v.float())


def test_train_route_counts_every_call_on_cpu():
    """Under tracing, each "xla" attention call counts attn.chunked on the
    CPU (attn.fused never), and a train step's step.fwd_bwd span keeps both
    counters: a call a layer, twice with remat (the forward and its
    recomputation); no kernel launches."""
    from repro_torch import configs, models, optim, tracing
    cfg = configs.get_config("musicgen-medium", reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    rng = np.random.RandomState(0)
    batch = {"embeds": torch.from_numpy(rng.randn(2, 64, cfg.d_model).astype(
        np.float32)).to(torch.bfloat16),
             "labels": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                    (2, 64)))}
    n0 = dict(fa.LAUNCHES)
    opt = optim.adamw(1e-3)
    tracing.start()
    try:
        models.train_step(params, opt.init(params), batch, cfg=cfg,
                          optimizer=opt)
    finally:
        rec = tracing.stop()
    assert cfg.remat
    want = {"attn.fused": 0, "attn.chunked": 2 * cfg.n_layers}
    assert rec.counters == {"attn.chunked": 2 * cfg.n_layers}
    fwd_bwd, = [s for s in rec.spans if s.name == "step.fwd_bwd"]
    assert fwd_bwd.counters == want
    assert fa.LAUNCHES == n0
    assert tattn.route_counts() == {}                   # tracing off
