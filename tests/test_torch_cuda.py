"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips itself unless a CUDA card of compute
capability (9, 0) is present.  This file imports no JAX, so it runs on the
card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fedavg within 1e-6 (the kernel and the plain version sum the
rows in the same order, so they normally agree bit for bit), and the
aggregate (B2) bit for bit at every width and row count tested; encode,
decode and the server-optimizer step bit-exact (the kernels round every
operation like the plain version does); flash attention elementwise
within 2e-5 in f32 (ROADMAP (b)) and within 2^-7 |plain| + 1e-4 in bf16:
one bf16 ulp of the plain output, since both sides compute in f32 and
round once, and another summation order flips at most the last bit.  q is
drawn at 8x the scale of k and v, so that the scores reach the softcap
and the softmax is peaked.  WKV (B9) elementwise within chip_smoke.py's
``WKV_TOL``: in bf16 one bf16 ulp of the plain output plus 1e-5 of its
largest |value|, in f32 1e-5 of the largest |value| (both sides compute
in f32 and round once); and that limit must fail against the plain
version given each of chip_smoke's faults (no bonus, no state carried
across chunks, an inclusive cumsum).  B9's state form (``wkv_state``, what
rwkv6's prefill runs) the same for y, and its final state within
chip_smoke's ``WKV_STATE_TOL`` of the plain version's largest |entry| (f32
on both sides, sums in another order), with s0 left unwritten; that limit
must also fail with s0 ignored and with the state taken before the last
chunk's update.
"""
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import transport
from repro_torch.kernels import (fedavg_agg, flash_attention, ref,
                                 server_opt, topk_quant)

# chip_smoke.py holds B9's limit (wkv_ratio) and its faults (wkv_fault)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _rows(W, N, seed=0):
    rng = np.random.RandomState(seed)
    rows = rng.randn(W, N).astype(np.float32)
    w = rng.rand(W).astype(np.float32) + 0.1
    return rows, (w / w.sum()).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability (9, 0)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,N", [(30, 101_888), (2, 101_888), (3, 1000)])
def test_cuda_fedavg_kernels_match_plain(h100, W, N):
    rows, w = _rows(W, N)
    rows_d, w_d = _t(rows).to(h100), _t(w).to(h100)
    n0 = dict(fedavg_agg.LAUNCHES)
    got = fedavg_agg.fedavg_agg_flat(rows_d, w_d)
    plain = ref.reference_fedavg(rows_d, w_d)
    assert torch.max(torch.abs(got - plain)).item() < 1e-6
    server = torch.randn(N, device=h100)
    wvec = torch.cat([torch.tensor([0.1], device=h100), w_d])
    plain = ref.reference_fedavg_mix(rows_d, w_d, server, wvec[0])
    fresh = fedavg_agg.fedavg_mix_flat(rows_d, wvec, server)
    inplace = fedavg_agg.fedavg_mix_flat(rows_d, wvec, server, out=server)
    torch.cuda.synchronize()
    assert torch.max(torch.abs(fresh - plain)).item() < 1e-6
    assert torch.equal(inplace, fresh)
    assert fedavg_agg.LAUNCHES["agg"] == n0["agg"] + 1
    assert fedavg_agg.LAUNCHES["mix"] == n0["mix"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("N", [101_888, 1000])
def test_cuda_codec_kernels_bit_exact(h100, N):
    xd = torch.from_numpy(np.random.RandomState(N).randn(N)
                          .astype(np.float32)).to(h100) * 0.01
    sd = transport._int8_scale(xd)
    td = transport.topk_threshold(xd, N // 10, N)
    q, r = topk_quant.topk_quant_encode(xd, td, sd)
    assert q.dtype == torch.int8 and r.dtype == torch.float32
    qp, rp = ref.reference_topk_quant_encode(xd, td, sd)
    assert torch.equal(q, qp) and torch.equal(r, rp)
    base = torch.randn(N, device=h100)
    assert torch.equal(topk_quant.dequant_add(q, sd, base),
                       ref.reference_dequant_add(q, sd, base))


@pytest.mark.cuda
@pytest.mark.parametrize("adam", [False, True], ids=["momentum", "adam"])
@pytest.mark.parametrize("N", [101_888, 29_184, 1000])
def test_cuda_server_opt_kernel_bit_exact(h100, adam, N):
    """B5a/B5b against the plain version, fresh and with the state written
    in place; the FedAvgM, FedDyn and FedAdam scalars."""
    rng = np.random.RandomState(N)
    prev, merged, m, v = (_t(rng.randn(N).astype(np.float32)).to(h100)
                          for _ in range(4))
    v = v.abs()
    scs = ([[0.9, 0.99, 0.05, 1e-3, 0.0, 0.0]] if adam
           else [[0.9, 1.0, 0.0, 1.0], [1.0, 1.0, 1.0, 0.25]])
    for sc in scs:
        sc = np.asarray(sc, np.float32)
        n0 = dict(server_opt.LAUNCHES)
        got = server_opt.server_opt_step_flat(prev, merged, m, v, sc,
                                              adam=adam)
        plain = ref.reference_server_opt(prev, merged, m, v, sc, adam=adam)
        m2, v2 = m.clone(), v.clone()
        inplace = server_opt.server_opt_step_flat(
            prev, merged, m2, v2, sc, adam=adam, m_out=m2, v_out=v2)
        torch.cuda.synchronize()
        for g, p, i in zip(got, plain, inplace):
            if p is None:
                assert g is None and i is None
                continue
            assert torch.equal(g, p) and torch.equal(i, p)
        key = "adam" if adam else "mom"
        assert server_opt.LAUNCHES[key] == n0[key] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async_delta"])
def test_cuda_run_fl_matches_cpu_run(h100, mode):
    """The main path on the card against the same run on the CPU: every
    history field but accuracy equal, accuracy within 4 test samples."""
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    kw = dict(seed=0, noise=0.25, batch_size=32, het="strong")
    mkw = ({"mode": "sync"} if mode == "sync"
           else {"mode": "async", "async_delta": True})
    card = make_setup(TABLE_4_1["mnist_even"], **kw, device=h100)
    w0 = {k: v.cpu().numpy() for k, v in card.weights0.items()}
    cpu = make_setup(TABLE_4_1["mnist_even"], **kw, weights0=w0,
                     device="cpu")
    n0 = dict(fedavg_agg.LAUNCHES)
    hg = run_fl(card, epochs_per_round=3, max_rounds=4, **mkw)
    hc = run_fl(cpu, epochs_per_round=3, max_rounds=4, **mkw)
    assert fedavg_agg.LAUNCHES["agg"] > n0["agg"]
    assert len(hg) == len(hc)
    for g, c in zip(hg, hc):
        assert (g.time, g.version, g.n_updates, g.selected, g.up_bytes,
                g.down_bytes) == (c.time, c.version, c.n_updates,
                                  c.selected, c.up_bytes, c.down_bytes)
        assert abs(g.accuracy - c.accuracy) <= 4 / 512


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["fedavgm", "fedadam"])
def test_cuda_server_opt_run_matches_cpu_run(h100, opt):
    """Async alpha 0.9 over a Dirichlet split with a server optimizer: the
    kernel launches once per merge, and the history matches the CPU's."""
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    kw = dict(seed=0, noise=0.25, batch_size=32, het="strong")
    rkw = dict(mode="async", async_alpha=0.9, async_latest_table=False,
               aggregator="linear", epochs_per_round=3, max_rounds=4,
               partition="dirichlet", partition_kw={"alpha": 0.3},
               server_opt=opt)
    card = make_setup(TABLE_4_1["mnist_even"], **kw, device=h100)
    w0 = {k: v.cpu().numpy() for k, v in card.weights0.items()}
    cpu = make_setup(TABLE_4_1["mnist_even"], **kw, weights0=w0,
                     device="cpu")
    key = "adam" if opt == "fedadam" else "mom"
    n0 = server_opt.LAUNCHES[key]
    hg = run_fl(card, **rkw)
    hc = run_fl(cpu, **rkw)
    assert server_opt.LAUNCHES[key] == n0 + 4
    assert len(hg) == len(hc)
    for g, c in zip(hg, hc):
        assert (g.time, g.version, g.n_updates, g.selected, g.up_bytes,
                g.down_bytes) == (c.time, c.version, c.n_updates,
                                  c.selected, c.up_bytes, c.down_bytes)
        assert abs(g.accuracy - c.accuracy) <= 4 / 512


# (B, S, H, Kv, D, dtype, window, softcap): the JAX tests' widths, gemma2's
# head_dim 256 in f32 (the largest block), a window of 40 that leaves the
# first KV tiles of later query tiles wholly masked, and a ragged S; then
# for the tensor-core body (bf16 at D 64/128/256) S not a multiple of a
# block's query rows (128 or 192) or a tile's 64 keys, window edges inside
# a tile and GQA rep 1, 2 and 8; and bf16 at D = 32 (the SIMT body)
FLASH_CASES = [
    (2, 128, 4, 2, 32, torch.float32, 0, 0.0),
    (2, 256, 2, 1, 64, torch.bfloat16, 0, 0.0),
    (2, 64, 8, 8, 16, torch.float32, 32, 30.0),
    (1, 256, 4, 2, 256, torch.float32, 40, 50.0),
    (2, 512, 8, 4, 256, torch.bfloat16, 128, 50.0),
    (1, 384, 8, 2, 128, torch.bfloat16, 0, 0.0),
    (2, 200, 4, 2, 128, torch.float32, 72, 0.0),
    (1, 200, 2, 2, 64, torch.bfloat16, 0, 0.0),
    (2, 330, 4, 2, 64, torch.bfloat16, 100, 50.0),
    (1, 77, 8, 1, 128, torch.bfloat16, 0, 0.0),
    (2, 300, 4, 2, 128, torch.bfloat16, 72, 30.0),
    (1, 260, 8, 1, 256, torch.bfloat16, 0, 50.0),
    (1, 450, 4, 4, 256, torch.bfloat16, 200, 50.0),
    (2, 190, 16, 2, 256, torch.bfloat16, 40, 0.0),
    (1, 96, 4, 2, 32, torch.bfloat16, 24, 30.0),
]


FLASH_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}


def _assert_flash_close(got, plain):
    rel, tol = FLASH_TOL[plain.dtype]
    d = (got.double() - plain.double()).abs()
    assert bool((d <= rel * plain.double().abs() + tol).all()), \
        float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,D,dtype,window,cap", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(h100, B, S, H, Kv, D, dtype,
                                            window, cap):
    rng = np.random.RandomState(S + D)
    q, k, v = (_t(rng.randn(B, S, n, D).astype(np.float32) * scale)
               .to(h100, dtype) for n, scale in ((H, 8), (Kv, 1), (Kv, 1)))
    n0 = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention(q, k, v, window=window,
                                          softcap=cap)
    plain = ref.reference_flash_attention(q, k, v, window=window,
                                          softcap=cap)
    torch.cuda.synchronize()
    # every launch counts under "flash"; the tensor-core body's also under
    # "flash_wgmma"
    wgmma = int(dtype == torch.bfloat16 and D in (64, 128, 256))
    assert flash_attention.LAUNCHES == {"flash": n0["flash"] + 1,
                                        "flash_wgmma": n0["flash_wgmma"]
                                        + wgmma}
    assert got.dtype == dtype and got.shape == q.shape
    _assert_flash_close(got, plain)


# B8 without the causal mask, (B, S, H, Kv, D, window, softcap), bf16 so
# the tensor-core body runs: its query tiles are issued in order and keys
# right of the query are seen; ragged S and window edges inside a tile
FLASH_NONCAUSAL_CASES = [
    (2, 200, 4, 2, 64, 0, 0.0),
    (1, 330, 8, 1, 128, 100, 0.0),
    (1, 77, 8, 8, 128, 40, 30.0),
    (2, 190, 8, 4, 256, 0, 50.0),
    (1, 256, 4, 2, 256, 72, 50.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,D,window,cap", FLASH_NONCAUSAL_CASES)
def test_cuda_flash_attention_non_causal_matches_plain(h100, B, S, H, Kv, D,
                                                       window, cap):
    rng = np.random.RandomState(S + D + 1)
    q, k, v = (_t(rng.randn(B, S, n, D).astype(np.float32) * scale)
               .to(h100, torch.bfloat16)
               for n, scale in ((H, 8), (Kv, 1), (Kv, 1)))
    n0 = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention(q, k, v, causal=False,
                                          window=window, softcap=cap)
    plain = ref.reference_flash_attention(q, k, v, causal=False,
                                          window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {"flash": n0["flash"] + 1,
                                        "flash_wgmma": n0["flash_wgmma"] + 1}
    _assert_flash_close(got, plain)
    # a control: the causal plain version differs beyond the limit
    causal = ref.reference_flash_attention(q, k, v, window=window,
                                           softcap=cap)
    with pytest.raises(AssertionError):
        _assert_flash_close(got, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 30, 64])
@pytest.mark.parametrize("N", [4, 101_888, 101_890, 1_048_576])
def test_cuda_fedavg_agg_bit_exact(h100, W, N):
    """B2 equals reference_fedavg bit for bit: vector (N % 4 == 0) and
    scalar (101,890) paths, row counts below, at and above a 16-row
    group."""
    rows, w = _rows(W, N, seed=W)
    rows_d, w_d = _t(rows).to(h100), _t(w).to(h100)
    got = fedavg_agg.fedavg_agg_flat(rows_d, w_d)
    assert torch.equal(got, ref.reference_fedavg(rows_d, w_d))


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_views(h100):
    """q, k, v as views of one fused (B, S, H + 2 Kv, D) projection: the
    kernel reads them through their strides, with no copy."""
    B, S, H, Kv, D = 2, 192, 4, 2, 64
    qkv = torch.randn(B, S, H + 2 * Kv, D, device=h100)
    qkv[:, :, :H] *= 8
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Kv], qkv[:, :, H + Kv:]
    got = flash_attention.flash_attention(q, k, v, softcap=50.0)
    plain = ref.reference_flash_attention(q, k, v, softcap=50.0)
    torch.cuda.synchronize()
    _assert_flash_close(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "yi-9b"])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_cuda_prefill_launches_flash_once_per_layer(h100, arch, head_dim):
    """A REDUCED prefill on the card goes through the kernel once per layer
    and decode never, through the tensor-core body at head_dim 64 and the
    SIMT body at 16; its logits match the same run on the CPU (the
    kernel's plain version) within 0.04 of max|logit| (bf16 end to end)."""
    from repro_torch import configs, models
    # yi's REDUCED head_dim (8) is below the kernel's smallest (16)
    cfg = configs.get_config(arch, reduced=True).replace(
        head_dim=head_dim, attn_impl="pallas")
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(h100)
                for k, v in tree.items()}
    card = to(params)
    toks = _t(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 96)))
    n0 = dict(flash_attention.LAUNCHES)
    wgmma = cfg.n_layers if head_dim == 64 else 0
    after_prefill = {"flash": n0["flash"] + cfg.n_layers,
                     "flash_wgmma": n0["flash_wgmma"] + wgmma}
    lg, st = models.prefill_step(card, {"tokens": toks[:, :64].to(h100)},
                                 cfg=cfg, max_len=96)
    assert flash_attention.LAUNCHES == after_prefill
    for t in range(64, 68):
        lg, st = models.serve_step(card, st, toks[:, t:t + 1].to(h100), t,
                                   cfg=cfg)
    assert flash_attention.LAUNCHES == after_prefill
    lc, sc = models.prefill_step(params, {"tokens": toks[:, :64]}, cfg=cfg,
                                 max_len=96)
    for t in range(64, 68):
        lc, sc = models.serve_step(params, sc, toks[:, t:t + 1], t, cfg=cfg)
    err = (lg.float().cpu() - lc.float()).abs().max() / lc.float().abs().max()
    assert float(err) < 0.04


# B9 (WKV): (B, S, H, K, chunk, dtype): rwkv6-3b's heads at ops.wkv's
# chunk, tests/test_kernels.py's f32 shapes, K = 16 (one block per head),
# and a chunk of 64 (over 48 KB of shared memory: the opt-in path)
WKV_CASES = [
    (2, 1024, 40, 64, 16, torch.bfloat16),
    (2, 512, 4, 64, 16, torch.float32),
    (2, 64, 2, 16, 16, torch.float32),
    (2, 128, 3, 32, 32, torch.float32),
    (2, 64, 1, 8, 8, torch.float32),
    (1, 256, 2, 64, 64, torch.bfloat16),
]


def _wkv_case(h100, B, S, H, K, dtype, seed=0):
    """chip_smoke's B9 inputs: w ~ 0.98, so the state carries far."""
    rng = np.random.RandomState(seed)
    r, k, v = (_t(0.5 * rng.randn(B, S, H, K).astype(np.float32))
               .to(h100, dtype) for _ in range(3))
    w = _t(np.exp(-np.exp(-4 + 0.5 * rng.randn(B, S, H, K))).astype(
        np.float32)).to(h100)
    u = _t((0.5 + 0.1 * rng.randn(H, K)).astype(np.float32)).to(h100)
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,chunk,dtype", WKV_CASES)
def test_cuda_wkv_matches_plain(h100, B, S, H, K, chunk, dtype):
    from repro_torch.kernels import rwkv6_kernel
    r, k, v, w, u = _wkv_case(h100, B, S, H, K, dtype)
    n0 = rwkv6_kernel.LAUNCHES["wkv"]
    got = rwkv6_kernel.wkv(r, k, v, w, u, chunk=chunk)
    plain = ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0 + 1
    assert got.dtype == dtype and got.shape == r.shape
    assert chip_smoke.wkv_ratio(got, plain) <= 1.0


@pytest.mark.cuda
def test_cuda_wkv_reads_strided_views(h100):
    """r, k, v as views of one (B, S, H, 3K) projection: read through
    their strides, with no copy."""
    from repro_torch.kernels import rwkv6_kernel
    B, S, H, K = 2, 256, 4, 64
    rkv = (0.5 * torch.randn(B, S, H, 3 * K, device=h100)).bfloat16()
    r, k, v = rkv[..., :K], rkv[..., K:2 * K], rkv[..., 2 * K:]
    _, _, _, w, u = _wkv_case(h100, B, S, H, K, torch.bfloat16)
    got = rwkv6_kernel.wkv(r, k, v, w, u)
    plain = ref.reference_wkv_chunked(r, k, v, w, u, chunk=16)
    torch.cuda.synchronize()
    assert chip_smoke.wkv_ratio(got, plain) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["u = 0", "no carry", "inclusive cumsum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_wkv_check_catches_faults(h100, fault, dtype):
    """The limit that the kernel meets fails a plain version given each
    of chip_smoke's faults."""
    from repro_torch.kernels import rwkv6_kernel
    r, k, v, w, u = _wkv_case(h100, 2, 512, 4, 64, dtype, seed=1)
    got = rwkv6_kernel.wkv(r, k, v, w, u)
    bad = chip_smoke.wkv_fault(fault, r, k, v, w, u, 16)
    torch.cuda.synchronize()
    plain = ref.reference_wkv_chunked(r, k, v, w, u)
    assert chip_smoke.wkv_ratio(got, plain) <= 1.0
    assert chip_smoke.wkv_ratio(got, bad) > 1.0


# B9's state form: K in HEAD_DIMS, chunk 16 and 64, S one chunk or several
# hundred positions, f32 and bf16, from s0 or from zeros
WKV_STATE_CASES = [
    (K, chunk, S, dtype, with_s0) for K, chunk, (S, dtype, with_s0) in
    itertools.product((8, 16, 32, 64, 128), (16, 64), itertools.product(
        ("one chunk", 384), (torch.float32, torch.bfloat16), (True, False)))]


def _wkv_state_check(r, k, v, w, u, s0, chunk):
    """B9's state form against its plain version: y within WKV_TOL, the
    final state within WKV_STATE_TOL, one launch, s0 unwritten."""
    from repro_torch.kernels import rwkv6_kernel
    kept = None if s0 is None else s0.clone()
    n0 = rwkv6_kernel.LAUNCHES["wkv"]
    y, st = rwkv6_kernel.wkv_state(r, k, v, w, u, s0, chunk=chunk)
    py, pst = ref.reference_wkv_chunked(r, k, v, w, u, chunk=chunk, s0=s0,
                                        return_state=True)
    torch.cuda.synchronize()
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0 + 1
    assert y.dtype == r.dtype and y.shape == r.shape
    assert st.dtype == torch.float32 and st.shape == pst.shape
    assert chip_smoke.wkv_ratio(y, py) <= 1.0
    assert chip_smoke.state_ratio(st, pst) <= 1.0
    assert s0 is None or torch.equal(s0, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("K,chunk,S,dtype,with_s0", WKV_STATE_CASES)
def test_cuda_wkv_state_matches_plain(h100, K, chunk, S, dtype, with_s0):
    S = chunk if S == "one chunk" else S
    r, k, v, w, u = _wkv_case(h100, 2, S, 3, K, dtype, seed=K + chunk)
    s0 = (1.25 * torch.randn(2, 3, K, K, device=h100) if with_s0 else None)
    _wkv_state_check(r, k, v, w, u, s0, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,chunk", [(50, 32, 10), (72, 128, 24),
                                       (6, 16, 3)])
def test_cuda_wkv_state_ragged_chunk_tiles(h100, S, K, chunk):
    """Chunks that are not a multiple of the kernel's 4-position tiles."""
    r, k, v, w, u = _wkv_case(h100, 1, S, 2, K, torch.float32)
    _wkv_state_check(r, k, v, w, u, torch.randn(1, 2, K, K, device=h100),
                     chunk)


@pytest.mark.cuda
def test_cuda_wkv_state_reads_strided_views(h100):
    """r, k, v as views of one (B, S, H, 3K) projection, read in place, and
    a view offset by one element (copied first)."""
    B, S, H, K = 2, 256, 4, 64
    rkv = (0.5 * torch.randn(B, S, H, 3 * K + 1, device=h100)).bfloat16()
    r, k, v = rkv[..., :K], rkv[..., K:2 * K], rkv[..., 2 * K + 1:]
    _, _, _, w, u = _wkv_case(h100, B, S, H, K, torch.bfloat16)
    _wkv_state_check(r, k, v, w, u, torch.randn(B, H, K, K, device=h100), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", chip_smoke.WKV_STATE_FAULTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_wkv_state_check_catches_faults(h100, fault, dtype):
    """The limits that the state form meets fail a plain version given each
    of chip_smoke's state-form faults (y or final state)."""
    from repro_torch.kernels import rwkv6_kernel
    r, k, v, w, u = _wkv_case(h100, 2, 512, 4, 64, dtype, seed=1)
    s0 = 1.25 * torch.randn(2, 4, 64, 64, device=h100)
    y, st = rwkv6_kernel.wkv_state(r, k, v, w, u, s0)
    by, bst = chip_smoke.wkv_fault_state(fault, r, k, v, w, u, 64, s0)
    py, pst = ref.reference_wkv_chunked(r, k, v, w, u, chunk=64, s0=s0,
                                        return_state=True)
    torch.cuda.synchronize()
    assert max(chip_smoke.wkv_ratio(y, py),
               chip_smoke.state_ratio(st, pst)) <= 1.0
    assert max(chip_smoke.wkv_ratio(y, by),
               chip_smoke.state_ratio(st, bst)) > 1.0


@pytest.mark.cuda
def test_cuda_rwkv6_prefill_launches_wkv_once_per_layer(h100):
    """A REDUCED rwkv6-3b prefill on the card runs B9 once per layer and
    decode never; its logits match the same run on the CPU (the plain
    wkv_chunked) within 0.04 of max|logit| (bf16 end to end)."""
    from repro_torch import configs, models
    from repro_torch.kernels import rwkv6_kernel
    cfg = configs.get_config("rwkv6-3b", reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")

    def to(tree):
        return {n: to(t) if isinstance(t, dict) else t.to(h100)
                for n, t in tree.items()}
    card = to(params)
    toks = _t(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 132)))
    n0 = rwkv6_kernel.LAUNCHES["wkv"]
    lg, st = models.prefill_step(card, {"tokens": toks[:, :128].to(h100)},
                                 cfg=cfg, max_len=132)
    torch.cuda.synchronize()
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0 + cfg.n_layers
    for t in range(128, 132):
        lg, st = models.serve_step(card, st, toks[:, t:t + 1].to(h100), t,
                                   cfg=cfg)
    torch.cuda.synchronize()
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0 + cfg.n_layers
    lc, sc = models.prefill_step(params, {"tokens": toks[:, :128]}, cfg=cfg,
                                 max_len=132)
    for t in range(128, 132):
        lc, sc = models.serve_step(params, sc, toks[:, t:t + 1], t, cfg=cfg)
    err = (lg.float().cpu() - lc.float()).abs().max() / lc.float().abs().max()
    assert float(err) < 0.04
