"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips itself unless a CUDA card of compute
capability (9, 0) is present.  This file imports no JAX, so it runs on the
card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the fedavg aggregate (B2) and mix (B1) bit for bit at every
width and row count tested (the kernels and the plain versions sum the
rows in the same order and round every operation alike); encode, decode,
the server-optimizer step and the fused merge and step
(``merge_opt_flat``) bit-exact, the fused form also aliased as the merge
path calls it and with an inf in a zero-weight row; flash attention
elementwise
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
B3's and B4's redesigns (``ef_encode``: the whole EF top-k+int8 encode
in one cluster launch; ``dequant_add_rows``: a merge's decodes into the
row buffer in one launch) bit for bit against their plain versions in
every output at chip_smoke.py's draws at small sizes (NaN, +-inf and -0.0,
ties, all zeros, k = 1 and k = n, the strided-sample and grid paths,
misaligned views), with chip_smoke's controls failing, and a short run
over top-k+int8 uplinks launching each as the FL path must.  B4 folded
into its neighbours (``ef_encode``'s decoded output, ``dequant_mix``) bit
for bit against the chain each replaces on the card (the encode then B4;
B4, stack, B1) at odd, ragged and large widths, on a misaligned base, at
2, 4 and 34 pieces, with chip_smoke's controls failing, and short runs
through them equal in every field to the same runs through the chains.
The training kernel pair (``flash_attention_train``) within chip_smoke's
``TRAIN_FLASH_LIMIT`` of its plain versions in o, dq, dk and dv (the norm
of the difference over the plain output's; both sides compute in f32 and
round once) and ``TRAIN_LSE_LIMIT`` in lse, bit for bit run to run, with
dS as one bf16 term and a skipped diagonal tile failing; a 2-layer
musicgen-medium step through it within the benchmark contract's gaps of
the same step through ``mha_chunked``.
"""
import io
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
@pytest.mark.parametrize("W,N", [(30, 101_888), (2, 101_888), (3, 1000),
                                 (1, 101_888)])
def test_cuda_fedavg_kernels_match_plain(h100, W, N):
    rows, w = _rows(W, N)
    rows_d, w_d = _t(rows).to(h100), _t(w).to(h100)
    n0 = dict(fedavg_agg.LAUNCHES)
    got = fedavg_agg.fedavg_agg_flat(rows_d, w_d)
    plain = ref.reference_fedavg(rows_d, w_d)
    assert torch.equal(got, plain)
    server = torch.randn(N, device=h100)
    wvec = torch.cat([torch.tensor([0.1], device=h100), w_d])
    plain = ref.reference_fedavg_mix(rows_d, w_d, server, wvec[0])
    fresh = fedavg_agg.fedavg_mix_wvec(rows_d, wvec, server)
    inplace = fedavg_agg.fedavg_mix_wvec(rows_d, wvec, server, out=server)
    torch.cuda.synchronize()
    assert torch.equal(fresh, plain)
    assert torch.equal(inplace, fresh)
    assert fedavg_agg.LAUNCHES["agg"] == n0["agg"] + 1
    assert fedavg_agg.LAUNCHES["mix"] == n0["mix"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("N", [101_888, 1000])
def test_cuda_codec_kernels_bit_exact(h100, N):
    xd = torch.from_numpy(np.random.RandomState(N).randn(N)
                          .astype(np.float32)).to(h100) * 0.01
    sd = ref.reference_int8_scale(xd)
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
    fused merge and step launches once per merge, B5 and B1 never, and the
    history matches the CPU's."""
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
    n0, f0 = server_opt.LAUNCHES[key], dict(fedavg_agg.LAUNCHES)
    hg = run_fl(card, **rkw)
    hc = run_fl(cpu, **rkw)
    assert server_opt.LAUNCHES[key] == n0
    assert fedavg_agg.LAUNCHES[f"merge_{key}"] == f0[f"merge_{key}"] + 4
    assert fedavg_agg.LAUNCHES["mix"] == f0["mix"]
    assert len(hg) == len(hc)
    for g, c in zip(hg, hc):
        assert (g.time, g.version, g.n_updates, g.selected, g.up_bytes,
                g.down_bytes) == (c.time, c.version, c.n_updates,
                                  c.selected, c.up_bytes, c.down_bytes)
        assert abs(g.accuracy - c.accuracy) <= 4 / 512


MERGE_SCALARS = {k: np.asarray(v, np.float32)
                 for k, v in chip_smoke.OPT_SCALARS.items()}


def _merge_inputs(W, N, s, seed=0):
    """One merge's operands on the card, as chip_smoke draws them (s None:
    the aggregate)."""
    g = torch.Generator(device="cuda").manual_seed(seed + W + N)
    return chip_smoke.merge_inputs(g, W, N, s)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", sorted(chip_smoke.OPT_SCALARS))
@pytest.mark.parametrize("s", [None, 0.1, 1.0], ids=["agg", "mix0.1",
                                                     "mix1"])
@pytest.mark.parametrize("W,N", [(1, 101_888), (2, 101_890), (10, 29_184),
                                 (30, 101_888), (65, 1000)])
def test_cuda_merge_opt_bit_exact_and_aliased(h100, W, N, s, opt):
    """The fused merge and step against its plain version (the unfused
    chain), fresh and aliased as the merge path calls it (out = server =
    prev in the mix, m_out = m, v_out = v), one launch a call counted
    under its optimizer form and none of B5."""
    rows, w, server, prev, m, v = _merge_inputs(W, N, s)
    srv = None if s is None else server
    sc, adam = MERGE_SCALARS[opt], opt == "fedadam"
    form = "adam" if adam else "mom"
    n0, b5 = dict(fedavg_agg.LAUNCHES), dict(server_opt.LAUNCHES)
    got = fedavg_agg.merge_opt_flat(rows, w, srv, prev, m, v, sc, adam=adam)
    plain = ref.reference_merge_opt(rows, w, srv, prev, m, v, sc, adam=adam)
    assert not chip_smoke.merge_mismatch(got, plain)
    kprev = prev if srv is None else srv
    fresh = fedavg_agg.merge_opt_flat(rows, w, srv, kprev, m, v, sc,
                                      adam=adam)
    out = None if srv is None else srv.clone()
    m2, v2 = m.clone(), v.clone()
    inplace = fedavg_agg.merge_opt_flat(
        rows, w, out, prev if out is None else out, m2, v2, sc, adam=adam,
        out=out, m_out=m2, v_out=v2)
    torch.cuda.synchronize()
    assert not chip_smoke.merge_mismatch(inplace, fresh)
    assert inplace[1] is m2 and (out is None or inplace[0] is out)
    assert not chip_smoke.merge_mismatch(fresh, ref.reference_merge_opt(
        rows, w, srv, kprev, m, v, sc, adam=adam))
    assert fedavg_agg.LAUNCHES[f"merge_{form}"] == n0[f"merge_{form}"] + 3
    assert server_opt.LAUNCHES == b5
    assert fedavg_agg.LAUNCHES["agg"] == n0["agg"]
    assert fedavg_agg.LAUNCHES["mix"] == n0["mix"]


@pytest.mark.cuda
@pytest.mark.parametrize("s", [None, 0.1], ids=["agg", "mix"])
def test_cuda_merge_opt_nonfinite_and_faults(h100, s):
    """An inf in a zero-weight row gives NaN as the chain does, and
    chip_smoke's controls (FMA-rounded mix or m') fail the check."""
    rows, w, server, prev, m, v = _merge_inputs(3, 4099, s, seed=1)
    srv = None if s is None else server
    w[-1] = 0.0
    rows[-1, 5] = float("inf")
    for opt, sc in MERGE_SCALARS.items():
        adam = opt == "fedadam"
        got = fedavg_agg.merge_opt_flat(rows, w, srv, prev, m, v, sc,
                                        adam=adam)
        assert not chip_smoke.merge_mismatch(got, ref.reference_merge_opt(
            rows, w, srv, prev, m, v, sc, adam=adam))
        assert got[0][5].isnan() and torch.isfinite(got[0][6:]).all()
    for fault, (W, fs, opt) in chip_smoke.MERGE_FAULTS.items():
        if (fs is None) != (s is None):
            continue
        rows, w, server, prev, m, v = _merge_inputs(W, 101_888, fs, seed=2)
        srv = None if fs is None else server
        sc, adam = MERGE_SCALARS[opt], opt == "fedadam"
        got = fedavg_agg.merge_opt_flat(rows, w, srv, prev, m, v, sc,
                                        adam=adam)
        assert chip_smoke.merge_mismatch(got, chip_smoke.merge_plain_fault(
            fault, rows, w, srv, prev, m, v, sc, adam=adam))


@pytest.mark.cuda
def test_cuda_merge_opt_aliasing_rules_and_unread_server(h100):
    """Outputs may alias only what the merge path aliases; the flat
    state's alpha 1 merge never reads its server buffer (chip_smoke's
    check on the card)."""
    rows, w, server, prev, m, v = _merge_inputs(2, 1000, 0.1)
    sc = MERGE_SCALARS["fedadam"]
    for kw in ({"out": m}, {"out": v}, {"m_out": prev}, {"m_out": v},
               {"v_out": m}, {"v_out": server}):
        with pytest.raises(ValueError):
            fedavg_agg.merge_opt_flat(rows, w, server, prev, m, v, sc,
                                      adam=True, **kw)
    rec = chip_smoke.check_unread_server(h100)
    assert all(rec.values()), rec


@pytest.mark.cuda
def test_cuda_sync_fedadam_run_launches_fused_merge(h100):
    """A short sync FedAdam run: one fused launch a merge (the aggregate
    form), no B2 and no B5, and the CPU's history."""
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    kw = dict(seed=0, noise=0.25, batch_size=32, het="strong")
    rkw = dict(mode="sync", selector="all", epochs_per_round=3,
               max_rounds=4, server_opt="fedadam",
               server_opt_kw={"lr": 0.05})
    card = make_setup(TABLE_4_1["mnist_even"], **kw, device=h100)
    w0 = {k: v.cpu().numpy() for k, v in card.weights0.items()}
    cpu = make_setup(TABLE_4_1["mnist_even"], **kw, weights0=w0,
                     device="cpu")
    n0, b5 = dict(fedavg_agg.LAUNCHES), dict(server_opt.LAUNCHES)
    hg = run_fl(card, **rkw)
    hc = run_fl(cpu, **rkw)
    assert fedavg_agg.LAUNCHES["merge_adam"] == n0["merge_adam"] + 4
    assert fedavg_agg.LAUNCHES["agg"] == n0["agg"]
    assert server_opt.LAUNCHES == b5
    for g, c in zip(hg, hc):
        assert (g.time, g.version, g.n_updates, g.selected, g.up_bytes,
                g.down_bytes) == (c.time, c.version, c.n_updates,
                                  c.selected, c.up_bytes, c.down_bytes)
        assert abs(g.accuracy - c.accuracy) <= 4 / 512


# (B, S, H, Kv, D, dtype, window, softcap): the JAX tests' widths, gemma2's
# head_dim 256 in f32 (the largest block), a window of 40 that leaves the
# first KV tiles of later query tiles wholly masked, and a ragged S; then
# for the tensor-core body (bf16 at D 64/112/128/256) S not a multiple of a
# block's query rows (128 or 192) or a tile's 64 keys, window edges inside
# a tile and GQA rep 1, 2, 4 and 8; and bf16 at D = 32 (the SIMT body)
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
    # zamba2-7b's head dim (3584 / 32): bf16 on the tensor-core body (the
    # TMA box at column 64 zero-fills columns 112..127), f32 on the SIMT
    # body (16 lanes x 7 columns); a ragged S with window and softcap at
    # GQA rep 4
    (2, 256, 4, 4, 112, torch.bfloat16, 0, 0.0),
    (1, 330, 4, 2, 112, torch.bfloat16, 100, 30.0),
    (2, 77, 2, 1, 112, torch.float32, 0, 50.0),
    (2, 201, 8, 2, 112, torch.bfloat16, 72, 50.0),
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
    wgmma = int(dtype == torch.bfloat16 and D in chip_smoke.WGMMA_DIMS)
    assert flash_attention.LAUNCHES == {**n0, "flash": n0["flash"] + 1,
                                        "flash_wgmma": n0["flash_wgmma"]
                                        + wgmma}
    assert got.dtype == dtype and got.shape == q.shape
    _assert_flash_close(got, plain)


# B8 without the causal mask, (B, S, H, Kv, D, window, softcap), bf16 so
# the tensor-core body runs: its query tiles are issued in order and keys
# right of the query are seen; ragged S and window edges inside a tile;
# D = 112's padded chunk too
FLASH_NONCAUSAL_CASES = [
    (2, 200, 4, 2, 64, 0, 0.0),
    (1, 330, 8, 1, 128, 100, 0.0),
    (1, 77, 8, 8, 128, 40, 30.0),
    (2, 190, 8, 4, 256, 0, 50.0),
    (1, 256, 4, 2, 256, 72, 50.0),
    (1, 200, 4, 2, 112, 40, 30.0),
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
    assert flash_attention.LAUNCHES == {**n0, "flash": n0["flash"] + 1,
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


def _strided_views_match_plain(dev, B, S, H, Kv, D):
    qkv = torch.randn(B, S, H + 2 * Kv, D, device=dev)
    qkv[:, :, :H] *= 8
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Kv], qkv[:, :, H + Kv:]
    n0 = dict(flash_attention.LAUNCHES)
    got = flash_attention.flash_attention(q, k, v, softcap=50.0)
    plain = ref.reference_flash_attention(q, k, v, softcap=50.0)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == {**n0, "flash": n0["flash"] + 1,
                                        "flash_wgmma": n0["flash_wgmma"] + 1}
    _assert_flash_close(got, plain)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_views(h100):
    """q, k, v as views of one fused (B, S, H + 2 Kv, D) projection: the
    kernel reads them through their strides, with no copy."""
    _strided_views_match_plain(h100, 2, 192, 4, 2, 64)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_views_at_112(h100):
    """The same at zamba2's head dim: each view's rows are 224 bytes apart
    and a head's columns 112..127 are the next head's first 16 in memory,
    which the TMA box at column 64 must zero-fill, not read."""
    _strided_views_match_plain(h100, 2, 200, 8, 2, 112)


@pytest.mark.cuda
def test_cuda_flash_body_at_head_dim_112(h100):
    """bf16 at D = 112 runs the tensor-core body, f32 the SIMT body: the
    source's rule and the launch counters agree."""
    from repro_torch.kernels._build import lib
    assert lib().flash_attention_wgmma_body(1, 112) == 1
    assert lib().flash_attention_wgmma_body(0, 112) == 0
    for dtype, wgmma in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v = (torch.randn(1, 130, 2, 112, device=h100).to(dtype)
                   for _ in range(3))
        n0 = dict(flash_attention.LAUNCHES)
        flash_attention.flash_attention(q, k, v)
        assert flash_attention.LAUNCHES == {
            **n0, "flash": n0["flash"] + 1,
            "flash_wgmma": n0["flash_wgmma"] + wgmma}


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
    after_prefill = {**n0, "flash": n0["flash"] + cfg.n_layers,
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


# ef_encode's cases at small sizes, (N, n_params, k, quantize, draw) as in
# chip_smoke.EF_CASES, and the launches each takes: one cluster launch where
# the sample is x itself and fits one cluster; above it a pass over x, the
# select (the int8 codec: a one-block reduce), a second pass
EF_SMALL = [
    ((1000, 1000, 100, True, "parts"), 1),
    ((1000, 1000, 100, False, "parts"), 1),
    ((1000, 1000, None, True, "parts"), 1),
    ((1001, 1001, 100, True, "parts"), 1),          # a ragged tail
    ((4096, 4000, 1, True, "parts"), 1),
    ((4096, 4096, 4096, True, "parts"), 1),
    ((29_184, 28_938, 2_893, True, "parts"), 1),
    ((29_184, 28_938, None, True, "parts"), 1),
    ((131_584, 131_484, 13_148, True, "parts"), 1),  # sampled at stride 1
    ((131_584, 131_484, 13_148, False, "parts"), 1),
    ((524_288, 524_188, 52_418, True, "parts"), 3),  # sampled at stride 4
    ((524_288, 524_188, 52_418, False, "parts"), 3),
    ((524_288, 524_188, None, True, "parts"), 3),
    ((4096, 4000, 400, True, "ties"), 1),
    ((4096, 4000, 400, True, "zeros"), 1),
    ((4096, 4000, 400, True, "nonfinite"), 1),
    ((4096, 4000, 400, False, "nonfinite"), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,launches", EF_SMALL,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}-{c[4]}"
                              for c, _ in EF_SMALL])
def test_cuda_ef_encode_matches_plain(h100, case, launches):
    N, n_params, k, quantize, draw = case
    g = torch.Generator(device=h100).manual_seed(N)
    a, b, c = chip_smoke.ef_inputs(g, N, draw)
    kw = dict(k=k, n_params=n_params, quantize=quantize)
    n0 = topk_quant.LAUNCHES["ef_encode"]
    got = topk_quant.ef_encode(a, b, c, **kw)
    assert topk_quant.LAUNCHES["ef_encode"] == n0 + launches
    want = ref.reference_ef_encode(a, b, c, **kw)
    torch.cuda.synchronize()
    assert chip_smoke.ef_mismatch(got, want) == []
    if k is not None:
        x = a if b is None else (a - b) + c
        assert chip_smoke.same_bits(
            topk_quant.topk_threshold(x, k, n_params),
            ref.reference_topk_threshold(x, k, n_params))


@pytest.mark.cuda
def test_cuda_ef_encode_reads_misaligned_views(h100):
    """Parts that do not start on 16 bytes take the scalar loads."""
    g = torch.Generator(device=h100).manual_seed(5)
    base = [torch.randn(29_185, device=h100, generator=g) for _ in range(3)]
    a, b, c = (t[1:] for t in base)
    kw = dict(k=2_893, n_params=28_938, quantize=True)
    got = topk_quant.ef_encode(a, b, c, **kw)
    want = ref.reference_ef_encode(a, b, c, **kw)
    torch.cuda.synchronize()
    assert chip_smoke.ef_mismatch(got, want) == []


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(chip_smoke.EF_FAULTS))
def test_cuda_ef_encode_check_catches_faults(h100, fault):
    N, n_params, k, quantize, draw = chip_smoke.EF_CASES[
        chip_smoke.EF_FAULTS[fault]]
    g = torch.Generator(device=h100).manual_seed(7)
    a, b, c = chip_smoke.ef_inputs(g, N, draw)
    kw = dict(k=k, n_params=n_params, quantize=quantize)
    got = topk_quant.ef_encode(a, b, c, **kw)
    assert chip_smoke.ef_mismatch(got, ref.reference_ef_encode(a, b, c,
                                                               **kw)) == []
    assert chip_smoke.ef_mismatch(
        got, chip_smoke.ef_plain_fault(fault, a, b, c, **kw))


def _sharded_encode_case(dev, D, N, kw, seed=0):
    """The sharded encode on a mesh of D repeating ``dev``: bit for bit
    against the plain chain on the gathered vectors and the plain staged
    version; returns its launches."""
    from repro_torch.parallel import sharding as psh
    g = torch.Generator(device=dev).manual_seed(seed)
    a, b, c = chip_smoke.shard_enc_inputs(g, N)
    mesh = psh.agg_mesh(devices=(dev,) * D)
    sh = [psh.split(t, mesh) for t in (a, b, c)]
    n0 = topk_quant.LAUNCHES["ef_encode_sharded"]
    got = chip_smoke._gathered(topk_quant.ef_encode(*sh, **kw))
    launches = topk_quant.LAUNCHES["ef_encode_sharded"] - n0
    outs, rs, *rest = ref.reference_ef_encode_sharded(
        *(t.shards for t in sh), **kw, home=mesh.home)
    torch.cuda.synchronize()
    assert chip_smoke.ef_mismatch(got, ref.reference_ef_encode(
        a, b, c, **kw)) == []
    assert chip_smoke.ef_mismatch(got, (torch.cat(outs), torch.cat(rs),
                                        *rest)) == []
    assert chip_smoke.check_ef_stages(*(t.shards for t in sh), **kw) == []
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["topk_ef", "topk_ef+int8", "int8"])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_cuda_sharded_ef_encode_matches_plain(h100, D, codec):
    """The sharded grid form at D = 2, 3, 4 on one card, sampled at stride
    D (and the exact path at 3 x 4,096): every output and every stage bit
    for bit, 2D + 2 launches (2D + 1 for int8)."""
    topk = codec != "int8"
    for N, n_params in ((D << 17, D << 17), (3 * 4096, 3 * 4000)):
        kw = dict(k=n_params // 10 if topk else None, n_params=n_params,
                  quantize=codec != "topk_ef")
        assert _sharded_encode_case(h100, D, N, kw) == \
            2 * D + (2 if topk else 1)


@pytest.mark.cuda
def test_cuda_sharded_ef_encode_with_an_empty_sample_share(h100,
                                                           monkeypatch):
    """A stride above the shard's width leaves shards 1 and 3 of four with
    no share of the sample: their pass 1 writes only partials."""
    monkeypatch.setattr(ref, "SAMPLE_CAP", 2)
    N = 1024
    assert [m for _, m in ref.shard_samples(N, 4, N // 2)] == [1, 0, 1, 0]
    for quantize in (True, False):
        kw = dict(k=100, n_params=1000, quantize=quantize)
        assert _sharded_encode_case(h100, 4, N, kw) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 30, 65, 130])
def test_cuda_dequant_add_rows_matches_plain(h100, W):
    """Bit for bit, the two stale rows beyond zeroed; 130 decodes take two
    launches (128 a launch)."""
    N = 4096
    g = torch.Generator(device=h100).manual_seed(W)
    qs, scales, bases = chip_smoke.rows_inputs(g, W, N)
    rows = torch.full((W + 2, N), float("nan"), device=h100)
    plain = rows.clone()
    n0 = topk_quant.LAUNCHES["decode_rows"]
    assert topk_quant.dequant_add_rows(qs, scales, bases, rows) is rows
    assert topk_quant.LAUNCHES["decode_rows"] == n0 + (W + 127) // 128
    ref.reference_dequant_add_rows(qs, scales, bases, plain)
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(rows, plain) and not rows[W:].any()


@pytest.mark.cuda
def test_cuda_dequant_add_rows_raises_on_misaligned_base(h100):
    qs, scales, bases = chip_smoke.rows_inputs(
        torch.Generator(device=h100).manual_seed(0), 2, 4096)
    bad = torch.randn(4097, device=h100)[1:]
    with pytest.raises(ValueError):
        topk_quant.dequant_add_rows(qs, scales, [bases[0], bad],
                                    torch.empty(2, 4096, device=h100))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sync", "async_delta"])
def test_cuda_uplink_run_launches_fused_codec(h100, mode):
    """A short run over top-k+int8 uplinks: one ef_encode launch an encode
    and no B3; in sync one dequant_add_rows launch a merge, in async_delta
    one dequant_mix launch a merged response (its decode and delta merge),
    and no B4 or B1."""
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    card = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                      batch_size=32, het="strong", device=h100)
    n0 = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    with chip_smoke.counted_encodes() as encodes:
        h = run_fl(card, epochs_per_round=3, max_rounds=4,
                   transport="topk_ef+int8", transport_down="raw",
                   **({"mode": "sync"} if mode == "sync"
                      else {"mode": "async", "async_delta": True}))
    now = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    got = {k: now[k] - n0[k] for k in n0}
    merges = sum(p.n_updates > 0 for p in h[1:])
    assert got["ef_encode"] == encodes[0] >= merges == 4
    assert got["encode"] == got["select"] == got["decode"] == 0
    assert got["ef_encode_dec"] == 0
    if mode == "sync":
        # every response of every round merged, each round one launch
        assert encodes[0] == sum(p.n_updates for p in h[1:])
        assert got["decode_rows"] == merges and got["dequant_mix"] == 0
    else:
        # an async merge per arriving response, decoded in its merge
        assert got["decode_rows"] == got["mix"] == 0
        assert got["dequant_mix"] == merges


# B4's redesign around its path: ef_encode's decoded output (a quantised
# downlink) and dequant_mix (async_delta's delta merge), bit for bit
# against the chain each replaces: (N, n_params), odd and ragged widths,
# the MLP's, the scalar path's, past the exact threshold's cap, the grid
# form at stride 4 and at B7's width
DEC_ENC_CASES = [(1000, 1000), (1001, 1001), (101_888, 101_770),
                 (101_890, 101_890), (131_584, 131_484), (524_288, 524_188),
                 (16_777_216, 16_777_216)]


def _moved(before):
    now = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["topk_ef+int8", "int8"])
@pytest.mark.parametrize("N,n_params", DEC_ENC_CASES)
def test_cuda_ef_encode_decoded_equals_the_chain(h100, N, n_params, codec):
    """Every output, the decoded vector too, equal to the encode then B4
    on the card, under ef_encode_dec alone (1 launch, 3 in the grid
    form)."""
    g = torch.Generator(device=h100).manual_seed(N)
    a, b, *_ = chip_smoke.dec_inputs(g, N)
    kw = chip_smoke.dec_kw(N, n_params, codec)
    want = chip_smoke.dec_chain("ef_encode_dec", (a, b), kw)
    n0 = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    dec = torch.empty(N, device=h100)
    got = (*topk_quant.ef_encode(a, b, **kw, decoded=dec), dec)
    assert _moved(n0) == {
        "ef_encode_dec": 3 if chip_smoke.dec_grid(N, kw) else 1}
    torch.cuda.synchronize()
    assert chip_smoke.dec_mismatch(got, want) == []


@pytest.mark.cuda
@pytest.mark.parametrize("N,n_params", [(29_184, 28_938),
                                        (524_288, 524_188)])
def test_cuda_ef_encode_decoded_reads_a_misaligned_base(h100, N, n_params):
    """A base that does not start on 16 bytes: the cluster sweep's and
    pass 2's scalar loads of it."""
    g = torch.Generator(device=h100).manual_seed(1)
    a = torch.randn(N, device=h100, generator=g)
    b = torch.randn(N + 1, device=h100, generator=g)[1:]
    kw = chip_smoke.dec_kw(N, n_params, "topk_ef+int8")
    dec = torch.empty(N, device=h100)
    got = (*topk_quant.ef_encode(a, b, **kw, decoded=dec), dec)
    torch.cuda.synchronize()
    assert chip_smoke.dec_mismatch(
        got, chip_smoke.dec_chain("ef_encode_dec", (a, b), kw)) == []


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 1000, 1001, 101_888, 101_890,
                               16_777_216])
@pytest.mark.parametrize("w", [chip_smoke.DEC_WVEC, (0.3, 0.5, -0.2)],
                         ids=["delta", "weighted"])
def test_cuda_dequant_mix_equals_the_chain(h100, N, w):
    """dequant_mix fresh and in place (out = server, as the delta merge
    calls it) equal to B4, stack and B1 on the card, one launch each."""
    g = torch.Generator(device=h100).manual_seed(N)
    _, _, q, scale, base, server = chip_smoke.dec_inputs(g, N)
    wd = torch.tensor(w, dtype=torch.float32, device=h100)
    want = chip_smoke.dec_chain("dequant_mix", (q, scale, base, server, wd))
    n0 = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    fresh = fedavg_agg.dequant_mix(q, scale, base, wd, server)
    srv = server.clone()
    assert fedavg_agg.dequant_mix(q, scale, base, wd, srv, out=srv) is srv
    assert _moved(n0) == {"dequant_mix": 2}
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(fresh, want)
    assert chip_smoke.same_bits(srv, want)
    assert chip_smoke.same_bits(
        ref.reference_dequant_mix(q, scale, base, server, wd), want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4, 34])
def test_cuda_sharded_decode_forms_equal_the_chain(h100, D):
    """Both forms on a mesh of D repeating the card, against the
    unsharded chains: the encode's 2D + 2 launches, the merge one launch
    over D pieces (two above the 32-piece table, at 34)."""
    N = 4096 * D
    rec = chip_smoke.check_shard_fused(h100, sizes=((N, N - 100, None),),
                                       meshes=(D,), timed=False)
    assert rec["ef_encode_dec"][0]["launches"] == 2 * D + 2
    assert rec["dequant_mix"][0]["launches"] == (2 if D > 32 else 1)
    assert rec["dequant_mix"][0]["pieces"] == D


@pytest.mark.cuda
@pytest.mark.parametrize("D", [None, 2], ids=["unsharded", "mesh2"])
def test_cuda_delta_vec_of_an_encoded_response_is_one_launch(h100, D,
                                                             monkeypatch):
    """``FlatServerState.delta_vec`` on an ``EncodedVec`` (async_delta's
    quantised response): one ``dequant_mix`` launch (one a device), no B4,
    no B1 and no ``torch.stack``, bit for bit the chain's result."""
    from repro_torch.core import flatbuf
    from repro_torch.parallel import sharding as psh
    dev = torch.device("cuda", 0)
    mesh = None if D is None else psh.agg_mesh(devices=(dev,) * D)
    g = torch.Generator(device=dev).manual_seed(3)
    template = {"w": torch.randn(256, 100, device=dev, generator=g)}
    st = flatbuf.FlatServerState(template, mesh=mesh)
    base = st.pack(template)
    N = st.bundle.padded_size
    q = torch.randint(-127, 128, (N,), device=dev, generator=g,
                      dtype=torch.int8)
    scale = 0.01 * torch.rand((), device=dev, generator=g)
    enc = flatbuf.EncodedVec(q if mesh is None else psh.split(q, mesh),
                             scale, base)
    whole = base if mesh is None else base.gather()
    want = chip_smoke.dec_chain("dequant_mix", (
        q, scale, whole, st.bundle.pack(template),
        torch.tensor(chip_smoke.DEC_WVEC, device=dev)))
    stacks, real = [], torch.stack
    monkeypatch.setattr(torch, "stack",
                        lambda *a, **k: stacks.append(1) or real(*a, **k))
    n0 = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    got = st.delta_vec(template, enc, base)
    assert _moved(n0) == {"dequant_mix": 1} and stacks == []
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert chip_smoke.same_bits(got if mesh is None else got.gather(), want)


@pytest.mark.cuda
def test_cuda_decode_checks_catch_their_controls(h100):
    """chip_smoke's phase 3 checks at small widths, each control (an
    FMA-contracted decode; the delta merge with its rows swapped) caught."""
    checks, controls = chip_smoke.check_decode_forms(
        h100, chip_smoke.DEC_SIZES[:3])
    assert all(not c["mismatch"] for c in checks)
    assert len(controls) == 3 and all(controls.values())


def _parent_route(monkeypatch):
    """The parent's chains in place of the fused forms: a decoding
    encode runs the encode then B4, and a quantised async_delta response
    is decoded on arrival (B4) and merged through the stack and B1."""
    from repro_torch.core import transport as ttr
    real = topk_quant.ef_encode

    def chain(a, b=None, c=None, *, decoded=None, **kw):
        out = real(a, b, c, **kw)
        if decoded is not None:
            dq = topk_quant.dequant_add(out[0], out[3], b)
            if isinstance(decoded, torch.Tensor):
                decoded.copy_(dq)
            else:
                for d, s in zip(decoded.shards, dq.shards):
                    d.copy_(s)
        return out
    monkeypatch.setattr(topk_quant, "ef_encode", chain)
    monkeypatch.setattr(ttr.Link, "up_vec_deferred", ttr.Link.decode_up_vec)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [None, 2], ids=["unsharded", "mesh2"])
@pytest.mark.parametrize("run", ["symmetric/sync", "uplink_only/async_delta"])
def test_cuda_fused_decode_runs_equal_the_chain(h100, run, mesh,
                                                monkeypatch):
    """A short run with the fused forms equals, in every field, the same
    run through the parent's chains on the card; the fused run launches
    no B4 (the symmetric run's downlink encodes under ef_encode_dec, the
    async_delta merges under dequant_mix)."""
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    from repro_torch.parallel import sharding as psh
    dev = torch.device("cuda", 0)
    card = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                      batch_size=32, het="strong", device=dev)
    kw = dict(epochs_per_round=2, max_rounds=4, transport="topk_ef+int8",
              transport_frac=0.1,
              server_mesh=None if mesh is None else psh.agg_mesh(
                  devices=(dev,) * mesh))
    kw.update({"mode": "sync"} if run == "symmetric/sync" else
              {"mode": "async", "async_delta": True,
               "transport_down": "raw"})
    n0 = {**topk_quant.LAUNCHES, **fedavg_agg.LAUNCHES}
    fused = run_fl(card, **kw)
    got = _moved(n0)
    assert got.get("decode", 0) == 0
    if run == "symmetric/sync":
        assert got["ef_encode_dec"] > 0
    else:
        assert got["dequant_mix"] == sum(p.n_updates > 0 for p in fused[1:])
    _parent_route(monkeypatch)
    chain = run_fl(card, **kw)
    assert [vars(p) for p in fused] == [vars(p) for p in chain]


def _fleet_pair(key, h100, rounds):
    """A fleet run of chip_smoke.py on the card and on the CPU from the
    same initial weights, short: (card history, card extras, cpu
    history, cpu extras, the card's encodes)."""
    w0 = {}
    with chip_smoke.counted_encodes() as encodes:
        hg, eg = chip_smoke.fleet_call(
            key, chip_smoke.fleet_setup(key, h100, w0), rounds)
    hc, ec = chip_smoke.fleet_call(
        key, chip_smoke.fleet_setup(key, "cpu", w0), rounds)
    return hg, eg, hc, ec, encodes[0]


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["lossy/sync", "cohort/main_k10",
                                 "chaos_raw/1x2"])
def test_cuda_fleet_run_matches_cpu(h100, key):
    """Lossy links, a cohort and a failing-over 1x2 topology, 3 rounds:
    every non-accuracy field (retransmits included) and the kind's books
    equal the CPU's."""
    hg, eg, hc, ec, _ = _fleet_pair(key, h100, 3)
    assert [[getattr(p, f) for f in chip_smoke.FLEET_FIELDS] for p in hg] \
        == [[getattr(p, f) for f in chip_smoke.FLEET_FIELDS] for p in hc]
    for k in ("ledger", "audit", "failover_dispatches"):
        if k in eg:
            assert eg[k] == ec[k], k


@pytest.mark.cuda
def test_cuda_lossy_topk_run_encodes_once_per_logical_uplink(h100):
    """Top-k+int8 uplinks over lossy links: one ef_encode launch per
    logical uplink payload, while copies were retransmitted."""
    n0 = dict(topk_quant.LAUNCHES)
    hg, eg, _, _, encodes = _fleet_pair("lossy/uplink_only", h100, 3)
    launched = topk_quant.LAUNCHES["ef_encode"] - n0["ef_encode"]
    assert launched == encodes
    chip_smoke.check_encodes(launched, eg["ledger"], eg["retx_up"],
                             "lossy/uplink_only")


@pytest.mark.cuda
def test_cuda_cohort_w_and_flat1x1_equal_the_single_server_run(h100):
    """cohort = W and the 1x1 topology, on the card: the single-server
    run bit for bit, accuracy included."""
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device=h100)
    kw = dict(epochs_per_round=3, max_rounds=4, mode="sync", selector="all")
    want = [vars(p) for p in run_fl(setup, **kw)]
    assert [vars(p) for p in run_fl(setup, cohort=10, **kw)] == want
    assert [vars(p) for p in run_fl(setup, topology="1x1", **kw)] == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uplink_only/sync", "fedadam/async",
                                  "topk/1x2"])
def test_cuda_snapshot_round_trip_resumes_bit_for_bit(h100, case, tmp_path):
    """A run on the card stopped after its first snapshot and resumed from
    disk equals the uninterrupted card run in every field, accuracy bits
    included; the snapshot's tensors are host copies (the file needs no
    card to read), the restored ones live on the card, the responses
    pinned to one model keep one base, and the resumed segment launches
    the path's kernels."""
    import pickle

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device=h100)
    kw = {"uplink_only/sync": dict(mode="sync", transport="topk_ef+int8",
                                   transport_down="raw",
                                   transport_frac=0.1),
          "fedadam/async": dict(mode="async", async_alpha=0.9,
                                async_latest_table=False,
                                aggregator="linear", server_opt="fedadam",
                                server_opt_kw={"lr": 0.05}),
          "topk/1x2": dict(mode="sync", transport="topk_ef+int8",
                           transport_frac=0.1, topology="1x2")}[case]
    kw.update(epochs_per_round=3, max_rounds=4)
    want = [vars(p) for p in run_fl(setup, **kw)]
    d = str(tmp_path / "ckpt")
    run_fl(setup, **kw, checkpoint_every=2, checkpoint_dir=d,
           stop_after_checkpoints=1)
    _, snap, _ = CheckpointManager(d).restore_latest()
    tensors = []

    class Spy(pickle.Pickler):
        def persistent_id(self, o):
            if isinstance(o, torch.Tensor):
                tensors.append(o)
            return None
    Spy(io.BytesIO()).dump(snap)
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    if case != "topk/1x2":
        from repro_torch.core import build_experiment
        loop, server = build_experiment(setup, **kw)
        snap.restore_run(loop, server)
        assert all(t.device.type == "cuda" for t in server.weights.values())
        assert server._flat._rows is None or \
            server._flat._rows.device.type == "cuda"
        cache = [u.weights for u in server._cache]
        if case == "uplink_only/sync":
            assert all(v.base is cache[0].base and v.q.is_cuda
                       for v in cache)
    zero = {k: 0 for k in fedavg_agg.LAUNCHES}
    fedavg_agg.LAUNCHES.update(zero)
    topk_quant.LAUNCHES.update({k: 0 for k in topk_quant.LAUNCHES})
    got = [vars(p) for p in run_fl(setup, **kw, checkpoint_dir=d,
                                   resume=True)]
    assert got == want
    if case == "fedadam/async":
        assert fedavg_agg.LAUNCHES["merge_adam"] > 0
    else:
        assert fedavg_agg.LAUNCHES["agg"] > 0
        assert topk_quant.LAUNCHES["ef_encode"] > 0
        assert topk_quant.LAUNCHES["decode_rows"] > 0


# ---------------- B7: the sharded wrappers on a repeated-card mesh --------

@pytest.mark.cuda
@pytest.mark.parametrize("W,N", [(30, 102_400), (1, 4096), (5, 2048)])
def test_cuda_b7_matches_unsharded_and_plain(h100, W, N):
    """chip_smoke's ``check_b7`` at small sizes: every B7 form bit for bit
    against the unsharded kernel and the plain sharded version at D = 1,
    2 and 4 (meshes repeating the card), one launch covering the D
    pieces."""
    from repro_torch.parallel import sharding as psh
    dev = torch.device("cuda", 0)
    rec = chip_smoke.check_b7(dev, [(W, N)], meshes=(1, 2, 4))
    torch.cuda.synchronize()
    assert rec["ok"] and rec["cases"] == 3 * len(chip_smoke.B7_FORMS)
    # each form's B7 call launches its kernel once for the card's pieces
    counters, pieces = (chip_smoke.launch_counters(),
                        chip_smoke.piece_counters())
    o = chip_smoke.b7_inputs(dev, W, N, seed=0)
    for D in (1, 2, 4):
        o_sh = chip_smoke.b7_sharded(o, psh.agg_mesh(devices=(dev,) * D))
        mesh = o_sh["rows"].mesh
        for form, ctr, _ in chip_smoke.B7_RECORDS.values():
            n0, p0 = counters[ctr][ctr], pieces[ctr][ctr]
            chip_smoke.b7_call(form, o_sh, mesh)
            assert (counters[ctr][ctr] - n0, pieces[ctr][ctr] - p0) == \
                (1, D), (form, D)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_cuda_grouped_forms_equal_unsharded_kernel(h100, D):
    """Every grouped form at D pieces on the card (B7's six, B4 on
    ``Sharded`` q and base, a merge's decodes into sharded rows) bit for
    bit against the unsharded kernel on the whole vectors: one launch
    over D pieces each."""
    from repro_torch.core import flatbuf
    from repro_torch.parallel import sharding as psh
    dev = torch.device("cuda", 0)
    mesh = psh.agg_mesh(devices=(dev,) * D)
    W, N = 7, 4096 * D
    o = chip_smoke.b7_inputs(dev, W, N, seed=D)
    o_sh = chip_smoke.b7_sharded(o, mesh)
    for form in chip_smoke.B7_FORMS:
        got, want = (chip_smoke.b7_call(form, o_sh, mesh),
                     chip_smoke.b7_call(form, o))
        for g, u in zip(got, want):
            assert torch.equal(g.gather(), u), form
    g = torch.Generator(device=dev).manual_seed(D)
    qs, scales, base = chip_smoke.shard_dec_inputs(g, N, W)
    l0, p0 = dict(topk_quant.LAUNCHES), dict(topk_quant.PIECES)
    got = topk_quant.dequant_add(psh.split(qs[0], mesh), scales[0],
                                 psh.split(base, mesh))
    assert chip_smoke.same_bits(got.gather(), topk_quant.dequant_add(
        qs[0], scales[0], base))
    bundle = flatbuf.ParamBundle({"w": torch.empty(N, device="meta")},
                                 mesh=mesh)
    b_sh = psh.split(base, mesh)
    rows_sh = psh.split(torch.full((W + 2, N), float("nan"), device=dev),
                        mesh)
    bundle._set_rows(rows_sh, [flatbuf.EncodedVec(psh.split(q, mesh), s,
                                                  b_sh)
                               for q, s in zip(qs, scales)])
    rows = torch.full((W + 2, N), float("nan"), device=dev)
    topk_quant.dequant_add_rows(qs, scales, [base] * W, rows)
    assert chip_smoke.same_bits(rows_sh.gather(), rows)
    torch.cuda.synchronize()
    for key in ("decode", "decode_rows"):
        assert topk_quant.LAUNCHES[key] - l0[key] == 2, key  # with unsharded
        assert topk_quant.PIECES[key] - p0[key] == D + 1, key


@pytest.mark.cuda
def test_cuda_grouped_forms_split_above_the_table(h100):
    """More pieces on one device than a launch's table holds (32): the
    grouped entries take a launch every 32 pieces, the rows one every 128
    (decode, piece) pairs, bit for bit as before."""
    from repro_torch.kernels import GROUP_PIECES
    from repro_torch.parallel import sharding as psh
    dev = torch.device("cuda", 0)
    D = GROUP_PIECES + 2
    mesh = psh.agg_mesh(devices=(dev,) * D)
    W, N = 5, 256 * D
    o = chip_smoke.b7_inputs(dev, W, N, seed=1)
    o_sh = chip_smoke.b7_sharded(o, mesh)
    n0, p0 = fedavg_agg.LAUNCHES["mix"], fedavg_agg.PIECES["mix"]
    got = chip_smoke.b7_call("mix", o_sh, mesh)[0]
    assert (fedavg_agg.LAUNCHES["mix"] - n0,
            fedavg_agg.PIECES["mix"] - p0) == (2, D)
    assert torch.equal(got.gather(), chip_smoke.b7_call("mix", o)[0])
    g = torch.Generator(device=dev).manual_seed(2)
    qs, scales, base = chip_smoke.shard_dec_inputs(g, N, W)
    rows = [torch.empty(W + 1, N // D, device=dev) for _ in range(D)]
    q_sh = [psh.split(q, mesh).shards for q in qs]
    b_sh = psh.split(base, mesh).shards
    n0 = topk_quant.LAUNCHES["decode_rows"]
    topk_quant.dequant_add_rows_pieces(q_sh, scales, [b_sh] * W, rows)
    assert topk_quant.LAUNCHES["decode_rows"] - n0 == \
        topk_quant.rows_launches(W, 1, D) == 3
    want = torch.empty(W + 1, N, device=dev)
    topk_quant.dequant_add_rows(qs, scales, [base] * W, want)
    assert chip_smoke.same_bits(torch.cat(rows, dim=1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(chip_smoke.SHARD_DEC_FAULTS.values()))
def test_cuda_shard_decode_check_catches_faults(h100, fault):
    with pytest.raises(AssertionError, match="sharded"):
        chip_smoke.check_shard_decode(
            torch.device("cuda", 0), sizes=((8192, 8192, 100),), W=5,
            fault=fault)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", chip_smoke.B7_FAULTS)
def test_cuda_b7_check_catches_faults(h100, fault):
    with pytest.raises(AssertionError, match="B7"):
        chip_smoke.check_b7(torch.device("cuda", 0), [(3, 4096)],
                            meshes=(2,), fault=fault)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["raw/sync", "uplink_only/sync",
                                 "hetero/sync/fedadam"])
def test_cuda_sharded_run_equals_unsharded(h100, key):
    """chip_smoke's ``shard_run`` at a short cut: D = 1, 2 and 4 equal to
    the unsharded card run in every field, D launches a merge."""
    from repro_torch.core import TABLE_4_1, make_setup
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device=h100)
    rec = chip_smoke.shard_run(key, setup, rounds=2, epochs=1)
    assert rec["equal"] == {"1": True, "2": True, "4": True}


@pytest.mark.cuda
def test_cuda_forward_only_kernels_raise_under_autograd(h100):
    """B8 and B9 on CUDA tensors that require grad while autograd records
    raise before launching; under torch.no_grad() they launch."""
    from repro_torch.kernels import rwkv6_kernel
    q, k, v = (torch.randn(1, 64, 2, 112, device=h100,
                           dtype=torch.bfloat16) for _ in range(3))
    q.requires_grad_()
    n0 = dict(flash_attention.LAUNCHES)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention.flash_attention(q, k, v)
    assert flash_attention.LAUNCHES == n0
    with torch.no_grad():
        flash_attention.flash_attention(q, k, v)
    assert flash_attention.LAUNCHES["flash"] == n0["flash"] + 1
    r, kk, vv = (torch.randn(1, 64, 2, 64, device=h100) for _ in range(3))
    w = torch.full_like(r, 0.9)
    u = torch.full((2, 64), 0.5, device=h100, requires_grad=True)
    w0 = rwkv6_kernel.LAUNCHES["wkv"]
    for fn in (rwkv6_kernel.wkv, rwkv6_kernel.wkv_state):
        with pytest.raises(RuntimeError, match="forward only"):
            fn(r, kk, vv, w, u, chunk=16)
    assert rwkv6_kernel.LAUNCHES["wkv"] == w0


@pytest.mark.cuda
def test_cuda_rwkv6_loss_trains_through_wkv_chunked(h100):
    """On the card a REDUCED rwkv6-3b ``loss_fn`` under autograd launches
    B9 zero times (the plain wkv_chunked, JAX's training route) and its
    gradients match the CPU's within 0.06 of each leaf's largest |value|;
    a prefill under torch.no_grad() still launches B9 once a layer."""
    from repro_torch import configs, models
    from repro_torch.kernels import rwkv6_kernel
    from repro_torch.models import transformer
    cfg = configs.get_config("rwkv6-3b", reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")

    def to(tree, d):
        return {n: to(t, d) if isinstance(t, dict) else t.to(d)
                for n, t in tree.items()}
    rng = np.random.RandomState(0)
    batch = {"tokens": _t(rng.randint(0, cfg.vocab_size, (2, 64))),
             "labels": _t(rng.randint(0, cfg.vocab_size, (2, 64)))}
    n0 = rwkv6_kernel.LAUNCHES["wkv"]
    _, _, g_card = transformer._value_and_grad(
        to(params, h100), cfg, to(batch, h100), 0.01)
    torch.cuda.synchronize()
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0
    _, _, g_cpu = transformer._value_and_grad(params, cfg, batch, 0.01)
    for a, b in zip(jax_free_leaves(g_card), jax_free_leaves(g_cpu)):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).abs().max()) <= 0.06 * float(
            b.abs().max().clamp(min=1e-6))
    with torch.no_grad():
        models.prefill_step(to(params, h100),
                            {"tokens": batch["tokens"].to(h100)}, cfg=cfg)
    torch.cuda.synchronize()
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0 + cfg.n_layers


def jax_free_leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from jax_free_leaves(tree[k])
        else:
            yield tree[k]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "zamba2-7b"])
def test_cuda_lm_zoo_prefill_matches_cpu(h100, arch):
    """A REDUCED MoE / zamba2 prefill and 4 decode steps on the card,
    through B8's tensor-core body (zamba2's head dim raised to its full
    size's 112; mixtral at 128, windowed), match the CPU within 0.04 of
    max|logit|; B8 launches once per attention layer (once a group for
    zamba2's shared block), every launch on the tensor-core body, and
    never in decode."""
    from repro_torch import configs, models
    cfg = configs.get_config(arch, reduced=True).replace(attn_impl="pallas")
    if arch == "zamba2-7b":
        cfg = cfg.replace(d_model=448, n_heads=4, n_kv_heads=4)
    else:
        cfg = cfg.replace(head_dim=128, capacity_factor=4.0)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(h100)
                for k, v in tree.items()}
    card = to(params)
    toks = _t(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 68)))
    n_attn = (cfg.n_shared_attn_applications() if cfg.block_type == "mamba2"
              else cfg.n_layers)
    n0 = flash_attention.LAUNCHES["flash"]
    w0 = flash_attention.LAUNCHES["flash_wgmma"]
    lg, st = models.prefill_step(card, {"tokens": toks[:, :64].to(h100)},
                                 cfg=cfg, max_len=68)
    for t in range(64, 68):
        lg, st = models.serve_step(card, st, toks[:, t:t + 1].to(h100), t,
                                   cfg=cfg)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES["flash"] == n0 + n_attn
    assert flash_attention.LAUNCHES["flash_wgmma"] == w0 + n_attn
    lc, sc = models.prefill_step(params, {"tokens": toks[:, :64]}, cfg=cfg,
                                 max_len=68)
    for t in range(64, 68):
        lc, sc = models.serve_step(params, sc, toks[:, t:t + 1], t, cfg=cfg)
    err = (lg.float().cpu() - lc.float()).abs().max() / lc.float().abs().max()
    assert float(err) < 0.04


# The training pair (flash_attention_train: the forward with lse, the
# backward's two launches) against its plain versions, with chip_smoke's
# check (train_pair_check) and limits (TRAIN_FLASH_LIMIT, TRAIN_LSE_LIMIT,
# set there from readings on an H100), at musicgen-medium's pods' shape,
# hd 128 with GQA and two short cases (a ragged last block of query rows,
# GQA at hd 64).
TRAIN_FLASH_CASES = [(8, 1024, 24, 24, 64), (2, 1024, 8, 2, 128),
                     (1, 320, 4, 4, 128), (2, 192, 4, 2, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,D", TRAIN_FLASH_CASES)
def test_cuda_flash_train_matches_plain(h100, B, S, H, Kv, D):
    """The training pair's o, lse, dq, dk and dv within the limits of its
    plain versions; a second forward and backward give the same bits; the
    plain versions with dS as one bf16 term, and with the last diagonal
    tile skipped, exceed them; a forward call is one launch, a backward
    call two."""
    g = torch.Generator(device=h100).manual_seed(S + D + Kv)
    q, k, v, do = (torch.randn(B, S, n, D, device=h100, generator=g)
                   .to(torch.bfloat16) for n in (H, Kv, Kv, H))
    n0 = dict(flash_attention.LAUNCHES)
    res = chip_smoke.train_pair_check(q, k, v, do)
    assert chip_smoke.train_pair_problems(res) == [], res
    assert res["launches"] == {"flash_train_fwd": 1, "flash_train_bwd": 2}
    # the check's own second forward and backward count too
    assert flash_attention.LAUNCHES == {
        **n0, "flash_train_fwd": n0["flash_train_fwd"] + 2,
        "flash_train_bwd": n0["flash_train_bwd"] + 4}


@pytest.mark.cuda
def test_cuda_tensor_map_kernels_run_on_a_new_thread(h100):
    """B8's tensor-core body and both halves of the training pair encode
    their TMA maps with cuTensorMapEncodeTiled, which needs a current
    context: on a host thread that has made no CUDA call yet (autograd's
    worker thread on its first backward) each launch still runs, and
    gives the bits it gives on this thread."""
    import threading
    g = torch.Generator(device=h100).manual_seed(5)
    q, k, v, do = (torch.randn(2, 256, n, 64, device=h100, generator=g)
                   .to(torch.bfloat16) for n in (4, 2, 2, 4))
    calls = {
        "b8": lambda: (flash_attention.flash_attention(
            q, k, v, causal=True, window=0, softcap=0.0),),
        "train_fwd": lambda: flash_attention._train_fwd(q, k, v),
        "train_bwd": lambda: flash_attention._train_bwd(
            q, k, v, *flash_attention._train_fwd(q, k, v), do)}
    for name, call in calls.items():
        # first here, so that the thread's allocations come from the
        # caching allocator and it makes no CUDA call before the launch
        here = call()
        torch.cuda.synchronize(h100)
        got = {}

        def run():
            try:
                got["out"] = call()
                torch.cuda.synchronize(h100)
            except Exception as e:   # reported on the test's thread
                got["err"] = e
        th = threading.Thread(target=run)
        th.start()
        th.join()
        assert "err" not in got, (name, got.get("err"))
        assert all(torch.equal(a, b) for a, b in zip(got["out"], here)), name


@pytest.mark.cuda
def test_cuda_train_step_through_the_pair_matches_chunked(h100,
                                                          monkeypatch):
    """musicgen-medium at full width cut to 2 layers, 2 x 1024 frames: the
    loss and each leaf's gradient norm through the training pair within
    the benchmark contract's gaps (fedbench/limits, loss_gap and grad1_gap)
    of the same step through mha_chunked; the pair runs on every attention
    call (a forward and remat's recomputation a layer, a backward a
    layer, two launches) and mha_chunked on none."""
    import json
    from repro_torch import configs, models, tracing
    from repro_torch.models import attention, transformer
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from fedbench import compare
    limits = json.loads((Path(__file__).resolve().parents[1] / "fedbench"
                         / "limits" / "musicgen-pods.raw-h10.json")
                        .read_text())
    cfg = configs.get_config("musicgen-medium").replace(n_layers=2)
    params = models.init_params(torch.Generator(device=h100).manual_seed(0),
                                cfg, device=h100)
    g = torch.Generator(device=h100).manual_seed(1)
    batch = {"embeds": torch.randn(2, 1024, cfg.d_model, device=h100,
                                   generator=g).to(torch.bfloat16),
             "labels": torch.randint(0, cfg.vocab_size, (2, 1024),
                                     device=h100, generator=g)}

    def step():
        loss, _, grads = transformer._value_and_grad(params, cfg, batch,
                                                     0.01)
        flat = dict(compare_leaves(grads))
        return float(loss), {k: float(t.float().norm())
                             for k, t in flat.items()}
    n0 = dict(flash_attention.LAUNCHES)
    tracing.start(h100)
    try:
        fused_loss, fused = step()
    finally:
        rec = tracing.stop()
    torch.cuda.synchronize()
    assert rec.counters == {"attn.fused": 2 * cfg.n_layers}
    assert flash_attention.LAUNCHES == {
        **n0, "flash_train_fwd": n0["flash_train_fwd"] + 2 * cfg.n_layers,
        "flash_train_bwd": n0["flash_train_bwd"] + 2 * cfg.n_layers}
    monkeypatch.setattr(attention, "fused_route", lambda *a, **k: False)
    chunk_loss, chunk = step()
    assert compare.rel_gap(fused_loss, chunk_loss) <= limits["loss_gap"]
    assert compare.gap_of_norms(fused, chunk) <= limits["grad1_gap"]


def compare_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from compare_leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]
