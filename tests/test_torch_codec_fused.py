"""The fused codec forms of the port (``kernels/topk_quant.ef_encode`` and
``dequant_add_rows``, and the merge that decodes deferred responses)
against the JAX package on the CPU, where each wrapper runs its plain
version; inputs drawn with numpy from a seed.

* ``ef_encode`` on ``x = (a - b) + c`` against JAX's ``ef_topk_encode``
  (the top-k codecs) and the int8 codec's ``_int8_scale`` +
  ``topk_quant_encode``, at N = 1000, 29,184, 101,888 (the exact
  threshold) and 2^17 + 512 (the strided sample), with the inputs drawn
  three ways: random parts, values from a small set (ties at the
  threshold) and all zeros.  Threshold, kept count, wire bytes, q, scale
  and the masked recon and residual are equal bit for bit.  The quantised
  residual is equal bit for bit to ``x - q * scale`` rounded twice, as
  the port and JAX's own source spell it; XLA contracts that into one
  FMA on the CPU, so against JAX's output it is held to one f32 spacing
  of ``q * scale`` (the rounding the FMA skips) plus one of the result.
* ``dequant_add_rows`` row by row against JAX's ``dequant_add``, the same
  way (XLA's ``base + q * scale`` is an FMA too), with the stale rows
  beyond zeroed.
* ``run_fl`` over top-k+int8 uplinks in every mode: with responses kept
  encoded until the merge (the default in sync, time_based and FedAsync
  async) every history field equals a run that decodes each response as
  it arrives, and every such merge is one ``dequant_add_rows`` call.
* ``chip_smoke.py``'s controls of its ``ef_encode`` check (each faulty
  plain version differs from the plain version) and its recording and
  replay of a run's encodes and merges, rehearsed on the CPU.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as jtr
from repro.kernels import topk_quant as jtq
from repro_torch.core import TABLE_4_1, flatbuf, make_setup, run_fl
from repro_torch.core import transport as ttr
from repro_torch.kernels import topk_quant

FRAC = 0.1
# padded width -> logical parameters (the MLP's and the CNN's at MNIST
# width, a small vector, and one past the exact threshold's cap)
N_PARAMS = {1000: 1000, 29_184: 28_938, 101_888: 101_770,
            (1 << 17) + 512: (1 << 17) + 400}
CODECS = ("topk_ef+int8", "topk_ef", "int8")


def _parts(N, kind, seed=0):
    """(a, b, c) f32 numpy vectors; x = (a - b) + c."""
    rng = np.random.RandomState(seed + N)
    if kind == "parts":
        a, b = (rng.randn(N).astype(np.float32) for _ in range(2))
        c = (0.01 * rng.randn(N)).astype(np.float32)
        return a, b, c
    if kind == "ties":       # 41 distinct values: ties at any threshold
        a = (rng.randint(-20, 21, N) * 0.001).astype(np.float32)
    else:
        a = np.zeros(N, np.float32)
    return a, np.zeros(N, np.float32), np.zeros(N, np.float32)


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _spacing_bound(port, want, q, scale):
    """|port - want| <= spacing(|want|) + spacing(|q * scale|): the
    rounding of q * scale that an FMA skips, and the result's rounding,
    which it may then land on either side of."""
    prod = np.abs(q.astype(np.float32) * np.float32(scale))
    lim = np.spacing(np.abs(want)).astype(np.float64) + np.spacing(prod)
    gap = np.abs(port.astype(np.float64) - want.astype(np.float64))
    return bool(np.all(gap <= lim))


@pytest.mark.parametrize("kind", ["parts", "ties", "zeros"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("N", sorted(N_PARAMS))
def test_plain_ef_encode_matches_jax(N, codec, kind):
    n = N_PARAMS[N]
    spec = ttr.CODECS[codec]
    a, b, c = _parts(N, kind)
    x = (a - b) + c                               # two roundings, as both
    xj = (jnp.asarray(a) - jnp.asarray(b)) + jnp.asarray(c)
    assert np.array_equal(_bits(xj), _bits(x))
    k = ttr.topk_k(n, FRAC) if spec.topk else None
    out, r, thresh, scale, kept = topk_quant.ef_encode(
        *(torch.from_numpy(v) for v in (a, b, c)), k=k, n_params=n,
        quantize=spec.quantize)
    if spec.topk:
        jthr = jtr.topk_threshold(xj, k, n)
        assert _bits(thresh) == _bits(jthr)
        assert int(kept) == int(jtr._kept_count(xj, jthr))
        jd, _, jres, jwire = jtr.ef_topk_encode(xj, n_params=n, frac=FRAC,
                                                quantize=spec.quantize)
        td, _, tres, twire = ttr.ef_topk_encode(
            torch.from_numpy(x), n_params=n, frac=FRAC,
            quantize=spec.quantize)
        assert twire == jwire
        assert np.array_equal(_bits(tres), _bits(r))
        if spec.quantize:
            jq, js = np.asarray(jd[0]), np.asarray(jd[1])
            assert torch.equal(td[0], out)
        else:
            assert np.array_equal(_bits(out), _bits(jd))
            assert np.array_equal(_bits(r), _bits(jres))
            return
    else:
        assert float(thresh) == 0.0
        js = np.asarray(jtr._int8_scale(xj))
        jq, jres = (np.asarray(v) for v in
                    jtq.topk_quant_encode(xj, 0.0, js))
    assert np.array_equal(out.numpy(), jq)
    assert _bits(scale) == _bits(js)
    qs = jq.astype(np.float32) * js
    assert np.array_equal(_bits(r), _bits(x - qs))
    assert _spacing_bound(r.numpy(), np.asarray(jres), jq, js)


@pytest.mark.parametrize("W", [1, 30, 65])
def test_plain_dequant_add_rows_matches_jax(W):
    N, cap = 101_888, W + 3
    rng = np.random.RandomState(W)
    qs = [rng.randint(-127, 128, N).astype(np.int8) for _ in range(W)]
    scales = [np.float32(rng.rand() * 0.01) for _ in range(W)]
    distinct = [rng.randn(N).astype(np.float32) for _ in range(3)]
    bases = [distinct[i % 3] for i in range(W)]   # shared, as in a round
    rows = torch.full((cap, N), float("nan"))
    got = topk_quant.dequant_add_rows(
        [torch.from_numpy(q) for q in qs],
        [torch.tensor(s) for s in scales],
        [torch.from_numpy(bv) for bv in bases], rows)
    assert got is rows
    for i in range(W):
        want = np.asarray(jtq.dequant_add(jnp.asarray(qs[i]), scales[i],
                                          jnp.asarray(bases[i])))
        row = rows[i].numpy()
        assert np.array_equal(_bits(row), _bits(
            bases[i] + qs[i].astype(np.float32) * scales[i]))
        assert _spacing_bound(row, want, qs[i], scales[i])
    assert not rows[W:].any()


def test_merge_rows_decodes_encoded_vecs_like_decoded_ones():
    """``merge_rows`` over ``EncodedVec``s equals the merge over their
    decoded vectors bit for bit, a dirty row beyond them included."""
    rng = np.random.RandomState(3)
    template = {"w": torch.from_numpy(rng.randn(40, 25).astype(np.float32)),
                "b": torch.from_numpy(rng.randn(25).astype(np.float32))}
    st, ref_st = flatbuf.FlatServerState(template), \
        flatbuf.FlatServerState(template)
    N = st.bundle.padded_size
    base = torch.from_numpy(rng.randn(N).astype(np.float32))
    encs = [flatbuf.EncodedVec(
        torch.from_numpy(rng.randint(-127, 128, N).astype(np.int8)),
        torch.tensor(np.float32(0.01 * (i + 1))), base) for i in range(3)]
    decoded = [topk_quant.dequant_add(e.q, e.scale, e.base) for e in encs]
    for s in (st, ref_st):       # a first merge of 4 leaves row 3 stale
        s.merge_rows(template, decoded + [base], [1.0] * 4)
        s._rows[3] = float("inf")
    got = st.merge_rows(template, encs, [1.0, 2.0, 3.0], alpha=0.5)
    want = ref_st.merge_rows(template, decoded, [1.0, 2.0, 3.0], alpha=0.5)
    assert torch.equal(st._rows, ref_st._rows)
    for key in template:
        assert torch.equal(got[key], want[key])


MODES = {"sync": dict(mode="sync"),
         "async": dict(mode="async", async_alpha=0.9,
                       async_latest_table=False, aggregator="linear"),
         "async_delta": dict(mode="async", async_delta=True),
         "time_based": dict(mode="sync", selector="time_based",
                            selector_kw={"r": 2, "T0": 0.0, "A": 0.01})}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_deferred_decoding_keeps_uplink_only_histories(mode, monkeypatch):
    kw = dict(seed=0, noise=0.25, batch_size=32, het="strong")
    rkw = dict(epochs_per_round=2, max_rounds=4, transport="topk_ef+int8",
               transport_down="raw", transport_frac=0.1, **MODES[mode])
    setup = make_setup(TABLE_4_1["mnist_even"], **kw, device="cpu")
    calls = []
    real = topk_quant.dequant_add_rows

    def counted(qs, *args):
        calls.append(len(qs))
        return real(qs, *args)
    monkeypatch.setattr(topk_quant, "dequant_add_rows", counted)
    deferred = run_fl(setup, **rkw)
    merges = sum(p.n_updates > 0 for p in deferred[1:])
    if mode == "async_delta":
        assert calls == []
    else:
        assert merges >= 2 and len(calls) == merges
        assert [p.n_updates for p in deferred[1:] if p.n_updates] == calls
    monkeypatch.setattr(ttr.Link, "up_vec_deferred",
                        ttr.Link.decode_up_vec)
    calls.clear()
    immediate = run_fl(setup, **rkw)
    assert calls == []
    assert [vars(p) for p in deferred] == [vars(p) for p in immediate]


# chip_smoke.py holds ef_encode's controls and the replay of a run's codec
# calls; here both are rehearsed on the CPU
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _draw(N, draw, seed=0):
    """chip_smoke's EF_CASES draws, made with numpy: (a, b, c) tensors."""
    rng = np.random.RandomState(seed)
    if draw == "parts":
        a, b = (rng.randn(N).astype(np.float32) for _ in range(2))
        c = (0.01 * rng.randn(N)).astype(np.float32)
        return tuple(torch.from_numpy(v) for v in (a, b, c))
    x = rng.randn(N).astype(np.float32)
    x[5], x[77], x[99] = np.nan, np.inf, -np.inf
    x[1000:1100] = -0.0
    return torch.from_numpy(x), None, None


@pytest.mark.parametrize("fault", sorted(chip_smoke.EF_FAULTS))
def test_chip_smoke_ef_faults_fail_against_plain(fault):
    """Each control of chip_smoke's ef_encode check, on its case, differs
    from the plain version (which on the card the kernel equals)."""
    N, n_params, k, quantize, draw = chip_smoke.EF_CASES[
        chip_smoke.EF_FAULTS[fault]]
    a, b, c = _draw(N, draw)
    kw = dict(k=k, n_params=n_params, quantize=quantize)
    plain = topk_quant.ef_encode(a, b, c, **kw)
    assert chip_smoke.ef_mismatch(plain, plain) == []
    assert chip_smoke.ef_mismatch(
        plain, chip_smoke.ef_plain_fault(fault, a, b, c, **kw))


def test_chip_smoke_recorded_codec_replays_a_run():
    """chip_smoke's recorder on a short sync run over top-k+int8 uplinks:
    every encode and merge is recorded, and replays through the plain
    versions equal bit for bit."""
    from repro_torch.kernels import ref
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device="cpu")
    encodes, merges = [], []
    real = topk_quant.ef_encode
    with chip_smoke.recorded_codec(encodes, merges):
        h = run_fl(setup, epochs_per_round=2, max_rounds=2,
                   transport="topk_ef+int8", transport_down="raw")
    assert topk_quant.ef_encode is real and len(merges) == 2
    assert len(encodes) == sum(p.n_updates for p in h[1:])
    for ins, kw, out in encodes:
        assert ins[1] is not None           # the dispatch base
        assert chip_smoke.ef_mismatch(
            out, ref.reference_ef_encode(*ins, **kw)) == []
    for qs, scales, bases, rows in merges:
        plain = torch.full_like(rows, float("nan"))
        ref.reference_dequant_add_rows(qs, scales, bases, plain)
        assert chip_smoke.same_bits(rows, plain)
