"""B4's redesign around its path, on the CPU, where each wrapper runs its
plain version: ``ef_encode``'s decoded output (a quantised downlink's
encode writes ``base + q * scale``, the receiver's model, itself) and
``fedavg_agg.dequant_mix`` (async_delta's decode and delta merge of a
quantised response in one pass); inputs drawn with numpy from a seed.

* Both forms bit for bit against the port's own chain (the encode, then
  ``dequant_add``; ``dequant_add``, ``torch.stack``, the mix), at N = 1000,
  101,888, 101,890 and 2^17 + 512, in the top-k+int8 and int8 codecs, and
  on CPU meshes of D = 1, 2 and 4 (``chip_smoke.check_shard_fused``).
* Both against JAX's chain: ``repro.kernels.topk_quant.dequant_add`` as
  its tests run it (XLA; the Pallas kernel in interpret mode at the small
  width) and ``repro.core.flatbuf``'s ``delta_vec``.  XLA contracts
  ``base + q * scale`` into one FMA on the CPU, so the decode is held to
  ``tests/test_torch_codec_fused.py``'s bound: one f32 spacing of ``q *
  scale`` (the rounding the FMA skips) plus one of the result; the merged
  vector within that plus, for each of the merge's two roundings (XLA
  adds the three terms in an order of its own), one spacing of ``|new| +
  |base| + |server|``.
* ``run_fl`` over symmetric top-k+int8 links (sync) and over top-k+int8
  uplinks in async_delta, unsharded and at ``server_mesh`` 2 and 4: every
  history field equal bit for bit to the same run through the parent's
  chains (a decoding encode run as the encode then ``dequant_add``; a
  quantised async_delta response decoded on arrival and merged through the
  stack and the mix), and the fused runs call ``dequant_add`` never, the
  async_delta run ``dequant_mix`` once a merge.
* ``chip_smoke.py``'s checks of both forms (phase 3's and phase 9's)
  rehearsed, and each of its controls (an FMA-contracted decode, the delta
  merge reading row 1 as the decoded row) caught.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro.kernels import topk_quant as jtq
from repro_torch.core import TABLE_4_1, flatbuf, make_setup, run_fl
from repro_torch.core import transport as ttr
from repro_torch.kernels import fedavg_agg, ref, topk_quant
from repro_torch.parallel import sharding as psh

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# padded width -> logical parameters: a small vector, the MLP's, the
# scalar path's width, one past the exact threshold's cap
N_PARAMS = {1000: 1000, 101_888: 101_770, 101_890: 101_890,
            (1 << 17) + 512: (1 << 17) + 400}
CODECS = ("topk_ef+int8", "int8")
DELTA_W = np.asarray(chip_smoke.DEC_WVEC, np.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(N, seed=0):
    """Numpy f32 a, b (the downlink's model and acked base), int8 q, a
    scale, base and server (the delta merge's response and model)."""
    rng = np.random.RandomState(seed + N)
    a, b, base, server = (rng.randn(N).astype(np.float32) for _ in range(4))
    q = rng.randint(-127, 128, N).astype(np.int8)
    return a, b, q, np.float32(0.01 * rng.rand()), base, server


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(v)) for v in arrays)


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _spacing(v):
    return np.spacing(np.abs(np.asarray(v, np.float32))).astype(np.float64)


def _gap(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("N", sorted(N_PARAMS))
def test_encode_decoded_equals_the_chain_and_jax(N, codec):
    a, b, *_ = _inputs(N)
    ta, tb = _t(a, b)
    kw = chip_smoke.dec_kw(N, N_PARAMS[N], codec)
    dec = torch.empty(N)
    got = (*topk_quant.ef_encode(ta, tb, **kw, decoded=dec), dec)
    want = chip_smoke.dec_chain("ef_encode_dec", (ta, tb), kw)
    assert chip_smoke.dec_mismatch(got, want) == []
    assert chip_smoke.dec_mismatch(got, ref.reference_ef_encode_decoded(
        ta, tb, k=kw["k"], n_params=kw["n_params"])) == []
    # JAX's decode of the same payload against the same base
    q, scale = got[0].numpy(), got[3].numpy()
    jdec = np.asarray(jtq.dequant_add(jnp.asarray(q), scale,
                                      jnp.asarray(b)))
    prod = q.astype(np.float32) * scale
    assert np.all(_gap(dec.numpy(), jdec) <= _spacing(jdec) + _spacing(prod))
    assert np.array_equal(_bits(dec), _bits(b + prod))


def test_encode_decoded_pallas_interpret_matches():
    """The JAX package's Pallas decode (interpret mode) on the downlink's
    payload, within the same bound."""
    N = 4096
    a, b, *_ = _inputs(N)
    ta, tb = _t(a, b)
    dec = torch.empty(N)
    got = topk_quant.ef_encode(ta, tb, **chip_smoke.dec_kw(
        N, N, "topk_ef+int8"), decoded=dec)
    q, scale = got[0].numpy(), got[3].numpy()
    pallas = np.asarray(jtq.dequant_add(jnp.asarray(q), scale,
                                        jnp.asarray(b), use_pallas=True,
                                        interpret=True))
    prod = q.astype(np.float32) * scale
    assert np.all(_gap(dec.numpy(), pallas) <= _spacing(pallas)
                  + _spacing(prod))


@pytest.mark.parametrize("N", sorted(N_PARAMS))
def test_dequant_mix_equals_the_chain_and_jax(N):
    _, _, q, scale, base, server = _inputs(N)
    tq, tsc, tb, ts = _t(q, scale, base, server)
    w = torch.from_numpy(DELTA_W)
    want = chip_smoke.dec_chain("dequant_mix", (tq, tsc, tb, ts, w))
    fresh = fedavg_agg.dequant_mix(tq, tsc, tb, w, ts)
    srv = ts.clone()
    assert fedavg_agg.dequant_mix(tq, tsc, tb, w, srv, out=srv) is srv
    for got in (fresh, srv, ref.reference_dequant_mix(tq, tsc, tb, ts, w)):
        assert chip_smoke.same_bits(got, want)
    # JAX: dequant_add, then the flat state's delta merge
    jnew = jtq.dequant_add(jnp.asarray(q), scale, jnp.asarray(base))
    tree = {"v": jnp.asarray(server)}
    jst = jflat.FlatServerState(tree)
    jv = np.asarray(jst.delta_vec(
        tree, jst.bundle.pack({"v": jnew}),
        jst.bundle.pack({"v": jnp.asarray(base)})))[:N]
    new = np.asarray(jnew)
    lim = (_spacing(new) + _spacing(q.astype(np.float32) * scale)
           + 2 * _spacing(np.abs(new) + np.abs(base) + np.abs(server)))
    assert np.all(_gap(fresh.numpy(), jv) <= lim)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_forms_equal_the_unsharded_chain(D):
    """Both forms on a CPU mesh of D: bit for bit against the unsharded
    chains at the MLP's width padded for D = 4 and at 2^17 + 2048 (the
    sampled path at stride 1)."""
    rec = chip_smoke.check_shard_fused(
        torch.device("cpu"), sizes=((102_400, 101_770, None),
                                    ((1 << 17) + 2048, (1 << 17) + 2000,
                                     None)),
        meshes=(D,), timed=False)
    assert rec["ok"]
    assert [c["D"] for c in rec["ef_encode_dec"]] == [D, D]
    assert all(c["equal"] for c in rec["dequant_mix"])


def test_delta_vec_takes_an_encoded_response():
    """``FlatServerState.delta_vec`` on an ``EncodedVec`` encoded against
    the delta's base: one ``dequant_mix`` call (no ``dequant_add``, no
    stack), bit for bit the decoded response's delta merge, unsharded and
    on a mesh; against another base it decodes first."""
    rng = np.random.RandomState(7)
    template = {"w": torch.from_numpy(rng.randn(64, 32).astype(np.float32))}
    for mesh in (None, psh.agg_mesh(devices=[torch.device("cpu")] * 2)):
        st, ref_st = (flatbuf.FlatServerState(template, mesh=mesh)
                      for _ in range(2))
        N = st.bundle.padded_size
        base = st.pack(template)
        q = torch.from_numpy(rng.randint(-127, 128, N).astype(np.int8))
        if mesh is not None:
            q = psh.split(q, mesh)
        scale = torch.tensor(np.float32(0.02))
        enc = flatbuf.EncodedVec(q, scale, base)
        calls = {"mix": 0, "add": 0}
        real_mix, real_add = (fedavg_agg.dequant_mix_pieces,
                              topk_quant.dequant_add_pieces)

        def mix(*a, **k):
            calls["mix"] += 1
            return real_mix(*a, **k)

        def add(*a, **k):
            calls["add"] += 1
            return real_add(*a, **k)
        fedavg_agg.dequant_mix_pieces = mix
        topk_quant.dequant_add_pieces = add
        try:
            got = st.delta_vec(template, enc, base)
            assert calls == {"mix": 1, "add": 0}
            new = topk_quant.dequant_add(q, scale, base)
            want = ref_st.delta_vec(template, new, base)
            other = st.pack(template)        # equal bits, another object
            st.forget_server()
            again = st.delta_vec(template, enc, other)
            assert calls == {"mix": 1, "add": 2}
        finally:
            fedavg_agg.dequant_mix_pieces = real_mix
            topk_quant.dequant_add_pieces = real_add
        if mesh is not None:
            got, want, again = got.gather(), want.gather(), again.gather()
        assert chip_smoke.same_bits(got, want)
        assert chip_smoke.same_bits(again, want)


def _parent_route(monkeypatch):
    """The parent's chains in place of the fused forms: a decoding encode
    runs the encode, then ``dequant_add``; a quantised async_delta response
    is decoded on arrival and merged through the stack and the mix."""
    real = topk_quant.ef_encode

    def chain(a, b=None, c=None, *, decoded=None, **kw):
        out = real(a, b, c, **kw)
        if decoded is not None:
            dq = topk_quant.dequant_add(out[0], out[3], b)
            for d, s in (((decoded, dq),) if isinstance(dq, torch.Tensor)
                         else zip(decoded.shards, dq.shards)):
                d.copy_(s)
        return out
    monkeypatch.setattr(topk_quant, "ef_encode", chain)
    monkeypatch.setattr(ttr.Link, "up_vec_deferred", ttr.Link.decode_up_vec)


RUNS = {"symmetric/sync": dict(mode="sync"),
        "uplink_only/async_delta": dict(mode="async", async_delta=True,
                                        transport_down="raw")}


@pytest.mark.parametrize("D", [None, 2, 4], ids=["unsharded", "mesh2",
                                                 "mesh4"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_fl_histories_equal_the_chain(run, D, monkeypatch):
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device="cpu")
    kw = dict(epochs_per_round=1, max_rounds=3, transport="topk_ef+int8",
              transport_frac=0.1, **RUNS[run],
              server_mesh=None if D is None else psh.agg_mesh(
                  devices=[torch.device("cpu")] * D))
    calls = {"add": 0, "mix": 0, "dec": 0}
    real_add, real_mix = (topk_quant.dequant_add_pieces,
                          fedavg_agg.dequant_mix_pieces)
    real_enc = topk_quant.ef_encode

    def add(*a, **k):
        calls["add"] += 1
        return real_add(*a, **k)

    def mix(*a, **k):
        calls["mix"] += 1
        return real_mix(*a, **k)

    def enc(*a, decoded=None, **k):
        calls["dec"] += decoded is not None
        return real_enc(*a, decoded=decoded, **k)
    with monkeypatch.context() as m:
        m.setattr(topk_quant, "dequant_add_pieces", add)
        m.setattr(fedavg_agg, "dequant_mix_pieces", mix)
        m.setattr(topk_quant, "ef_encode", enc)
        fused = run_fl(setup, **kw)
    merges = sum(p.n_updates > 0 for p in fused[1:])
    assert calls["add"] == 0
    if run == "symmetric/sync":
        assert calls["dec"] > 0 and calls["mix"] == 0
    else:
        assert calls["dec"] == 0 and calls["mix"] == merges > 0
    _parent_route(monkeypatch)
    chain = run_fl(setup, **kw)
    assert [vars(p) for p in fused] == [vars(p) for p in chain]


def test_chip_smoke_decode_checks_rehearsed():
    """Phase 3's check of both forms at its small widths on the CPU, and
    each of its controls disagreeing with the plain chain."""
    checks, controls = chip_smoke.check_decode_forms(
        torch.device("cpu"), chip_smoke.DEC_SIZES[:3])
    assert len(checks) == 9 and all(not c["mismatch"] for c in checks)
    assert sorted(controls) == sorted(
        f"{f} ({form})" for f, forms in chip_smoke.DEC_FAULTS.items()
        for form in forms)
    assert all(controls.values())
