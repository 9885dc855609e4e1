"""The port's transport layer (repro_torch.core.transport) against the JAX
package's, on the same numpy inputs: the EF top-k(+int8) encode on the
exact and the sampled threshold paths, the codec byte table, and the
link protocol (dispatch, fetch/ack, uplink encode/decode, restores) for
every codec.  Thresholds, kept counts and wire bytes are equal.  Vectors
agree within 1e-6, except along the link's quantised codecs: there each
decode ``base + q*scale`` and residual ``x - q*scale`` may differ by one
rounding of the product (XLA may fuse it into an FMA), and residuals carry
those differences from dispatch to dispatch, so they are held to 1e-6
relative to the vector's largest magnitude (about 8 ulps)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transport as jtr
from repro_torch.core import transport as ttr

SHAPES = {"a": (30, 30), "b": (100,)}       # 1000 params


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jt(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def _tt(t):
    return {k: torch.from_numpy(v.copy()) for k, v in t.items()}


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("n,quantize", [(5000, True), (5000, False),
                                        (200_000, True), (200_000, False)])
def test_ef_topk_encode_matches_jax(n, quantize):
    """n = 200,000 > 2**17 takes the strided-sample threshold."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    k = jtr.topk_k(n, 0.1)
    jthr = float(jtr.topk_threshold(jnp.asarray(x), k, n))
    tthr = float(ttr.topk_threshold(torch.from_numpy(x), k, n))
    assert tthr == jthr
    jd, jrec, jres, jwire = jtr.ef_topk_encode(jnp.asarray(x), n_params=n,
                                               frac=0.1, quantize=quantize)
    td, trec, tres, twire = ttr.ef_topk_encode(torch.from_numpy(x),
                                               n_params=n, frac=0.1,
                                               quantize=quantize)
    assert twire == jwire
    if quantize:
        assert np.array_equal(td[0].numpy(), np.asarray(jd[0]))
        assert float(td[1]) == float(jd[1])
    assert _err(trec.numpy(), jrec) < 1e-6
    assert _err(tres.numpy(), jres) < 1e-6


def test_zero_vector_selects_nothing():
    x = torch.zeros(2048)
    _, recon, resid, wire = ttr.ef_topk_encode(x, n_params=2000, frac=0.1,
                                               quantize=True)
    assert wire == ttr.bitmap_bytes(2000) + 4 and not recon.any()


@pytest.mark.parametrize("codec", sorted(jtr.CODECS))
def test_expected_codec_bytes_match_jax(codec):
    for n, raw, frac in ((1000, 4000, 0.1), (101_770, 407_080, 0.01),
                         (7, 28, 0.5)):
        assert ttr.expected_codec_bytes(ttr.CODECS[codec], n, raw, frac) == \
            jtr.expected_codec_bytes(jtr.CODECS[codec], n, raw, frac)
    jt = jtr.Transport(_jt(_tree(0)), codec)
    tt = ttr.Transport(_tt(_tree(0)), codec)
    assert (tt.expected_up_bytes(), tt.expected_down_bytes(),
            tt.expected_oneway_bytes()) == \
        (jt.expected_up_bytes(), jt.expected_down_bytes(),
         jt.expected_oneway_bytes())


def test_raw_codec_round_trip_is_exact():
    t = _tt(_tree(1))
    tr = ttr.Transport(t, "raw")
    link = tr.link("w0")
    down = link.encode_down(t)
    assert down.codec == "raw" and down.wire_bytes == 4000
    assert link.complete_fetch(down) is t
    up = link.encode_up(t)
    assert torch.equal(link.decode_up_vec(up), tr.bundle.pack(t))


def _run_link(mod, wrap, unwrap, codec):
    """One scripted conversation on one link; returns what it observed."""
    trees = [wrap(_tree(10 + i, scale=1.0 + 0.1 * i)) for i in range(5)]
    tr = mod.Transport(trees[0], codec)
    link = tr.link("w0")
    out = []
    for i in range(3):
        down = link.encode_down(trees[i])
        got = link.complete_fetch(down)
        out.append((down.codec, down.wire_bytes,
                    unwrap(tr.bundle.pack(got))))
        up = link.encode_up(trees[i + 1])
        out.append((up.codec, up.wire_bytes,
                    unwrap(link.decode_up_vec(up))))
    # a cancelled downlink reverts; a discarded uplink credits back
    down = link.encode_down(trees[4])
    link.restore_downlink(down)
    up = link.encode_up(trees[3])
    link.restore_uplink(up)
    for v in (link.acked_base, link.down_residual, link.residual):
        out.append(None if v is None else unwrap(v))
    return out


@pytest.mark.parametrize("codec", sorted(jtr.CODECS))
def test_link_protocol_matches_jax(codec):
    ref = _run_link(jtr, _jt, np.asarray, codec)
    port = _run_link(ttr, _tt, lambda v: v.numpy(), codec)

    def close(p, r):
        tol = 1e-6
        if jtr.CODECS[codec].quantize:
            tol *= max(1.0, float(np.max(np.abs(r))))
        return _err(p, r) <= tol

    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        if r is None or p is None:
            assert r is None and p is None
        elif isinstance(r, tuple):
            assert p[:2] == r[:2]
            assert close(p[2], r[2])
        else:
            assert close(p, r)


def test_auto_and_lossy_links_are_not_ported():
    """The auto resolver and lossy links are ported (tests/
    test_torch_autotune.py, tests/test_torch_transport_lossy.py): an auto
    transport builds its tuner and ``LinkReliability`` has JAX's fields
    and defaults; an unknown codec still raises as JAX's does."""
    tr = ttr.Transport(_tt(_tree(0)), "auto")
    jt = jtr.Transport(_jt(_tree(0)), "auto")
    assert (tr.codec, tr.auto_up, tr.auto_down, tr.tuner.n_params) == \
        (jt.codec, jt.auto_up, jt.auto_down, jt.tuner.n_params)
    assert vars(ttr.LinkReliability(drop_p=0.1)) == \
        vars(jtr.LinkReliability(drop_p=0.1))
    with pytest.raises(ValueError):
        ttr.Transport(_tt(_tree(0)), "gzip")


@pytest.mark.parametrize("codec", ["delta", "int8", "topk_ef",
                                   "topk_ef+int8"])
def test_run_fl_with_symmetric_codec_matches_jax(codec):
    """Both directions compressed (the downlink ack protocol end to end):
    version, selected and down-link-independent fields equal, bytes and
    time within 2% (top-k ties), accuracy within 4/512."""
    from repro.core import TABLE_4_1
    from repro.core import make_setup as jmake_setup
    from repro.core import run_fl as jrun_fl
    from repro_torch.core import make_setup, run_fl
    kw = dict(seed=0, noise=0.25, batch_size=32, het="strong")
    js = jmake_setup(TABLE_4_1["mnist_even"], **kw)
    ts = make_setup(TABLE_4_1["mnist_even"], **kw, device="cpu",
                    weights0={k: np.asarray(v)
                              for k, v in js.weights0.items()})
    run = dict(epochs_per_round=3, max_rounds=4, mode="sync",
               transport=codec, transport_frac=0.1)
    jh, th = jrun_fl(js, **run), run_fl(ts, **run)
    assert len(jh) == len(th)
    for j, t in zip(jh, th):
        assert (t.version, t.selected, t.n_updates) == \
            (j.version, j.selected, j.n_updates)
        for f in ("time", "up_bytes", "down_bytes"):
            assert abs(getattr(t, f) - getattr(j, f)) \
                <= 0.02 * abs(getattr(j, f)), f
        assert abs(t.accuracy - j.accuracy) <= 4 / 512
