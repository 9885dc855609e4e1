"""The port's kernels (repro_torch.kernels) against the JAX package's
Pallas kernels (interpret mode) and XLA oracles, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions;
tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on the card.

Tolerances: fedavg 1e-6 absolute on unit-normal rows with normalised
weights (tests/test_kernels.py's bound: the two frameworks reduce in
different orders); encode ``q`` exact.  The residual ``x - q*scale`` and
the decode ``base + q*scale`` may differ by one rounding of the product
(XLA on the CPU, interpret-mode Pallas included, may contract them into
an FMA), so they are held to one ulp of ``q*scale`` plus one ulp of the
result: a fixed 1e-7 cannot hold where ``|q*scale| >= 1`` and one ulp is
1.19e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fedavg_agg as jfedavg
from repro.kernels import ref as jref
from repro.kernels import topk_quant as jtopk
from repro_torch.kernels import fedavg_agg, topk_quant, use_kernel

WS = [1, 2, 3, 30]
NS = [512, 1000, 4096]


def _rows(W, N, seed=0):
    rng = np.random.RandomState(seed)
    rows = rng.randn(W, N).astype(np.float32)
    w = rng.rand(W).astype(np.float32) + 0.1
    return rows, (w / w.sum()).astype(np.float32)


def _encode_inputs(N, seed=0):
    x = np.random.RandomState(seed).randn(N).astype(np.float32)
    thresh = np.float32(np.sort(np.abs(x))[int(N * 0.9)])
    scale = np.float32(np.abs(x).max() / np.float32(127.0))
    return x, thresh, scale


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _within_fma(a, b, prod):
    """|a - b| within one ulp of the product ``prod`` plus one of ``b``:
    the gap between rounding ``prod`` or fusing it into an FMA."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    prod = np.abs(np.asarray(prod, np.float32))
    return bool(np.all(np.abs(a - b)
                       <= np.spacing(prod) + np.spacing(np.abs(b))))


# ---------------- B2: fedavg_agg_flat ----------------

@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("N", NS)
def test_fedavg_agg_matches_pallas(W, N):
    rows, w = _rows(W, N)
    got = fedavg_agg.fedavg_agg_flat(_t(rows), _t(w)).numpy()
    pallas = np.asarray(jfedavg.fedavg_agg_flat(jnp.asarray(rows),
                                                jnp.asarray(w),
                                                interpret=True))
    oracle = np.asarray(jref.reference_fedavg(jnp.asarray(rows),
                                              jnp.asarray(w)))
    assert np.max(np.abs(got - pallas)) < 1e-6
    assert np.max(np.abs(got - oracle)) < 1e-6


def test_fedavg_agg_at_main_path_width_matches_oracle():
    rows, w = _rows(30, 101_888, seed=1)
    got = fedavg_agg.fedavg_agg_flat(_t(rows), _t(w)).numpy()
    oracle = np.asarray(jref.reference_fedavg(jnp.asarray(rows),
                                              jnp.asarray(w)))
    assert np.max(np.abs(got - oracle)) < 1e-6


def test_fedavg_agg_reads_zero_weight_rows_and_no_server():
    """A NaN in a zero-weight row propagates (as JAX's 0 * row does)."""
    rows, _ = _rows(3, 512)
    rows[2, 7] = np.nan
    w = np.asarray([0.5, 0.5, 0.0], np.float32)
    got = fedavg_agg.fedavg_agg_flat(_t(rows), _t(w)).numpy()
    assert np.isnan(got[7]) and np.isfinite(np.delete(got, 7)).all()


# ---------------- B1: fedavg_mix_flat / fedavg_delta_flat ----------------

@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("s", [0.1, 1.0])
def test_fedavg_mix_matches_pallas(W, N, s):
    rows, w = _rows(W, N)
    server = np.random.RandomState(9).randn(N).astype(np.float32)
    wvec = np.concatenate([[np.float32(s)], w]).astype(np.float32)
    got = fedavg_agg.fedavg_mix_wvec(_t(rows), _t(wvec), _t(server)).numpy()
    pallas = np.asarray(jfedavg.fedavg_mix_flat(
        jnp.asarray(rows), jnp.asarray(w), jnp.asarray(server),
        np.float32(s), interpret=True))
    oracle = np.asarray(jref.reference_fedavg_sharded(
        jnp.asarray(rows), jnp.asarray(w), jnp.asarray(server),
        np.float32(s), n_shards=1))
    assert np.max(np.abs(got - pallas)) < 1e-6
    assert np.max(np.abs(got - oracle)) < 1e-6


def test_fedavg_mix_in_place_equals_out_of_place():
    rows, w = _rows(30, 1000)
    wvec = _t(np.concatenate([[0.1], w]).astype(np.float32))
    server = torch.from_numpy(np.random.RandomState(2).randn(1000)
                              .astype(np.float32))
    fresh = fedavg_agg.fedavg_mix_wvec(_t(rows), wvec, server)
    out = fedavg_agg.fedavg_mix_wvec(_t(rows), wvec, server, out=server)
    assert out is server
    assert torch.equal(server, fresh)


def test_fedavg_delta_is_mix_with_unit_server_scale():
    rows, _ = _rows(2, 4096)
    server = np.random.RandomState(3).randn(4096).astype(np.float32)
    w = np.asarray([1.0, -1.0], np.float32)
    got = fedavg_agg.fedavg_delta_flat(_t(server), _t(rows), _t(w)).numpy()
    pallas = np.asarray(jfedavg.fedavg_delta_flat(
        jnp.asarray(server), jnp.asarray(rows), jnp.asarray(w),
        interpret=True))
    assert np.max(np.abs(got - pallas)) < 1e-6


# ---------------- B3: topk_quant_encode ----------------

@pytest.mark.parametrize("N", NS)
def test_topk_quant_encode_matches_pallas(N):
    x, thresh, scale = _encode_inputs(N)
    q, r = topk_quant.topk_quant_encode(_t(x), _t(thresh), _t(scale))
    qp, rp = jtopk.topk_quant_encode(jnp.asarray(x), thresh, scale,
                                     use_pallas=True, interpret=True)
    qo, ro = jref.reference_topk_quant_encode(jnp.asarray(x), thresh, scale)
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(qp))
    assert np.array_equal(q.numpy(), np.asarray(qo))
    prod = q.numpy().astype(np.float32) * scale
    assert _within_fma(r.numpy(), rp, prod)
    assert _within_fma(r.numpy(), ro, prod)


def test_topk_quant_encode_int8_codec_form_at_main_path_width():
    """thresh = 0 (the int8 codec) at N = 101,888 against the oracle."""
    x, _, scale = _encode_inputs(101_888, seed=4)
    q, r = topk_quant.topk_quant_encode(_t(x), 0.0, _t(scale))
    qo, ro = jref.reference_topk_quant_encode(jnp.asarray(x), 0.0, scale)
    assert np.array_equal(q.numpy(), np.asarray(qo))
    assert _within_fma(r.numpy(), ro, q.numpy().astype(np.float32) * scale)


def test_topk_quant_encode_rounds_half_to_even():
    x = np.asarray([1.25, 1.75, -1.25, 0.75, -0.25, 100.0], np.float32)
    scale = np.float32(0.5)        # x / scale = 2.5, 3.5, -2.5, 1.5, -0.5
    q, r = topk_quant.topk_quant_encode(_t(x), 0.0, _t(scale))
    qp, _ = jtopk.topk_quant_encode(jnp.asarray(x), 0.0, scale,
                                    use_pallas=True, interpret=True)
    assert q.tolist() == [2, 4, -2, 2, 0, 127]
    assert q.tolist() == np.asarray(qp).tolist()
    assert r[0].item() == 0.25 and r[5].item() == 100.0 - 63.5


# ---------------- B4: dequant_add ----------------

@pytest.mark.parametrize("N", NS + [101_888])
def test_dequant_add_matches_pallas(N):
    rng = np.random.RandomState(5)
    q = rng.randint(-127, 128, size=N).astype(np.int8)
    base = rng.randn(N).astype(np.float32)
    scale = np.float32(0.013)
    got = topk_quant.dequant_add(_t(q), _t(scale), _t(base)).numpy()
    oracle = np.asarray(jref.reference_dequant_add(jnp.asarray(q), scale,
                                                   jnp.asarray(base)))
    prod = q.astype(np.float32) * scale
    assert _within_fma(got, oracle, prod)
    if N <= 4096:
        pallas = np.asarray(jtopk.dequant_add(
            jnp.asarray(q), scale, jnp.asarray(base), use_pallas=True,
            interpret=True))
        assert _within_fma(got, pallas, prod)


# ---------------- dispatch rule ----------------

def test_dispatch_cpu_runs_plain_version_and_other_devices_raise():
    assert use_kernel(torch.zeros(4)) is False
    with pytest.raises(RuntimeError):
        use_kernel(torch.zeros(4, device="meta"))
    with pytest.raises(RuntimeError):
        fedavg_agg.fedavg_agg_flat(torch.zeros(2, 4, device="meta"),
                                   torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(4), torch.zeros(4, device="meta"))


def test_cpu_wrappers_do_not_count_launches():
    before = (dict(fedavg_agg.LAUNCHES), dict(topk_quant.LAUNCHES))
    rows, w = _rows(2, 512)
    fedavg_agg.fedavg_agg_flat(_t(rows), _t(w))
    topk_quant.dequant_add(torch.zeros(512, dtype=torch.int8), 0.5,
                           torch.zeros(512))
    assert (fedavg_agg.LAUNCHES, topk_quant.LAUNCHES) == before
