"""The port's lossy links (``LinkReliability``, ``TransportAudit``,
``_Channel``, the lossy ``transmit``) against the JAX package's, on the
same numpy inputs.

* A link's channel draws the same drop/duplicate sequence as JAX's (the
  same ``numpy.random.RandomState`` seeded from the same crc32 mix), and
  prices the same retransmit timeouts.
* Lossy ``run_fl`` (a 1x1 topology with every worker link on a seeded
  lossy channel priced by the estimator, as ``inject_link_reliability``
  attaches it): raw sync and async equal JAX in every non-accuracy field,
  ``retransmits`` included, and the delivery ledger and
  ``audit_chaos_run``'s statistics equal JAX's.  Accuracy within 4/512 at
  every point (tests/test_torch_golden.py's bound: f32 training is not
  bit-identical across frameworks); the measured gap is 0 of 512 at
  every point of both runs.
* A retransmit re-sends the identical ``Payload``: one encode per logical
  uplink, however many copies go; the EF books are debited once.
* A cancelled uplink in flight on a lossy link credits its reconstruction
  back into the residual, as JAX's does (within 1e-6).
* A duplicated uplink never reaches a deferred merge: each merge decodes
  exactly its n_updates responses, and no encoded response twice.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import TABLE_4_1 as JTABLE
from repro.core import make_setup as jmake_setup
from repro.core import topology as jtop
from repro.core import transport as jtr
from repro.core.estimator import TimeEstimator as JEst
from repro.core.estimator import WorkerProfile as JProfile
from repro.core.events import EventLoop as JLoop
from repro.runtime import faults as jfaults
from repro_torch.core import TABLE_4_1, flatbuf, make_setup
from repro_torch.core import topology as ttop
from repro_torch.core import transport as ttr
from repro_torch.core.estimator import TimeEstimator as TEst
from repro_torch.core.estimator import WorkerProfile as TProfile
from repro_torch.core.events import EventLoop as TLoop
from repro_torch.kernels import topk_quant
from repro_torch.runtime import faults as tfaults

SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")
EP, ROUNDS = 2, 4
ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")
MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
}
LOSS = dict(drop_p=0.2, dup_p=0.1, seed=123)
SHAPES = {"a": (30, 30), "b": (100,)}       # 1000 params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: these runs are hundreds of
    small ops, and beside other test processes torch's thread pool spins
    instead of working (several times the wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setups():
    js = jmake_setup(JTABLE["mnist_even"], **SETUP_KW)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    return js, make_setup(TABLE_4_1["mnist_even"], **SETUP_KW, weights0=w0,
                          device="cpu")


def _lossy_run(top, tr_mod, faults, setup, **kw):
    def on_build(topo):
        (lf,) = topo.leaves.values()
        faults.inject_link_reliability(lf.server.transport,
                                       tr_mod.LinkReliability(**LOSS),
                                       estimator=lf.server.est)
    res = top.run_fl_topology(setup, topology="1x1", on_build=on_build,
                              epochs_per_round=EP, max_rounds=ROUNDS, **kw)
    stats = faults.audit_chaos_run(res.topology)
    (lf,) = res.topology.leaves.values()
    return res.root_history, stats, lf.server.transport.audit


def _assert_histories_match(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


@pytest.mark.parametrize("wid", ["w0", "w17", "leaf1", ""])
@pytest.mark.parametrize("seed", [0, 123, 2 ** 31 + 5])
def test_channel_draws_match_jax(wid, seed):
    w = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    jt = jtr.Transport({k: jnp.asarray(v) for k, v in w.items()})
    tt = ttr.Transport({k: torch.from_numpy(v) for k, v in w.items()})
    for t, mod in ((jt, jtr), (tt, ttr)):
        t.reliability = mod.LinkReliability(drop_p=0.3, dup_p=0.2, seed=seed)
    jl, tl = jt.link(wid), tt.link(wid)
    assert [jl.channel().next_seq() for _ in range(3)] == \
        [tl.channel().next_seq() for _ in range(3)]
    np.testing.assert_array_equal(jl.channel().rng.random_sample(200),
                                  tl.channel().rng.random_sample(200))
    # retransmit timeouts: from the transmit time, then from the
    # estimator's measured bandwidth once one is bound
    for a in range(4):
        assert jl.rto(4000, 0.01, a) == tl.rto(4000, 0.01, a)
    je, te = JEst(), TEst()
    for est in (je, te):
        est.observe_transmit(wid, 0.5, 1000)
    jt.rel_estimator, tt.rel_estimator = je, te
    for a in range(4):
        assert jl.rto(4000, 0.01, a) == tl.rto(4000, 0.01, a)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_lossy_run_fl_matches_jax(mode):
    js, ts = _setups()
    kw = dict(**MODES[mode], transport="raw")
    hj, sj, aj = _lossy_run(jtop, jtr, jfaults, js, **kw)
    ht, st, at = _lossy_run(ttop, ttr, tfaults, ts, **kw)
    assert ht[-1].retransmits > 0
    _assert_histories_match(hj, ht)
    assert st == sj
    # the delivery ledger: sends, deliveries, duplicates, retransmits and
    # the fetch log, field for field
    assert vars(at) == vars(aj)
    assert at.dup_count["up"] + at.dup_count["down"] > 0


def _encode_counter(monkeypatch):
    calls = [0]
    real = topk_quant.ef_encode

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(topk_quant, "ef_encode", counted)
    return calls


def test_retransmit_resends_the_identical_payload(monkeypatch):
    """One top-k uplink over a link that drops 90%: every copy carries the
    same Payload (retransmitted bytes = copies x its wire bytes), it is
    encoded once, delivered once, and the residual is the one its encode
    left."""
    rng = np.random.RandomState(0)
    base = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in SHAPES.items()}
    new = {k: v + 0.1 * torch.from_numpy(
        rng.randn(*v.shape).astype(np.float32)) for k, v in base.items()}
    tr = ttr.Transport(base, "topk_ef+int8", down_codec="raw")
    tfaults.inject_link_reliability(
        tr, ttr.LinkReliability(drop_p=0.9, seed=4))
    link = tr.link("w0")
    link.complete_fetch(link.encode_down(base))
    calls = _encode_counter(monkeypatch)
    up = link.encode_up(new)
    resid = link.residual.clone()
    loop, got = TLoop(), []
    assert ttr.transmit(loop, link, up, 0.01, lambda: got.append(up),
                        direction="up") is None
    loop.run()
    aud = tr.audit
    assert got == [up] and calls[0] == 1
    assert tr.total_retransmits == aud.retx_count > 0
    assert aud.retx_bytes == aud.retx_count * up.wire_bytes
    assert aud.sent_count["up"] == aud.delivered_count["up"] == 1
    assert torch.equal(link.residual, resid)


def test_lossy_uplink_encodes_once_per_logical_payload(monkeypatch):
    """A lossy run over top-k+int8 uplinks: the encodes equal the ledger's
    original uplink sends, while copies were retransmitted."""
    _, ts = _setups()
    calls = _encode_counter(monkeypatch)
    copies = [0]
    real = ttr.TransportAudit.note_sent

    def note_sent(self, direction, nbytes, retransmit):
        copies[0] += retransmit and direction == "up"
        return real(self, direction, nbytes, retransmit)
    monkeypatch.setattr(ttr.TransportAudit, "note_sent", note_sent)
    _, _, aud = _lossy_run(ttop, ttr, tfaults, ts, **MODES["sync"],
                           transport="topk_ef+int8", transport_down="raw",
                           transport_frac=0.1)
    assert copies[0] > 0
    assert calls[0] == aud.sent_count["up"]


def _cancel_in_flight(tr_mod, worker_mod, loop_cls, prof_cls, wrap, unwrap):
    """One worker dispatch over a lossy topk_ef link, cancelled while its
    uplink is in flight; returns (residual, responses, retransmits)."""
    from repro.core.warehouse import Pointer as JPointer
    from repro_torch.core.warehouse import Pointer as TPointer
    rng = np.random.RandomState(1)
    base = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    new = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32)
           for k, v in base.items()}
    tr = tr_mod.Transport(wrap(base), "topk_ef", down_codec="raw")
    tr.reliability = tr_mod.LinkReliability(drop_p=0.5, seed=7)
    link = tr.link("w0")
    loop = loop_cls()
    w = worker_mod.FLWorker(
        "w0", profile=prof_cls("w0", n_batches=1, bandwidth=1e3),
        data={"x": np.zeros((2, 1)), "y": None},
        train_fn=lambda p, x, y, e: wrap(new), loop=loop,
        per_batch_time=0.01)
    ptr = (JPointer if tr_mod is jtr else TPointer)("server://s", "uid")
    w.add_server(ptr)
    got = []
    w.train_async(ptr, link.encode_down(wrap(base)), 0, 1, link, got.append)
    # run until the uplink is on the wire, then close the round
    while not w._inflight:
        loop.run(max_events=1)
    loop.schedule(1e-9, w.cancel_inflight, ptr)
    loop.run()
    return unwrap(link.residual), got, tr.total_retransmits


def test_cancelled_uplink_credits_residual_back_under_loss():
    from repro.core import worker as jworker
    from repro_torch.core import worker as tworker

    def jwrap(t):
        return {k: jnp.asarray(v) for k, v in t.items()}

    def twrap(t):
        return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
    jres, jgot, jretx = _cancel_in_flight(
        jtr, jworker, JLoop, JProfile, jwrap, np.asarray)
    tres, tgot, tretx = _cancel_in_flight(
        ttr, tworker, TLoop, TProfile, twrap, lambda v: v.numpy())
    assert jgot == tgot == []
    assert jretx == tretx
    # the whole encoded delta is back: residual = (new - base) + 0
    np.testing.assert_allclose(tres, jres, atol=1e-6, rtol=0)


def test_duplicates_never_reach_a_deferred_merge(monkeypatch):
    """Sync over top-k+int8 uplinks with half the copies duplicated: every
    merge decodes exactly its responses, each response once."""
    _, ts = _setups()
    merges = []
    real = topk_quant.dequant_add_rows

    def rows_fn(qs, scales, bases, rows):
        merges.append([id(q) for q in qs])
        return real(qs, scales, bases, rows)
    monkeypatch.setattr(topk_quant, "dequant_add_rows", rows_fn)
    deferred = [0]
    real_up = ttr.Link.up_vec_deferred

    def up_vec(self, payload):
        deferred[0] += 1
        out = real_up(self, payload)
        assert isinstance(out, flatbuf.EncodedVec)
        return out
    monkeypatch.setattr(ttr.Link, "up_vec_deferred", up_vec)

    def on_build(topo):
        (lf,) = topo.leaves.values()
        tfaults.inject_link_reliability(
            lf.server.transport,
            ttr.LinkReliability(drop_p=0.1, dup_p=0.5, seed=9))
    res = ttop.run_fl_topology(ts, topology="1x1", on_build=on_build,
                               epochs_per_round=EP, max_rounds=ROUNDS,
                               **MODES["sync"], transport="topk_ef+int8",
                               transport_down="raw", transport_frac=0.1)
    tfaults.audit_chaos_run(res.topology)
    (lf,) = res.topology.leaves.values()
    aud = lf.server.transport.audit
    h = res.root_history
    assert aud.dup_count["up"] > 0
    assert [len(m) for m in merges] == [p.n_updates for p in h[1:]]
    assert all(len(set(m)) == len(m) for m in merges)
    assert deferred[0] == sum(p.n_updates for p in h[1:]) \
        == aud.delivered_count["up"]
