"""The port's cohorts (``AggregationServer(cohort=, cohort_seed=,
max_resident_links=)``, ``_sample_cohort``, the row-window merge and the
LRU link bound) against the golden fixtures and the JAX package.

* ``cohort=None`` and ``cohort=W`` give the same history bit for bit
  (accuracy included), and both match the ``raw/*`` fixtures as
  tests/test_torch_golden.py holds them: every non-accuracy field exact,
  accuracy within 4 of 512 test samples.
* ``cohort=k < W`` equals JAX in every non-accuracy field, accuracy
  within 4/512, in all four modes (measured: 0 of 512 at every point,
  here and at W = 1,000).
* At W = 1,000 workers sharing one shard, cohort 64: the histories'
  non-accuracy fields, the row buffer's capacity, the resident links and
  the link evictions equal JAX's.
* Under a cohort a compressed (top-k+int8) response lands, decoded, in
  the row it claimed, and the merge reads exactly the claimed rows.
* With resident links bounded, a link is evicted only after the merge
  consumed every response that waited encoded, and the evictions equal
  JAX's (top-k uplinks: up_bytes within 2%, tests/test_torch_golden.py's
  caveat).
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import TABLE_4_1 as JTABLE
from repro.core.experiment import build_experiment as jbuild
from repro.core import make_setup as jmake_setup
from repro.core import run_fl as jrun_fl
from repro.core.experiment import heterogeneous_profiles as jprofiles
from repro_torch.core import (TABLE_4_1, build_experiment, flatbuf,
                              heterogeneous_profiles, make_setup, run_fl)
from repro_torch.core import transport as ttr
from repro_torch.kernels import ref

_GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")
EXACT = ("time", "version", "n_updates", "selected", "up_bytes",
         "down_bytes")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: these runs are hundreds of
    small ops, and beside other test processes torch's thread pool spins
    instead of working (several times the wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_weights0():
    import jax
    from repro.models.mlp import init_mlp
    with jax.threefry_partitionable(False):
        w = init_mlp(jax.random.PRNGKey(_gen.SETUP_KW["seed"]),
                     in_dim=16 * 16)
    return {k: np.asarray(v) for k, v in w.items()}


def _value(rec, key):
    v = rec[key]
    return float.fromhex(v) if isinstance(v, str) else v


@pytest.fixture(scope="module")
def golden_weights0():
    return _golden_weights0()


@pytest.mark.parametrize("mode", sorted(_gen.MODES))
def test_cohort_none_and_w_match_the_raw_fixtures(mode, golden_weights0):
    golden = json.loads((_GOLDEN_DIR / "histories.json").read_text())
    want = golden[f"raw/{mode}"]
    got = {}
    for cohort in (None, 10):
        setup = make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                           weights0=golden_weights0, device="cpu")
        h = run_fl(setup, epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
                   transport="raw", cohort=cohort, cohort_seed=3,
                   **_gen.MODES[mode])
        got[cohort] = [vars(p) for p in h]
        rec = _gen.history_record(h)
        assert len(rec) == len(want)
        for g, w in zip(rec, want):
            for key in EXACT:
                assert _value(g, key) == _value(w, key), key
            assert abs(_value(g, "accuracy") - _value(w, "accuracy")) \
                <= ACC_TOL
    assert got[10] == got[None]


def _setups(**kw):
    js = jmake_setup(JTABLE["mnist_even"], **_gen.SETUP_KW, **kw)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    return js, make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW, **kw,
                          weights0=w0, device="cpu")


def _assert_match(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


@pytest.mark.parametrize("mode", sorted(_gen.MODES))
def test_cohort_k_matches_jax(mode):
    js, ts = _setups()
    kw = dict(epochs_per_round=2, max_rounds=_gen.ROUNDS, transport="raw",
              cohort=4, cohort_seed=11, **_gen.MODES[mode])
    _assert_match(jrun_fl(js, **kw), run_fl(ts, **kw))


def _scale_setup(make, profiles, W, **kw):
    base = make([1], seed=0, **kw)
    extra = {"device_shards": base.device_shards * W} \
        if hasattr(base, "device_shards") else {}
    return dataclasses.replace(base, shards=base.shards * W,
                               profiles=profiles(W, "mixed", [1] * W, 0),
                               **extra)


def _scale_run(build, setup):
    loop, server = build(setup, mode="sync", selector="all",
                         epochs_per_round=1, max_rounds=5, transport="raw",
                         cohort=64)
    server.start()
    loop.run()
    tr = server.transport
    return server.history, (server._flat.capacity, len(tr._links),
                            tr.total_link_evictions, list(tr._links))


def test_scale_cohort_matches_jax():
    W = 1000
    js = _scale_setup(jmake_setup, jprofiles, W)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    ts = _scale_setup(lambda t, **kw: make_setup(t, weights0=w0,
                                                 device="cpu", **kw),
                      heterogeneous_profiles, W)
    hj, sj = _scale_run(jbuild, js)
    ht, st = _scale_run(build_experiment, ts)
    _assert_match(hj, ht)
    assert st == sj
    cap, links, evictions, _ = st
    assert cap <= 2 * 64 and links <= 256 and evictions > 0


def test_compressed_response_lands_in_its_claimed_row(monkeypatch):
    """Sync and FedAsync under cohort 6 over top-k+int8 uplinks: every
    response is decoded at arrival (base + q*scale, bit for bit the plain
    decode) into the row it claimed; the merge weights exactly the claimed
    rows, which hold those vectors."""
    _, ts = _setups()
    decoded, writes, merges = [], [], []
    real_dec = ttr.Link.decode_up_vec
    real_write = flatbuf.FlatServerState.win_write
    real_merge = flatbuf.FlatServerState.merge_window

    def dec(self, payload):
        out = real_dec(self, payload)
        q, scale = payload.data
        plain = ref.reference_dequant_add(q, scale, self.tx_base)
        assert torch.equal(out, plain)
        decoded.append(out)
        return out

    def write(self, row, vec):
        assert any(vec is d for d in decoded)
        writes.append((row, vec.clone()))
        return real_write(self, row, vec)

    def merge(self, server_tree, rows, weights, alpha=1.0):
        rows = list(rows)
        merges.append(rows)
        latest = dict(writes)
        assert set(rows) == set(latest)
        for r in rows:
            assert torch.equal(self._rows[r], latest[r])
        writes.clear()
        return real_merge(self, server_tree, rows, weights, alpha)
    monkeypatch.setattr(ttr.Link, "decode_up_vec", dec)
    monkeypatch.setattr(flatbuf.FlatServerState, "win_write", write)
    monkeypatch.setattr(flatbuf.FlatServerState, "merge_window", merge)
    for mode in ("sync", "async"):
        merges.clear()
        h = run_fl(ts, epochs_per_round=1, max_rounds=3, cohort=6,
                   transport="topk_ef+int8", transport_down="raw",
                   transport_frac=0.1, **_gen.MODES[mode])
        assert [len(m) for m in merges] == [p.n_updates for p in h[1:]]
        assert all(len(set(m)) == len(m) for m in merges)


def _bounded_run(build, setup, evictions_at):
    """Sync over top-k+int8 uplinks (responses wait encoded for the merge)
    with resident links bounded at 3; ``evictions_at`` collects, at every
    eviction, the number of responses still waiting for a merge."""
    loop, server = build(setup, mode="sync", selector="all",
                         epochs_per_round=2, max_rounds=4,
                         transport="topk_ef+int8", transport_down="raw",
                         transport_frac=0.1)
    server.max_resident_links = 3
    real = server.transport.lru_evict

    def lru_evict(keep=(), max_links=None):
        evictions_at.append(len(server._cache))
        return real(keep, max_links)
    server.transport.lru_evict = lru_evict
    server.start()
    loop.run()
    return server.history, server.transport.total_link_evictions


def test_eviction_never_drops_a_link_whose_response_waits():
    """Links are evicted only after the merge consumed every encoded
    response (nothing waits), and the bounded run evicts as JAX's does:
    the same evictions and every field that top-k ties cannot move."""
    js, ts = _setups()
    jat, tat = [], []
    hj, ej = _bounded_run(jbuild, js, jat)
    ht, et = _bounded_run(build_experiment, ts, tat)
    assert tat == [0] * len(tat) and len(tat) == len(ht) - 1
    assert et == ej > 0
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in ("version", "n_updates", "selected", "down_bytes"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.up_bytes - b.up_bytes) <= 0.02 * max(a.up_bytes, 1)
