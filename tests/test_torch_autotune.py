"""The port's auto codec (``core/autotune.py`` and the ``auto`` resolver
of ``core/transport.py``) and ``Transport.lru_evict`` against the JAX
package's.

* ``AutoTuner.choose_for`` (and the latency it minimises) equals JAX's
  over a grid of bandwidth, retransmit tax, rung of the frac ladder,
  warmup and model size; ``_CANDIDATES`` is the same tuple in the same
  order (the argmin's tie-break).
* The plateau ladder follows the same accuracy sequence to the same
  rungs, streaks and warmup state.
* ``run_fl(transport="auto")`` at fl_figures' backbone tier (bandwidths
  / 0.02) equals JAX in every non-accuracy field; at the edge and
  starved tiers, and at one where the links resolve raw and int8 apart
  (so a merge mixes decoded and encoded responses), the codec each link
  resolves at every encode is counted, and the counts equal JAX's.  Accuracy within 4/512 at every point
  (tests/test_torch_golden.py's bound; measured: 0 of 512 at every
  point of the backbone run).
* After an auto run, the fixed-codec runs still match the golden
  fixtures as tests/test_torch_golden.py holds them (the reference's
  ``test_auto_transport_never_dirties_existing_fixtures``).
* ``lru_evict`` drops the same links in the same order as JAX's, never
  one in the keep set or with a pending downlink.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import TABLE_4_1 as JTABLE
from repro.core import autotune as jat
from repro.core import make_setup as jmake_setup
from repro.core import run_fl as jrun_fl
from repro.core import transport as jtr
from repro.models.mlp import init_mlp
from repro_torch.core import TABLE_4_1, autotune, make_setup, run_fl
from repro_torch.core import transport as ttr

_GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")
# fl_figures' tiers, and one whose bandwidths straddle the raw/int8
# boundary (1e9 B/s), so a sync merge mixes raw and encoded responses
TIERS = {"backbone": 0.02, "edge": 0.25, "starved": 400.0, "mixed": 0.1}
BWS = (None, 0.0, 1.0, 1e3, 1e5, 1e6, 3e7, 9.7e7, 1e8, 1.2e8, 5e8, 1e9,
       1.2e9, 1e10, 1e12)
RETX = (1.0, 1.0 / 0.9, 1.25, 2.0, 1000.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: these runs are hundreds of
    small ops, and beside other test processes torch's thread pool spins
    instead of working (several times the wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_candidates_and_policy_match_jax():
    assert autotune._CANDIDATES == jat._CANDIDATES
    assert autotune.AutoPolicy() == autotune.AutoPolicy(
        **vars(jat.AutoPolicy()))


@pytest.mark.parametrize("n_params,raw_bytes", [(101_770, 407_080),
                                                (1000, 4000), (7, 28)])
@pytest.mark.parametrize("warmup", [0, 2])
def test_choose_for_matches_jax(n_params, raw_bytes, warmup):
    jt = jat.AutoTuner(n_params, raw_bytes,
                       jat.AutoPolicy(warmup_rounds=warmup))
    tt = autotune.AutoTuner(n_params, raw_bytes,
                            autotune.AutoPolicy(warmup_rounds=warmup))
    for rung_acc in (0.5, 0.5, 0.5, 0.5, 0.5):    # warmup, then rung 1
        for bw in BWS:
            for retx in RETX:
                assert tt.choose_for(bw, retx) == jt.choose_for(bw, retx)
                if bw:
                    for name in autotune._CANDIDATES:
                        assert tt.expected_latency(name, tt.frac, bw, retx) \
                            == jt.expected_latency(name, jt.frac, bw, retx)
        jt.note_round(rung_acc)
        tt.note_round(rung_acc)
    assert tt.frac == jt.frac == 0.05


def test_plateau_ladder_follows_jax():
    accs = np.random.RandomState(3).rand(40).cumsum() / 40
    accs[10:20] = accs[10]              # a plateau: the ladder tightens
    pol = dict(fracs=(0.2, 0.1, 0.05, 0.01), plateau_window=2,
               warmup_rounds=3)
    jt = jat.AutoTuner(1000, 4000, jat.AutoPolicy(**pol))
    tt = autotune.AutoTuner(1000, 4000, autotune.AutoPolicy(**pol))
    seen = set()
    for a in accs:
        jt.note_round(float(a))
        tt.note_round(float(a))
        state = (tt.rounds, tt.frac, tt._flat_streak, tt.warming_up)
        assert state == (jt.rounds, jt.frac, jt._flat_streak, jt.warming_up)
        seen.add(tt.frac)
    assert len(seen) > 1


def test_auto_transport_resolves_and_prices_as_jax():
    """A lossy auto transport's per-link resolutions and byte estimates
    equal JAX's, with the bandwidth sources bound as run_fl binds them."""
    w = {"a": np.zeros((30, 30), np.float32), "b": np.zeros(100, np.float32)}
    jt = jtr.Transport({k: jnp.asarray(v) for k, v in w.items()}, "auto")
    tt = ttr.Transport({k: torch.from_numpy(v) for k, v in w.items()},
                       "auto")
    rates = {"w0": 1e3, "w1": 1e6, "w2": 1e9, "w3": None}
    for t, mod in ((jt, jtr), (tt, ttr)):
        t.tuner.bind_bandwidth(rates.get, lambda: 1e6)
        t.reliability = mod.LinkReliability(drop_p=0.3)
    assert tt._retx_factor() == jt._retx_factor()
    for wid in rates:
        for d in ("up", "down"):
            js, jf = getattr(jt, f"resolve_{d}")(jt.link(wid))
            ts, tf = getattr(tt, f"resolve_{d}")(tt.link(wid))
            assert (ts.name, tf) == (js.name, jf)
    assert (tt.expected_up_bytes(), tt.expected_down_bytes(),
            tt.expected_oneway_bytes()) == \
        (jt.expected_up_bytes(), jt.expected_down_bytes(),
         jt.expected_oneway_bytes())


def _tier_setups(div):
    kw = dict(seed=0, noise=0.1, batch_size=64, het="strong")
    js = jmake_setup(JTABLE["mnist_even"], **kw)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    ts = make_setup(TABLE_4_1["mnist_even"], **kw, weights0=w0,
                    device="cpu")
    for s in (js, ts):
        for p in s.profiles:
            p.bandwidth /= div
    return js, ts


def _counting(mod, monkeypatch):
    counts = {"up": {}, "down": {}}
    for d in counts:
        real = getattr(mod.Transport, f"resolve_{d}")

        def resolve(self, link, _real=real, _d=d):
            spec, frac = _real(self, link)
            counts[_d][spec.name] = counts[_d].get(spec.name, 0) + 1
            return spec, frac
        monkeypatch.setattr(mod.Transport, f"resolve_{d}", resolve)
    return counts


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_auto_run_matches_jax(tier, monkeypatch):
    js, ts = _tier_setups(TIERS[tier])
    kw = dict(mode="sync", selector="all", epochs_per_round=2,
              max_rounds=4, transport="auto")
    jcounts, tcounts = _counting(jtr, monkeypatch), \
        _counting(ttr, monkeypatch)
    hj, ht = jrun_fl(js, **kw), run_fl(ts, **kw)
    assert tcounts == jcounts
    assert sum(tcounts["up"].values()) == sum(p.n_updates for p in ht[1:])
    if tier == "backbone":
        assert tcounts["up"] == {"raw": 40}
        assert len(hj) == len(ht)
        for a, b in zip(hj, ht):
            for f in FIELDS:
                assert getattr(a, f) == getattr(b, f), f
            assert abs(a.accuracy - b.accuracy) <= ACC_TOL
    elif tier == "mixed":
        assert set(tcounts["up"]) == {"raw", "int8"}
    else:
        assert "raw" not in tcounts["up"]


EXACT = {"raw": ("time", "version", "n_updates", "selected", "up_bytes",
                 "down_bytes"),
         "uplink_only": ("version", "selected", "down_bytes")}
WITHIN_2PCT = {"raw": (), "uplink_only": ("time", "up_bytes")}


def _value(rec, key):
    v = rec[key]
    return float.fromhex(v) if isinstance(v, str) else v


def test_auto_run_leaves_the_fixtures_clean():
    golden_file = _GOLDEN_DIR / "histories.json"
    before = golden_file.read_bytes()
    golden = json.loads(before)
    # the fixtures' initial weights need JAX's original threefry
    with jax.threefry_partitionable(False):
        w = init_mlp(jax.random.PRNGKey(_gen.SETUP_KW["seed"]),
                     in_dim=16 * 16)
    w0 = {k: np.asarray(v) for k, v in w.items()}

    def setup():
        return make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                          weights0=w0, device="cpu")
    kw = dict(epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
              **_gen.MODES["sync"])
    h_auto = _gen.history_record(run_fl(setup(), **kw, transport="auto"))
    assert golden_file.read_bytes() == before
    for tname, tkw in (("raw", dict(transport="raw")),
                       ("uplink_only", dict(transport="topk_ef+int8",
                                            transport_down="raw",
                                            transport_frac=0.1))):
        got = _gen.history_record(run_fl(setup(), **kw, **tkw))
        want = golden[f"{tname}/sync"]
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            for key in EXACT[tname]:
                assert _value(g, key) == _value(w_, key), key
            for key in WITHIN_2PCT[tname]:
                assert abs(_value(g, key) - _value(w_, key)) \
                    <= 0.02 * abs(_value(w_, key)), key
            assert abs(_value(g, "accuracy") - _value(w_, "accuracy")) \
                <= ACC_TOL
    # the auto run is its own trajectory: its bytes leave the raw fixture's
    assert [r["up_bytes"] for r in h_auto] != \
        [r["up_bytes"] for r in golden["raw/sync"]]


def _lru_script(mod, wrap):
    w = wrap({"a": np.zeros((4, 4), np.float32)})
    tr = mod.Transport(w, "int8")
    for i in range(12):
        tr.link(f"w{i}")
    # recency: touch some again; pending downlinks on two others
    for wid in ("w0", "w5", "w3"):
        tr.link(wid)
    for wid in ("w1", "w7"):
        link = tr.link(wid)
        link.complete_fetch(link.encode_down(w))      # acked base
        link.encode_down(w)                           # pending delta
    out = [tr.lru_evict(keep=("w2", "w4"), max_links=None),
           tr.lru_evict(keep=("w2", "w4"), max_links=20)]
    out.append(tr.lru_evict(keep=("w2", "w4"), max_links=5))
    out.append(list(tr._links))
    out.append(tr.lru_evict(keep=(), max_links=1))
    out.append(list(tr._links))
    out.append(tr.total_link_evictions)
    return out


def test_lru_evict_matches_jax():
    got = _lru_script(ttr, lambda t: {k: torch.from_numpy(v)
                                      for k, v in t.items()})
    want = _lru_script(jtr, lambda t: {k: jnp.asarray(v)
                                       for k, v in t.items()})
    assert got == want
    assert {"w1", "w7"} <= set(got[3]) and {"w2", "w4"} <= set(got[3])
