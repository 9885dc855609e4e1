"""The port's server optimizers (repro_torch.core.server_opt and the plain
version of kernel B5) against the JAX package's, on the same numpy inputs:

* kernel: ``ref.reference_server_opt`` (what the CPU runs) against JAX's
  oracle and its Pallas kernel in interpret mode, rtol/atol 1e-6;
* substrate: the fused ``step_vec`` in the flat merge tail against JAX's
  flat state, alpha 1 and alpha 0.9 (the in-place merge that overwrites
  the packed server mirror must not overwrite the optimizer's ``prev``
  anchor), within 1e-6; ``step_vec`` against ``step_tree`` within 5e-6;
* system: ``run_fl(server_opt=, partition="dirichlet")`` against JAX's at
  the golden setup, every non-accuracy field equal and accuracy within 4
  of the 512 test samples; the degenerate settings bit-identical to
  ``server_opt=None`` and to the ``raw/*`` golden fixtures.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro.core.experiment import build_experiment as jbuild
from repro.core import make_setup as jmake_setup
from repro.core import repartition_setup as jrepartition
from repro.core import run_fl as jrun_fl
from repro.core import server_opt as jso
from repro.kernels import fedavg_agg as jfedavg
from repro.kernels import ref as jref
from repro.models.mlp import init_mlp
from repro_torch.core import (TABLE_4_1, build_experiment, flatbuf,
                              make_setup, repartition_setup, run_fl)
from repro_torch.core import server_opt as so
from repro_torch.kernels import ref
from repro_torch.kernels import server_opt as opt_kernel

_GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes")
OPTS = {
    "fedavgm": {"momentum": 0.9},
    "fedadam": {"lr": 0.05},
    "feddyn": {"gamma": 0.25},
}
PARTITION = dict(partition="dirichlet", partition_kw={"alpha": 0.3,
                                                      "seed": 0})
MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
    "async_delta": dict(mode="async", selector="all", async_delta=True),
}
MOM_SC = np.asarray([0.9, 1.0, 0.0, 1.0], np.float32)
ADAM_SC = np.asarray([0.9, 0.99, 0.05, 1e-3, 0.0, 0.0], np.float32)


def _vecs(n, seed=7):
    rng = np.random.RandomState(seed)
    prev, merged, m, v = (rng.randn(n).astype(np.float32) for _ in range(4))
    return prev, merged, m, np.abs(v)


# ---------------- kernel B5: plain version vs JAX ----------------

@pytest.mark.parametrize("adam", [False, True], ids=["momentum", "adam"])
@pytest.mark.parametrize("n", [511, 2048, 4099])
def test_reference_server_opt_matches_jax(adam, n):
    prev, merged, m, v = _vecs(n)
    sc = ADAM_SC if adam else MOM_SC
    vj = jnp.asarray(v) if adam else None
    want_ref = jref.reference_server_opt(
        jnp.asarray(prev), jnp.asarray(merged), jnp.asarray(m), vj,
        jnp.asarray(sc), adam=adam)
    want_kern = jfedavg.server_opt_step_flat(
        jnp.asarray(prev), jnp.asarray(merged), jnp.asarray(m), vj,
        jnp.asarray(sc), adam=adam, interpret=True)
    t = [torch.from_numpy(a.copy()) for a in (prev, merged, m, v)]
    got = ref.reference_server_opt(t[0], t[1], t[2], t[3] if adam else None,
                                   sc, adam=adam)
    for want in (want_ref, want_kern):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("adam", [False, True], ids=["momentum", "adam"])
def test_wrapper_in_place_state_equals_fresh_outputs(adam):
    prev, merged, m, v = (torch.from_numpy(a) for a in _vecs(1000, 3))
    sc = ADAM_SC if adam else MOM_SC
    fresh = opt_kernel.server_opt_step_flat(prev, merged, m, v, sc,
                                            adam=adam)
    m2, v2 = m.clone(), v.clone()
    inplace = opt_kernel.server_opt_step_flat(prev, merged, m2, v2, sc,
                                              adam=adam, m_out=m2, v_out=v2)
    assert torch.equal(inplace[0], fresh[0])
    assert inplace[1] is m2 and torch.equal(m2, fresh[1])
    if adam:
        assert inplace[2] is v2 and torch.equal(v2, fresh[2])
    else:
        assert inplace[2] is None and torch.equal(v2, v)
    with pytest.raises(ValueError):
        opt_kernel.server_opt_step_flat(prev, merged, m, v, sc[:3],
                                        adam=adam)


def test_dispatch_cpu_counts_no_launch_and_other_devices_raise():
    before = dict(opt_kernel.LAUNCHES)
    prev, merged, m, v = (torch.from_numpy(a) for a in _vecs(512, 5))
    opt_kernel.server_opt_step_flat(prev, merged, m, v, ADAM_SC, adam=True)
    opt_kernel.server_opt_step_flat(prev, merged, m, None, MOM_SC,
                                    adam=False)
    assert opt_kernel.LAUNCHES == before
    meta = [torch.zeros(512, device="meta") for _ in range(3)]
    with pytest.raises(RuntimeError):
        opt_kernel.server_opt_step_flat(*meta, None, MOM_SC, adam=False)


# ---------------- substrate: fused pass in the merge tail ----------------

SHAPES = {"w": (37, 41), "b": (53,)}


def _tree(rng):
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("alpha", [1.0, 0.9])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_flat_step_matches_jax(name, alpha):
    """Four merges through each package's flat state with the optimizer
    attached.  At alpha 0.9 every merge writes the packed server mirror in
    place, and that mirror is the optimizer's ``prev`` anchor: the step
    must still see ``d = merged - prev`` (not 0) and match JAX."""
    rng = np.random.RandomState(0)
    s0 = _tree(rng)
    jstate = jflat.FlatServerState({k: jnp.asarray(v) for k, v in s0.items()})
    tstate = flatbuf.FlatServerState({k: torch.from_numpy(v.copy())
                                      for k, v in s0.items()})
    plain = flatbuf.FlatServerState({k: torch.from_numpy(v.copy())
                                     for k, v in s0.items()})
    jstate.server_opt = jso.make_server_opt(name, **OPTS[name])
    tstate.server_opt = so.make_server_opt(name, **OPTS[name])
    js = {k: jnp.asarray(v) for k, v in s0.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in s0.items()}
    for step in range(4):
        ups = [_tree(rng) for _ in range(3)]
        w = [1.0, 2.0, 1.0]
        js = jstate.merge(js, [{k: jnp.asarray(v) for k, v in u.items()}
                               for u in ups], w, alpha)
        tups = [{k: torch.from_numpy(v) for k, v in u.items()} for u in ups]
        prev = {k: t.clone() for k, t in ts.items()}
        ts = tstate.merge(ts, tups, w, alpha)
        err = max(float(np.max(np.abs(np.asarray(js[k]) - ts[k].numpy())))
                  for k in SHAPES)
        assert err < 1e-6, (name, alpha, step, err)
        # the optimizer really stepped: from the second merge on (FedAvgM's
        # first step is the plain merge) the install is not the plain one
        merged = plain.merge(prev, tups, w, alpha)
        if step:
            assert max(float((ts[k] - merged[k]).abs().max())
                       for k in SHAPES) > 1e-3


@pytest.mark.parametrize("name", sorted(OPTS))
def test_step_vec_matches_step_tree(name):
    rng = np.random.RandomState(0)
    template = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    opt_flat = so.make_server_opt(name, **OPTS[name])
    opt_tree = so.make_server_opt(name, **OPTS[name])
    flat = flatbuf.FlatServerState(template)
    flat.server_opt = opt_flat
    server_f = server_t = template
    for step in range(4):
        ups = [{k: l + 0.1 * torch.from_numpy(
                    rng.randn(*l.shape).astype(np.float32))
                for k, l in server_t.items()} for _ in range(3)]
        w = [1.0, 2.0, 1.0]
        server_f = flat.merge(server_f, ups, w, alpha=1.0)
        mixed = {k: sum(wi / sum(w) * u[k] for wi, u in zip(w, ups))
                 for k in template}
        server_t = opt_tree.step_tree(server_t, mixed)
        err = max(float((server_f[k] - server_t[k]).abs().max())
                  for k in template)
        assert err < 5e-6, (name, step, err)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_capture_restore_replays_the_run(name):
    """An image taken mid-run and restored into a fresh optimizer on a
    fresh flat state continues exactly as the original did; the image is
    a copy, untouched by later in-place steps."""
    rng = np.random.RandomState(1)
    s0 = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    rounds = [[{k: torch.from_numpy(v) for k, v in _tree(rng).items()}
               for _ in range(2)] for _ in range(4)]
    opt = so.make_server_opt(name, **OPTS[name])
    flat = flatbuf.FlatServerState(s0)
    flat.server_opt = opt
    s = s0
    for ups in rounds[:2]:
        s = flat.merge(s, ups, [1.0, 1.0], 0.9)
    img = opt.capture()
    m_at_capture = img["m"].clone()
    mid = {k: t.clone() for k, t in s.items()}
    for ups in rounds[2:]:
        s = flat.merge(s, ups, [1.0, 1.0], 0.9)
    assert torch.equal(img["m"], m_at_capture)
    opt2 = so.make_server_opt(name, **OPTS[name])
    opt2.restore(img)
    flat2 = flatbuf.FlatServerState(mid)
    flat2.server_opt = opt2
    s2 = mid
    for ups in rounds[2:]:
        s2 = flat2.merge(s2, ups, [1.0, 1.0], 0.9)
    assert all(torch.equal(s[k], s2[k]) for k in s)


def test_make_server_opt_contract():
    assert so.make_server_opt(None) is None
    o = so.make_server_opt("fedavgm", momentum=0.5)
    assert isinstance(o, so.FedAvgM) and o.momentum == 0.5
    assert so.make_server_opt(o) is o
    with pytest.raises(ValueError):
        so.make_server_opt("nope")
    with pytest.raises(ValueError):
        so.make_server_opt(o, momentum=0.1)
    assert sorted(so.SERVER_OPTS) == sorted(jso.SERVER_OPTS)
    for name, cls in so.SERVER_OPTS.items():
        assert np.array_equal(cls()._scalars(),
                              jso.SERVER_OPTS[name]()._scalars())


# ---------------- system: run_fl against JAX ----------------

def _jax_and_port_setup(fedprox_mu=0.0):
    js = jmake_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                     fedprox_mu=fedprox_mu)
    w0 = {k: np.asarray(v) for k, v in js.weights0.items()}
    ts = make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                    fedprox_mu=fedprox_mu, weights0=w0, device="cpu")
    return js, ts


def _assert_histories_match(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL


RUN_CASES = ([(n, m) for n in sorted(OPTS) for m in ("sync", "async")]
             + [("fedadam", "async_delta"), ("fedprox", "sync"),
                ("fedprox", "async")])


@pytest.mark.parametrize("name,mode", RUN_CASES,
                         ids=[f"{n}-{m}" for n, m in RUN_CASES])
def test_run_fl_matches_jax(name, mode):
    js, ts = _jax_and_port_setup(0.01 if name == "fedprox" else 0.0)
    okw = ({} if name == "fedprox"
           else dict(server_opt=name, server_opt_kw=OPTS[name]))
    kw = dict(epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
              **MODES[mode], **PARTITION, **okw)
    _assert_histories_match(jrun_fl(js, **kw), run_fl(ts, **kw))


@pytest.mark.parametrize("name", ["fedavgm", "fedadam"])
def test_async_optimizer_step_is_live_and_matches_jax(name):
    """Async alpha 0.9: each merge writes the server mirror in place.  The
    installed model must equal JAX's (to f32 training drift) and differ
    from what the same run installs without the optimizer."""
    js, ts = _jax_and_port_setup()
    kw = dict(epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
              **MODES["async"])
    ts = repartition_setup(ts, partition="dirichlet", alpha=0.3)
    js = jrepartition(js, partition="dirichlet", alpha=0.3)
    finals = {}
    for tag, opt in (("opt", name), ("none", None)):
        okw = {} if opt is None else dict(server_opt=opt,
                                          server_opt_kw=OPTS[opt])
        loop, server = build_experiment(ts, **kw, **okw)
        server.start()
        loop.run()
        finals[tag] = server.weights
    jloop, jserver = jbuild(js, **kw, server_opt=name,
                            server_opt_kw=OPTS[name])
    jserver.start()
    jloop.run()
    err = max(float(np.max(np.abs(np.asarray(jserver.weights[k])
                                  - finals["opt"][k].numpy())))
              for k in finals["opt"])
    assert err < 1e-4
    step = max(float((finals["opt"][k] - finals["none"][k]).abs().max())
               for k in finals["opt"])
    assert step > 1e-2


def test_repartition_setup_matches_jax_and_moves_device_shards():
    js, ts = _jax_and_port_setup()
    jr = jrepartition(js, partition="dirichlet", alpha=0.3, seed=0)
    tr = repartition_setup(ts, partition="dirichlet", alpha=0.3, seed=0)
    assert ts.shards is not tr.shards
    for a, b, d in zip(jr.shards, tr.shards, tr.device_shards):
        assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["y"],
                                                                 b["y"])
        assert np.array_equal(d["x"].numpy(), b["x"])
        assert np.array_equal(d["y"].numpy(), b["y"].astype(np.int64))
    assert tr.weights0 is ts.weights0 and tr.profiles is ts.profiles


# ---------------- degenerate settings: the raw/* fixtures ----------------

def _golden_weights0():
    with jax.threefry_partitionable(False):
        w = init_mlp(jax.random.PRNGKey(_gen.SETUP_KW["seed"]),
                     in_dim=16 * 16)
    return {k: np.asarray(v) for k, v in w.items()}


@pytest.fixture(scope="module")
def golden():
    import json
    return json.loads((_GOLDEN_DIR / "histories.json").read_text())


@pytest.fixture(scope="module")
def golden_setup():
    return make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                      weights0=_golden_weights0(), device="cpu")


@pytest.fixture(scope="module")
def opt_none_histories(golden_setup):
    out = {}
    for tname in ("raw", "uplink_only"):
        tkw = dict(_gen.SERVER_OPT_ALIASES[f"{tname}_opt_none"][1])
        for mname, mkw in _gen.MODES.items():
            out[f"{tname}/{mname}"] = _gen.history_record(run_fl(
                golden_setup, epochs_per_round=_gen.EP,
                max_rounds=_gen.ROUNDS, **mkw, **tkw))
    return out


ALIAS_CASES = [(a, m) for a in _gen.SERVER_OPT_ALIASES for m in _gen.MODES]


@pytest.mark.parametrize("alias,mname", ALIAS_CASES,
                         ids=[f"{a}-{m}" for a, m in ALIAS_CASES])
def test_server_opt_alias_is_bit_identical(alias, mname, golden,
                                           golden_setup, opt_none_histories):
    prefix, tkw = _gen.SERVER_OPT_ALIASES[alias]
    got = _gen.history_record(run_fl(
        golden_setup, epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
        **_gen.MODES[mname], **tkw))
    assert got == opt_none_histories[f"{prefix}/{mname}"]
    if prefix == "raw":
        assert got == golden[f"raw/{mname}"]


def test_degenerate_flags_match_jax():
    for name, kw in (("fedavgm", {"momentum": 0.0, "lr": 1.0}),
                     ("fedadam", {"beta1": 0.0, "beta2": 0.0,
                                  "tau": math.inf}),
                     ("feddyn", {"gamma": 0.0})):
        assert so.make_server_opt(name, **kw)._degenerate()
        assert jso.make_server_opt(name, **kw)._degenerate()
        assert not so.make_server_opt(name, **OPTS[name])._degenerate()
