"""Shard-local link vectors on a sharded server (the JAX package's links
hold shard-local slices, ``repro/core/transport.py``), on the CPU.

Meshes of D = 1, 2 and 4 repeat the one CPU device, so every piece is a
separate tensor and every per-shard launch runs its plain version.  The
JAX package here sees one device: its side is the unsharded path.

* ``ef_encode``'s sharded form (its stages' plain versions on the CPU)
  equals the unsharded encode of the gathered vectors bit for
  bit in every output, at N = 1,024, 102,400 (exact select), 2^17 + 2,048
  (the sampled path at stride 1) and 2^19 (stride 4), and at three
  shards 3 x 4,096 and 3 x 2^17, for the top-k, top-k+int8 and int8
  codecs, with b and c present and absent, and with shards that hold no
  share of the sample; so do the sharded select (``topk_threshold``) and
  decode (``dequant_add``).  The unsharded grid form equals the chain of
  PyTorch ops and the staged plain version
  (``ref.reference_ef_encode_sharded``); its launch plan, counted at the
  stage wrappers, is 2D + 2 (2D + 1 for int8; one vector: 3) with no
  ``torch.cat``.
* The same inputs against JAX's ``ef_topk_encode`` and int8 codec within
  tests/test_torch_codec_fused.py's bounds (bit for bit but for the
  quantised residual, which XLA contracts into an FMA: one f32 spacing of
  ``q * scale`` plus one of the result).
* ``run_fl`` at ``server_mesh=4`` over compressed links (uplink-only,
  symmetric top-k+int8 async delta, symmetric top-k, int8, auto, lossy,
  cohort, 1x2): after the run every link vector and in-flight payload is
  a ``Sharded`` of four (N/4,) pieces; the history equals the unsharded
  run bit for bit and JAX's in every non-accuracy field (top-k byte
  counts and times within 2%, as tests/test_torch_sharded.py holds them;
  accuracy within 4 of 512 test samples).
* A sharded split over compressed links resumes bit for bit; the
  snapshot keeps the link pieces, shared ones stay shared, and restore
  places them with ``to_mesh``.
* ``snapshot_ef_norms`` equals the unsharded run's.
* ``chip_smoke.check_shard_encode`` rehearsed, each of its controls
  failing; ``chip_smoke.check_ef_stages`` (each stage against its plain
  stage) at D = 1 to 4, and failing two faulty stages.
"""
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TABLE_4_1 as JTABLE
from repro.core import make_setup as jmake_setup
from repro.core import run_fl as jrun_fl
from repro.core import topology as jtop
from repro.core import transport as jtr
from repro.kernels import topk_quant as jtq
from repro.runtime import faults as jfaults
from repro_torch.core import TABLE_4_1, build_experiment, make_setup, run_fl
from repro_torch.core import topology as ttop
from repro_torch.core import transport as ttr
from repro_torch.kernels import ref, topk_quant
from repro_torch.parallel import sharding as psh
from repro_torch.runtime import faults as tfaults

ROOT = Path(__file__).resolve().parents[1]
MESH_SIZES = (1, 2, 4)
FRAC = 0.1
# padded width -> logical parameters: a small vector, the main path's MLP
# padded for D = 4, the sampled path at stride 1 and at stride 4
N_PARAMS = {1024: 1000, 102_400: 101_770, (1 << 17) + 2048: (1 << 17) + 2000,
            1 << 19: (1 << 19) - 7}
CODECS = ("topk_ef", "topk_ef+int8", "int8")
SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes", "retransmits")
ACC_TOL = 4 / 512


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: beside other test processes
    torch's thread pool spins instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _mesh(d):
    return psh.agg_mesh(devices=("cpu",) * d)


def _parts(N, seed=0):
    """(a, b, c) f32 numpy vectors, x = (a - b) + c, with max |x| at the
    first element of the last shard at D = 2."""
    rng = np.random.RandomState(seed + N)
    a, b = (rng.randn(N).astype(np.float32) for _ in range(2))
    a[N // 2] = 40.0
    return a, b, (0.01 * rng.randn(N)).astype(np.float32)


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _same(got, want) -> bool:
    """Two encode outputs equal bit for bit (0-d counts as integers)."""
    if got is None or want is None:
        return got is None and want is None
    if isinstance(got, psh.Sharded):
        got = got.gather()
    if got.dtype == torch.float32:
        return np.array_equal(_bits(got), _bits(want))
    return int(got.numel()) == int(want.numel()) and torch.equal(
        got.to(want.dtype), want)


def _kw(codec, N):
    spec = ttr.CODECS[codec]
    n = N_PARAMS[N]
    return dict(k=ttr.topk_k(n, FRAC) if spec.topk else None, n_params=n,
                quantize=spec.quantize)


# ---------------- the sharded encode against the unsharded one -------------

@pytest.mark.parametrize("present", ["abc", "a"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("N", sorted(N_PARAMS))
def test_sharded_encode_equals_unsharded(N, codec, present):
    a, b, c = (torch.from_numpy(v) for v in _parts(N))
    if present == "a":
        b = c = None
    kw = _kw(codec, N)
    want = topk_quant.ef_encode(a, b, c, **kw)
    for d in MESH_SIZES:
        mesh = _mesh(d)
        sh = [None if t is None else psh.split(t, mesh) for t in (a, b, c)]
        got = topk_quant.ef_encode(*sh, **kw)
        for g, w in zip(got, want):
            assert _same(g, w)
        for out in got[:2]:
            assert isinstance(out, psh.Sharded) and len(out.shards) == d
            assert all(p.shape == (N // d,) for p in out.shards)
        if kw["k"] is not None:
            x = a if b is None else (a - b) + c
            assert _same(topk_quant.topk_threshold(psh.split(x, mesh),
                                                   kw["k"], kw["n_params"]),
                         want[2])
        if kw["quantize"]:
            dec = topk_quant.dequant_add(got[0], got[3], sh[0])
            assert _same(dec, topk_quant.dequant_add(want[0], want[3], a))


@pytest.mark.parametrize("codec", CODECS)
def test_one_shard_takes_the_unsharded_form(codec, monkeypatch):
    """On a mesh of one device nothing crosses devices: the encode and the
    select run the unsharded form on the one piece (on the card its
    launches, under its counter), never the sharded decomposition."""
    def sharded(*args, **kw):
        raise AssertionError("the sharded form ran on one shard")
    for name in ("reference_ef_encode_sharded",
                 "reference_topk_threshold_sharded"):
        monkeypatch.setattr(ref, name, sharded)
    for name in ("_sharded_select", "_ef_encode_grid"):
        monkeypatch.setattr(topk_quant, name, sharded)
    N = 102_400
    a, b, c = (torch.from_numpy(v) for v in _parts(N))
    kw = _kw(codec, N)
    want = topk_quant.ef_encode(a, b, c, **kw)
    mesh = _mesh(1)
    got = topk_quant.ef_encode(*(psh.split(t, mesh) for t in (a, b, c)),
                               **kw)
    for g, w in zip(got, want):
        assert _same(g, w)
    assert all(isinstance(o, psh.Sharded) and len(o.shards) == 1
               for o in got[:2])
    if kw["k"] is not None:
        x = (a - b) + c
        assert _same(topk_quant.topk_threshold(psh.split(x, mesh), kw["k"],
                                               kw["n_params"]), want[2])


# three shards: a width divisible by 3 on the exact path and at stride 3
N_PARAMS_3 = {3 * 4096: 3 * 4000, 3 << 17: (3 << 17) - 5}


@pytest.mark.parametrize("present", ["abc", "a"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("N", sorted(N_PARAMS_3))
def test_three_shards_equal_unsharded_and_jax(N, codec, present):
    """D = 3: the sharded encode bit for bit against the unsharded plain
    encode of the gathered vectors, and against JAX's codec within
    tests/test_torch_codec_fused.py's bounds."""
    a, b, c = _parts(N)
    if present == "a":
        b = c = None
    spec, n = ttr.CODECS[codec], N_PARAMS_3[N]
    kw = dict(k=ttr.topk_k(n, FRAC) if spec.topk else None, n_params=n,
              quantize=spec.quantize)
    ts = [None if v is None else torch.from_numpy(v) for v in (a, b, c)]
    want = ref.reference_ef_encode(*ts, **kw)
    mesh = _mesh(3)
    out, r, thresh, scale, kept = got = topk_quant.ef_encode(
        *(None if t is None else psh.split(t, mesh) for t in ts), **kw)
    for g, w in zip(got, want):
        assert _same(g, w)
    out, r = out.gather(), r.gather()
    x = a if b is None else (a - b) + c
    xj = jnp.asarray(x)
    if spec.topk:
        jthr = jtr.topk_threshold(xj, kw["k"], n)
        assert _bits(thresh) == _bits(jthr)
        assert int(kept) == int(jtr._kept_count(xj, jthr))
        jd, _, jres, _ = jtr.ef_topk_encode(xj, n_params=n, frac=FRAC,
                                            quantize=spec.quantize)
        if not spec.quantize:
            assert np.array_equal(_bits(out), _bits(jd))
            assert np.array_equal(_bits(r), _bits(jres))
            return
        jq, js = np.asarray(jd[0]), np.asarray(jd[1])
    else:
        js = np.asarray(jtr._int8_scale(xj))
        jq, jres = (np.asarray(v) for v in jtq.topk_quant_encode(xj, 0.0, js))
    assert np.array_equal(out.numpy(), jq)
    assert _bits(scale) == _bits(js)
    assert _spacing_bound(r.numpy(), np.asarray(jres), jq, js)


@pytest.mark.parametrize("codec", CODECS)
def test_a_shard_with_no_share_of_the_sample(codec, monkeypatch):
    """A stride above the shard's width (SAMPLE_CAP cut to 2: stride 512
    over shards of 256) leaves shards 1 and 3 of four no share of the
    sample; their pass 1 writes only partials, and every output still
    equals the unsharded plain encode's."""
    monkeypatch.setattr(ref, "SAMPLE_CAP", 2)
    N = 1024
    assert [m for _, m in ref.shard_samples(N, 4, N // 2)] == [1, 0, 1, 0]
    spec = ttr.CODECS[codec]
    kw = dict(k=100 if spec.topk else None, n_params=1000,
              quantize=spec.quantize)
    a, b, c = (torch.from_numpy(v) for v in _parts(N))
    want = ref.reference_ef_encode(a, b, c, **kw)
    mesh = _mesh(4)
    got = topk_quant.ef_encode(*(psh.split(t, mesh) for t in (a, b, c)),
                               **kw)
    for g, w in zip(got, want):
        assert _same(g, w)
    staged = ref.reference_ef_encode_sharded(
        *(psh.split(t, mesh).shards for t in (a, b, c)), **kw,
        home=mesh.home)
    for g, w in zip(got, (torch.cat(staged[0]), torch.cat(staged[1]),
                          *staged[2:])):
        assert _same(g, w)


@pytest.mark.parametrize("present", ["abc", "a"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("N", [3 << 17, 1 << 19])
def test_grid_form_equals_the_chain(N, codec, present):
    """One vector above one cluster's size takes the grid form (its plain
    stages on the CPU): bit for bit the chain of PyTorch ops
    (``ref.reference_ef_encode``) and the staged plain version."""
    spec = ttr.CODECS[codec]
    kw = dict(k=ttr.topk_k(N, FRAC) if spec.topk else None, n_params=N,
              quantize=spec.quantize)
    a, b, c = (torch.from_numpy(v) for v in _parts(N))
    if present == "a":
        b = c = None
    got = topk_quant.ef_encode(a, b, c, **kw)
    for g, w in zip(got, ref.reference_ef_encode(a, b, c, **kw)):
        assert _same(g, w)
    outs, rs, *rest = ref.reference_ef_encode_sharded(
        [a], *(None if t is None else [t] for t in (b, c)), **kw,
        home=a.device)
    for g, w in zip(got, (outs[0], rs[0], *rest)):
        assert _same(g, w)


@pytest.mark.parametrize("present", ["abc", "a"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_grid_form_launch_plan(D, codec, present, monkeypatch):
    """The grid form's launches, counted at the stage wrappers: a pass 1
    and a pass 2 a shard, one select (or, int8, one reduce) and, sharded
    top-k, one sum of the kept partials: 2D + 2 (2D + 1 for int8); one
    vector (2^19, stride 4): 3.  Pass 2 reads x back from the residual's
    buffer where b or c is given, else a itself; no torch.cat on a
    one-device mesh."""
    N = 3 << 17 if D == 3 else 1 << 19
    spec = ttr.CODECS[codec]
    kw = dict(k=ttr.topk_k(N, FRAC) if spec.topk else None, n_params=N,
              quantize=spec.quantize)
    calls = []
    for name in ("ef_pass1", "ef_select", "ef_reduce", "ef_pass2"):
        real = getattr(topk_quant, name)

        def counted(*args, _real=real, _name=name, **k):
            calls.append((_name, k.get("x"), args[0]))
            return _real(*args, **k)
        monkeypatch.setattr(topk_quant, name, counted)

    def no_cat(*args, **k):
        raise AssertionError("torch.cat in the sharded encode")
    a, b, c = (torch.from_numpy(v) for v in _parts(N))
    if present == "a":
        b = c = None
    want = ref.reference_ef_encode(a, b, c, **kw)
    mesh = _mesh(D)
    ins = [None if t is None else psh.split(t, mesh) for t in (a, b, c)]
    if D == 1:
        ins = [None if t is None else t.shards[0] for t in ins]
    monkeypatch.setattr(torch, "cat", no_cat)
    got = topk_quant.ef_encode(*ins, **kw)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert _same(g, w)
    names = [n for n, _, _ in calls]
    sel = "ef_select" if spec.topk else "ef_reduce"
    if D == 1:
        assert names == ["ef_pass1", sel, "ef_pass2"]
    else:
        assert names == ["ef_pass1"] * D + [sel] + ["ef_pass2"] * D + (
            ["ef_reduce"] if spec.topk else [])
    stored = [x is not None for n, x, _ in calls if n == "ef_pass1"]
    assert stored == [present == "abc"] * D
    # pass 2 runs the last piece first
    read = [x for n, _, x in calls if n == "ef_pass2"][::-1]
    pieces = [ins[0]] if D == 1 else ins[0].shards
    assert all((x is p) != (present == "abc") for x, p in zip(read, pieces))


def test_shard_samples_are_the_strided_sample():
    for size, d, stride in ((1024, 4, 1), (1 << 19, 4, 4), (3000, 3, 7),
                            (4096, 4, 1500)):
        x = torch.arange(size)
        s = size // d
        plan = ref.shard_samples(size, d, stride)
        got = torch.cat([x[i * s:(i + 1) * s][off::stride]
                         for i, (off, m) in enumerate(plan) if m])
        assert torch.equal(got, x[::stride])
        assert sum(m for _, m in plan) == len(x[::stride])


def test_sharded_operands_must_share_one_mesh():
    a = psh.split(torch.ones(1024), _mesh(2))
    b = psh.split(torch.ones(1024), _mesh(4))
    with pytest.raises(ValueError, match="mesh"):
        topk_quant.ef_encode(a, b, None, k=10, n_params=1000,
                             quantize=True)
    with pytest.raises(ValueError, match="mesh"):
        a - b


# ---------------- against the JAX package's codec -------------------------

def _spacing_bound(port, want, q, scale):
    """|port - want| <= spacing(|want|) + spacing(|q * scale|)
    (tests/test_torch_codec_fused.py's bound for the quantised
    residual)."""
    prod = np.abs(q.astype(np.float32) * np.float32(scale))
    lim = np.spacing(np.abs(want)).astype(np.float64) + np.spacing(prod)
    gap = np.abs(port.astype(np.float64) - want.astype(np.float64))
    return bool(np.all(gap <= lim))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("N", sorted(N_PARAMS))
def test_sharded_encode_matches_jax(N, codec):
    a, b, c = _parts(N)
    kw = _kw(codec, N)
    n, spec = kw["n_params"], ttr.CODECS[codec]
    mesh = _mesh(4)
    out, r, thresh, scale, kept = (
        o.gather() if isinstance(o, psh.Sharded) else o
        for o in topk_quant.ef_encode(
            *(psh.split(torch.from_numpy(v), mesh) for v in (a, b, c)),
            **kw))
    xj = (jnp.asarray(a) - jnp.asarray(b)) + jnp.asarray(c)
    x = (a - b) + c
    if spec.topk:
        jthr = jtr.topk_threshold(xj, kw["k"], n)
        assert _bits(thresh) == _bits(jthr)
        assert int(kept) == int(jtr._kept_count(xj, jthr))
        jd, _, jres, _ = jtr.ef_topk_encode(xj, n_params=n, frac=FRAC,
                                            quantize=spec.quantize)
        if not spec.quantize:
            assert np.array_equal(_bits(out), _bits(jd))
            assert np.array_equal(_bits(r), _bits(jres))
            return
        jq, js = np.asarray(jd[0]), np.asarray(jd[1])
    else:
        assert float(thresh) == 0.0
        js = np.asarray(jtr._int8_scale(xj))
        jq, jres = (np.asarray(v) for v in jtq.topk_quant_encode(xj, 0.0, js))
    assert np.array_equal(out.numpy(), jq)
    assert _bits(scale) == _bits(js)
    assert np.array_equal(_bits(r), _bits(x - jq.astype(np.float32) * js))
    assert _spacing_bound(r.numpy(), np.asarray(jres), jq, js)


# ---------------- runs: shard-local links, equal to unsharded and JAX -----

def _pair():
    """A JAX setup drawn under the legacy PRNG and the port's setup from
    the same seed with JAX's initial weights."""
    with jax.threefry_partitionable(False):
        jsetup = jmake_setup(JTABLE["mnist_even"], **SETUP_KW)
    w0 = {k: np.asarray(v) for k, v in jsetup.weights0.items()}
    return jsetup, make_setup(TABLE_4_1["mnist_even"], **SETUP_KW,
                              weights0=w0, device="cpu")


SYNC = dict(mode="sync", selector="all")
TOPK8 = dict(transport="topk_ef+int8", transport_frac=FRAC)
RUNS = {
    "uplink_only/sync": dict(**SYNC, **TOPK8, transport_down="raw"),
    "topk_ef+int8/async_delta": dict(mode="async", selector="all",
                                     async_delta=True, **TOPK8),
    "topk_ef/sync": dict(**SYNC, transport="topk_ef", transport_frac=FRAC),
    "int8/sync": dict(**SYNC, transport="int8"),
    "auto/sync": dict(**SYNC, transport="auto"),
    "lossy/int8": dict(**SYNC, transport="int8", topology="1x1"),
    "cohort/uplink_only": dict(**SYNC, **TOPK8, transport_down="raw",
                               cohort=4, cohort_seed=11),
    "topology/1x2": dict(**SYNC, **TOPK8, topology=2),
}
EXACT = {"int8/sync", "lossy/int8"}     # fixed wire bytes: every field
LOSS = dict(drop_p=0.2, dup_p=0.1, seed=123)


def _call(top, tr_mod, faults, setup, name, **extra):
    """``name``'s run through ``top``'s topology runner (or ``run_fl``
    when ``top`` is None): the histories by server, root first."""
    kw = dict(RUNS[name], epochs_per_round=2, max_rounds=3, **extra)
    topo = kw.pop("topology", None)
    if topo is None:
        return {"server": (jrun_fl if top is jtop else run_fl)(setup, **kw)}
    on_build = None
    if name.startswith("lossy"):
        def on_build(t):
            (lf,) = t.leaves.values()
            faults.inject_link_reliability(
                lf.server.transport, tr_mod.LinkReliability(**LOSS),
                estimator=lf.server.est)
    res = top.run_fl_topology(setup, topology=topo, on_build=on_build, **kw)
    return {"root": res.root_history, **res.leaf_histories}


def _rec(history):
    return [(p.time.hex(), p.version, float(p.accuracy).hex(), p.n_updates,
             p.selected, p.up_bytes, p.down_bytes, p.retransmits)
            for p in history]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sharded_run_holds_shard_local_links(name, monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    jsetup, setup = _pair()
    whole = _call(ttop, ttr, tfaults, setup, name)
    with cs.recorded_transports() as made:
        sharded = _call(ttop, ttr, tfaults, setup, name, server_mesh=4)
    assert cs.check_shard_local(made, 4) > 0
    assert {k: _rec(h) for k, h in sharded.items()} == \
        {k: _rec(h) for k, h in whole.items()}
    with jax.threefry_partitionable(False):
        jh = _call(jtop, jtr, jfaults, jsetup, name)
    assert sorted(jh) == sorted(sharded)
    for key, want in jh.items():
        got = sharded[key]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in FIELDS:
                a, b = getattr(g, f), getattr(w, f)
                if name not in EXACT and f in ("time", "up_bytes",
                                               "down_bytes"):
                    assert abs(a - b) <= 0.02 * abs(b), f
                else:
                    assert a == b, f
            assert abs(g.accuracy - w.accuracy) <= ACC_TOL


def test_whole_link_vectors_fail_the_shard_local_check(monkeypatch):
    """The check's control: a transport whose packs are not split leaves
    whole vectors on its links, and check_shard_local says so."""
    cs = _chip_smoke()
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    _, setup = _pair()
    monkeypatch.setattr(ttr.Transport, "pack",
                        lambda self, tree: self.bundle.pack(tree))
    with cs.recorded_transports() as made:
        _call(ttop, ttr, tfaults, setup, "uplink_only/sync", server_mesh=4)
    with pytest.raises(AssertionError, match="not 4 pieces"):
        cs.check_shard_local(made, 4)


def test_snapshot_ef_norms_equal_unsharded(monkeypatch):
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    _, setup = _pair()
    norms = []
    for mesh in (None, 4):
        loop, server = build_experiment(setup, **RUNS["uplink_only/sync"],
                                        epochs_per_round=2, max_rounds=3,
                                        server_mesh=mesh)
        server.start()
        loop.run(max_events=100_000)
        if mesh is not None:
            assert all(isinstance(ln.residual, psh.Sharded)
                       for ln in server.transport._links.values())
        norms.append(server.population.snapshot_ef_norms(
            server.transport).copy())
    assert norms[0].any()
    assert np.array_equal(norms[0], norms[1])


# ---------------- sharded split and resume over compressed links ----------

SPLITS = {"uplink_only/sync": RUNS["uplink_only/sync"],
          "topk_ef+int8/sync": dict(**SYNC, **TOPK8)}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_sharded_split_over_compressed_links_resumes(name, monkeypatch,
                                                     tmp_path):
    """A D = 4 run over compressed links stopped at its first snapshot:
    the snapshot holds every link vector as four pieces, the links of one
    dispatch round share one base object after a restore's copy as
    before it, restore places the pieces with ``to_mesh``, and the resumed
    run equals the uninterrupted unsharded one in every field."""
    from repro_torch.checkpoint import CheckpointManager
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    _, setup = _pair()
    kw = dict(SPLITS[name], epochs_per_round=2, max_rounds=4)
    d = str(tmp_path / "c")
    run_fl(setup, **kw, server_mesh=4, checkpoint_every=2, checkpoint_dir=d,
           stop_after_checkpoints=1)
    _, snap, _ = CheckpointManager(d).restore_latest()
    restored = snap._on(torch.device("cpu"))
    links = restored.state["server"]["transport"]["links"]
    acks = restored.state["acks"]
    vecs = [li[k] for li in links.values() for k in ("tx_base", "residual")]
    vecs += [a[k] for a in acks.values() for k in ("acked_base",
                                                   "down_residual")]
    vecs = [v for v in vecs if v is not None]
    assert vecs and all(isinstance(v, psh.Sharded) and len(v.shards) == 4
                        for v in vecs)
    # identity kept: two links share a base after the copy iff they did
    # before it (a raw downlink's round: every link the same base)
    before = [li["tx_base"] for li in
              snap.state["server"]["transport"]["links"].values()]
    after = [li["tx_base"] for li in links.values()]
    for i, j in itertools.combinations(range(len(after)), 2):
        assert (after[i] is after[j]) == (before[i] is before[j])
    if name == "uplink_only/sync":
        assert len({id(b) for b in after}) < len(after)
    placed = [0]
    to_mesh = psh.Sharded.to_mesh

    def counted(self):
        placed[0] += 1
        return to_mesh(self)
    monkeypatch.setattr(psh.Sharded, "to_mesh", counted)
    resumed = run_fl(setup, **kw, server_mesh=4, checkpoint_dir=d,
                     resume=True)
    assert placed[0] >= len({id(v) for v in vecs})
    monkeypatch.setattr(psh.Sharded, "to_mesh", to_mesh)
    assert _rec(resumed) == _rec(run_fl(setup, **kw))


# ---------------- chip_smoke.py's check, rehearsed -------------------------

def test_chip_smoke_shard_encode_rehearsed():
    cs = _chip_smoke()
    rec = cs.check_shard_encode(torch.device("cpu"),
                                sizes=((4096, 4000, 400),
                                       (1 << 19, 1 << 19, 52_428)))
    assert rec["ok"] and rec["cases"] == 2 * 3 * len(cs.SHARD_ENC_FORMS)
    # B4 per shard is check_shard_decode's, at the same widths and meshes
    dec = cs.check_shard_decode(torch.device("cpu"),
                                sizes=((4096, 4000, 400),
                                       (1 << 19, 1 << 19, 52_428)), W=5)
    assert dec["ok"] and len(dec["decode"]) == len(dec["rows"]) == 2 * 3


def test_chip_smoke_shard_enc_controls_rehearsed():
    """run_shard's controls: check_shard_encode fails under each fault."""
    cs = _chip_smoke()
    assert cs.shard_enc_controls(torch.device("cpu")) == dict.fromkeys(
        cs.SHARD_ENC_FAULTS, True)


@pytest.mark.parametrize("fault", [0, 1, 2])
def test_chip_smoke_shard_encode_faults_fail(fault):
    cs = _chip_smoke()
    with pytest.raises(AssertionError, match="sharded ef_encode"):
        cs.check_shard_encode(torch.device("cpu"),
                              sizes=((4096, 4000, 400),),
                              fault=cs.SHARD_ENC_FAULTS[fault])


@pytest.mark.parametrize("present", ["abc", "a"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_chip_smoke_ef_stages_rehearsed(D, codec, present):
    """chip_smoke.check_ef_stages: each stage wrapper alone against its
    plain stage, on pieces of a sampled vector (stride 4; 3 x 2^17 at
    stride 3) and, int8, the exact one."""
    cs = _chip_smoke()
    N = 3 << 17 if D == 3 else 1 << 19
    spec = ttr.CODECS[codec]
    kw = dict(k=ttr.topk_k(N, FRAC) if spec.topk else None, n_params=N,
              quantize=spec.quantize)
    ps = [torch.from_numpy(v).chunk(D) for v in _parts(N)]
    if present == "a":
        ps[1] = ps[2] = None
    assert cs.check_ef_stages(*ps, **kw) == []


def test_chip_smoke_ef_stages_catch_a_faulty_stage(monkeypatch):
    """check_ef_stages fails a pass 1 whose sample share starts one element
    late, and a pass 2 whose kept partials are off by one."""
    cs = _chip_smoke()
    N, D = 1 << 19, 2
    kw = dict(k=ttr.topk_k(N, FRAC), n_params=N, quantize=True)
    ps = [torch.from_numpy(v).chunk(D) for v in _parts(N)]
    real1, real2 = topk_quant.ef_pass1, topk_quant.ef_pass2

    def late(*args, off=0, sample=None, **k):
        real1(*args, off=off, sample=sample, **k)
        if sample is not None:
            real1(*args, off=off + 1, sample=sample[:-1], **k)

    def off_by_one(*args, part_kept=None, **k):
        real2(*args, part_kept=part_kept, **k)
        part_kept[0] += 1
    monkeypatch.setattr(topk_quant, "ef_pass1", late)
    bad = cs.check_ef_stages(*ps, **kw)
    assert any("sample" in b for b in bad)
    monkeypatch.setattr(topk_quant, "ef_pass1", real1)
    monkeypatch.setattr(topk_quant, "ef_pass2", off_by_one)
    bad = cs.check_ef_stages(*ps, **kw)
    assert any("kept" in b for b in bad)
