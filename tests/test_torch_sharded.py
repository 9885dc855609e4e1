"""The port's sharded aggregation substrate (ROADMAP A7) and its kernels'
sharded wrappers (B7) against the JAX package and against the port's own
unsharded path, on the CPU.

Meshes of D = 1, 2 and 4 devices repeat the one CPU device
(``REPRO_HOST_DEVICES``, the variable through which the JAX tests ask for
a forced host platform, read by ``agg_mesh``), so every shard's pieces
are separate tensors and every per-shard launch runs its plain version.
The JAX package here sees one device, so its side is the unsharded path
and its pure functions.

* Layout: ``padded_size_for``, ``shard_spans`` and ``leaf_spans`` equal
  JAX's; each device's row and mirror bytes are total / D.
* B7's plain versions: within 1e-6 of JAX's ``reference_fedavg_sharded``
  and ``reference_server_opt_sharded`` (the two frameworks reduce in
  different orders), and bit for bit equal to the port's unsharded
  wrappers: every element is computed by the same operations whatever
  the sharding.  The device guard is entered once a device, with that
  device.
* Merges and runs: every sharded merge form (aggregate, mix, encoded
  rows, delta, window, server optimizers) equals the unsharded state bit
  for bit; the ``run_fl`` cases of the JAX package's sharded tiers
  (tests/test_agg_sharded.py, test_server_opt.py, test_faults.py,
  test_topology.py) equal the port's unsharded run in every field, bits
  of accuracy included, and JAX's unsharded run (the fused path, and
  for one case the per-leaf tree path) in every non-accuracy field (top-k byte counts within 2%, as tests/test_torch_golden.py
  holds them), accuracy within 4 of 512 test samples; ``server_mesh=1``
  against the golden fixtures' ``MESH1_ALIASES``; a sharded run split at
  its first snapshot and resumed equals the uninterrupted run bit for bit.
* chip_smoke.py's phase 9 checks and faults, rehearsed at small sizes.
"""
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TABLE_4_1 as JTABLE
from repro.core import flatbuf as jflatbuf
from repro.core import make_setup as jmake_setup
from repro.core import run_fl as jrun_fl
from repro.core import topology as jtop
from repro.kernels import ref as jref
from repro_torch.core import (TABLE_4_1, build_experiment, flatbuf,
                              make_setup, run_fl)
from repro_torch.core import topology as ttop
from repro_torch.kernels import fedavg_agg, ref, server_opt
from repro_torch.parallel import sharding as psh
from repro_torch.runtime import faults as tfaults

ROOT = Path(__file__).resolve().parents[1]
_GOLDEN_DIR = ROOT / "tests" / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

MESH_SIZES = [1, 2, 4]
KERNEL_TOL = 1e-6
ACC_TOL = 4 / 512
SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes")
OPT_SCALARS = {False: np.asarray([0.9, 1.0, 0.0, 1.0], np.float32),
               True: np.asarray([0.9, 0.99, 0.05, 1e-3, 0.0, 0.0],
                                np.float32)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: beside other test processes
    torch's thread pool spins instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh_of(monkeypatch):
    """``agg_mesh(d)`` on the CPU, with ``REPRO_HOST_DEVICES`` set to d for
    the test (``run_fl(server_mesh=d)`` reads it too)."""
    def make(d):
        monkeypatch.setenv("REPRO_HOST_DEVICES", str(d))
        return psh.agg_mesh(d, platform="cpu")
    return make


def _tree(seed):
    """Ragged leaves: n_params = 37*41 + 53 + 11*7*3 = 1801, not a
    multiple of BLOCK, let alone of BLOCK * D (the padded tail)."""
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(37, 41).astype(np.float32),
            "b": rng.randn(53).astype(np.float32),
            "w2": rng.randn(11, 7, 3).astype(np.float32)}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _rec(history):
    return [(p.time.hex(), p.version, float(p.accuracy).hex(), p.n_updates,
             p.selected, p.up_bytes, p.down_bytes, p.retransmits)
            for p in history]


# ---------------- layout against JAX's pure functions ----------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_padded_size_matches_jax(n_shards):
    for n in (1, 511, 512, 513, 1801, 101_770, 2 ** 20 + 1):
        assert flatbuf.padded_size_for(n, n_shards) == \
            jflatbuf.padded_size_for(n, n_shards)


def test_shard_spans_match_jax():
    for lo, hi, size in ((100, 1300, 512), (0, 1801, 1024), (5, 6, 512),
                         (0, 2048, 512), (1023, 1025, 1024)):
        assert flatbuf.shard_spans(lo, hi, size) == \
            jflatbuf.shard_spans(lo, hi, size)


@pytest.mark.parametrize("d", MESH_SIZES)
def test_leaf_spans_match_jax(d, mesh_of):
    t = _tree(0)
    b = flatbuf.bundle_for(_torch(t), mesh_of(d))
    assert b.padded_size == jflatbuf.padded_size_for(b.n_params, d)
    assert b.shard_size * d == b.padded_size
    vec = b.pack(_torch(t)).numpy()
    jb = jflatbuf.ParamBundle({k: jnp.asarray(v) for k, v in t.items()})
    assert b.offsets == jb.offsets and b.sizes == jb.sizes
    for i, key in enumerate(b.keys):
        o = b.offsets[i]
        assert b.leaf_spans(i) == jflatbuf.shard_spans(
            o, o + b.sizes[i], b.shard_size)
        got = [vec[b.shard_bounds(s)[0] + lo:b.shard_bounds(s)[0] + hi]
               for s, lo, hi, _ in b.leaf_spans(i)]
        assert np.array_equal(np.concatenate(got), t[key].reshape(-1))
    assert np.all(vec[b.n_params:] == 0.0)
    with pytest.raises(IndexError):
        b.shard_bounds(d)


def test_agg_mesh_raises_as_the_reference_does(monkeypatch):
    monkeypatch.delenv("REPRO_HOST_DEVICES", raising=False)
    assert psh.agg_mesh(platform="cpu").devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="server mesh of 2 devices, but "
                                         "only 1 available"):
        psh.agg_mesh(2, platform="cpu")
    with pytest.raises(ValueError):
        psh.agg_mesh(0, platform="cpu")
    mesh = psh.agg_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {psh.AGG_AXIS: 3} and mesh.home.type == "cpu"
    assert psh.agg_vec_spec() == (psh.AGG_AXIS,)
    assert psh.agg_row_spec() == (None, psh.AGG_AXIS)


# ---------------- B7's plain versions ----------------

def _kernel_inputs(W, N, seed=0):
    rng = np.random.RandomState(seed)
    rows = rng.randn(W, N).astype(np.float32)
    w = rng.rand(W).astype(np.float32) + 0.1
    w = (w / w.sum()).astype(np.float32)
    server, prev, m = (rng.randn(N).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(N)).astype(np.float32)
    return rows, w, server, prev, m, v


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("W", [1, 5, 30])
def test_sharded_merges_match_jax_and_the_unsharded_path(d, W, mesh_of):
    mesh = mesh_of(d)
    N = flatbuf.BLOCK * d * 2
    rows, w, server, _, _, _ = _kernel_inputs(W, N, seed=W + d)
    t_rows, t_w, t_srv = (torch.from_numpy(a) for a in (rows, w, server))
    got = fedavg_agg.fedavg_mix_flat_sharded(t_rows, 0.6 * t_w, t_srv, 0.4,
                                             mesh=mesh)
    assert isinstance(got, psh.Sharded) and len(got.shards) == d
    oracle = np.asarray(jref.reference_fedavg_sharded(
        jnp.asarray(rows), 0.6 * jnp.asarray(w), jnp.asarray(server), 0.4,
        d))
    assert float(np.abs(got.gather().numpy() - oracle).max()) < KERNEL_TOL
    whole = fedavg_agg.fedavg_mix_flat(t_rows, 0.6 * t_w, t_srv, 0.4)
    assert torch.equal(got.gather(), whole)
    assert torch.equal(ref.reference_fedavg_sharded(
        t_rows, 0.6 * t_w, t_srv, 0.4, d), whole)
    gathered = fedavg_agg.fedavg_mix_flat_sharded(
        t_rows, 0.6 * t_w, t_srv, 0.4, mesh=mesh, gather=True)
    assert isinstance(gathered, torch.Tensor)
    assert torch.equal(gathered, whole)
    agg = fedavg_agg.fedavg_agg_flat_sharded(t_rows, t_w, mesh=mesh)
    assert float(np.abs(agg.gather().numpy() - np.asarray(
        jref.reference_fedavg(jnp.asarray(rows), jnp.asarray(w)))).max()) \
        < KERNEL_TOL
    assert torch.equal(agg.gather(), fedavg_agg.fedavg_agg_flat(t_rows, t_w))


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("adam", [False, True])
def test_sharded_server_opt_matches_jax_and_the_unsharded_step(d, adam,
                                                               mesh_of):
    mesh = mesh_of(d)
    N = flatbuf.BLOCK * d
    _, _, merged, prev, m, v = _kernel_inputs(1, N, seed=d)
    sc = OPT_SCALARS[adam]
    t = [torch.from_numpy(a) for a in (prev, merged, m, v)]
    got = fedavg_agg.server_opt_step_flat_sharded(*t, sc, adam=adam,
                                                  mesh=mesh)
    want = jref.reference_server_opt_sharded(
        *(jnp.asarray(a) for a in (prev, merged, m, v)), sc, adam=adam,
        n_shards=d)
    whole = server_opt.server_opt_step_flat(*t, sc, adam=adam)
    plain = ref.reference_server_opt_sharded(*t, sc, adam=adam, n_shards=d)
    for g, j, u, p in zip(got, want, whole, plain):
        assert (g is None) == (j is None) == (u is None) == (p is None)
        if g is None:
            continue
        assert float(np.abs(g.gather().numpy() - np.asarray(j)).max()) \
            < KERNEL_TOL
        assert torch.equal(g.gather(), u) and torch.equal(p, u)


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("mix", [False, True])
def test_sharded_merge_opt_in_place_equals_unsharded(d, adam, mix, mesh_of):
    """The fused merge and step per shard, as the merge path calls it (out
    = server = prev, m and v in place), equals ``merge_opt_flat`` on whole
    vectors bit for bit and its plain sharded version."""
    mesh = mesh_of(d)
    N = flatbuf.BLOCK * d
    rows, w, server, prev, m, v = (torch.from_numpy(a) for a in
                                   _kernel_inputs(7, N, seed=3 * d + adam))
    sc = OPT_SCALARS[adam]
    wvec = torch.cat([torch.tensor([0.3]), 0.7 * w]) if mix else w
    srv = server if mix else None
    anchor = server if mix else prev
    want = fedavg_agg.merge_opt_flat(rows, wvec, srv, anchor, m.clone(),
                                     v.clone(), sc, adam=adam)
    plain = ref.reference_merge_opt_sharded(rows, wvec, srv, anchor, m, v,
                                            sc, adam=adam, n_shards=d)
    s_srv, s_m, s_v = (psh.split(t, mesh) for t in (anchor, m, v))
    new, mo, vo = fedavg_agg.merge_opt_flat_sharded(
        psh.split(rows, mesh), wvec,
        s_srv if mix else None, s_srv if mix else psh.split(prev, mesh),
        s_m, s_v,
        sc, adam=adam, mesh=mesh, out=s_srv if mix else None, m_out=s_m,
        v_out=s_v)
    for g, u, p in zip((new, mo, vo), want, plain):
        if u is None:
            assert g is None and p is None
            continue
        assert torch.equal(g.gather(), u) and torch.equal(p, u)
    # in place: the server's own pieces and the moments' pieces were
    # written
    assert torch.equal(s_m.gather(), want[1])
    if mix:
        assert all(a is b for a, b in zip(new.shards, s_srv.shards))


@pytest.mark.parametrize("d", [2, 4])
def test_device_guard_entered_once_per_device(d, mesh_of, monkeypatch):
    """Every sharded launch runs inside ``device_guard`` of its device,
    entered once a distinct device of the mesh (one launch over every
    piece the device holds): the CUDA runtime launches on the thread's
    current device, so on D distinct cards a launch outside it would go
    wrong.  The CPU mesh repeats one device: one entry a call."""
    mesh = mesh_of(d)
    devices = [dev for dev, _ in psh.device_groups(mesh)]
    assert devices == [torch.device("cpu")]
    entered = []
    real = psh.device_guard

    @contextlib.contextmanager
    def spy(dev):
        entered.append(dev)
        with real(dev):
            yield
    monkeypatch.setattr(psh, "device_guard", spy)
    N = flatbuf.BLOCK * d
    rows, w, server, prev, m, v = (torch.from_numpy(a) for a in
                                   _kernel_inputs(3, N))
    sc = OPT_SCALARS[True]
    calls = (
        lambda: fedavg_agg.fedavg_mix_flat_sharded(rows, w, server, 0.5,
                                                   mesh=mesh),
        lambda: fedavg_agg.fedavg_agg_flat_sharded(rows, w, mesh=mesh),
        lambda: fedavg_agg.merge_opt_flat_sharded(
            rows, w, None, prev, m, v, sc, adam=True, mesh=mesh),
        lambda: fedavg_agg.server_opt_step_flat_sharded(
            prev, server, m, v, sc, adam=True, mesh=mesh))
    for call in calls:
        entered.clear()
        call()
        assert entered == devices
    # an encoded merge decodes each device's rows under its guard too
    t = _torch(_tree(1))
    st = flatbuf.FlatServerState(t, mesh=mesh)
    base = st.bundle.pack(t)
    q = torch.zeros(st.bundle.padded_size, dtype=torch.int8)
    enc = flatbuf.EncodedVec(q, torch.tensor(0.5), base)
    entered.clear()
    st.merge_rows(t, [enc, enc], [1.0, 1.0])
    assert entered == devices * 2                   # decode, then merge


def test_sharded_wrappers_refuse_an_indivisible_width(mesh_of):
    mesh = mesh_of(4)
    with pytest.raises(ValueError, match="not divisible"):
        fedavg_agg.fedavg_agg_flat_sharded(torch.zeros(2, 1002),
                                           torch.ones(2), mesh=mesh)
    with pytest.raises(ValueError, match="in place only into a Sharded"):
        srv = torch.zeros(2048)
        fedavg_agg.fedavg_mix_wvec_sharded(torch.zeros(2, 2048),
                                           torch.ones(3), srv, mesh=mesh,
                                           out=srv)


# ---------------- the flat state: sharded == unsharded ----------------

@pytest.mark.parametrize("d", MESH_SIZES)
def test_per_device_row_buffer_shrinks_linearly(d, mesh_of):
    t = _torch(_tree(0))
    st = flatbuf.FlatServerState(t, mesh=mesh_of(d))
    st.merge(t, [_torch(_tree(i)) for i in range(4)], [1.0] * 4, alpha=0.5)
    total = 4 * st.bundle.padded_size * 4            # (W, N) f32 bytes
    assert {p.numel() * 4 for p in st._rows.shards} == {total // d}
    assert {p.numel() * 4 for p in st._server_flat.shards} == \
        {st.bundle.padded_size * 4 // d}
    assert [p.device for p in st._rows.shards] == list(st.mesh.devices)


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_sharded_merge_bit_identical_to_unsharded(d, alpha, mesh_of):
    """Merges of 3-4 updates over rounds, then the transport's forms:
    packed vectors, encoded rows (alone and mixed with decoded ones),
    delta_vec and apply_delta."""
    server = _torch(_tree(10))
    sharded = flatbuf.FlatServerState(server, mesh=mesh_of(d))
    whole = flatbuf.FlatServerState(server)
    out_s = out_w = server
    for r in range(3):
        ups = [_torch(_tree(100 + 10 * r + i)) for i in range(3 + r % 2)]
        ws = [1.0 / (1 + i % 3) for i in range(len(ups))]
        out_s = sharded.merge(out_s, ups, ws, alpha=alpha)
        out_w = whole.merge(out_w, ups, ws, alpha=alpha)
        assert _equal(out_s, out_w)
    vecs = [sharded.bundle.pack(_torch(_tree(300 + i))) for i in range(3)]
    wvecs = [whole.bundle.pack(_torch(_tree(300 + i))) for i in range(3)]
    assert _equal(sharded.merge_rows(out_s, vecs, [1.0, 0.5, 2.0], alpha),
                  whole.merge_rows(out_w, wvecs, [1.0, 0.5, 2.0], alpha))
    rng = np.random.RandomState(d)

    def encoded(b, q):
        base = b.pack(server)
        return flatbuf.EncodedVec(torch.from_numpy(np.pad(
            q, (0, b.padded_size - len(q)))), torch.tensor(0.01), base)
    qs = [rng.randint(-127, 128, whole.bundle.n_params).astype(np.int8)
          for _ in range(2)]
    for mixed in (False, True):
        es = [encoded(sharded.bundle, q) for q in qs]
        ew = [encoded(whole.bundle, q) for q in qs]
        if mixed:
            es, ew = es + vecs[:1], ew + wvecs[:1]
        ws = [1.0] * len(es)
        assert _equal(sharded.merge_rows(server, es, ws, alpha),
                      whole.merge_rows(server, ew, ws, alpha))
    new, base = _torch(_tree(41)), _torch(_tree(42))
    got = sharded.delta_vec(server, sharded.bundle.pack(new),
                            sharded.bundle.pack(base))
    assert isinstance(got, psh.Sharded)
    want = whole.delta_vec(server, whole.bundle.pack(new),
                           whole.bundle.pack(base))
    assert torch.equal(got.gather()[:whole.bundle.padded_size], want)
    assert _equal(sharded.apply_delta(server, new, base),
                  whole.apply_delta(server, new, base))
    # the padded tail stays zero in every shard
    tail = sharded._rows.gather()[:, sharded.bundle.n_params:]
    assert bool((tail == 0).all())


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("opt", ["fedavgm", "fedadam", "feddyn"])
@pytest.mark.parametrize("alpha", [1.0, 0.9])
def test_sharded_server_opt_merges_bit_identical(d, opt, alpha, mesh_of):
    """A server optimizer on a sharded state: prev, m and v sharded like
    the mirror, one fused launch per shard, equal to the unsharded state
    bit for bit; ``step_vec`` (the oracle pass) too."""
    from repro_torch.core import server_opt as sopt
    server = _torch(_tree(20))
    states = []
    for mesh in (mesh_of(d), None):
        st = flatbuf.FlatServerState(server, mesh=mesh)
        st.server_opt = sopt.make_server_opt(opt)
        states.append(st)
    outs = [server, server]
    for r in range(3):
        ups = [_torch(_tree(200 + 10 * r + i)) for i in range(3)]
        outs = [st.merge(o, ups, [1.0, 2.0, 0.5], alpha)
                for st, o in zip(states, outs)]
        assert _equal(*outs)
    assert isinstance(states[0].server_opt._m, psh.Sharded)
    assert torch.equal(states[0].server_opt._m.gather(),
                       torch.nn.functional.pad(
                           states[1].server_opt._m,
                           (0, states[0].bundle.padded_size
                            - states[1].bundle.padded_size)))
    merged = [st.pack(outs[0]) for st in states]
    stepped = [st.server_opt.step_vec(st, outs[0], m)
               for st, m in zip(states, merged)]
    assert torch.equal(stepped[0].gather()[:states[1].bundle.padded_size],
                       stepped[1])


@pytest.mark.parametrize("d", MESH_SIZES)
def test_sharded_window_bit_identical(d, mesh_of):
    """The cohort row window on shards: claim, write (whole and sharded
    vectors), release with lazy zeroing, merge_window, row_vec."""
    server = _torch(_tree(30))
    states = [flatbuf.FlatServerState(server, mesh=mesh_of(d)),
              flatbuf.FlatServerState(server)]
    outs = [server, server]
    for r in range(3):
        per = []
        for st, out in zip(states, outs):
            rows = [st.win_claim() for _ in range(3)]
            for i, row in enumerate(rows):
                vec = st.bundle.pack(_torch(_tree(400 + 10 * r + i)))
                st.win_write(row, st.pack(_torch(_tree(400 + 10 * r + i)))
                             if i == 0 else vec)
            got = st.merge_window(out, rows, [1.0, 2.0, 3.0], 0.8)
            assert torch.equal(st.row_vec(rows[1]).gather()
                               if st.mesh is not None else
                               st.row_vec(rows[1]),
                               st.bundle.pack(_torch(_tree(401 + 10 * r))))
            for row in rows[:2]:
                st.win_release(row)
            per.append(got)
        outs = per
        assert _equal(*outs)


# ---------------- runs against the unsharded port and JAX -----------------

def _pair(table_key, **setup_kw):
    """A JAX setup drawn under the legacy PRNG and the port's setup from
    the same seed with JAX's initial weights."""
    with jax.threefry_partitionable(False):
        jsetup = jmake_setup(_table(JTABLE, table_key), **SETUP_KW,
                             **setup_kw)
    w0 = {k: np.asarray(v) for k, v in jsetup.weights0.items()}
    tsetup = make_setup(_table(TABLE_4_1, table_key), **SETUP_KW,
                        **setup_kw, weights0=w0, device="cpu")
    return jsetup, tsetup


def _table(table, key):
    return [1] * 4 if key == "four" else table[key]


RUN_CASES = {
    # tests/test_agg_sharded.py
    "raw/sync": ("mnist_even", dict(mode="sync", selector="all",
                                    epochs_per_round=2, max_rounds=3)),
    "topk/async_delta": ("mnist_even", dict(
        mode="async", selector="all", async_delta=True,
        transport="topk_ef+int8", transport_frac=0.1, epochs_per_round=2,
        max_rounds=4)),
    "time_based/T0=0": ("mnist_even", dict(
        mode="sync", selector="time_based",
        selector_kw={"r": 2, "T0": 0.0, "A": 0.01}, epochs_per_round=2,
        max_rounds=3)),
    "uplink_only/sync": ("mnist_even", dict(
        mode="sync", selector="all", transport="topk_ef+int8",
        transport_down="raw", transport_frac=0.1, epochs_per_round=2,
        max_rounds=3)),
    # tests/test_server_opt.py
    **{f"server_opt/{name}": ("four", dict(
        mode="sync", selector="all", epochs_per_round=3, max_rounds=4,
        server_opt=name, server_opt_kw=kw))
       for name, kw in (("fedavgm", {"momentum": 0.9}),
                        ("fedadam", {"lr": 0.05}),
                        ("feddyn", {"gamma": 0.2}))},
    "async/fedadam": ("four", dict(
        mode="async", selector="all", async_latest_table=False,
        async_alpha=0.9, aggregator="linear", epochs_per_round=3,
        max_rounds=6, server_opt="fedadam", server_opt_kw={"lr": 0.05})),
}
TOPK = {"topk/async_delta", "uplink_only/sync"}


@pytest.fixture(scope="module")
def references():
    """Per run case: (the port's setup, its unsharded history, JAX's
    unsharded history)."""
    out = {}
    for name, (table, kw) in RUN_CASES.items():
        jsetup, tsetup = _pair(table)
        with jax.threefry_partitionable(False):
            jh = jrun_fl(jsetup, **kw)
        out[name] = (tsetup, run_fl(tsetup, **kw), jh)
    return out


def _against_jax(got, want, topk: bool):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if topk and f in ("time", "up_bytes", "down_bytes"):
                assert abs(a - b) <= 0.02 * abs(b), f
            else:
                assert a == b, f
        assert abs(g.accuracy - w.accuracy) <= ACC_TOL


@pytest.mark.parametrize("d", MESH_SIZES)
@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_run_fl_sharded_equals_unsharded_and_jax(name, d, references,
                                                 mesh_of):
    mesh_of(d)
    setup, h0, jh = references[name]
    h = run_fl(setup, **RUN_CASES[name][1], server_mesh=d)
    assert _rec(h) == _rec(h0)
    _against_jax(h, jh, name in TOPK)
    if name == "time_based/T0=0":
        assert any(p.n_updates == 0 for p in h[1:]), "no empty round"


@pytest.mark.parametrize("d", [1, 4])
def test_run_fl_sharded_vs_jax_forced_tree_path(d, mesh_of, monkeypatch):
    """tests/test_agg_sharded.py's tree-path case: JAX's per-leaf
    reference aggregation end to end (``REPRO_AGG_PATH=tree``) against
    the port's sharded server: the same schedule and bytes, accuracy
    within 4/512."""
    mesh_of(d)
    jsetup, setup = _pair("mnist_even")
    kw = dict(mode="sync", selector="all", epochs_per_round=2, max_rounds=3)
    monkeypatch.setenv("REPRO_AGG_PATH", "tree")
    with jax.threefry_partitionable(False):
        jh = jrun_fl(jsetup, **kw)
    monkeypatch.delenv("REPRO_AGG_PATH")
    _against_jax(run_fl(setup, **kw, server_mesh=d), jh, topk=False)


@pytest.mark.parametrize("d", [1, 2])
def test_topology_on_server_mesh_bit_identical(d, mesh_of):
    """tests/test_topology.py's sharded composition: a 1x2 topology over
    top-k+int8 links, the root and both leaves sharded."""
    mesh_of(d)
    jsetup, setup = _pair("mnist_even")
    kw = dict(topology=2, mode="sync", epochs_per_round=3, max_rounds=3,
              transport="topk_ef+int8", transport_frac=0.1)
    plain = ttop.run_fl_topology(setup, **kw)
    sharded = ttop.run_fl_topology(setup, **kw, server_mesh=d)
    assert sharded.topology._flat.bundle.n_shards == d
    assert _rec(sharded.root_history) == _rec(plain.root_history)
    for lid, lh in plain.leaf_histories.items():
        assert sharded.leaf_histories[lid][0].version == 0
        assert _rec(sharded.leaf_histories[lid]) == _rec(lh)
    with jax.threefry_partitionable(False):
        jres = jtop.run_fl_topology(jsetup, **kw)
    _against_jax(sharded.root_history, jres.root_history, topk=True)


@pytest.mark.parametrize("d", MESH_SIZES)
def test_row_buffer_reclamation_across_deaths(d, mesh_of):
    """tests/test_faults.py: after a worker dies, a merge of fewer updates
    finds every stale row zeroed in every shard, and the run equals the
    unsharded one."""
    mesh_of(d)

    def killed(mesh):
        # a fresh setup each: the kill marks the setup's profile failed
        setup = make_setup([1] * 4, **SETUP_KW, device="cpu")
        loop, server = build_experiment(
            setup, mode="sync", selector="all", transport="topk_ef+int8",
            transport_frac=0.1, epochs_per_round=2, max_rounds=6,
            server_mesh=mesh)
        tfaults.FaultInjector(loop, server).kill_at(1.2, "w3")
        server.start()
        loop.run(max_events=100_000)
        return server
    sharded, whole = killed(d), killed(None)
    assert _rec(sharded.history) == _rec(whole.history)
    n_last = sharded.history[-1].n_updates
    assert 0 < n_last < 4
    st = sharded._flat
    assert st.capacity >= 4 and len(st._rows.shards) == d
    assert all(bool((p[n_last:] == 0).all()) for p in st._rows.shards)


@pytest.mark.parametrize("tname", sorted(_gen.TRANSPORTS))
@pytest.mark.parametrize("mname", sorted(_gen.MODES))
def test_mesh1_aliases_match_the_golden_fixtures(tname, mname):
    """``MESH1_ALIASES``: ``server_mesh=1`` against the fixtures as
    tests/test_torch_golden.py holds the unsharded port (raw: every
    non-accuracy field exact; uplink_only: version, selected and
    down_bytes exact, time and up_bytes within 2%; accuracy within
    4/512)."""
    alias = {"raw": "raw_mesh1", "uplink_only": "uplink_only_mesh1"}[tname]
    prefix, kw = _gen.MESH1_ALIASES[alias]
    want = json.loads((_GOLDEN_DIR / "histories.json").read_text())[
        f"{prefix}/{mname}"]
    with jax.threefry_partitionable(False):
        from repro.models.mlp import init_mlp
        w = init_mlp(jax.random.PRNGKey(_gen.SETUP_KW["seed"]),
                     in_dim=16 * 16)
    setup = make_setup(TABLE_4_1["mnist_even"], **_gen.SETUP_KW,
                       weights0={k: np.asarray(v) for k, v in w.items()},
                       device="cpu")
    got = _gen.history_record(run_fl(setup, epochs_per_round=_gen.EP,
                                     max_rounds=_gen.ROUNDS,
                                     **_gen.MODES[mname], **kw))
    exact = FIELDS if tname == "raw" else ("version", "selected",
                                           "down_bytes")
    near = () if tname == "raw" else ("time", "up_bytes")

    def value(rec, key):
        v = rec[key]
        return float.fromhex(v) if isinstance(v, str) else v
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in exact:
            assert value(g, key) == value(w, key), key
        for key in near:
            assert abs(value(g, key) - value(w, key)) \
                <= 0.02 * abs(value(w, key)), key
        assert abs(value(g, "accuracy") - value(w, "accuracy")) <= ACC_TOL


SPLITS = {
    "raw/sync": dict(mode="sync", selector="all"),
    "uplink_only/sync": dict(mode="sync", selector="all",
                             transport="topk_ef+int8", transport_down="raw",
                             transport_frac=0.1),
    "hetero/fedadam": dict(mode="sync", selector="all", server_opt="fedadam",
                           server_opt_kw={"lr": 0.05}),
    "topology/1x2": dict(mode="sync", selector="all", topology="1x2",
                         transport="topk_ef+int8", transport_frac=0.1),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_sharded_split_and_resume_bit_identical(name, mesh_of, tmp_path):
    """A D = 2 run stopped at its first snapshot and resumed from disk
    equals the uninterrupted unsharded run in every field; the snapshot
    holds the row buffer's (and the moments') pieces."""
    mesh_of(2)
    setup = make_setup(TABLE_4_1["mnist_even"], **SETUP_KW, device="cpu")
    kw = dict(SPLITS[name], epochs_per_round=2, max_rounds=4)
    d = str(tmp_path / "c")
    run_fl(setup, **kw, server_mesh=2, checkpoint_every=2,
           checkpoint_dir=d, stop_after_checkpoints=1)
    from repro_torch.checkpoint import CheckpointManager
    _, snap, _ = CheckpointManager(d).restore_latest()
    srv = (snap.state["server"] if snap.kind == "run"
           else snap.state["servers"]["leaf0"])
    assert isinstance(srv["flat"]["rows"], psh.Sharded)
    assert [p.device.type for p in srv["flat"]["rows"].shards] == \
        ["cpu"] * 2
    if "server_opt" in kw:
        assert isinstance(srv["server_opt"]["m"], psh.Sharded)
    resumed = run_fl(setup, **kw, server_mesh=2, checkpoint_dir=d,
                     resume=True)
    assert _rec(resumed) == _rec(run_fl(setup, **kw))


# ---------------- chip_smoke.py's phase 9, rehearsed ----------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("W,N", [(3, 4096), (1, 2048)])
def test_chip_smoke_b7_checks_pass_and_their_faults_fail(W, N):
    cs = _chip_smoke()
    rec = cs.check_b7(torch.device("cpu"), [(W, N)], meshes=(1, 2, 4))
    assert rec["ok"] and rec["cases"] == 3 * len(cs.B7_FORMS)
    for fault in cs.B7_FAULTS:
        with pytest.raises(AssertionError, match="B7"):
            cs.check_b7(torch.device("cpu"), [(W, N)], meshes=(2,),
                        fault=fault)


def test_chip_smoke_shard_runs_rehearsed(monkeypatch):
    """phase 9's FL comparison and launch accounting at a small cut, on
    the CPU (the launch counts stay 0 here: no kernel runs)."""
    cs = _chip_smoke()
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    setup = make_setup(TABLE_4_1["mnist_even"], **SETUP_KW, device="cpu")
    rec = cs.shard_run("raw/sync", setup, rounds=2, epochs=1,
                       meshes=(1, 2))
    assert rec["equal"] == {"1": True, "2": True}
