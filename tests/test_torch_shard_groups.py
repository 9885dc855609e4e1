"""The sharded kernels grouped by device: one launch a device over every
piece it holds, on the CPU.

* ``parallel.sharding.device_groups`` on meshes of distinct and repeated
  devices (``cuda:i`` device objects are only compared, never touched).
* The grouped wrappers launch once a distinct device: on a mesh that
  mixes the CPU and the meta device (two devices that exist here), every
  B7 wrapper and both B4 sharded forms call their pieces function once a
  device with the pieces it holds, under that device's guard; on a mesh
  of distinct devices that is one call a piece.
* Every B7 form (mix, aggregate, the fused merge and step in both forms,
  the step in both forms) and both B4 sharded forms (``dequant_add`` on
  ``Sharded`` q and base; a merge's encoded responses landed in a sharded
  row buffer) on a CPU mesh of D = 1, 2 and 4 (``REPRO_HOST_DEVICES``),
  bit for bit equal to the port's unsharded plain version, and to the JAX
  package's ``*_sharded`` wrappers (and ``dequant_add``) in interpret
  mode: B7 within 1e-6 as ``tests/test_torch_sharded.py`` holds it (the
  two frameworks reduce in different orders), B4 within the rounding an
  FMA may skip (``tests/test_torch_codec_fused.py``'s bound).
* The pieces' pointer table, the launch counts of a grouped call, and
  ``chip_smoke.check_shard_decode`` with its controls, rehearsed.
"""
import contextlib
import ctypes
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fedavg_agg as jfa
from repro.kernels import topk_quant as jtq
from repro.parallel import sharding as jpsh
from repro_torch.core import flatbuf
from repro_torch.kernels import (GROUP_PIECES, fedavg_agg, group_launches,
                                 pointer_table, server_opt, topk_quant)
from repro_torch.parallel import sharding as psh

ROOT = Path(__file__).resolve().parents[1]
KERNEL_TOL = 1e-6
B7_FORMS = ("mix", "agg", "merge_mom", "merge_adam", "opt_mom", "opt_adam")
OPT_SCALARS = {False: np.asarray([0.9, 1.0, 0.0, 1.0], np.float32),
               True: np.asarray([0.9, 0.99, 0.05, 1e-3, 0.0, 0.0],
                                np.float32)}
S = 0.4                                    # the mix's server scale


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(*names):
    return psh.AggMesh(tuple(torch.device(n) for n in names))


# ---------------- device_groups ----------------

@pytest.mark.parametrize("names,want", [
    (("cuda:0", "cuda:1", "cuda:0", "cuda:1"),
     [("cuda:0", [0, 2]), ("cuda:1", [1, 3])]),
    (("cuda:0", "cuda:1", "cuda:2", "cuda:3"),
     [("cuda:0", [0]), ("cuda:1", [1]), ("cuda:2", [2]), ("cuda:3", [3])]),
    (("cuda:1", "cuda:0", "cuda:1"), [("cuda:1", [0, 2]), ("cuda:0", [1])]),
    (("cuda:0",) * 4, [("cuda:0", [0, 1, 2, 3])]),
    (("cuda:0",), [("cuda:0", [0])]),
    (("cpu",) * 2, [("cpu", [0, 1])]),
])
def test_device_groups_first_seen_order(names, want):
    got = psh.device_groups(_mesh(*names))
    assert [(d, idx) for d, idx in got] == \
        [(torch.device(d), idx) for d, idx in want]
    # every piece in exactly one group
    assert sorted(i for _, idx in got for i in idx) == list(range(len(names)))


def test_device_groups_equal_index_forms():
    """``cuda:0`` and ``("cuda", 0)`` are one device."""
    mesh = psh.AggMesh((torch.device("cuda:0"), torch.device("cuda", 0)))
    assert psh.device_groups(mesh) == [(torch.device("cuda", 0), [0, 1])]


# ---------------- one call a device, on distinct devices ----------------

MIXED = {"distinct": ("cpu", "meta"), "repeated": ("cpu", "meta") * 2,
         "one device": ("cpu",) * 4}


def _spy(monkeypatch, module, name, calls, fake, pieces=0):
    """Replace ``module.name`` by a recorder of (device, pieces), read
    from its argument ``pieces``, that returns ``fake(*args)``: the meta
    device has no kernel and no plain version, so the spy stands in for
    both."""
    def spy(*args, **kw):
        calls.append((args[pieces][0].device, len(args[pieces])))
        return fake(*args, **kw)
    monkeypatch.setattr(module, name, spy)


def _guard_spy(monkeypatch):
    entered, real = [], psh.device_guard

    @contextlib.contextmanager
    def spy(dev):
        entered.append(dev)
        with real(dev):
            yield
    monkeypatch.setattr(psh, "device_guard", spy)
    return entered


def _vecs(pieces):
    return [torch.zeros(p.shape[-1], device=p.device) for p in pieces]


@pytest.mark.parametrize("kind", sorted(MIXED))
def test_wrappers_call_once_a_device(kind, monkeypatch):
    mesh = _mesh(*MIXED[kind])
    groups = psh.device_groups(mesh)
    want = [(dev, len(idx)) for dev, idx in groups]
    devices = [dev for dev, _ in groups]
    D, W = len(mesh.devices), 3
    N = 64 * D
    rows, server = torch.randn(W, N), torch.randn(N)
    w, wvec = torch.rand(W), torch.rand(W + 1)
    entered = _guard_spy(monkeypatch)
    calls = []
    _spy(monkeypatch, fedavg_agg, "fedavg_agg_pieces", calls,
         lambda r, w_: _vecs(r))
    _spy(monkeypatch, fedavg_agg, "fedavg_mix_pieces", calls,
         lambda r, w_, s, outs=None: _vecs(s))
    _spy(monkeypatch, fedavg_agg, "merge_opt_pieces", calls,
         lambda r, w_, s, p, m, v, sc, **kw: (_vecs(p), _vecs(p),
                                              _vecs(p)))
    _spy(monkeypatch, fedavg_agg, "server_opt_step_pieces", calls,
         lambda p, g, m, v, sc, **kw: (_vecs(p), _vecs(p), [None] * len(p)))
    sc = OPT_SCALARS[True]
    for call in (
            lambda: fedavg_agg.fedavg_agg_flat_sharded(rows, w, mesh=mesh),
            lambda: fedavg_agg.fedavg_mix_wvec_sharded(rows, wvec, server,
                                                       mesh=mesh),
            lambda: fedavg_agg.merge_opt_flat_sharded(
                rows, wvec, server, server, server, server, sc, adam=True,
                mesh=mesh),
            lambda: fedavg_agg.server_opt_step_flat_sharded(
                server, server, server, None, OPT_SCALARS[False],
                adam=False, mesh=mesh)):
        calls.clear()
        entered.clear()
        out = call()
        first = out[0] if isinstance(out, tuple) else out
        assert calls == want and entered == devices
        assert [p.device for p in first.shards] == list(mesh.devices)
    # B4 on Sharded q and base, and a merge's decodes into sharded rows
    _spy(monkeypatch, topk_quant, "dequant_add_pieces", calls,
         lambda qs, s, bases: _vecs(bases))
    _spy(monkeypatch, topk_quant, "dequant_add_rows_pieces", calls,
         lambda qs, s, bases, r: list(r), pieces=3)
    q = psh.split(torch.zeros(N, dtype=torch.int8), mesh)
    base = psh.split(torch.zeros(N), mesh)
    calls.clear()
    entered.clear()
    out = topk_quant.dequant_add(q, torch.tensor(0.5), base)
    assert calls == want and entered == devices
    assert [p.device for p in out.shards] == list(mesh.devices)
    bundle = flatbuf.ParamBundle({"w": torch.empty(N, device="meta")},
                                 mesh=mesh)
    rows_sh = psh.split(torch.zeros(W, N), mesh)
    calls.clear()
    entered.clear()
    bundle._set_rows(rows_sh, [flatbuf.EncodedVec(q, torch.tensor(0.5),
                                                  base)] * 2)
    assert calls == want and entered == devices


# ---------------- the grouped forms against the unsharded ones and JAX ----

def _inputs(W, N, seed):
    rng = np.random.RandomState(seed)
    rows = rng.randn(W, N).astype(np.float32)
    w = rng.rand(W).astype(np.float32) + 0.1
    w = (w / w.sum()).astype(np.float32)
    server, prev, m = (rng.randn(N).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(N)).astype(np.float32)
    w_mix = ((1.0 - S) * w).astype(np.float32)
    wvec = np.concatenate([[np.float32(S)], w_mix]).astype(np.float32)
    return dict(rows=rows, w=w, w_mix=w_mix, wvec=wvec, server=server,
                prev=prev, m=m, v=v)


def _port(form, o, mesh=None):
    """The form through its sharded wrapper over ``mesh`` (the outputs
    gathered), or with mesh None through the unsharded wrapper."""
    t = {k: torch.from_numpy(a) for k, a in o.items()}
    adam = form.endswith("adam")
    sc, v = OPT_SCALARS[adam], t["v"] if adam else None
    kw = {} if mesh is None else {"mesh": mesh}
    if form == "mix":
        out = (fedavg_agg.fedavg_mix_wvec_sharded(t["rows"], t["wvec"],
                                                  t["server"], **kw)
               if mesh else fedavg_agg.fedavg_mix_wvec(
                   t["rows"], t["wvec"], t["server"]),)
    elif form == "agg":
        out = (fedavg_agg.fedavg_agg_flat_sharded(t["rows"], t["w"], **kw)
               if mesh else fedavg_agg.fedavg_agg_flat(t["rows"], t["w"]),)
    elif form.startswith("merge"):
        wv, srv = (t["wvec"], t["server"]) if adam else (t["w"], None)
        args = (t["rows"], wv, srv, t["prev"], t["m"], v, sc)
        out = (fedavg_agg.merge_opt_flat_sharded(*args, adam=adam, **kw)
               if mesh else fedavg_agg.merge_opt_flat(*args, adam=adam))
    else:
        args = (t["prev"], t["server"], t["m"], v, sc)
        out = (fedavg_agg.server_opt_step_flat_sharded(*args, adam=adam,
                                                       **kw)
               if mesh else server_opt.server_opt_step_flat(*args,
                                                            adam=adam))
    return [None if x is None else
            (x.gather() if isinstance(x, psh.Sharded) else x).numpy()
            for x in out]


def _jax(form, o):
    """The JAX package's sharded wrappers, in interpret mode, on its mesh
    of the one device it sees here; the fused merge and step as its chain
    (the sharded merge, then the sharded step)."""
    mesh = jpsh.agg_mesh(1)
    j = {k: jnp.asarray(a) for k, a in o.items()}
    adam = form.endswith("adam")
    sc = jnp.asarray(OPT_SCALARS[adam])
    if form == "mix" or form == "merge_adam":
        merged = jfa.fedavg_mix_flat_sharded(j["rows"], j["w_mix"],
                                             j["server"], S, mesh=mesh,
                                             interpret=True)
    elif form in ("agg", "merge_mom"):
        merged = jfa.fedavg_agg_flat_sharded(j["rows"], j["w"], mesh=mesh,
                                             interpret=True)
    if form in ("mix", "agg"):
        return [np.asarray(merged)]
    if form.startswith("merge"):
        prev = j["server"] if adam else j["prev"]
    else:
        merged, prev = j["server"], j["prev"]
    out = jfa.server_opt_step_flat_sharded(
        prev, merged, j["m"], j["v"] if adam else None, sc, adam=adam,
        mesh=mesh, interpret=True)
    return [None if x is None else np.asarray(x) for x in out]


@pytest.mark.parametrize("form", B7_FORMS)
def test_b7_grouped_equals_unsharded_and_jax(form, monkeypatch):
    W, N = 3, flatbuf.BLOCK * 4 * 2
    o = _inputs(W, N, seed=B7_FORMS.index(form))
    if form == "merge_adam":
        o["prev"] = o["server"]         # the merge path's anchor: in place
    whole = _port(form, o)
    jax_out = _jax(form, o)
    for D in (1, 2, 4):
        monkeypatch.setenv("REPRO_HOST_DEVICES", str(D))
        got = _port(form, o, psh.agg_mesh(D, platform="cpu"))
        assert len(got) == len(whole) == len(jax_out)
        for g, u, j in zip(got, whole, jax_out):
            if u is None:
                assert g is None and j is None
                continue
            assert np.array_equal(g.view(np.int32), u.view(np.int32)), D
            assert float(np.abs(g - j).max()) < KERNEL_TOL, D


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


def _spacing_bound(port, want, q, scale):
    """|port - want| <= spacing(|want|) + spacing(|q * scale|): the
    rounding of q * scale that an FMA skips, and the result's rounding."""
    prod = np.abs(q.astype(np.float32) * np.float32(scale))
    lim = np.spacing(np.abs(want)).astype(np.float64) + np.spacing(prod)
    gap = np.abs(port.astype(np.float64) - want.astype(np.float64))
    return bool(np.all(gap <= lim))


def _payloads(W, N, seed):
    rng = np.random.RandomState(seed)
    qs = [rng.randint(-127, 128, N).astype(np.int8) for _ in range(W)]
    scales = [np.float32(rng.rand() * 0.01) for _ in range(W)]
    return qs, scales, rng.randn(N).astype(np.float32)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_b4_grouped_decode_equals_unsharded_and_jax(D, monkeypatch):
    monkeypatch.setenv("REPRO_HOST_DEVICES", str(D))
    mesh = psh.agg_mesh(D, platform="cpu")
    N = flatbuf.BLOCK * 4 * 2
    qs, scales, base = _payloads(1, N, seed=D)
    q, s, b = (torch.from_numpy(qs[0]), torch.tensor(scales[0]),
               torch.from_numpy(base))
    got = topk_quant.dequant_add(psh.split(q, mesh), s, psh.split(b, mesh))
    assert isinstance(got, psh.Sharded) and len(got.shards) == D
    got = got.gather().numpy()
    assert np.array_equal(_bits(got), _bits(
        topk_quant.dequant_add(q, s, b).numpy()))
    want = np.asarray(jtq.dequant_add(jnp.asarray(qs[0]), scales[0],
                                      jnp.asarray(base), interpret=True))
    assert _spacing_bound(got, want, qs[0], scales[0])


@pytest.mark.parametrize("D", [1, 2, 4])
def test_b4_grouped_rows_equal_unsharded_and_jax(D, monkeypatch):
    """A merge's encoded responses landed in a sharded row buffer (the
    sharded server's path, one ``dequant_add_rows_pieces`` a device), a
    dirty row beyond them zeroed: bit for bit the unsharded
    ``dequant_add_rows``, row by row within the FMA bound of JAX's
    ``dequant_add``."""
    monkeypatch.setenv("REPRO_HOST_DEVICES", str(D))
    mesh = psh.agg_mesh(D, platform="cpu")
    W, N = 5, flatbuf.BLOCK * 4 * 2
    qs, scales, base = _payloads(W, N, seed=10 + D)
    tq = [torch.from_numpy(q) for q in qs]
    ts = [torch.tensor(s) for s in scales]
    tb = torch.from_numpy(base)
    bundle = flatbuf.ParamBundle({"w": torch.empty(N, device="meta")},
                                 mesh=mesh)
    b_sh = psh.split(tb, mesh)
    rows_sh = psh.split(torch.full((W + 1, N), float("nan")), mesh)
    assert bundle._set_rows(rows_sh, [
        flatbuf.EncodedVec(psh.split(q, mesh), s, b_sh)
        for q, s in zip(tq, ts)]) is rows_sh
    got = rows_sh.gather().numpy()
    rows = torch.full((W + 1, N), float("nan"))
    topk_quant.dequant_add_rows(tq, ts, [tb] * W, rows)
    assert np.array_equal(_bits(got), _bits(rows.numpy()))
    assert not got[W:].any()
    for i in range(W):
        want = np.asarray(jtq.dequant_add(jnp.asarray(qs[i]), scales[i],
                                          jnp.asarray(base),
                                          interpret=True))
        assert _spacing_bound(got[i], want, qs[i], scales[i])


def test_pieces_functions_equal_their_single_forms():
    """The pieces functions on lists equal the single-piece wrappers
    piece by piece, in-place outputs included."""
    rng = np.random.RandomState(3)
    P, W, N = 3, 4, 256
    rows = [torch.from_numpy(rng.randn(W, N).astype(np.float32))
            for _ in range(P)]
    vecs = [[torch.from_numpy(rng.randn(N).astype(np.float32))
             for _ in range(P)] for _ in range(4)]
    srv, prev, m, v = vecs
    v = [x.abs() for x in v]
    w = torch.from_numpy(rng.rand(W).astype(np.float32))
    wvec = torch.from_numpy(rng.rand(W + 1).astype(np.float32))
    for r, got in zip(rows, fedavg_agg.fedavg_agg_pieces(rows, w)):
        assert torch.equal(got, fedavg_agg.fedavg_agg_flat(r, w))
    outs = [s.clone() for s in srv]
    got = fedavg_agg.fedavg_mix_pieces(rows, wvec, outs, outs=outs)
    for r, s, g, o in zip(rows, srv, got, outs):
        assert g is o and torch.equal(o, fedavg_agg.fedavg_mix_wvec(
            r, wvec, s))
    sc = OPT_SCALARS[True]
    m_in = [x.clone() for x in m]
    news, mos, vos = fedavg_agg.merge_opt_pieces(
        rows, wvec, srv, prev, m_in, v, sc, adam=True, m_outs=m_in)
    for i in range(P):
        want = fedavg_agg.merge_opt_flat(rows[i], wvec, srv[i], prev[i],
                                         m[i], v[i], sc, adam=True)
        assert mos[i] is m_in[i]
        for g, u in zip((news[i], mos[i], vos[i]), want):
            assert torch.equal(g, u)
    news, mos, vos = server_opt.server_opt_step_pieces(
        prev, srv, m, None, OPT_SCALARS[False], adam=False)
    assert vos == [None] * P
    for i in range(P):
        want = server_opt.server_opt_step_flat(prev[i], srv[i], m[i], None,
                                               OPT_SCALARS[False],
                                               adam=False)
        assert torch.equal(news[i], want[0]) and torch.equal(mos[i],
                                                             want[1])


# ---------------- launch bookkeeping ----------------

def test_pointer_table_is_piece_major_with_nulls():
    a, b, c, d = (torch.zeros(4) for _ in range(4))
    table = pointer_table([a, b], None, [c, d])
    assert isinstance(table, ctypes.Array) and len(table) == 6
    assert list(table) == [a.data_ptr(), None, c.data_ptr(),
                           b.data_ptr(), None, d.data_ptr()]


def test_launch_counts_of_a_grouped_call():
    """A launch every GROUP_PIECES pieces; the rows a launch every 128
    (decode, piece) pairs of at most GROUP_PIECES pieces, one that only
    zeroes, none for nothing (``dequant_add_rows_launch``'s loops)."""
    assert GROUP_PIECES == 32
    assert [group_launches(n) for n in (1, 4, 32, 33, 64, 65)] == \
        [1, 1, 1, 2, 2, 3]
    rl = topk_quant.rows_launches
    assert rl(30, 0, 1) == rl(128, 5, 1) == rl(30, 2, 4) == 1
    assert rl(0, 0, 1) == 0 and rl(0, 3, 4) == 1
    assert rl(129, 0, 1) == 2 and rl(33, 0, 4) == 2
    assert rl(5, 1, 34) == 3          # 32 pieces: 4 a launch; then 2


def test_cpu_pieces_count_no_launch():
    """On the CPU the plain versions run and no counter moves."""
    l0 = (dict(fedavg_agg.LAUNCHES), dict(fedavg_agg.PIECES),
          dict(topk_quant.LAUNCHES), dict(topk_quant.PIECES))
    fedavg_agg.fedavg_agg_pieces([torch.zeros(2, 8)] * 2, torch.ones(2))
    topk_quant.dequant_add_pieces([torch.zeros(8, dtype=torch.int8)], 1.0,
                                  [torch.zeros(8)])
    assert (fedavg_agg.LAUNCHES, fedavg_agg.PIECES, topk_quant.LAUNCHES,
            topk_quant.PIECES) == l0


# ---------------- chip_smoke.py's B4 check, rehearsed ----------------

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_shard_decode_rehearsed():
    cs = _chip_smoke()
    rec = cs.check_shard_decode(torch.device("cpu"),
                                sizes=((8192, 8192, 100), (4096, 4096, 10)),
                                W=5)
    assert rec["ok"] and len(rec["decode"]) == len(rec["rows"]) == 6
    assert all(c["equal"] for c in rec["decode"] + rec["rows"])


@pytest.mark.parametrize("kind", ["decode", "rows"])
def test_chip_smoke_shard_decode_faults_fail(kind):
    cs = _chip_smoke()
    with pytest.raises(AssertionError, match=f"sharded {kind}"):
        cs.check_shard_decode(torch.device("cpu"),
                              sizes=((8192, 8192, 100),), W=5,
                              fault=cs.SHARD_DEC_FAULTS[kind])


def test_chip_smoke_b7_group_fault_fails():
    """The B7 control "a device's group covers only its first piece"
    leaves every piece but a device's first unwritten."""
    cs = _chip_smoke()
    with pytest.raises(AssertionError, match="B7 mix"):
        cs.check_b7(torch.device("cpu"), [(3, 4096)], meshes=(4,),
                    fault=cs.B7_FAULTS[2])
    mesh = psh.AggMesh((torch.device("cpu"),) * 4)
    sh = psh.split(torch.arange(8.0) + 1, mesh)
    left = cs.first_pieces_only(sh)
    assert torch.equal(left.shards[0], sh.shards[0])
    assert all(not p.any() for p in left.shards[1:])
