"""The fused merge and server-optimizer step (``kernels.fedavg_agg.
merge_opt_flat``: B1's or B2's weighted row sum, then B5's step, in one
pass) on the CPU, where the wrapper runs its plain version
(``ref.reference_merge_opt``); inputs drawn with numpy from a seed.

* the plain fused version equals the unfused plain chain (the merge, then
  ``ref.reference_server_opt``) bit for bit, in both server forms (the
  aggregate, server None, and the mix) and both optimizer forms, fresh
  and with every output aliased as the merge path aliases them (out =
  server = prev, m_out = m, v_out = v);
* it matches the JAX package's ``fedavg_agg_flat`` / ``fedavg_mix_flat``
  followed by ``server_opt_step_flat``, all in interpret mode, within
  rtol = atol = 1e-6 (XLA reduces and contracts in its own order);
* a NaN or inf in a zero-weight row propagates as the chain's 0 * inf
  does, and the aggregate never reads the server;
* ``FlatServerState`` with each optimizer, over several merges at alpha 1
  and 0.9 (where the server buffer is also ``prev``), through
  ``merge_rows``, ``merge_window``, ``delta_vec`` and a ``rebase``, equals
  the unfused sequence (the merge's own pass, then ``step_vec``) bit for
  bit in every installed model and in the optimizer's moments, and
  ``run_fl`` with a server optimizer gives the unfused run's history in
  every field;
* a CPU call counts no launch; chip_smoke.py's controls of its fused
  check (each faulty plain version) differ from the plain version.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fedavg_agg as jfedavg
from repro_torch.core import TABLE_4_1, flatbuf, make_setup, run_fl
from repro_torch.core import server_opt as so
from repro_torch.kernels import fedavg_agg, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# optimizer -> its kernel scalars (chip_smoke's, the FL runs' settings)
SCALARS = {k: np.asarray(v, np.float32)
           for k, v in chip_smoke.OPT_SCALARS.items()}
ADAM = {"fedavgm": False, "feddyn": False, "fedadam": True}
NS = (511, 2048, 4099)
WS = (1, 2, 10)
FORMS = ("agg", "mix")


def _inputs(form, W, N, seed=0, s=0.1):
    """(stacked, wvec, server, prev, m, v) as CPU tensors: unit-normal
    rows, normalised positive weights (after the server scale ``s`` in
    the mix), |v| for the second moment; server None for the aggregate."""
    rng = np.random.RandomState(seed + 7 * W + N)
    rows = rng.randn(W, N).astype(np.float32)
    w = rng.rand(W).astype(np.float32) + 0.1
    w = (w / w.sum()).astype(np.float32)
    server, prev, m, v = (rng.randn(N).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    if form == "mix":
        w = np.concatenate([np.float32([s]), (1 - s) * w]).astype(np.float32)
    t = [torch.from_numpy(a) for a in (rows, w, server, prev, m, v)]
    if form == "agg":
        t[2] = None
    return t


def _chain(stacked, wvec, server, prev, m, v, sc, adam):
    """The unfused plain chain: the merge's plain version, then the
    step's."""
    if server is None:
        merged = ref.reference_fedavg(stacked, wvec)
    else:
        merged = ref.reference_fedavg_mix(stacked, wvec[1:], server,
                                          wvec[0])
    return ref.reference_server_opt(prev, merged, m, v, sc, adam=adam)


def _equal(got, want):
    """Equal bit for bit (a NaN equals a NaN of the same bits)."""
    for g, w in zip(got, want):
        assert chip_smoke.same_bits(g, w)


# ---------------- the plain fused version ----------------

@pytest.mark.parametrize("opt", sorted(SCALARS))
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("N", NS)
def test_plain_fused_equals_unfused_chain(N, W, form, opt):
    stacked, wvec, server, prev, m, v = _inputs(form, W, N)
    sc, adam = SCALARS[opt], ADAM[opt]
    want = _chain(stacked, wvec, server, prev, m, v, sc, adam)
    _equal(fedavg_agg.merge_opt_flat(stacked, wvec, server, prev, m, v, sc,
                                     adam=adam), want)
    # aliased as the merge path calls it: the mix writes into the server
    # buffer, which is also prev; the moments update in place
    if form == "mix":
        buf = prev.clone()
        want = _chain(stacked, wvec, buf, buf, m, v, sc, adam)
    else:
        buf = None
    m2, v2 = m.clone(), v.clone()
    got = fedavg_agg.merge_opt_flat(stacked, wvec, buf,
                                    prev if buf is None else buf, m2, v2,
                                    sc, adam=adam, out=buf, m_out=m2,
                                    v_out=v2)
    _equal(got, want)
    assert got[1] is m2
    if form == "mix":
        assert got[0] is buf
    if adam:
        assert got[2] is v2
    else:
        assert torch.equal(v2, v)


@pytest.mark.parametrize("opt", ["fedavgm", "fedadam"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("N", NS)
def test_plain_fused_matches_jax(N, W, form, opt):
    stacked, wvec, server, prev, m, v = _inputs(form, W, N, seed=1)
    sc, adam = SCALARS[opt], ADAM[opt]
    got = fedavg_agg.merge_opt_flat(stacked, wvec, server, prev, m, v, sc,
                                    adam=adam)
    j = {k: jnp.asarray(t.numpy()) for k, t in zip(
        ("rows", "w", "prev", "m", "v"), (stacked, wvec, prev, m, v))}
    if form == "agg":
        merged = jfedavg.fedavg_agg_flat(j["rows"], j["w"], interpret=True)
    else:
        merged = jfedavg.fedavg_mix_flat(
            j["rows"], j["w"][1:], jnp.asarray(server.numpy()), j["w"][0],
            interpret=True)
    want = jfedavg.server_opt_step_flat(
        j["prev"], merged, j["m"], j["v"] if adam else None,
        jnp.asarray(sc), adam=adam, interpret=True)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("form", FORMS)
def test_nonfinite_zero_weight_row_propagates(form):
    """An inf in a row of weight 0 gives NaN (0 * inf), as the chain
    does."""
    stacked, wvec, server, prev, m, v = _inputs(form, 3, 2048, seed=2)
    sc = SCALARS["fedadam"]
    wvec[-1] = 0.0
    stacked[-1, 5] = float("inf")
    got = fedavg_agg.merge_opt_flat(stacked, wvec, server, prev, m, v, sc,
                                    adam=True)
    _equal(got, _chain(stacked, wvec, server, prev, m, v, sc, True))
    assert torch.isnan(got[0][5]) and torch.isfinite(got[0][6:]).all()


def test_alpha_one_never_reads_the_server_buffer():
    """chip_smoke's flat-state check on the CPU: with the packed server
    mirror overwritten by inf and the optimizer's anchor re-packed from
    the (finite) server dict, an alpha 1 merge with its step stays finite
    and equals the same merge without the inf; an alpha 0.9 merge reads
    the mirror and gives NaN."""
    rec = chip_smoke.check_unread_server(torch.device("cpu"))
    assert rec == {"alpha 1 finite": True, "alpha 1 equals unpoisoned": True,
                   "alpha 0.9 NaN": True, "alpha 0.9 unpoisoned finite": True}


def test_cpu_counts_no_launch_and_other_devices_raise():
    before = dict(fedavg_agg.LAUNCHES)
    for form in FORMS:
        stacked, wvec, server, prev, m, v = _inputs(form, 2, 512)
        for opt in ("fedavgm", "fedadam"):
            fedavg_agg.merge_opt_flat(stacked, wvec, server, prev, m, v,
                                      SCALARS[opt], adam=ADAM[opt])
    assert fedavg_agg.LAUNCHES == before
    meta = [torch.zeros(s, device="meta") for s in ((2, 512), (2,), (512,),
                                                    (512,))]
    with pytest.raises(RuntimeError):
        fedavg_agg.merge_opt_flat(meta[0], meta[1], None, meta[2], meta[3],
                                  None, SCALARS["fedavgm"], adam=False)
    with pytest.raises(ValueError):
        fedavg_agg.merge_opt_flat(*_inputs("agg", 2, 512),
                                  SCALARS["fedavgm"][:3], adam=False)


@pytest.mark.parametrize("fault", sorted(chip_smoke.MERGE_FAULTS))
def test_chip_smoke_merge_faults_differ_from_the_plain_version(fault):
    """Each of chip_smoke's controls, at its case's W, s and optimizer,
    differs from the plain version: the fused check on the card would
    catch a kernel that computes it."""
    W, s, opt = chip_smoke.MERGE_FAULTS[fault]
    form = "agg" if s is None else "mix"
    stacked, wvec, server, prev, m, v = _inputs(form, W, 4099, seed=3,
                                                s=0.1 if s is None else s)
    sc, adam = SCALARS[opt], ADAM[opt]
    want = ref.reference_merge_opt(stacked, wvec, server, prev, m, v, sc,
                                   adam=adam)
    bad = chip_smoke.merge_plain_fault(fault, stacked, wvec, server, prev,
                                       m, v, sc, adam=adam)
    assert not torch.equal(bad[0], want[0])
    assert chip_smoke.merge_mismatch(bad, want)


def test_chip_smoke_merge_check_runs_on_the_cpu():
    """chip_smoke's fused check, its cases cut to small N, run on the CPU
    (kernel and plain version are then both the plain version): every
    case equal, every control caught, the aliased call equal to the fresh
    one."""
    rec = chip_smoke.check_merge_opt(torch.device("cpu"), ns=(512, 514),
                                     ws=(1, 2, 10))
    assert rec["cases"] and all(not c["mismatch"] for c in rec["cases"])
    assert all(rec["controls"].values())


# ---------------- the flat state: fused vs unfused ----------------

class Unfused(flatbuf.FlatServerState):
    """The merge tail before the fusion: the merge's own pass, then the
    optimizer's ``step_vec`` as a pass of its own."""

    def _merge(self, server_tree, idx, weights, alpha):
        w = flatbuf.normalized_weights(weights)
        if alpha >= 1.0:
            wv = np.zeros((self.capacity,), np.float32)
            wv[idx] = w
            merged = flatbuf.fused_weighted_sum(self._rows, wv)
        else:
            wv = np.zeros((self.capacity + 1,), np.float32)
            wv[0] = 1.0 - alpha
            wv[idx + 1] = alpha * w
            merged = flatbuf.fused_merge(self._server_buffer(server_tree),
                                         self._rows, wv)
        if self.server_opt is not None:
            merged = self.server_opt.step_vec(self, server_tree, merged)
        return self._finish(server_tree, merged)


SHAPES = {"w": (37, 41), "b": (53,)}
OPTS = {"fedavgm": {"momentum": 0.9}, "fedadam": {"lr": 0.05},
        "feddyn": {"gamma": 0.25}}


def _tree(rng):
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("alpha", [1.0, 0.9])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_flat_state_fused_equals_unfused(name, alpha, monkeypatch):
    """Six merges through both states from one start: merge_rows,
    merge_window, a delta_vec in between (which consumes the server
    buffer), a rebase (the anchor re-packs), and merges of 1 and 3
    updates.  Every installed model and the moments are equal bit for
    bit; at alpha 0.9 the fused merge re-packs nothing, its server buffer
    being prev."""
    rng = np.random.RandomState(0)
    s0 = _tree(rng)
    states = {}
    for tag, cls in (("fused", flatbuf.FlatServerState), ("unfused", Unfused)):
        st = cls(s0)
        st.server_opt = so.make_server_opt(name, **OPTS[name])
        states[tag] = [st, s0]
    # packs inside the fused merges, by step: the server buffer at the
    # first merge and after delta_vec consumed it; at alpha 1 also the
    # anchor at the first merge, after the rebase and after delta_vec
    want_packs = {0: 1, 4: 1} if alpha < 1.0 else {0: 1, 3: 1, 4: 1}
    bundle = states["fused"][0].bundle
    real_pack, counting = bundle.pack, [False, 0]

    def pack(tree):
        counting[1] += counting[0]
        return real_pack(tree)
    monkeypatch.setattr(bundle, "pack", pack)
    for step in range(6):
        ups = [_tree(rng) for _ in range(1 if step % 2 else 3)]
        for tag, (st, srv) in states.items():
            vecs = [st.bundle.pack(u) for u in ups]
            if step == 3:
                st.server_opt.rebase()
            if step == 4:
                # async_delta's form: the server buffer is consumed, then
                # the delta-applied vector merged as one update
                vecs = [st.delta_vec(srv, vecs[0], st.bundle.pack(srv))]
            w = [1.0, 2.0, 1.0][:len(vecs)]
            counting[:] = [tag == "fused", 0]
            if step == 5:
                rows = [st.win_claim() for _ in vecs]
                for r, vec in zip(rows, vecs):
                    st.win_write(r, vec)
                new = st.merge_window(srv, rows, w, alpha)
            else:
                new = st.merge_rows(srv, vecs, w, alpha)
            if tag == "fused":
                assert counting[1] == want_packs.get(step, 0), step
            counting[0] = False
            states[tag][1] = new
        (fs, fsrv), (us, usrv) = states["fused"], states["unfused"]
        assert all(torch.equal(fsrv[k], usrv[k]) for k in SHAPES), step
        assert torch.equal(fs.server_opt._m, us.server_opt._m)
        if fs.server_opt.adam:
            assert torch.equal(fs.server_opt._v, us.server_opt._v)


def test_degenerate_optimizer_merges_as_plain_fedavg():
    """A degenerate optimizer takes no step: the fused path is not taken
    and the merge result is installed verbatim."""
    rng = np.random.RandomState(4)
    s0 = _tree(rng)
    plain = flatbuf.FlatServerState(s0)
    deg = flatbuf.FlatServerState(s0)
    deg.server_opt = so.make_server_opt("fedavgm", momentum=0.0, lr=1.0)
    ups = [_tree(rng) for _ in range(2)]
    for alpha in (1.0, 0.9):
        a = plain.merge(s0, ups, [1.0, 3.0], alpha)
        b = deg.merge(s0, ups, [1.0, 3.0], alpha)
        assert all(torch.equal(a[k], b[k]) for k in SHAPES)
    assert deg.server_opt._m is None


RUN_MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
}


@pytest.mark.parametrize("mode", sorted(RUN_MODES))
@pytest.mark.parametrize("name", ["fedavgm", "fedadam"])
def test_run_fl_fused_equals_unfused(name, mode, monkeypatch):
    """A short non-IID run with a server optimizer: the fused merge gives
    the unfused run's history in every field, accuracy included."""
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device="cpu")
    kw = dict(epochs_per_round=2, max_rounds=4, **RUN_MODES[mode],
              partition="dirichlet", partition_kw={"alpha": 0.3, "seed": 0},
              server_opt=name, server_opt_kw=OPTS[name])
    fused = [vars(p) for p in run_fl(setup, **kw)]
    monkeypatch.setattr(flatbuf.FlatServerState, "_merge", Unfused._merge)
    assert [vars(p) for p in run_fl(setup, **kw)] == fused
