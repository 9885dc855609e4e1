"""The port's flat-buffer merge substrate (repro_torch.core.flatbuf) against
the JAX package's, on the same numpy inputs: pack/unpack layout, the
fused merges (alpha < 1 and alpha >= 1), the row window, the delta
merge, and the torch-specific aliasing contract (trees and vectors handed
out before a merge are unchanged by it).  Merges agree within 1e-6 (f32
reduction order differs between the frameworks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flatbuf as jflat
from repro_torch.core import flatbuf

SHAPES = {"w1": (7, 13), "b1": (13,), "w2": (13, 5), "scalar": ()}


def _np_tree(seed):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*s), np.float32) for k, s in SHAPES.items()}


def _both(seed):
    t = _np_tree(seed)
    return ({k: jnp.asarray(v) for k, v in t.items()},
            {k: torch.from_numpy(v.copy()) for k, v in t.items()})


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _tree_err(jt, tt):
    assert sorted(jt) == sorted(tt)
    return max(_err(jt[k], tt[k].numpy()) for k in jt)


def test_pack_unpack_layout_matches_jax():
    jt, tt = _both(0)
    jb, tb = jflat.ParamBundle(jt), flatbuf.ParamBundle(tt)
    assert (tb.n_params, tb.padded_size, tb.raw_bytes) == \
        (jb.n_params, jb.padded_size, jb.raw_bytes)
    vec = tb.pack(tt)
    assert np.array_equal(vec.numpy(), np.asarray(jb.pack(jt)))
    assert not vec[tb.n_params:].any()
    back = tb.unpack(vec)
    assert all(torch.equal(back[k], tt[k]) for k in tt)
    assert back["scalar"].shape == ()


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_merge_rows_matches_jax(alpha):
    jserver, tserver = _both(1)
    ups = [_both(10 + i) for i in range(3)]
    weights = [1.0, 2.0, 0.5]
    jst, tst = jflat.FlatServerState(jserver), flatbuf.FlatServerState(tserver)
    jvecs = [jst.bundle.pack(j) for j, _ in ups]
    tvecs = [tst.bundle.pack(t) for _, t in ups]
    jm = jst.merge_rows(jserver, jvecs, weights, alpha)
    tm = tst.merge_rows(tserver, tvecs, weights, alpha)
    assert _tree_err(jm, tm) < 1e-6
    # second round from the merged mirror (identity-keyed, no re-pack)
    jm2 = jst.merge_rows(jm, jvecs[:2], [1.0, 1.0], alpha)
    tm2 = tst.merge_rows(tm, tvecs[:2], [1.0, 1.0], alpha)
    assert _tree_err(jm2, tm2) < 1e-6


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_merge_window_matches_jax_and_dense_merge(alpha):
    jserver, tserver = _both(2)
    ups = [_both(20 + i) for i in range(3)]
    weights = [0.2, 0.3, 0.5]
    jst, tst = jflat.FlatServerState(jserver), flatbuf.FlatServerState(tserver)
    dense = flatbuf.FlatServerState(tserver)
    jrows, trows = [], []
    for j, t in ups:
        jr, tr = jst.win_claim(), tst.win_claim()
        assert jr == tr
        jst.win_write(jr, jst.bundle.pack(j))
        tst.win_write(tr, tst.bundle.pack(t))
        jrows.append(jr)
        trows.append(tr)
    jm = jst.merge_window(jserver, jrows, weights, alpha)
    tm = tst.merge_window(tserver, trows, weights, alpha)
    assert _tree_err(jm, tm) < 1e-6
    dm = dense.merge_rows(tserver, [dense.bundle.pack(t) for _, t in ups],
                          weights, alpha)
    assert all(torch.equal(tm[k], dm[k]) for k in tm)
    # released rows are zeroed before the next merge and claims recycle
    # the lowest free row
    for r in trows:
        tst.win_release(r)
    assert tst.win_claim() == 0
    tst.win_write(0, tst.bundle.pack(ups[0][1]))
    tst.merge_window(tm, [0], [1.0], alpha)
    assert not tst._rows[1:].any()


def test_delta_vec_matches_jax():
    jcur, tcur = _both(3)
    (jn, tn), (jb, tb) = _both(4), _both(5)
    jst, tst = jflat.FlatServerState(jcur), flatbuf.FlatServerState(tcur)
    jv = jst.delta_vec(jcur, jst.bundle.pack(jn), jst.bundle.pack(jb))
    tv = tst.delta_vec(tcur, tst.bundle.pack(tn), tst.bundle.pack(tb))
    assert _err(jv, tv.numpy()) < 1e-6
    ja = jst.apply_delta(jcur, jn, jb)
    ta = tst.apply_delta(tcur, tn, tb)
    assert _tree_err(ja, ta) < 1e-6


def test_replace_merge_over_nonfinite_server_is_finite():
    _, tserver = _both(6)
    tserver["w1"][0, 0] = float("inf")
    tserver["b1"][3] = float("nan")
    st = flatbuf.FlatServerState(tserver)
    ups = [st.bundle.pack(_both(7 + i)[1]) for i in range(2)]
    out = st.merge_rows(tserver, ups, [1.0, 1.0], alpha=1.0)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_stale_rows_are_zeroed():
    _, tserver = _both(8)
    st = flatbuf.FlatServerState(tserver)
    vecs = [st.bundle.pack(_both(30 + i)[1]) for i in range(3)]
    vecs[2][0] = float("inf")
    st.merge_rows(tserver, vecs, [1.0, 1.0, 1.0])
    out = st.merge_rows(tserver, vecs[:2], [1.0, 1.0], alpha=0.5)
    assert st.capacity == 3 and not st._rows[2].any()
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_merge_does_not_alias_trees_or_vectors_handed_out(alpha):
    """The in-place mix writes only the server mirror: weight dicts and
    packed vectors returned before a merge are unchanged after it."""
    _, tserver = _both(9)
    st = flatbuf.FlatServerState(tserver)
    vecs = [st.bundle.pack(_both(40 + i)[1]) for i in range(2)]
    first = st.merge_rows(tserver, vecs, [1.0, 1.0], alpha)
    snap_first = {k: v.clone() for k, v in first.items()}
    snap_vecs = [v.clone() for v in vecs]
    delta = st.delta_vec(first, vecs[0], vecs[1])
    snap_delta = delta.clone()
    second = st.merge_rows(first, [delta, vecs[1]], [1.0, 1.0], alpha)
    st.merge_rows(second, vecs, [1.0, 3.0], alpha)
    assert all(torch.equal(first[k], snap_first[k]) for k in first)
    assert all(torch.equal(a, b) for a, b in zip(vecs, snap_vecs))
    assert torch.equal(delta, snap_delta)
    unpacked = st.bundle.unpack(vecs[0])
    unpacked["w1"].add_(1.0)
    assert torch.equal(vecs[0], snap_vecs[0])


def test_mesh_is_not_ported():
    """A mesh that is not the port's own (``parallel.sharding.agg_mesh``)
    is refused; the port's own runs (tests/test_torch_sharded.py)."""
    from repro_torch.parallel import sharding as psh
    _, tserver = _both(0)
    with pytest.raises(TypeError, match="agg_mesh"):
        flatbuf.FlatServerState(tserver, mesh=object())
    st = flatbuf.FlatServerState(tserver, mesh=psh.agg_mesh(1,
                                                            platform="cpu"))
    assert st.bundle.n_shards == 1
