"""The port's durable federation (``repro_torch/checkpoint``) on the CPU.

* ``CheckpointManager``'s contract: the ``*.tmp`` sweep at construction
  and before a save, readable-aware GC, ``keep <= 0`` keeping everything,
  ``restore_latest`` skipping a truncated newest file with a warning, the
  default host copy of tensor leaves; ``resume`` with no checkpoint and
  checkpointing with no directory raise; ``max_events`` spans segments.
* Bit-exact splits: a run stopped right after its first snapshot and
  resumed from disk equals the uninterrupted run in every history field,
  floats as ``float.hex``, over the reference's ``RUN_MATRIX`` and
  ``TOPO_MATRIX`` (tests/test_resume.py) plus ``raw/sync``,
  ``raw/async_delta``, ``uplink_only/sync`` and FedAdam (sync and
  FedAsync, at the root of a topology too); the resumed segment trains
  less than the whole run; checkpointing with no kill changes nothing;
  a snapshot that drops the EF residuals or the optimizer's moments
  makes the resumed run differ (the splits' controls).
* Identities: after a pickle round trip and after a restore, the
  responses pinned to one model share ONE ``EncodedVec.base``, and a
  fetch leg's payload and ack cell are the link's; a capture holds host
  copies that the live run's in-place writes (merge, moments, EF) never
  reach, so a run continued after a capture and a run restored from it
  agree.
* A failed-over root refuses to be captured.
* Chaos: a lossy 1x2 run SIGKILLed as a process and resumed, and one
  stopped after two snapshots with lossy legs in flight (cancelled with
  credit and re-kicked), each closing ``audit_chaos_run``'s books.
* ``chip_smoke.py``'s resume phase rehearsed: writer processes killed at
  their first snapshot, a fresh reader process resuming all, each
  history equal to the uninterrupted one (the launch counters are read
  on the card only: the plain versions count none).
"""
import dataclasses
import io
import pickle
import signal
import subprocess
import sys
import textwrap
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, FederationSnapshot
from repro_torch.checkpoint import snapshot as snap_mod
from repro_torch.core import TABLE_4_1, make_setup, run_fl
from repro_torch.core.experiment import build_experiment
from repro_torch.core.flatbuf import EncodedVec
from repro_torch.core.topology import (TopologyConfig, build_topology,
                                       parse_topology, run_fl_topology)
from repro_torch.runtime.faults import (ChaosSchedule, FaultInjector,
                                        audit_chaos_run)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")
EP, ROUNDS = 2, 3
MODE_KW = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
    "async_delta": dict(mode="async", selector="all", async_delta=True),
    "time_based": dict(mode="sync", selector="time_based",
                       selector_kw={"r": EP, "T0": 0.0, "A": 0.01}),
}
TOPK = dict(transport="topk_ef+int8", transport_frac=0.1)
UPLINK_ONLY = dict(transport="topk_ef+int8", transport_down="raw",
                   transport_frac=0.1)
FEDADAM = dict(server_opt="fedadam", server_opt_kw={"lr": 0.05})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one CPU thread: these runs are hundreds of
    small ops, and beside other test processes torch's thread pool spins
    instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(counter=None):
    setup = make_setup(TABLE_4_1["mnist_even"], **SETUP_KW, device="cpu")
    if counter is None:
        return setup
    train = setup.train_fn

    def counted(*args, **kw):
        counter[0] += 1
        return train(*args, **kw)
    return dataclasses.replace(setup, train_fn=counted)


def _rec(history):
    return [(p.time.hex(), p.version, float(p.accuracy).hex(), p.n_updates,
             p.selected, p.up_bytes, p.down_bytes, p.retransmits)
            for p in history]


def _allrec(res):
    out = {"root": _rec(res.root_history)}
    out.update({lid: _rec(h) for lid, h in res.leaf_histories.items()})
    return out


# ---------------- the manager ----------------

def test_stale_tmp_swept_on_init_and_save(tmp_path):
    (tmp_path / "stale_crash_a.tmp").write_bytes(b"partial write")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert list(tmp_path.glob("*.tmp")) == []
    (tmp_path / "stale_crash_b.tmp").write_bytes(b"partial write")
    mgr.save(1, {"x": np.ones(2)})
    assert list(tmp_path.glob("*.tmp")) == []
    step, state, _ = mgr.restore_latest()
    assert step == 1 and np.array_equal(state["x"], np.ones(2))


def test_gc_never_counts_unreadable_toward_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"x": np.ones(1)})
    mgr.save(2, {"x": np.full(1, 2.0)})
    mgr.save(3, {"x": np.full(1, 3.0)})
    mgr._path(3).write_bytes(b"\x00corrupt")      # newest unreadable
    mgr.save(4, {"x": np.full(1, 4.0)})           # triggers GC
    steps = mgr.steps()
    assert 2 in steps and 4 in steps, steps
    assert 1 not in steps
    step, state, _ = mgr.restore_latest()
    assert step == 4 and np.array_equal(state["x"], np.full(1, 4.0))


@pytest.mark.parametrize("keep", [0, -1])
def test_gc_keep_nonpositive_keeps_everything(keep, tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=keep)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, {"x": np.zeros(1)})
    assert mgr.steps() == [1, 2, 3, 4, 5]


def test_gc_keeps_the_newest_readable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": np.full(1, float(s))})
    assert mgr.steps() == [3, 4]


def test_restore_latest_skips_a_truncated_newest_file(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    mgr.save(1, {"x": torch.ones(3)})
    mgr.save(2, {"x": torch.full((3,), 2.0)})
    data = mgr._path(2).read_bytes()
    mgr._path(2).write_bytes(data[:len(data) // 2])     # a partial copy
    with pytest.warns(UserWarning, match="skipping unreadable checkpoint "
                                         "step 2"):
        step, state, _ = mgr.restore_latest()
    assert step == 1 and torch.equal(state["x"], torch.ones(3))


def test_restore_latest_of_an_empty_directory_is_none(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert CheckpointManager(str(tmp_path)).restore_latest() is None


def test_default_save_copies_tensor_leaves_to_the_host(tmp_path):
    """The counterpart of the reference's ``tree.map(np.asarray)``: tensor
    leaves of dicts, lists and tuples are host copies, the rest as is."""
    live = torch.arange(4.0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"a": live, "b": [live, (live, 3)], "c": "s"},
             {"note": 1})
    live += 1          # an in-place write after the save reaches no file
    step, state, meta = mgr.restore(7)
    assert step == 7 and meta == {"note": 1}
    assert torch.equal(state["a"], torch.arange(4.0))
    assert state["b"][1][1] == 3 and state["c"] == "s"
    assert state["a"].device.type == "cpu"


def test_resume_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no readable checkpoint"):
        run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", checkpoint_dir=str(tmp_path / "empty"),
               resume=True)
    with pytest.raises(FileNotFoundError, match="no readable checkpoint"):
        run_fl_topology(_fresh(), topology=parse_topology("1x2"),
                        mode="sync", epochs_per_round=EP,
                        max_rounds=ROUNDS,
                        checkpoint_dir=str(tmp_path / "empty2"),
                        resume=True)


@pytest.mark.parametrize("kw", [dict(checkpoint_every=1),
                                dict(resume=True)],
                         ids=["checkpoint_every", "resume"])
def test_checkpoint_requires_dir(kw):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", **kw)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", topology="1x2", **kw)


def test_checkpoint_every_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="must be positive"):
        run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", checkpoint_every=0,
               checkpoint_dir=str(tmp_path))


def test_max_events_budget_spans_checkpoint_segments(tmp_path):
    """A budget that starves the uninterrupted run (30 events) starves the
    segmented one too: segmentation must not reset the meter."""
    with pytest.raises(RuntimeError, match="max_events=25"):
        run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", max_events=25)
    with pytest.raises(RuntimeError, match="max_events=25"):
        run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", max_events=25, checkpoint_every=1,
               checkpoint_dir=str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="max_events=25"):
        run_fl_topology(_fresh(), topology=parse_topology("1x2"),
                        mode="sync", epochs_per_round=EP, max_rounds=ROUNDS,
                        max_events=25, checkpoint_every=1,
                        checkpoint_dir=str(tmp_path / "t"))
    # and a budget the whole run fits in is enough for the segmented run
    h = run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
               mode="sync", max_events=40, checkpoint_every=1,
               checkpoint_dir=str(tmp_path / "d"))
    assert h[-1].version == ROUNDS


# ---------------- bit-exact splits ----------------

RUN_MATRIX = [
    # the reference's (tests/test_resume.py)
    ("async", dict(transport="topk_ef+int8", transport_frac=0.1)),
    ("async", dict(transport="auto")),
    ("async_delta", dict(transport="topk_ef+int8", transport_frac=0.1)),
    ("async_delta", dict(transport="auto")),
    # the port's
    ("sync", dict(transport="raw")),
    ("async_delta", dict(transport="raw")),
    ("time_based", dict(transport="raw")),
    ("sync", UPLINK_ONLY),
    ("sync", dict(transport="raw", **FEDADAM)),
    ("async", dict(transport="raw", **FEDADAM)),
    ("sync", dict(**TOPK, **FEDADAM)),
]
_RUN_IDS = [f"{m}-{t['transport']}"
            + ("-down_raw" if t.get("transport_down") else "")
            + ("-fedadam" if "server_opt" in t else "")
            for m, t in RUN_MATRIX]


@pytest.mark.parametrize("mname,tkw", RUN_MATRIX, ids=_RUN_IDS)
def test_run_fl_split_matches_uninterrupted(mname, tkw, tmp_path):
    n_full, n_res = [0], [0]
    h_full = run_fl(_fresh(n_full), epochs_per_round=EP, max_rounds=ROUNDS,
                    **MODE_KW[mname], **tkw)
    d = str(tmp_path / "ckpt")
    run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
           **MODE_KW[mname], **tkw, checkpoint_every=1, checkpoint_dir=d,
           stop_after_checkpoints=1)
    # one snapshot, at the first version boundary (time_based's no-op
    # rounds move the version past 1 at once)
    assert len(CheckpointManager(d).steps()) == 1
    h_res = run_fl(_fresh(n_res), epochs_per_round=EP, max_rounds=ROUNDS,
                   **MODE_KW[mname], **tkw, checkpoint_dir=d, resume=True)
    assert _rec(h_res) == _rec(h_full)
    # the resumed segment resumed: it trains no more than the whole run,
    # less where training came before the snapshot (an async one may
    # train nothing: its last merges were encoded before it; time_based's
    # first rounds are no-ops)
    assert n_res[0] < n_full[0] or (mname == "time_based"
                                    and n_res[0] == n_full[0])


TOPO_MATRIX = [("sync", "raw"), ("sync", "topk_ef+int8"),
               ("async", "raw"), ("async", "topk_ef+int8")]


@pytest.mark.parametrize("push,transport", TOPO_MATRIX,
                         ids=[f"push_{p}-{t}" for p, t in TOPO_MATRIX])
def test_topology_split_matches_uninterrupted(push, transport, tmp_path):
    """The full 1x2 hierarchical state (root weights, server<->server
    acks, leaf push/fan legs, per-leaf servers) through a stop and a
    resume: root and leaf histories equal."""
    cfg = TopologyConfig(n_leaves=2, push=push)
    tkw = dict(transport=transport)
    if transport != "raw":
        tkw["transport_frac"] = 0.1
    full = run_fl_topology(_fresh(), topology=cfg, mode="sync",
                           epochs_per_round=EP, max_rounds=ROUNDS, **tkw)
    d = str(tmp_path / "ckpt")
    run_fl_topology(_fresh(), topology=cfg, mode="sync",
                    epochs_per_round=EP, max_rounds=ROUNDS, **tkw,
                    checkpoint_every=1, checkpoint_dir=d,
                    stop_after_checkpoints=1)
    res = run_fl_topology(_fresh(), topology=cfg, mode="sync",
                          epochs_per_round=EP, max_rounds=ROUNDS, **tkw,
                          checkpoint_dir=d, resume=True)
    assert _allrec(res) == _allrec(full)


@pytest.mark.parametrize("topology", ["1x1", "1x2"])
def test_topology_split_carries_the_roots_optimizer(topology, tmp_path):
    """FedAdam at the root of a 1x2 topology (on the lone leaf in 1x1):
    the moments ride the snapshot, the prev anchor re-packs."""
    kw = dict(epochs_per_round=EP, max_rounds=ROUNDS, mode="sync",
              topology=topology, **FEDADAM)
    h_full = run_fl(_fresh(), **kw)
    d = str(tmp_path / "ckpt")
    run_fl(_fresh(), **kw, checkpoint_every=1, checkpoint_dir=d,
           stop_after_checkpoints=1)
    assert _rec(run_fl(_fresh(), **kw, checkpoint_dir=d, resume=True)) == \
        _rec(h_full)


@pytest.mark.parametrize("mname", sorted(MODE_KW))
def test_checkpointing_itself_is_invisible(mname, tmp_path):
    """Saving snapshots with no kill leaves the run as it was: capture
    never mutates the live federation."""
    plain = run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
                   **MODE_KW[mname], **TOPK)
    saved = run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS,
                   **MODE_KW[mname], **TOPK, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path / "c"), checkpoint_keep=0)
    assert _rec(saved) == _rec(plain)
    steps = CheckpointManager(str(tmp_path / "c")).steps()
    assert steps and all(0 < s < ROUNDS for s in steps)


def _drop_residuals(img):
    for li in img["transport"]["links"].values():
        li["residual"] = None


def _drop_moments(img):
    img["server_opt"] = None


CONTROLS = {"EF residuals dropped": (_drop_residuals, "sync", TOPK),
            "optimizer moments dropped": (_drop_moments, "sync", FEDADAM)}


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_split_check_catches_a_snapshot_missing_state(name, tmp_path,
                                                      monkeypatch):
    """The splits' controls: a capture that loses the uplink EF residuals
    or the server optimizer's moments resumes into a different run."""
    fault, mname, tkw = CONTROLS[name]
    kw = dict(epochs_per_round=EP, max_rounds=ROUNDS, **MODE_KW[mname],
              **tkw)
    h_full = run_fl(_fresh(), **kw)
    real = snap_mod._capture_server

    def faulty(caps, srv):
        img = real(caps, srv)
        fault(img)
        return img
    monkeypatch.setattr(snap_mod, "_capture_server", faulty)
    d = str(tmp_path / "ckpt")
    run_fl(_fresh(), **kw, checkpoint_every=1, checkpoint_dir=d,
           stop_after_checkpoints=1)
    h_res = run_fl(_fresh(), **kw, checkpoint_dir=d, resume=True)
    assert _rec(h_res) != _rec(h_full)


# ---------------- identities and copies ----------------

def _build(**kw):
    return build_experiment(_fresh(), epochs_per_round=EP,
                            max_rounds=ROUNDS, **kw)


def _run_to(loop, cond):
    loop.run(break_when=cond)
    assert cond(), "the run ended before the state under test arose"


def test_responses_pinned_to_one_model_keep_one_base(tmp_path):
    """A sync round's quantised responses wait encoded, each pinned to the
    dispatched model: one base tensor in the live run, in the snapshot
    (a host copy), after a pickle round trip and after a restore."""
    kw = dict(**MODE_KW["sync"], **UPLINK_ONLY)
    loop, server = _build(**kw)
    server.start()
    _run_to(loop, lambda: len(server._cache) >= 3)
    live = [u.weights for u in server._cache]
    assert all(isinstance(v, EncodedVec) for v in live)
    assert all(v.base is live[0].base for v in live)
    snap = FederationSnapshot.capture_run(loop, server)
    for s in (snap, pickle.loads(pickle.dumps(snap))):
        cache = [u.weights for u in s.state["server"]["cache"]]
        assert len(cache) == len(live)
        assert all(v.base is cache[0].base for v in cache)
        assert cache[0].base is not live[0].base
        assert torch.equal(cache[0].base, live[0].base)
    loop2, server2 = _build(**kw)
    pickle.loads(pickle.dumps(snap)).restore_run(loop2, server2)
    got = [u.weights for u in server2._cache]
    assert all(v.base is got[0].base for v in got)
    # the restored links that dispatched this round hold that very base
    assert any(ln.tx_base is got[0].base
               for ln in server2.transport._links.values())


def test_fetch_legs_keep_their_payload_and_ack_cell(tmp_path):
    """Symmetric top-k: at a round boundary every fetch is in flight with
    a delta payload on the link and a cell in the worker's revert chain.
    The leg's payload IS the link's pending payload and the cell IS the
    ack state's, in the image and after the restore."""
    kw = dict(**MODE_KW["sync"], **TOPK)
    loop, server = _build(**kw)
    server.start()
    _run_to(loop, lambda: server.version >= 1)
    snap = pickle.loads(pickle.dumps(
        FederationSnapshot.capture_run(loop, server)))
    links = snap.state["server"]["transport"]["links"]
    acks = snap.state["acks"]
    legs = [r for r in snap.events if r["kind"] == "worker_leg"
            and r["rec"]["phase"] == "fetch"]
    assert len(legs) == len(server.workers)
    for r in legs:
        li = links[r["wid"]]
        payload, cell, _ = li["pending_down"]
        assert r["rec"]["down"] is payload and payload.codec != "raw"
        assert any(c is cell for c in acks[li["tok"]]["entries"])
    loop2, server2 = _build(**kw)
    snap.restore_run(loop2, server2)
    for wid, w in server2.workers.items():
        ln = server2.transport._links[wid]
        down, link = w._fetching[server2.pointer]
        assert link is ln and ln._pending_down[0] is down
        assert any(e is ln._pending_down[1] for e in ln._ack._entries)
    # and the restored run finishes as the live one does
    loop.run()
    loop2.run()
    assert _rec(server2.history) == _rec(server.history)


CONTINUE_CASES = {"fedasync-fedadam": dict(**MODE_KW["async"], **FEDADAM),
                  "sync-fedadam-topk": dict(**MODE_KW["sync"], **TOPK,
                                            **FEDADAM),
                  "async_delta-topk": dict(**MODE_KW["async_delta"],
                                           **TOPK),
                  # latest-table rows stay claimed across merges and are
                  # rewritten in place as their workers respond again
                  "async-latest-cohort": dict(mode="async", selector="all",
                                              cohort=6)}


def _storages(obj) -> set:
    """The storage addresses of every tensor reachable in ``obj``."""
    found = set()

    class Spy(pickle.Pickler):
        def persistent_id(self, o):
            if isinstance(o, torch.Tensor):
                found.add(o.untyped_storage().data_ptr())
            return None
    Spy(io.BytesIO()).dump(obj)
    return found


@pytest.mark.parametrize("case", sorted(CONTINUE_CASES))
def test_capture_holds_copies_the_live_run_never_writes(case):
    """Merges write their server buffer and the optimizer's moments in
    place, EF encodes replace residuals: the run continued after a
    capture and a run restored from that capture end equal, and the
    capture's tensors hold the values of the capture's moment."""
    kw = CONTINUE_CASES[case]
    loop, server = _build(**kw)
    server.start()
    _run_to(loop, lambda: server.version >= 1)
    live = _storages((server.weights, server._flat._rows, server._cache,
                      server._latest, server.server_opt and
                      (server.server_opt._m, server.server_opt._v),
                      [(ln.tx_base, ln.residual, ln._ack.acked_base)
                       for ln in server.transport._links.values()]))
    snap = FederationSnapshot.capture_run(loop, server)
    assert not live & _storages((snap.state, snap.events))
    img = snap.state["server"]
    before = {k: v.clone() for k, v in img["weights"].items()}
    opt = img["server_opt"]
    m0 = None if opt is None or opt["m"] is None else opt["m"].clone()
    loop.run()                                  # the live run goes on
    assert all(torch.equal(img["weights"][k], v) for k, v in before.items())
    if m0 is not None:
        assert torch.equal(opt["m"], m0)
        assert not torch.equal(server.server_opt._m, m0)
    loop2, server2 = _build(**kw)
    snap.restore_run(loop2, server2)
    loop2.run()
    assert _rec(server2.history) == _rec(server.history)
    # restoring the same snapshot twice gives two independent runs
    loop3, server3 = _build(**kw)
    snap.restore_run(loop3, server3)
    loop3.run()
    assert _rec(server3.history) == _rec(server.history)


def test_snapshot_pickle_roundtrip_counters_exact(tmp_path):
    """capture -> pickle -> restore into a fresh build -> capture again:
    byte counters, link bases and EF-residual norms survive exactly."""
    kw = dict(**MODE_KW["async_delta"], **TOPK)
    d = str(tmp_path / "ckpt")
    run_fl(_fresh(), epochs_per_round=EP, max_rounds=ROUNDS, **kw,
           checkpoint_every=1, checkpoint_dir=d, stop_after_checkpoints=1)
    _, snap, _ = CheckpointManager(d).restore_latest()
    loop, server = _build(**kw)
    pickle.loads(pickle.dumps(snap)).restore_run(loop, server)
    snap3 = FederationSnapshot.capture_run(loop, server)
    s_img, s3_img = snap.state["server"], snap3.state["server"]
    for k in ("total_up", "total_down", "version", "round_id"):
        assert s3_img[k] == s_img[k], k

    def norms(tr_img):
        return sorted((li["tok"], float(li["residual"].norm()))
                      for li in tr_img["links"].values()
                      if li["residual"] is not None)
    t_img, t3_img = s_img["transport"], s3_img["transport"]
    assert norms(t3_img) == norms(t_img) and norms(t_img)
    assert sorted((w, li["tx_base"] is not None)
                  for w, li in t3_img["links"].items()) == \
        sorted((w, li["tx_base"] is not None)
               for w, li in t_img["links"].items())
    # pending events survive as the same (kind, t) multiset (seq numbers
    # are loop-local and renumbered by the replay)
    assert sorted((r["kind"], r["t"]) for r in snap3.events) == \
        sorted((r["kind"], r["t"]) for r in snap.events)
    assert snap3.clock == snap.clock


def test_snapshot_refuses_failed_over_root():
    cfg = parse_topology("1x2", push="sync", root_failover=True)
    loop, topo = build_topology(_fresh(), topology=cfg, mode="sync",
                                epochs_per_round=EP, max_rounds=ROUNDS)
    topo.failovers = 1    # a promoted root
    with pytest.raises(NotImplementedError, match="failed-over root"):
        FederationSnapshot.capture_topology(loop, topo)


def test_a_snapshot_restores_only_as_its_kind(tmp_path):
    loop, server = _build(**MODE_KW["sync"])
    snap = FederationSnapshot.capture_run(loop, server)
    loop2, topo = build_topology(_fresh(), topology="1x2", mode="sync",
                                 epochs_per_round=EP, max_rounds=ROUNDS)
    with pytest.raises(ValueError, match="restored as a topology"):
        snap.restore_topology(loop2, topo)


# ---------------- chaos: kill, resume, audit ----------------

_CHAOS_KW = dict(seed=11, drop_p=0.2, dup_p=0.1, horizon=1.0,
                 recover_after=0.3, n_worker_kills=1)
_CHAOS_RUN_KW = dict(mode="sync", selector="all", epochs_per_round=2,
                     max_rounds=4, transport="topk_ef+int8",
                     transport_frac=0.1)

_CHILD_SRC = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import TABLE_4_1, make_setup
    from repro_torch.core.topology import parse_topology, run_fl_topology
    from repro_torch.runtime.faults import ChaosSchedule
    save = CheckpointManager.save

    def held(self, *a, **kw):
        save(self, *a, **kw)
        time.sleep(600)      # the kill lands here, mid-run
    CheckpointManager.save = held
    setup = make_setup(TABLE_4_1["mnist_even"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device="cpu")
    sched = ChaosSchedule(**{chaos_kw!r})
    run_fl_topology(setup, topology=parse_topology("1x2", push="sync"),
                    on_build=sched.apply, checkpoint_every=1,
                    checkpoint_dir={ckpt_dir!r}, **{run_kw!r})
    print("CHILD_FINISHED", flush=True)
""")


def _reinject_chaos(loop, topo, cfg):
    """Recompute the deterministic chaos schedule on a throwaway build and
    re-schedule ONLY the events still in the restored run's future (the
    snapshot carries the lossy channels and ledgers already)."""
    scratch = ChaosSchedule(**_CHAOS_KW)
    _, throwaway = build_topology(_fresh(), topology=cfg, **_CHAOS_RUN_KW)
    for kind, t, arg in scratch.apply(throwaway):
        if t <= loop.now:
            continue
        if kind in ("kill_worker", "recover_worker"):
            srv = next(lf.server for lf in topo.leaves.values()
                       if arg in lf.server.workers)
            inj = FaultInjector(loop, srv)
            (inj.kill_at if kind == "kill_worker"
             else inj.recover_at)(t, arg)
        elif kind == "kill_leaf":
            topo.kill_leaf_at(t, arg)
        else:
            raise AssertionError(f"unexpected chaos event {kind!r}")


def test_chaos_process_kill_then_resume_books_close(tmp_path):
    """A lossy chaos run SIGKILLed as a PROCESS after its first snapshot is
    durably published; a fresh build resumes from the newest readable
    snapshot, replays the rest of the chaos schedule, and
    ``audit_chaos_run`` closes the books of the stitched run."""
    d = tmp_path / "ckpt"
    child_py = tmp_path / "child.py"
    child_py.write_text(_CHILD_SRC.format(
        src=str(ROOT / "src"), chaos_kw=_CHAOS_KW, ckpt_dir=str(d),
        run_kw=_CHAOS_RUN_KW))
    proc = subprocess.Popen([sys.executable, str(child_py)],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if d.exists() and list(d.glob("ckpt_*.pkl")):
                break
            if proc.poll() is not None:
                raise AssertionError("child exited before its first "
                                     "checkpoint:\n"
                                     + proc.stdout.read().decode())
            time.sleep(0.02)
        else:
            raise AssertionError("child never published a checkpoint")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL

    cfg = parse_topology("1x2", push="sync")
    loop, topo = build_topology(_fresh(), topology=cfg, **_CHAOS_RUN_KW)
    got = CheckpointManager(str(d)).restore_latest()
    assert got is not None, "no readable checkpoint survived the SIGKILL"
    _, snap, _ = got
    snap.restore_topology(loop, topo)
    _reinject_chaos(loop, topo, cfg)
    loop.run(max_events=200_000)
    topo.finalize()
    stats = audit_chaos_run(topo)          # must not raise: books closed
    assert stats["retransmits"] >= 0
    for lid, lf in topo.leaves.items():
        assert len(lf.server.history) >= 1
        assert lf.server.version >= snap.state["servers"][lid]["version"]


def test_chaos_in_process_kill_resume_with_cancelled_legs(tmp_path):
    """A seed whose snapshot catches lossy legs mid-flight (cancelled with
    credit and re-kicked), stopped after TWO snapshots so the resume
    starts from the later one."""
    d = str(tmp_path / "ckpt")
    cfg = parse_topology("1x2", push="sync")
    sched = ChaosSchedule(**_CHAOS_KW)
    run_fl_topology(_fresh(), topology=cfg, on_build=sched.apply,
                    checkpoint_every=1, checkpoint_dir=d,
                    stop_after_checkpoints=2, **_CHAOS_RUN_KW)
    loop, topo = build_topology(_fresh(), topology=cfg, **_CHAOS_RUN_KW)
    _, snap, _ = CheckpointManager(d).restore_latest()
    assert snap.rekicks, "no lossy leg was in flight at the snapshot"
    snap.restore_topology(loop, topo)
    _reinject_chaos(loop, topo, cfg)
    loop.run(max_events=200_000)
    topo.finalize()
    audit_chaos_run(topo)
    for lf in topo.leaves.values():
        assert lf.server.history[-1].version >= _CHAOS_RUN_KW["max_rounds"]


# ---------------- chip_smoke's resume phase, rehearsed ----------------

def test_chip_smoke_resume_phase_rehearsed_on_cpu():
    report = {}
    rec = chip_smoke.run_resume("cpu", report, {}, rounds=4, epochs=1)
    assert report["resume"] is rec
    assert sorted(rec) == sorted(list(chip_smoke.RESUME)
                                 + [chip_smoke.RESUME_CHAOS])
    for key, r in rec.items():
        assert r["snapshot_step"] in (2,) and r["snapshot_bytes"] > 0
        if key == chip_smoke.RESUME_CHAOS:
            assert r["audit"]["failovers"] == 0
            assert r["audit"]["root_versions"] == 4
        else:
            assert r["equal"] is True
            assert len(r["history"]["root"]) >= 5
    assert sorted(rec["topology/1x2"]["history"]) == ["leaf0", "leaf1",
                                                      "root"]
