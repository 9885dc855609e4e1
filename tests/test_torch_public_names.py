"""Public names and fields of the port against the JAX package's:
``HistoryPoint``'s fields, the server's per-round ``note_round`` call,
``experiment.mlp_prox_train_wrapper``, ``cnn.model_nbytes``,
``layers.rmsnorm_init`` / ``glu_mlp_init`` / ``embed_init``, the MLP
entry points' default device (the card, as every entry point's), the
public names of the auto tuner, lossy links, topology and fault tools,
and of the checkpoint slice (A4) and the sharded substrate (A7), whose
entry points now run under the JAX package's signatures, and each raise
that remains naming its current ROADMAP step.  The kernels' reference
forms (ROADMAP C3): ``fedavg_agg.fedavg_mix_flat(stacked, weights,
server, server_scale)``, ``fedavg_agg.server_opt_step_flat``,
``rwkv6_kernel.wkv_pallas`` and ``layers.PARAM_DTYPE``, each against
JAX's signature (the Pallas knobs ``block_n``/``interpret`` have no twin)
and result.

Tolerances: the FedProx wrapper's parameters within 1e-5 of JAX's after
three epochs (tests/test_torch_mlp.py's bound); byte counts and shapes
exact; the random inits' spread within 5% of the scale they are drawn at
(the generators differ, so only the distribution can match).
"""
import dataclasses
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import MNIST_CNN as JMNIST_CNN
from repro.core import experiment as jexp
from repro.core import server as jserver
from repro.models import cnn as jcnn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro_torch.core import TABLE_4_1, experiment, make_setup, run_fl
from repro_torch.core import build_experiment, server, transport
from repro_torch.models import cnn, layers, mlp


def test_history_point_has_the_references_fields_in_order():
    names = [f.name for f in dataclasses.fields(server.HistoryPoint)]
    assert names == [f.name for f in dataclasses.fields(jserver.HistoryPoint)]
    assert server.HistoryPoint(0.0, 0, 0.5, 0, 0).retransmits == 0


def test_server_reports_every_round_to_its_transport(monkeypatch):
    """After each history point past the first, the server hands it to
    ``Transport.note_round``, as the reference's does; without lossy links
    ``retransmits`` stays 0."""
    seen = []
    monkeypatch.setattr(transport.Transport, "note_round",
                        lambda self, point: seen.append(point))
    setup = make_setup(TABLE_4_1["mnist_uneven"], seed=0, noise=0.25,
                       batch_size=32, het="strong", device="cpu")
    hist = run_fl(setup, mode="sync", max_rounds=3, epochs_per_round=1)
    assert len(hist) == 4 and seen == hist[1:]
    assert all(p.retransmits == 0 for p in hist)


def test_mlp_prox_train_wrapper_matches_jax():
    rng = np.random.RandomState(0)
    w0 = {k: np.asarray(v) for k, v in
          jmlp.init_mlp(jax.random.PRNGKey(0), in_dim=64).items()}
    x = rng.rand(96, 64).astype(np.float32)
    y = rng.randint(0, 10, 96).astype(np.int32)
    want = jexp.mlp_prox_train_wrapper(
        {k: jnp.asarray(v) for k, v in w0.items()}, x, y, 3, lr=0.1, mu=0.01)
    got = experiment.mlp_prox_train_wrapper(
        mlp.params_from_numpy(w0, "cpu"), x, y, 3, lr=0.1, mu=0.01,
        device="cpu")
    assert max(float(np.abs(np.asarray(want[k]) - got[k].numpy()).max())
               for k in want) < 1e-5


def test_cnn_model_nbytes_matches_jax():
    params = jcnn.init_cnn(jax.random.PRNGKey(0), JMNIST_CNN)
    ported = cnn.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu")
    assert cnn.model_nbytes(ported) == jcnn.model_nbytes(params) == 4 * sum(
        int(np.prod(v.shape)) for v in params.values())


def test_layer_inits_match_jax():
    """Same keys and shapes as JAX's inits; rmsnorm's zeros equal; the
    draws at JAX's scales (1/sqrt(fan_in), 0.02), in bf16 as the port's
    parameters are."""
    d, f, vocab = 256, 512, 1000
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    norm = layers.rmsnorm_init(d, device="cpu")
    np.testing.assert_array_equal(norm["scale"].float().numpy(),
                                  np.asarray(jlayers.rmsnorm_init(d)["scale"]))
    for got, want, scale in (
            (layers.glu_mlp_init(g, d, f, device="cpu"),
             jlayers.glu_mlp_init(key, d, f), None),
            (layers.embed_init(g, vocab, d, device="cpu"),
             jlayers.embed_init(key, vocab, d), 0.02)):
        assert set(got) == set(want)
        for name, t in got.items():
            assert t.shape == want[name].shape
            assert t.dtype == layers.COMPUTE_DTYPE
            s = scale or 1 / np.sqrt(want[name].shape[0])
            assert abs(float(t.float().std()) / s - 1) < 0.05


def test_mlp_entry_points_default_to_the_card(monkeypatch):
    """With no device, ``init_mlp`` and ``params_from_numpy`` take the
    CUDA card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp.init_mlp(g, in_dim=8)
    w = mlp.init_mlp(g, in_dim=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp.params_from_numpy({k: v.numpy() for k, v in w.items()})
    for fn in (lambda: layers.rmsnorm_init(4),
               lambda: layers.embed_init(g, 10, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def _same_signature(fn, jfn) -> bool:
    """Parameter names, kinds and defaults equal to the JAX package's."""
    def params(f):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(f).parameters.values()]
    return params(fn) == params(jfn)


def _entry_points(tmp_path):
    """Each entry point that raised until its ROADMAP step was ported, with
    the step: the checkpoints and their resume seams (A4), the LM zoo's
    MoE and mamba2 families (A5), pod-level FL (A6) and the sharded
    substrate (A7) and ``train_step(grad_specs=...)`` (A8's launch path)
    now run, each under the JAX package's signature."""
    from repro.core import experiment as jexperiment
    from repro.core import topology as jtopology
    from repro.core import worker as jworker
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import flatbuf, topology
    from repro_torch.core.worker import FLWorker
    from repro_torch.parallel import sharding as psh
    setup = make_setup(TABLE_4_1["mnist_even"], device="cpu")
    kw = dict(max_rounds=2, epochs_per_round=1)

    def records(h):
        return [vars(p) for p in h]

    def checkpointed(topo=None):
        d = str(tmp_path / "c")
        extra = {} if topo is None else {"topology": topo}
        h = run_fl(setup, **kw, **extra, checkpoint_every=1,
                   checkpoint_dir=d)
        assert records(h) == records(run_fl(setup, **kw, **extra))
        assert CheckpointManager(d).steps() == [1]
        assert _same_signature(run_fl, jexperiment.run_fl)

    def resumed():
        d = str(tmp_path / "r")
        run_fl(setup, **kw, checkpoint_every=1, checkpoint_dir=d,
               stop_after_checkpoints=1)
        h = run_fl(setup, **kw, checkpoint_dir=d, resume=True)
        assert records(h) == records(run_fl(setup, **kw))

    def topology_resumed():
        d = str(tmp_path / "t")
        run = topology.run_fl_topology
        run(setup, topology="1x2", **kw, checkpoint_every=1,
            checkpoint_dir=d, stop_after_checkpoints=1)
        res = run(setup, topology="1x2", **kw, checkpoint_dir=d,
                  resume=True)
        full = run(setup, topology="1x2", **kw)
        assert records(res.root_history) == records(full.root_history)
        assert _same_signature(run, jtopology.run_fl_topology)

    def seam(name):
        """A resume seam re-creates its leg at the exact deadline with one
        event, and keeps the record it was given."""
        loop, topo = topology.build_topology(setup, topology="1x2")
        lf = topo.leaves["leaf0"]
        payload = transport.Payload("raw", 1, setup.weights0)
        rec = {"payload": payload, "base_rv": 0, "n_data": 1,
               "snap": setup.weights0, "v_enc": 0, "base": None}
        t = 0.1 + 2 ** -30
        if name == "resume_done_settled":
            topo.resume_done_settled(lf, t)
            ev = lf.done_settling
        else:
            getattr(topo, name)(lf, rec, t)
            ev = rec["ev"]
            if name == "resume_push":
                assert lf.push_inflight is payload and lf.push_rec is rec
            else:
                assert lf.fan_inflight is payload and lf.fan_rec is rec
        assert ev.time == t and len(loop._q) == 1
        assert _same_signature(getattr(topology.Topology, name),
                               getattr(jtopology.Topology, name))

    def conversation():
        loop, server = build_experiment(setup, **kw)
        w = server.workers["w0"]
        link = server.transport.link("w0")
        rec = {"phase": "train_fast", "weights": setup.weights0,
               "base_version": 0, "epochs": 1, "up_bytes": 1,
               "t_train": 0.0}
        w.resume_conversation(server.pointer, link, server._on_response,
                              rec, 0.25)
        assert w.busy and w._conv[server.pointer] is rec
        assert rec["ev"].time == 0.25 and len(loop._q) == 1
        with pytest.raises(ValueError, match="unknown conversation phase"):
            w.resume_conversation(server.pointer, link, None,
                                  {"phase": "nap"}, 0.3)
        assert _same_signature(FLWorker.resume_conversation,
                               jworker.FLWorker.resume_conversation)

    # two shards on the one CPU device: agg_mesh's repeated-device form
    mesh2 = psh.agg_mesh(devices=["cpu"] * 2)

    def sharded_run():
        h = run_fl(setup, **kw, server_mesh=1)
        assert records(h) == records(run_fl(setup, **kw))
        assert records(run_fl(setup, **kw, server_mesh=mesh2)) == records(h)
        assert _same_signature(run_fl, jexperiment.run_fl)

    def sharded_topology():
        run = topology.run_fl_topology
        res = run(setup, topology="1x2", **kw, server_mesh=mesh2)
        full = run(setup, topology="1x2", **kw)
        assert records(res.root_history) == records(full.root_history)
        assert res.topology._flat.mesh is mesh2
        assert _same_signature(topology.build_topology,
                               jtopology.build_topology)

    def sharded_bundle():
        b = flatbuf.ParamBundle(setup.weights0, mesh=mesh2)
        assert b.padded_size % (2 * flatbuf.BLOCK) == 0
        assert b.shard_size * 2 == b.padded_size
        assert flatbuf.bundle_for(setup.weights0, mesh2) is \
            flatbuf.bundle_for(setup.weights0, mesh2)

    def lm_zoo(arch):
        from repro_torch import configs, models
        cfg = configs.get_config(arch, reduced=True)
        params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        models.init_decode_state(cfg, 1, 8, device="cpu")
        models.forward(params, cfg, tokens=torch.zeros((1, 8),
                                                       dtype=torch.int32))

    def pod_round():
        from repro_torch.core import federated
        st = federated.stack_for_pods({"w": torch.ones(4)}, 2)
        federated.fl_round(st, torch.ones(2))

    def grad_specs():
        from repro_torch import configs, models, optim
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.parallel import param_specs
        cfg = configs.get_config("yi-9b", reduced=True)
        params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        opt = optim.adamw()
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
                 "labels": torch.zeros((2, 8), dtype=torch.int32)}
        models.train_step(params, opt.init(params), batch, cfg=cfg,
                          optimizer=opt, grad_specs=param_specs(
                              cfg, params, make_production_mesh()))

    def sharded_transport():
        tr = transport.Transport(setup.weights0, mesh=mesh2)
        assert tr.bundle is flatbuf.bundle_for(setup.weights0, mesh2)

    return {
        "run_fl checkpoint_every": ("A4", checkpointed),
        "run_fl resume": ("A4", resumed),
        "run_fl topology checkpoint": ("A4", lambda: checkpointed("1x2")),
        "run_fl_topology resume": ("A4", topology_resumed),
        "Topology.resume_push": ("A4", lambda: seam("resume_push")),
        "Topology.resume_fan": ("A4", lambda: seam("resume_fan")),
        "Topology.resume_done_settled": (
            "A4", lambda: seam("resume_done_settled")),
        "FLWorker.resume_conversation": ("A4", conversation),
        "run_fl server_mesh": ("A7", sharded_run),
        "run_fl_topology server_mesh": ("A7", sharded_topology),
        "ParamBundle mesh": ("A7", sharded_bundle),
        "Transport mesh": ("A7", sharded_transport),
        "init_params moe": ("A5", lambda: lm_zoo("mixtral-8x22b")),
        "init_params mamba2": ("A5", lambda: lm_zoo("zamba2-7b")),
        "federated fl_round": ("A6", pod_round),
        "train_step grad_specs": ("A8", grad_specs),
    }


UNPORTED_RAISES = sorted((
    "run_fl checkpoint_every", "run_fl resume", "run_fl topology checkpoint",
    "run_fl_topology resume", "Topology.resume_push", "Topology.resume_fan",
    "Topology.resume_done_settled", "FLWorker.resume_conversation",
    "run_fl server_mesh", "run_fl_topology server_mesh", "ParamBundle mesh",
    "Transport mesh", "init_params moe", "init_params mamba2",
    "federated fl_round", "train_step grad_specs"))
# A8's first half (the launch path) raised only in train_step(grad_specs=);
# its second half (the dry run) has no stub to raise
PORTED_STEPS = ("A4", "A5", "A6", "A7", "A8")


@pytest.mark.parametrize("name", UNPORTED_RAISES)
def test_unported_raises_name_the_current_roadmap_step(name, tmp_path):
    """Each entry point that raised names its ROADMAP step while the step
    is open; once the step is ported (``PORTED_STEPS``) the entry point
    runs under the JAX package's signature."""
    step, call = _entry_points(tmp_path)[name]
    if step in PORTED_STEPS:
        call()
        return
    with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {step}\)"):
        call()


def test_no_raise_names_a_ported_step():
    """No ``NotImplementedError`` of the port names a ported step."""
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for path in root.rglob("*.py"):
        text = path.read_text()
        for step in PORTED_STEPS:
            assert f'"{step}")' not in text and \
                f"ROADMAP {step})" not in text, (path, step)


def test_checkpoint_slice_keeps_the_references_public_names():
    """ROADMAP A4: the checkpoint package, the manager's and the
    snapshot's methods, ``drive_checkpointed`` and the server's resume
    seams, each under the JAX package's name and signature."""
    import repro.checkpoint as jcheckpoint
    from repro.checkpoint import manager as jmanager
    from repro.checkpoint import snapshot as jsnapshot
    from repro.core import server as jserver_mod
    import repro_torch.checkpoint as checkpoint
    from repro_torch.checkpoint import manager, snapshot
    assert checkpoint.__all__ == jcheckpoint.__all__
    assert manager.FederationSnapshot is snapshot.FederationSnapshot
    for name in ("__init__", "save", "restore", "restore_latest", "steps",
                 "_gc", "_readable", "_sweep_tmp", "_path"):
        assert _same_signature(getattr(manager.CheckpointManager, name),
                               getattr(jmanager.CheckpointManager, name))
    snap, jsnap = snapshot.FederationSnapshot, jsnapshot.FederationSnapshot
    assert [f.name for f in dataclasses.fields(snap)] == \
        [f.name for f in dataclasses.fields(jsnap)]
    for name in ("capture_run", "capture_topology", "restore_run",
                 "restore_topology", "_replay", "_rekick"):
        assert _same_signature(getattr(snap, name), getattr(jsnap, name))
    assert _same_signature(snapshot.drive_checkpointed,
                           jsnapshot.drive_checkpointed)
    assert snapshot._LANES == jsnapshot._LANES
    for name in ("resume_noop_dispatch", "resume_round_timeout",
                 "_noop_dispatch"):
        assert _same_signature(getattr(server.AggregationServer, name),
                               getattr(jserver_mod.AggregationServer, name))


def test_ported_slice_keeps_the_references_public_names():
    """The modules of ROADMAP A1-A3 export what the JAX package's do."""
    from repro.core import autotune as jautotune
    from repro.core import topology as jtopology
    from repro.core import transport as jtransport
    from repro.runtime import faults as jfaults
    from repro_torch.core import autotune, topology
    from repro_torch.runtime import faults
    for mod, jmod, names in (
            (autotune, jautotune, ("AutoPolicy", "AutoTuner",
                                   "_CANDIDATES")),
            (transport, jtransport, ("LinkReliability", "TransportAudit",
                                     "_Channel", "transmit",
                                     "resume_transmit", "AUTO_SPEC")),
            (topology, jtopology, ("TopologyConfig", "parse_topology",
                                   "Topology", "TopologyResult",
                                   "build_topology", "run_fl_topology")),
            (faults, jfaults, ("FaultInjector", "ElasticPool",
                               "TopologyFaultInjector",
                               "inject_link_reliability", "ChaosSchedule",
                               "audit_chaos_run"))):
        for name in names:
            assert hasattr(mod, name) and hasattr(jmod, name), name
    for cls, jcls in ((topology.TopologyConfig, jtopology.TopologyConfig),
                      (transport.LinkReliability, jtransport.LinkReliability),
                      (transport.TransportAudit, jtransport.TransportAudit),
                      (faults.ChaosSchedule, jfaults.ChaosSchedule)):
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(jcls)]
    for meth in ("resolve_up", "resolve_down", "note_round", "lru_evict",
                 "_retx_factor", "expected_up_bytes", "expected_down_bytes"):
        assert hasattr(transport.Transport, meth)
    for meth in ("hold", "release", "install_global"):
        assert hasattr(server.AggregationServer, meth)


# Pallas-only knobs: the port dispatches by device, so they have no twin
PALLAS_KNOBS = ("block_n", "interpret")


def _params_but_knobs(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name not in PALLAS_KNOBS]


def test_fedavg_mix_flat_takes_the_references_form():
    """ROADMAP C3: ``fedavg_mix_flat(stacked, weights, server,
    server_scale)`` as in the JAX package, its result within 1e-6 of
    JAX's Pallas kernel (interpret) and equal bit for bit to the wvec
    form the merge paths launch (``fedavg_mix_wvec``)."""
    from repro.kernels import fedavg_agg as jfedavg
    from repro_torch.kernels import fedavg_agg
    assert _params_but_knobs(fedavg_agg.fedavg_mix_flat) == \
        _params_but_knobs(jfedavg.fedavg_mix_flat)
    rng = np.random.RandomState(0)
    rows = rng.randn(3, 1000).astype(np.float32)
    w = np.asarray([0.2, 0.3, 0.1], np.float32)
    server = rng.randn(1000).astype(np.float32)
    got = fedavg_agg.fedavg_mix_flat(torch.from_numpy(rows),
                                     torch.from_numpy(w),
                                     torch.from_numpy(server), 0.4)
    want = np.asarray(jfedavg.fedavg_mix_flat(
        jnp.asarray(rows), jnp.asarray(w), jnp.asarray(server), 0.4,
        interpret=True))
    assert float(np.abs(got.numpy() - want).max()) < 1e-6
    wvec = torch.from_numpy(np.concatenate([[0.4], w]).astype(np.float32))
    assert torch.equal(got, fedavg_agg.fedavg_mix_wvec(
        torch.from_numpy(rows), wvec, torch.from_numpy(server)))


@pytest.mark.parametrize("adam", [False, True])
def test_server_opt_step_flat_lives_in_fedavg_agg(adam):
    """ROADMAP C3: ``fedavg_agg.server_opt_step_flat`` is the step of
    ``kernels/server_opt.py`` under the JAX package's signature, within
    1e-6 of JAX's Pallas kernel (interpret)."""
    from repro.kernels import fedavg_agg as jfedavg
    from repro_torch.kernels import fedavg_agg
    from repro_torch.kernels import server_opt as opt_kernel
    assert fedavg_agg.server_opt_step_flat is opt_kernel.server_opt_step_flat
    theirs = _params_but_knobs(jfedavg.server_opt_step_flat)
    assert _params_but_knobs(fedavg_agg.server_opt_step_flat)[:len(theirs)] \
        == theirs
    rng = np.random.RandomState(1)
    prev, merged, m = (rng.randn(1000).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(1000)).astype(np.float32)
    sc = np.asarray([0.9, 0.99, 0.05, 1e-3, 0, 0] if adam
                    else [0.9, 1.0, 0.0, 1.0], np.float32)
    got = fedavg_agg.server_opt_step_flat(
        *(torch.from_numpy(a) for a in (prev, merged, m, v)), sc, adam=adam)
    want = jfedavg.server_opt_step_flat(
        *(jnp.asarray(a) for a in (prev, merged, m, v)), jnp.asarray(sc),
        adam=adam, interpret=True)
    for g, j in zip(got, want):
        assert (g is None) == (j is None)
        if g is not None:
            assert float(np.abs(g.numpy() - np.asarray(j)).max()) < 1e-6


def test_wkv_pallas_is_wkv():
    """ROADMAP C3: ``rwkv6_kernel.wkv_pallas`` is ``wkv`` (y from a zero
    state, chunk 16) under the JAX package's name and signature, within
    1e-4 of JAX's Pallas kernel (interpret; tests/test_kernels.py's wkv
    bound)."""
    from repro.kernels import rwkv6_kernel as jwkv
    from repro_torch.kernels import rwkv6_kernel
    assert _params_but_knobs(rwkv6_kernel.wkv_pallas) == \
        _params_but_knobs(jwkv.wkv_pallas)
    rng = np.random.RandomState(2)
    r, k, v = (rng.randn(1, 32, 2, 8).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.uniform(0.8, 0.99, (1, 32, 2, 8)).astype(np.float32)
    u = rng.randn(2, 8).astype(np.float32) * 0.5
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    got = rwkv6_kernel.wkv_pallas(*t)
    assert torch.equal(got, rwkv6_kernel.wkv(*t))
    want = np.asarray(jwkv.wkv_pallas(*(jnp.asarray(a)
                                        for a in (r, k, v, w, u)),
                                      interpret=True))
    assert float(np.abs(got.numpy() - want).max()) < 1e-4


def test_layers_param_dtype_matches_jax():
    """ROADMAP C3: the master parameters' dtype, f32 on both sides."""
    assert layers.PARAM_DTYPE == torch.float32
    assert np.dtype(jlayers.PARAM_DTYPE) == np.float32


def _public(module):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", None) == module.__name__)


def test_lm_zoo_and_pod_fl_keep_the_references_public_names():
    """ROADMAP A5 and A6: ``models.moe``, ``models.mamba2``, the training
    half of ``models.transformer`` and ``layers``, ``optim``,
    ``core.compression`` and ``core.federated`` export the JAX package's
    public functions and classes under its signatures (the port adds
    ``moe.route`` and ``moe.capacity``, the routing ``moe_apply`` runs,
    and ``optimizers`` has no ``Optimizer.global_norm`` of its own to
    differ); ``init`` functions take the port's generator, stacking
    ``lead`` and device."""
    import repro.optim as joptim
    from repro.core import compression as jcomp
    from repro.core import federated as jfed
    from repro.models import layers as jlayers
    from repro.models import mamba2 as jmamba
    from repro.models import moe as jmoe
    from repro.models import transformer as jtr
    from repro.optim import optimizers as jopt
    import repro_torch.optim as optim
    from repro_torch.core import compression, federated
    from repro_torch.models import layers, mamba2, moe
    from repro_torch.models import transformer as tr
    from repro_torch.optim import optimizers
    assert _public(moe) == sorted(_public(jmoe) + ["capacity", "route"])
    assert _public(mamba2) == _public(jmamba)
    assert _public(compression) == _public(jcomp)
    assert set(_public(jfed)) <= set(_public(federated))
    assert _public(optimizers) == _public(jopt)
    assert sorted(optim.__all__ if hasattr(optim, "__all__") else
                  [n for n in dir(optim) if not n.startswith("_")
                   and n != "optimizers"]) == sorted(
        [n for n in dir(joptim) if not n.startswith("_")
         and n != "optimizers"])
    for mod, jmod, names in (
            (moe, jmoe, ["moe_apply"]),
            (mamba2, jmamba, ["_causal_conv", "ssd_chunked", "ssd_step",
                              "mamba2_apply"]),
            (layers, jlayers, ["chunked_ce_loss"]),
            (tr, jtr, ["loss_fn", "train_step", "forward", "prefill_step",
                       "serve_step", "logits_from_hidden"]),
            (compression, jcomp, ["topk_compress", "int8_quantize",
                                  "int8_dequantize"]),
            (federated, jfed, ["stack_for_pods", "unstack_pod",
                               "fl_local_step", "fl_round",
                               "fl_round_delta_compressed"]),
            (optimizers, jopt, ["adamw", "sgd", "global_norm"])):
        for name in names:
            assert _same_signature(getattr(mod, name), getattr(jmod, name)), \
                (mod.__name__, name)
    for name in ("__init__", "compress", "_compress_tree",
                 "uncompressed_bytes"):
        assert _same_signature(
            getattr(compression.ErrorFeedbackCompressor, name),
            getattr(jcomp.ErrorFeedbackCompressor, name)), name
    assert [f for f in optimizers.Optimizer.__dataclass_fields__] == \
        [f for f in jopt.Optimizer.__dataclass_fields__]
    assert _same_signature(tr.init_decode_state, jtr.init_decode_state) \
        is False      # the port adds device=
    import repro_torch.models as models
    import repro.models as jmodels
    for name in ("loss_fn", "train_step"):
        assert getattr(models, name) is getattr(tr, name)
        assert hasattr(jmodels, name)


def test_launch_path_keeps_the_references_public_names():
    """ROADMAP A8's first half: ``repro_torch.parallel`` exports what
    ``repro.parallel`` does, and the LM half of ``parallel.sharding``,
    ``launch.mesh``, ``launch.specs`` and ``launch.train`` keep the JAX
    package's names and signatures (``make_host_mesh`` adds ``device=``,
    the trainer's ``main`` adds ``argv=``); ``train_step`` keeps its
    ``grad_specs`` and no longer raises."""
    import repro.parallel as jparallel
    from repro.launch import mesh as jmesh
    from repro.launch import specs as jspecs
    from repro.launch import train as jtrain
    from repro.models import transformer as jtr
    from repro.parallel import sharding as jsh
    import repro_torch.parallel as parallel
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import specs, train
    from repro_torch.models import transformer as tr
    from repro_torch.parallel import sharding as psh
    assert sorted(n for n in dir(parallel) if not n.startswith("_")
                  and n != "sharding") == sorted(
        n for n in dir(jparallel) if not n.startswith("_")
        and n != "sharding")
    for name in ("dp_axes", "_dp_total", "named", "to_named_tree",
                 "pod_axis_is_vmapped", "current_mesh_axes", "constrain_qkv",
                 "constrain_act", "_pspec", "param_specs", "batch_specs",
                 "state_specs", "_sizes"):
        assert _same_signature(getattr(psh, name), getattr(jsh, name)), name
        if hasattr(parallel, name):
            assert getattr(parallel, name) is getattr(psh, name)
    for name in ("abstract_params", "abstract_opt_state", "abstract_batch",
                 "abstract_decode_state", "input_specs", "_sds"):
        assert _same_signature(getattr(specs, name),
                               getattr(jspecs, name)), name
    assert _same_signature(tmesh.make_production_mesh,
                           jmesh.make_production_mesh)
    assert [p.name for p in inspect.signature(
        tmesh.make_host_mesh).parameters.values()] == ["device"]
    assert list(inspect.signature(jmesh.make_host_mesh).parameters) == []
    assert list(inspect.signature(train.main).parameters) == ["argv"]
    assert list(inspect.signature(jtrain.main).parameters) == []
    assert _same_signature(tr.train_step, jtr.train_step)
    assert "NotImplementedError" not in inspect.getsource(tr.train_step)
