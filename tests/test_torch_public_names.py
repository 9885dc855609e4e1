"""Public names and fields of the port against the JAX package's:
``HistoryPoint``'s fields, the server's per-round ``note_round`` call,
``experiment.mlp_prox_train_wrapper``, ``cnn.model_nbytes``,
``layers.rmsnorm_init`` / ``glu_mlp_init`` / ``embed_init``, the MLP
entry points' default device (the card, as every entry point's), the
public names of the auto tuner, lossy links, topology and fault tools,
and each raise that remains naming its current ROADMAP step
(checkpoints A4, the sharded substrate A7).

Tolerances: the FedProx wrapper's parameters within 1e-5 of JAX's after
three epochs (tests/test_torch_mlp.py's bound); byte counts and shapes
exact; the random inits' spread within 5% of the scale they are drawn at
(the generators differ, so only the distribution can match).
"""
import dataclasses

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
from repro_torch.core import server, transport
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


def _raises_of_unported():
    """Each raise that remains in the port, with the ROADMAP step it names:
    checkpoints and their resume seams (A4), the sharded substrate (A7)."""
    from repro_torch.core import flatbuf, topology
    from repro_torch.core.warehouse import Pointer
    from repro_torch.core.worker import FLWorker
    setup = make_setup(TABLE_4_1["mnist_even"], device="cpu")
    _, topo = topology.build_topology(setup, topology="1x2")
    lf = topo.leaves["leaf0"]
    w = FLWorker("w0", profile=setup.profiles[0], data={}, train_fn=None,
                 loop=topo.loop)
    return {
        "run_fl checkpoint_every": ("A4", lambda: run_fl(
            setup, max_rounds=1, checkpoint_every=1, checkpoint_dir="c")),
        "run_fl resume": ("A4", lambda: run_fl(setup, max_rounds=1,
                                               resume=True)),
        "run_fl topology checkpoint": ("A4", lambda: run_fl(
            setup, max_rounds=1, topology="1x2", checkpoint_every=1,
            checkpoint_dir="c")),
        "run_fl_topology resume": ("A4", lambda: topology.run_fl_topology(
            setup, topology="1x2", resume=True)),
        "Topology.resume_push": ("A4", lambda: topo.resume_push(lf, {}, 0.0)),
        "Topology.resume_fan": ("A4", lambda: topo.resume_fan(lf, {}, 0.0)),
        "Topology.resume_done_settled": (
            "A4", lambda: topo.resume_done_settled(lf, 0.0)),
        "FLWorker.resume_conversation": (
            "A4", lambda: w.resume_conversation(Pointer("s", "u"), None,
                                                None, {}, 0.0)),
        "run_fl server_mesh": ("A7", lambda: run_fl(setup, max_rounds=1,
                                                    server_mesh=1)),
        "run_fl_topology server_mesh": (
            "A7", lambda: topology.run_fl_topology(setup, topology="1x2",
                                                   server_mesh=2)),
        "ParamBundle mesh": ("A7", lambda: flatbuf.ParamBundle(
            setup.weights0, mesh=object())),
        "Transport mesh": ("A7", lambda: transport.Transport(
            setup.weights0, mesh=object())),
    }


UNPORTED_RAISES = sorted((
    "run_fl checkpoint_every", "run_fl resume", "run_fl topology checkpoint",
    "run_fl_topology resume", "Topology.resume_push", "Topology.resume_fan",
    "Topology.resume_done_settled", "FLWorker.resume_conversation",
    "run_fl server_mesh", "run_fl_topology server_mesh", "ParamBundle mesh",
    "Transport mesh"))


@pytest.mark.parametrize("name", UNPORTED_RAISES)
def test_unported_raises_name_the_current_roadmap_step(name):
    step, call = _raises_of_unported()[name]
    with pytest.raises(NotImplementedError, match=rf"\(ROADMAP {step}\)"):
        call()


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
