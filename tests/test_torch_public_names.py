"""Public names and fields of the port against the JAX package's:
``HistoryPoint``'s fields, the server's per-round ``note_round`` call,
``experiment.mlp_prox_train_wrapper``, ``cnn.model_nbytes``,
``layers.rmsnorm_init`` / ``glu_mlp_init`` / ``embed_init``, and the MLP
entry points' default device (the card, as every entry point's).

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
