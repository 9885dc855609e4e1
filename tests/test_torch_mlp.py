"""The port's MLP (repro_torch.models.mlp) against the JAX package's, from
the JAX package's initial weights exported as numpy: gradients within
1e-6, parameters after three epochs of local SGD within 1e-5 (f32 matmul
and reduction order differ between the frameworks), accuracy equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as jmlp
from repro_torch.core import TABLE_4_1, make_setup
from repro_torch.models import mlp

SETUP_KW = dict(seed=0, noise=0.25, batch_size=32, het="strong")


@pytest.fixture(scope="module")
def setup():
    return make_setup(TABLE_4_1["mnist_uneven"], **SETUP_KW, device="cpu")


@pytest.fixture(scope="module")
def w0():
    return {k: np.asarray(v) for k, v in
            jmlp.init_mlp(jax.random.PRNGKey(0), in_dim=256).items()}


def _to_torch(d):
    return mlp.params_from_numpy(d, "cpu")


def _err(jparams, tparams):
    return max(float(np.max(np.abs(np.asarray(jparams[k])
                                   - tparams[k].numpy())))
               for k in jparams)


def test_one_step_gradients_match_jax_grad(setup, w0):
    x, y = setup.shards[3]["x"][:32], setup.shards[3]["y"][:32]
    jg = jax.grad(jmlp.mlp_loss)({k: jnp.asarray(v) for k, v in w0.items()},
                                 jnp.asarray(x), jnp.asarray(y))
    params = {k: v.requires_grad_(True) for k, v in _to_torch(w0).items()}
    loss = mlp.mlp_loss(params, torch.from_numpy(x),
                        torch.from_numpy(y).long())
    tg = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert _err(jg, tg) < 1e-6


def test_three_epochs_of_sgd_match_jax(setup, w0):
    shard = setup.shards[3]                      # 3 batches of 32
    assert len(shard["x"]) == 96
    jp = jmlp.mlp_sgd_train({k: jnp.asarray(v) for k, v in w0.items()},
                            jnp.asarray(shard["x"]), jnp.asarray(shard["y"]),
                            lr=0.1, epochs=3)
    tp = mlp.mlp_sgd_train(_to_torch(w0), torch.from_numpy(shard["x"]),
                           torch.from_numpy(shard["y"]).long(), lr=0.1,
                           epochs=3)
    assert _err(jp, tp) < 1e-5
    tx, ty = setup.test_x, setup.test_y
    acc_j = float(jmlp.mlp_accuracy(jp, jnp.asarray(tx), jnp.asarray(ty)))
    acc_t = float(mlp.mlp_accuracy(_to_torch({k: np.asarray(v) for k, v in
                                              jp.items()}),
                                   torch.from_numpy(tx),
                                   torch.from_numpy(ty).long()))
    assert acc_j == acc_t


def test_partial_batch_is_truncated_like_jax(w0):
    """n // mb whole batches: the ragged tail is dropped."""
    rng = np.random.RandomState(1)
    x = rng.rand(80, 16, 16, 1).astype(np.float32)
    y = rng.randint(0, 10, 80).astype(np.int32)
    for n in (45, 80):
        jp = jmlp.mlp_sgd_train({k: jnp.asarray(v) for k, v in w0.items()},
                                jnp.asarray(x[:n]), jnp.asarray(y[:n]),
                                epochs=2)
        tp = mlp.mlp_sgd_train(_to_torch(w0), torch.from_numpy(x[:n]),
                               torch.from_numpy(y[:n]).long(), epochs=2)
        assert _err(jp, tp) < 1e-5


def test_prox_train_matches_jax_and_mu0_is_sgd(setup, w0):
    shard = setup.shards[3]
    x, y = torch.from_numpy(shard["x"]), torch.from_numpy(shard["y"]).long()
    jp = jmlp.mlp_prox_train({k: jnp.asarray(v) for k, v in w0.items()},
                             jnp.asarray(shard["x"]), jnp.asarray(shard["y"]),
                             epochs=2, mu=0.5)
    tp = mlp.mlp_prox_train(_to_torch(w0), x, y, epochs=2, mu=0.5)
    assert _err(jp, tp) < 1e-5
    a = mlp.mlp_prox_train(_to_torch(w0), x, y, epochs=2, mu=0.0)
    b = mlp.mlp_sgd_train(_to_torch(w0), x, y, epochs=2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_training_leaves_its_input_untouched(w0):
    params = _to_torch(w0)
    snap = {k: v.clone() for k, v in params.items()}
    out = mlp.mlp_sgd_train(params, torch.rand(32, 256), torch.zeros(32),
                            epochs=1)
    assert all(torch.equal(params[k], snap[k]) for k in params)
    assert not any(v.requires_grad for v in out.values())


def test_init_mlp_is_seeded_he_normal():
    a = mlp.init_mlp(torch.Generator().manual_seed(3), in_dim=784)
    b = mlp.init_mlp(torch.Generator().manual_seed(3), in_dim=784)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["w1"].shape == (784, 128) and a["w2"].shape == (128, 10)
    assert abs(a["w1"].std().item() - (2.0 / 784) ** 0.5) < 2e-3
    assert not a["b1"].any() and not a["b2"].any()
