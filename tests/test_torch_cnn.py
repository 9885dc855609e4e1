"""The port's CNN (repro_torch.models.cnn, the thesis' Listing 4.1) against
the JAX package's, from the JAX package's initial weights exported as
numpy, at the FAST_MNIST_CNN and MNIST_CNN shapes:

* logits and loss gradients within 1e-5 (the two frameworks' CPU
  convolutions sum in different orders);
* parameters after three full-batch SGD steps within 1e-5; accuracy equal;
* the packed parameter vector equal to JAX's (HWIO layout kept);
* a short ``run_fl(model="cnn")`` against JAX's at the golden setup: every
  non-accuracy history field equal, accuracy within 4 of the 512 test
  samples.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import FAST_MNIST_CNN, MNIST_CNN
from repro.core import flatbuf as jflat
from repro.core import make_setup as jmake_setup
from repro.core import run_fl as jrun_fl
from repro.models import cnn as jcnn
from repro_torch.configs import paper_cnn
from repro_torch.core import TABLE_4_1, flatbuf, make_setup, run_fl
from repro_torch.models import cnn

_GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
_spec = importlib.util.spec_from_file_location("golden_generate",
                                               _GOLDEN_DIR / "generate.py")
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

CFGS = {"fast": FAST_MNIST_CNN, "mnist": MNIST_CNN}
PORT_CFGS = {"fast": paper_cnn.FAST_MNIST_CNN, "mnist": paper_cnn.MNIST_CNN}
TOL = 1e-5
ACC_TOL = 4 / 512
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes")


def _case(cfg, n=64, seed=0):
    """He-normal weights (zero biases) in the JAX package's layout, and a
    batch, all drawn with numpy: independent of ``jax.random``'s mode."""
    rng = np.random.RandomState(seed)
    c, hw = cfg.channels, cfg.image_hw
    flat = (hw // 4) * (hw // 4) * cfg.conv2

    def he(shape, fan):
        return (rng.randn(*shape) * np.sqrt(2.0 / fan)).astype(np.float32)
    w0 = {"c1w": he((5, 5, c, cfg.conv1), 25 * c),
          "c1b": np.zeros(cfg.conv1, np.float32),
          "c2w": he((5, 5, cfg.conv1, cfg.conv2), 25 * cfg.conv1),
          "c2b": np.zeros(cfg.conv2, np.float32),
          "fw": he((flat, cfg.n_classes), flat),
          "fb": np.zeros(cfg.n_classes, np.float32)}
    x = rng.rand(n, cfg.image_hw, cfg.image_hw, cfg.channels)
    y = rng.randint(0, cfg.n_classes, n)
    return w0, x.astype(np.float32), y.astype(np.int32)


def _port(w0):
    return cnn.params_from_numpy(w0, "cpu")


def _max_err(jt, tt):
    assert sorted(jt) == sorted(tt)
    return max(float(np.max(np.abs(np.asarray(jt[k]) - tt[k].detach()
                                   .numpy()))) for k in jt)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cnn_logits_match_jax(name):
    w0, x, _ = _case(CFGS[name])
    want = np.asarray(jcnn.cnn_logits(w0, jnp.asarray(x)))
    got = cnn.cnn_logits(_port(w0), torch.from_numpy(x)).numpy()
    assert got.shape == (len(x), CFGS[name].n_classes)
    assert np.max(np.abs(got - want)) < TOL


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cnn_loss_gradients_match_jax(name):
    w0, x, y = _case(CFGS[name])
    jl, jg = jax.value_and_grad(jcnn.cnn_loss)(
        w0, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    params = {k: v.requires_grad_(True) for k, v in _port(w0).items()}
    loss = cnn.cnn_loss(params, {"x": torch.from_numpy(x),
                                 "y": torch.from_numpy(y).long()})
    tg = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(float(loss.detach()) - float(jl)) < TOL
    assert _max_err(jg, tg) < TOL


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cnn_sgd_train_three_steps_match_jax(name):
    cfg = CFGS[name]
    w0, x, y = _case(cfg)
    jp = jcnn.cnn_sgd_train(w0, jnp.asarray(x), jnp.asarray(y), lr=cfg.lr,
                            epochs=3)
    start = _port(w0)
    tp = cnn.cnn_sgd_train(start, torch.from_numpy(x),
                           torch.from_numpy(y).long(), lr=cfg.lr, epochs=3)
    assert _max_err(jp, tp) < TOL
    assert _max_err(w0, start) == 0.0           # the input is left as it was
    assert float(jcnn.cnn_accuracy(jp, jnp.asarray(x), jnp.asarray(y))) == \
        float(cnn.cnn_accuracy(cnn.params_from_numpy(
            {k: np.asarray(v) for k, v in jp.items()}, "cpu"),
            torch.from_numpy(x), torch.from_numpy(y).long()))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cnn_params_pack_like_jax(name):
    cfg = CFGS[name]
    w0, _, _ = _case(cfg)
    tp = _port(w0)
    jb, tb = jflat.ParamBundle(w0), flatbuf.ParamBundle(tp)
    assert (tb.n_params, tb.padded_size) == (jb.n_params, jb.padded_size)
    assert np.array_equal(tb.pack(tp).numpy(), np.asarray(jb.pack(w0)))
    shapes = {k: v.shape for k, v in
              jcnn.init_cnn(jax.random.PRNGKey(0), cfg).items()}
    assert {k: v.shape for k, v in w0.items()} == shapes
    mine = cnn.init_cnn(torch.Generator().manual_seed(0), PORT_CFGS[name],
                        device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == shapes


def test_mnist_cnn_width():
    p = cnn.init_cnn(torch.Generator().manual_seed(0), paper_cnn.MNIST_CNN,
                     device="cpu")
    assert sum(v.numel() for v in p.values()) == 28_938
    assert flatbuf.padded_size_for(28_938) == 29_184


def test_setup_rejects_an_unknown_model():
    with pytest.raises(ValueError, match="unknown model"):
        make_setup([1, 1], model="resnet", device="cpu")


RUN_CASES = [("sync", None), ("sync", "fedadam"), ("async", None),
             ("async", "fedadam")]


@pytest.mark.parametrize("mname,opt", RUN_CASES,
                         ids=[f"{m}-{o}" for m, o in RUN_CASES])
def test_cnn_run_fl_matches_jax(mname, opt):
    kw = dict(_gen.SETUP_KW, model="cnn")
    js = jmake_setup(TABLE_4_1["mnist_even"], **kw)
    ts = make_setup(TABLE_4_1["mnist_even"], **kw, device="cpu",
                    weights0={k: np.asarray(v)
                              for k, v in js.weights0.items()})
    assert ts.model_bytes == js.model_bytes
    rkw = dict(epochs_per_round=_gen.EP, max_rounds=_gen.ROUNDS,
               **_gen.MODES[mname])
    if opt is not None:
        rkw.update(server_opt=opt, server_opt_kw={"lr": 0.05})
    hj, ht = jrun_fl(js, **rkw), run_fl(ts, **rkw)
    assert len(hj) == len(ht) == _gen.ROUNDS + 1
    for a, b in zip(hj, ht):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.accuracy - b.accuracy) <= ACC_TOL
