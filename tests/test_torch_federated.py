"""The port's pod-level FL (repro_torch.core.federated) and update
compression (repro_torch.core.compression) against the JAX package on the
same numpy inputs.

Tolerances:
* ``topk_compress``, ``int8_quantize``/``int8_dequantize``: bit for bit
  (the same threshold and the scale spelt as XLA computes it).
* ``ErrorFeedbackCompressor``, flat path (``ef_encode``'s plain version)
  and per-leaf path (``REPRO_AGG_PATH=tree``): reconstruction and residual
  after round k within k f32 spacings of the largest reconstructed
  |value| of JAX's (XLA contracts the codec's products into FMAs on the
  CPU, ROADMAP C, and the residual carries each round's into the next),
  wire bytes exact, over four rounds of error feedback.
* ``fl_round`` / ``fl_round_delta_compressed``: the merged f32 buffer
  within 1e-6 of JAX's (B2's and B6's plain versions sum the pods in row
  order), so the bf16 parameters equal JAX's bit for bit but where the
  f32 merge rounds to the other bf16 neighbour.
* ``fl_local_step``: each pod equal to ``train_step`` on its slice of the
  batch, bit for bit (the same calls on the same tensors); against JAX's
  vmapped step within 2e-2 (tests/test_substrate.py's bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import compression as jcomp
from repro.core import federated as jfed
from repro_torch import configs, models, optim
from repro_torch.core import compression, federated
from repro_torch.kernels import fedavg_agg
from torch_lm_common import both


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def test_topk_and_int8_match_jax_bit_for_bit():
    x = np.random.RandomState(0).randn(37, 11).astype(np.float32)
    jv, jm = jcomp.topk_compress(jnp.asarray(x), 0.1)
    tv, tm = compression.topk_compress(torch.from_numpy(x), 0.1)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    jq, js = jcomp.int8_quantize(jnp.asarray(x))
    tq, ts = compression.int8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        compression.int8_dequantize(tq, ts).numpy(),
        _np(jcomp.int8_dequantize(jq, js)))


def _deltas(seed, n=4):
    rng = np.random.RandomState(seed)
    return [{"w": {"a": rng.randn(30, 17).astype(np.float32) * 0.1},
             "b": rng.randn(700).astype(np.float32) * 0.1}
            for _ in range(n)]


def _close_tree(got, want, top, rounds=1):
    """Leaves within ``rounds`` f32 spacings of ``top`` (the largest |value|
    a product of the encode can take: an FMA and a rounded product differ
    by at most one; error feedback carries each round's into the next)."""
    tol = rounds * np.spacing(np.float32(top))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert (np.abs(g.numpy() - _np(w)) <= tol).all()


def _top(tree):
    return max(float(np.abs(_np(l)).max()) for l in jax.tree.leaves(tree))


@pytest.mark.parametrize("path", ["flat", "tree"])
@pytest.mark.parametrize("quantize", [True, False])
def test_error_feedback_compressor_matches_jax(path, quantize, monkeypatch):
    """Four rounds of EF compression: reconstructions, residuals and wire
    bytes against JAX's, on the flat path and the per-leaf path."""
    if path == "tree":
        monkeypatch.setenv("REPRO_AGG_PATH", "tree")
    jc = jcomp.ErrorFeedbackCompressor(frac=0.1, quantize=quantize)
    tc = compression.ErrorFeedbackCompressor(frac=0.1, quantize=quantize)
    for i, d in enumerate(_deltas(1)):
        jr, jw = jc.compress(jax.tree.map(jnp.asarray, d))
        tr, tw = tc.compress(jax.tree.map(torch.from_numpy, d))
        assert tw == jw
        _close_tree(tr, jr, _top(jr), i + 1)
        _close_tree(tc.residual, jc.residual, _top(jr), i + 1)
    assert tc.uncompressed_bytes(jax.tree.map(torch.from_numpy, d)) == \
        jc.uncompressed_bytes(d)
    # control: without error feedback the reconstructions must differ
    fresh = compression.ErrorFeedbackCompressor(frac=0.1, quantize=quantize)
    lr, _ = fresh.compress(jax.tree.map(torch.from_numpy, d))
    with pytest.raises(AssertionError):
        _close_tree(lr, jr, _top(jr))


def test_error_feedback_on_one_packed_buffer():
    """A bare (n_pods, N) tensor, as fl_round_delta_compressed hands it:
    one global top-k over both pods, seeded from a given residual."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 1000).astype(np.float32)
    res = rng.randn(2, 1000).astype(np.float32) * 0.01
    jc = jcomp.ErrorFeedbackCompressor(frac=0.1, residual=jnp.asarray(res))
    tc = compression.ErrorFeedbackCompressor(frac=0.1,
                                             residual=torch.from_numpy(res))
    jr, jw = jc.compress(jnp.asarray(x))
    tr, tw = tc.compress(torch.from_numpy(x))
    assert tw == jw and tr.shape == (2, 1000)
    _close_tree([tr], [jr], _top(jr))
    _close_tree([tc.residual], [jc.residual], _top(jr))


def _stacked(seed=0, n_pods=3):
    rng = np.random.RandomState(seed)
    tree = {"layer": {"w": rng.randn(n_pods, 8, 5).astype(np.float32)},
            "emb": rng.randn(n_pods, 33).astype(np.float32)}
    jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tt = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), tree)
    return jt, tt


def _bf16_close(got, want):
    """bf16 leaves equal, but where the f32 merge (within 1e-6 of JAX's)
    rounds to the other neighbour: at most one bf16 ulp apart."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g, w = g.float().numpy(), _np(w)
        assert g.shape == w.shape
        assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-6).all()


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0], [0.5, 0.0, 2.0],
                                     [0.0, 1.0, 0.0]],
                         ids=["fedavg", "weighted+mask", "one pod"])
def test_fl_round_matches_jax(weights):
    jt, tt = _stacked()
    want = jfed.fl_round(jt, jnp.asarray(weights, jnp.float32))
    before = fedavg_agg.LAUNCHES["agg"]
    got = federated.fl_round(tt, torch.tensor(weights))
    assert fedavg_agg.LAUNCHES["agg"] == before      # the CPU: plain B2
    _bf16_close(got, want)
    for leaf in jax.tree.leaves(got):
        assert leaf.dtype == torch.bfloat16
        assert all(torch.equal(leaf[0], leaf[i]) for i in range(3))
    if weights[1] == 0.0:
        # control: the masked pod included must move the merge
        alt = federated.fl_round(tt, torch.ones(3))
        with pytest.raises(AssertionError):
            _bf16_close(alt, want)


def test_fl_round_delta_compressed_identity_equals_fl_round():
    jt, tt = _stacked(1)
    anchor = federated.unstack_pod(tt, 0)
    w = torch.tensor([0.2, 0.3, 0.5])
    got = federated.fl_round_delta_compressed(tt, anchor, w,
                                              compressor=lambda d: d)
    want = federated.fl_round(tt, w)
    _bf16_close(got, jax.tree.map(lambda t: jnp.asarray(t.float().numpy()),
                                  want))
    jgot = jfed.fl_round_delta_compressed(
        jt, jfed.unstack_pod(jt, 0), jnp.asarray(w.numpy()),
        compressor=lambda d: d)
    _bf16_close(got, jgot)


def test_fl_round_delta_compressed_with_error_feedback_matches_jax():
    jt, tt = _stacked(2)
    w = [1.0, 1.0, 1.0]
    jc = jcomp.ErrorFeedbackCompressor(frac=0.1)
    tc = compression.ErrorFeedbackCompressor(frac=0.1)
    janchor = jfed.unstack_pod(jt, 1)
    tanchor = federated.unstack_pod(tt, 1)
    for _ in range(2):
        jgot = jfed.fl_round_delta_compressed(
            jt, janchor, jnp.asarray(w), compressor=lambda d:
            jc.compress(d)[0])
        tgot = federated.fl_round_delta_compressed(
            tt, tanchor, torch.tensor(w), compressor=lambda d:
            tc.compress(d)[0])
        _bf16_close(tgot, jgot)
        janchor = jfed.unstack_pod(jgot, 0)
        tanchor = federated.unstack_pod(tgot, 0)
    _close_tree([tc.residual], [jc.residual], 1.0)


def test_stack_for_pods_copies():
    tree = {"a": torch.arange(6.0).reshape(2, 3), "s": torch.tensor(3)}
    st = federated.stack_for_pods(tree, 2)
    assert st["a"].shape == (2, 2, 3) and st["s"].shape == (2,)
    st["a"][0].add_(1)
    assert torch.equal(st["a"][1], tree["a"])         # real copies
    assert torch.equal(federated.unstack_pod(st, 1)["a"], tree["a"])


def test_fl_local_step_matches_train_step_per_pod():
    """Two pods on different halves of the batch: each pod's parameters,
    optimizer state and metrics equal ``train_step`` on its half; with the
    same half on both pods, JAX's vmapped step within 2e-2
    (tests/test_substrate.py:155's setting)."""
    cfg = configs.get_config("musicgen-medium", reduced=True)
    opt = optim.adamw(1e-3)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    rng = np.random.RandomState(0)
    B, S = 2, 32
    emb = torch.from_numpy(rng.randn(2 * B, S, cfg.d_model).astype(
        np.float32)).to(torch.bfloat16)
    lab = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2 * B, S)))
    sp = federated.stack_for_pods(params, 2)
    so = federated.stack_for_pods(opt.init(params), 2)
    sp2, so2, met = federated.fl_local_step(
        sp, so, {"embeds": emb, "labels": lab}, cfg=cfg, optimizer=opt,
        n_pods=2)
    assert met["loss"].shape == (2,)
    for i in range(2):
        p = jax.tree.map(torch.clone, params)
        o = opt.init(p)
        p, o, m = models.train_step(
            p, o, {"embeds": emb[i * B:(i + 1) * B],
                   "labels": lab[i * B:(i + 1) * B]}, cfg=cfg, optimizer=opt)
        for a, b in zip(jax.tree.leaves(federated.unstack_pod(sp2, i)),
                        jax.tree.leaves(p)):
            assert torch.equal(a, b)
        for a, b in zip(jax.tree.leaves(federated.unstack_pod(so2, i)),
                        jax.tree.leaves(o)):
            assert torch.equal(a, b)
        assert float(met["loss"][i]) == float(m["loss"])
    # against JAX's vmapped step, the same half on both pods
    jcfg, tcfg, jp, tp = both("musicgen-medium")
    jopt = joptim.adamw(1e-3)
    half = {"embeds": emb[:B], "labels": lab[:B]}
    two = {k: torch.cat([v, v]) for k, v in half.items()}
    jtwo = {"embeds": jnp.asarray(two["embeds"].float().numpy(),
                                  jnp.bfloat16),
            "labels": jnp.asarray(two["labels"].numpy())}
    jsp, _, _ = jfed.fl_local_step(
        jfed.stack_for_pods(jp, 2), jfed.stack_for_pods(jopt.init(jp), 2),
        jtwo, cfg=jcfg, optimizer=jopt, n_pods=2)
    tsp, _, _ = federated.fl_local_step(
        federated.stack_for_pods(tp, 2),
        federated.stack_for_pods(opt.init(tp), 2), two, cfg=tcfg,
        optimizer=opt, n_pods=2)
    for a, b in zip(jax.tree.leaves(tsp), jax.tree.leaves(jsp)):
        np.testing.assert_allclose(a.float().numpy(), _np(b), rtol=0,
                                   atol=2e-2)


def test_wire_bench_twin_counts_the_references_bytes(tmp_path, monkeypatch):
    """The twin of benchmarks/wire_bench.py (``--smoke`` on the CPU) reports
    the reference's bytes per update for every codec, and its fused path
    launches no kernel on the CPU."""
    import importlib.util
    from pathlib import Path
    from repro.core import transport as jtransport
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_wire_bench", root / "benchmarks" / "torch_wire_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    monkeypatch.setattr(bench, "RESULTS", tmp_path)
    rec = bench.run(torch.device("cpu"), rounds=1)
    base = {k: jnp.zeros(s) for k, s in bench.SHAPES.items()}
    want = {name: jtransport.Transport(base, codec=name, frac=bench.FRAC)
            .expected_up_bytes() for name in jtransport.CODECS}
    assert rec["bytes_per_update"] == want
    assert rec["ef_encode_launches_per_encode"] == 0
    assert (tmp_path / "BENCH_wire.json").exists()
