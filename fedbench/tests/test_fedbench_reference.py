"""The benchmark's plain references held against the port at small sizes
on the CPU, and each control held to differ from its reference."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from fedbench.drivers import fl as fl_driver  # noqa: E402
from fedbench.drivers import pods as pods_driver  # noqa: E402
from fedbench.reference import cnn as ref_cnn  # noqa: E402
from fedbench.reference import codec as ref_codec  # noqa: E402
from fedbench.reference import lm as ref_lm  # noqa: E402

CPU = torch.device("cpu")
CNN = {"image_hw": 28, "channels": 1, "kernel": 5, "conv1": 16, "conv2": 32,
       "n_classes": 10, "lr": 0.01}
LM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
      "d_ff": 128, "vocab_size": 256, "rope_theta": 10000.0}
OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
       "weight_decay": 0.01, "clip_norm": 1.0}


def _cnn_inputs(seed=7, workers=3, per=48):
    tr = {"workers": workers, "images_per_worker": per, "n_test": 64,
          "noise": 0.35}
    return fl_driver.make_inputs(CNN, tr, seed, CPU)


def test_cnn_local_sgd_matches_the_port():
    from repro_torch.models import cnn as cnn_mod
    inp = _cnn_inputs()
    x, y = inp["shards"][0]
    ours = cnn_mod.cnn_sgd_train(inp["w0"], x, y, lr=0.01, epochs=3)
    ref = ref_cnn.local_sgd(inp["w0"], x, y, lr=0.01, epochs=3)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=1e-5, atol=1e-6)


def test_cnn_fedavg_matches_b2_plain_version():
    from repro_torch.kernels import fedavg_agg
    inp = _cnn_inputs()
    models = [ref_cnn.local_sgd(inp["w0"], x, y, lr=0.01, epochs=1)
              for x, y in inp["shards"]]
    keys = sorted(models[0])
    rows = torch.stack([torch.cat([m[k].reshape(-1) for k in keys])
                        for m in models])
    w = torch.full((len(models),), 1.0 / len(models))
    merged = fedavg_agg.fedavg_agg_flat(rows, w)
    ref = ref_cnn.fedavg(models)
    torch.testing.assert_close(
        merged, torch.cat([ref[k].reshape(-1) for k in keys]),
        rtol=1e-6, atol=1e-7)


def _lm_inputs(seed=11, rows=4, seq=32):
    tr = {"n_pods": 2, "rows_per_pod": rows // 2, "seq_len": seq}
    w0 = pods_driver.init_weights(LM, seed, CPU)
    return w0, pods_driver.batch(LM, tr, seed, 1, CPU)


def _port_cfg():
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="t", family="audio", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                       embeds_input=True, loss_chunk=16)


def test_lm_loss_and_gradients_match_the_port():
    from repro_torch.models import transformer
    w0, (emb, lab) = _lm_inputs()
    loss, _, grads = transformer._value_and_grad(
        w0, _port_cfg(), {"embeds": emb, "labels": lab}, 0.0)
    rl, rg = ref_lm.grads(w0, emb, lab)
    assert abs(float(loss) - rl) / rl < 2e-3
    ours = dict(ref_lm.flat(grads))
    for k, g in rg.items():
        num = torch.linalg.vector_norm(ours[k].float() - g)
        assert float(num) <= 0.05 * float(torch.linalg.vector_norm(g)) + 1e-6


def test_adamw_matches_the_port():
    from repro_torch import optim
    w0, _ = _lm_inputs()
    g = {k: torch.randn(t.shape, generator=torch.Generator().manual_seed(i))
         for i, (k, t) in enumerate(ref_lm.flat(w0))}
    opt = optim.adamw(**OPT)
    state = opt.init(w0)
    params = ref_lm.rebuild(w0, {k: v.clone() for k, v in ref_lm.flat(w0)})
    ref = ref_lm.AdamW(w0, **OPT)
    for _ in range(2):
        opt.update(params, ref_lm.rebuild(w0, {k: v.to(torch.bfloat16)
                                               for k, v in g.items()}),
                   state)
        ref.step({k: v.to(torch.bfloat16).float() for k, v in g.items()})
    ours = dict(ref_lm.flat(state["master"]))
    for k, v in ref.master.items():
        torch.testing.assert_close(ours[k], v, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [3000, (1 << 17) + 4096])
def test_codec_matches_the_port(n):
    from repro_torch.core.compression import ErrorFeedbackCompressor
    gen = torch.Generator().manual_seed(n)
    ours = ErrorFeedbackCompressor(frac=0.1, quantize=True)
    ref = ref_codec.ErrorFeedbackTopkInt8(0.1)
    for _ in range(3):
        d = torch.randn((2, n // 2), generator=gen)
        a = ours.compress(d)[0]
        b = ref(d)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ours._res_vec[:n], ref.residual[:n],
                               rtol=0, atol=0)


def test_pod_reference_follows_the_port_at_a_small_size():
    """Three steps and a merge of the port's pods against the reference's,
    read as the benchmark reads them."""
    from repro_torch import optim
    from repro_torch.core import federated
    w0, _ = _lm_inputs()
    tr = {"n_pods": 2, "rows_per_pod": 2, "seq_len": 32}
    batches = [pods_driver.batch(LM, tr, 11, s, CPU) for s in (1, 2, 3)]
    opt = optim.adamw(**OPT)
    params = federated.stack_for_pods(w0, 2)
    state = federated.stack_for_pods(opt.init(w0), 2)
    losses = []
    for s, (emb, lab) in enumerate(batches, start=1):
        params, state, met = federated.fl_local_step(
            params, state, {"embeds": emb, "labels": lab}, cfg=_port_cfg(),
            optimizer=opt, n_pods=2)
        losses.append([float(x) for x in met["loss"]])
        if s == 2:
            params = federated.fl_round(params, torch.ones(2))
    ref = ref_lm.run_pods(w0, batches, n_pods=2, merge_after=[2],
                          compress=None, opt_kw=OPT, rows=2)
    for s in range(3):
        for i in range(2):
            assert abs(losses[s][i] - ref["losses"][i][s]) \
                < 2e-3 * ref["losses"][i][s]
    mast = dict(ref_lm.flat(state["master"]))
    base = dict(ref_lm.flat(w0))
    for k, v in ref["change"][0].items():
        ours = float(torch.linalg.vector_norm(mast[k][0] - base[k].float()))
        assert abs(ours - v) <= 0.05 * max(v, 1e-8) + 1e-7


def test_fp8_control_departs_from_the_bf16_reference():
    w0, (emb, lab) = _lm_inputs()
    l16, g16 = ref_lm.grads(w0, emb, lab)
    l8, g8 = ref_lm.grads(w0, emb, lab, precision="fp8")
    lsound, _ = ref_lm.grads(w0, emb, lab, rows=1)
    assert abs(l8 - l16) > 3 * abs(lsound - l16)
    assert any(float(torch.linalg.vector_norm(g8[k] - g16[k]))
               > 1e-3 * float(torch.linalg.vector_norm(g16[k]))
               for k in g16)
