"""The benchmark's arithmetic against shapes worked out by hand."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from fedbench import yardstick as ys  # noqa: E402


def test_cnn_macs_and_flops_of_listing_4_1():
    # conv1 28*28 outputs x 16 channels x 5*5*1; conv2 14*14 x 32 x 5*5*16;
    # dense 7*7*32 inputs x 10 outputs
    assert ys.cnn_layer_macs(28, 1, 16, 32, 10) == (313_600, 2_508_800,
                                                     15_680)
    fwd = 2 * (313_600 + 2_508_800 + 15_680)
    assert ys.cnn_train_flops_per_image(28, 1, 16, 32, 10) == \
        fwd + fwd + 2 * (2_508_800 + 15_680) == 16_401_280


def test_cnn_flops_of_a_cifar_shape():
    # 32x32x3: conv1 32*32*16*25*3, conv2 16*16*32*25*16, dense 8*8*32*10
    macs = (1_228_800, 3_276_800, 20_480)
    assert ys.cnn_layer_macs(32, 3, 16, 32, 10) == macs
    assert ys.cnn_train_flops_per_image(32, 3, 16, 32, 10) == \
        4 * sum(macs) + 2 * sum(macs[1:])


def test_lm_params_of_musicgen_medium():
    # a layer: 4 * 1536^2 attention + 3 * 1536 * 6144 MLP + 2 norms
    layer = 4 * 1536 ** 2 + 3 * 1536 * 6144 + 2 * 1536
    assert layer == 37_751_808
    assert ys.lm_params(16, 1536, 24, 24, 6144, 2048) == \
        16 * layer + 2048 * 1536 + 1536 == 607_176_192
    assert ys.lm_params(48, 1536, 24, 24, 6144, 2048) == 1_815_234_048


def test_lm_params_match_the_port_at_a_small_size():
    import torch
    from fedbench.drivers import pods
    model = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
             "d_ff": 96, "vocab_size": 128}
    w = pods.init_weights(model, 3, torch.device("cpu"))
    n = sum(t.numel() for t in pods.named(w).values())
    assert n == ys.lm_params(2, 64, 4, 4, 96, 128)


def test_palm_flops_per_token():
    assert ys.lm_train_flops_per_token(1000, 2, 8, 4) == 6000 + 12 * 2 * 8 * 4


def test_kernel_bytes():
    assert ys.b2_bytes(2, 3) == 4 * (6 + 2 + 3)
    assert ys.b2_bytes(30, 29_184) == 4 * (30 * 29_184 + 30 + 29_184)
    assert ys.ef_encode_bytes(10) == 40 + 10 + 40
    assert ys.ef_encode_bytes(10, b=True, c=True) == 120 + 10 + 40
    assert ys.ef_encode_bytes(10, quantize=False) == 40 + 40 + 40
    # PR 28's bound at the pod width, x alone: 3.267911 ms
    assert ys.ef_encode_bytes(1_216_389_120) / ys.PEAK_BYTES_PER_S * 1e3 \
        == pytest.approx(3.267911, abs=1e-6)


def test_peaks_and_shares():
    assert ys.PEAK_FLOPS["bf16"] == 989e12 and ys.PEAK_FLOPS["f32"] == 67e12
    assert ys.PEAK_BYTES_PER_S == 3.35e12
    assert ys.utilization(67e12, 2.0, 67e12) == pytest.approx(50.0)
    assert ys.roofline_share(3.35e9, 2e-3) == pytest.approx(50.0)


def test_busy_union_gaps_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (4.0, 4.5), (6.0, 7.0)]
    assert ys.union(iv) == [(0.0, 2.0), (3.0, 4.5), (6.0, 7.0)]
    assert ys.busy_seconds(iv, 0.0, 10.0) == pytest.approx(4.5)
    assert ys.busy_seconds(iv, 1.5, 6.5) == pytest.approx(0.5 + 1.5 + 0.5)
    assert ys.gaps(iv, 0.0, 8.0) == [(2.0, 3.0), (4.5, 6.0), (7.0, 8.0)]
    assert ys.idle_share(4.5, 10.0) == pytest.approx(55.0)


def test_innermost_op_and_top():
    ops = sorted([(0.0, 10.0, "outer"), (2.0, 5.0, "inner"),
                  (6.0, 7.0, "other")])
    assert ys.innermost(ops, 3.0) == "inner"
    assert ys.innermost(ops, 5.5) == "outer"
    assert ys.innermost(ops, 11.0) == "host (no op)"
    assert ys.top([("a", 1.0), ("b", 3.0), ("a", 2.5)], 1) == [["a", 3.5]]
