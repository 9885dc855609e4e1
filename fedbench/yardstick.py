"""The benchmark's arithmetic: published peaks, model FLOP, kernel bytes, and
the reduction of a profiler trace to busy time and idle share.

Everything here is plain Python on numbers and lists, so the CPU tests hold
each formula against shapes worked out by hand.  Nothing here reads the
program: a later change to the program cannot move the yardstick.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence, Tuple

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "f32": 67e12, "fp8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------------------
# Model FLOP
# ---------------------------------------------------------------------------

def cnn_layer_macs(image_hw: int, channels: int, conv1: int, conv2: int,
                   n_classes: int, kernel: int = 5) -> Tuple[int, ...]:
    """Multiply-accumulates per image of the thesis' CNN (Listing 4.1):
    a SAME 5x5 convolution at full resolution, a 2x2 pool, a SAME 5x5
    convolution at half resolution, a 2x2 pool, and the dense layer.
    Returns (conv1, conv2, fc)."""
    hw1, hw2, hw3 = image_hw, image_hw // 2, image_hw // 4
    kk = kernel * kernel
    return (hw1 * hw1 * conv1 * kk * channels,
            hw2 * hw2 * conv2 * kk * conv1,
            hw3 * hw3 * conv2 * n_classes)


def cnn_train_flops_per_image(image_hw: int, channels: int, conv1: int,
                              conv2: int, n_classes: int,
                              kernel: int = 5) -> int:
    """FLOP of one SGD step per image: the forward (2 a MAC in every layer),
    the weight gradients (2 a MAC in every layer) and the input gradients
    (2 a MAC in every layer but the first, whose input needs none).  Bias,
    relu, pooling and the loss are left out."""
    macs = cnn_layer_macs(image_hw, channels, conv1, conv2, n_classes, kernel)
    return 2 * sum(macs) + 2 * sum(macs) + 2 * sum(macs[1:])


def lm_params(n_layers: int, d_model: int, n_heads: int, n_kv_heads: int,
              d_ff: int, vocab: int, head_dim: int = 0) -> int:
    """Parameters of a pre-norm decoder with GLU MLPs and a tied head:
    q, k, v, o, three MLP matrices and two norm scales a layer, the
    embedding and the final norm."""
    hd = head_dim or d_model // n_heads
    attn = d_model * hd * (2 * n_heads + 2 * n_kv_heads)
    return (n_layers * (attn + 3 * d_model * d_ff + 2 * d_model)
            + vocab * d_model + d_model)


def lm_train_flops_per_token(n_params: int, n_layers: int, seq_len: int,
                             d_model: int) -> int:
    """PaLM's model FLOP per trained token (Chowdhery et al. 2022, app. B):
    6 N for the matrices, forward and backward, plus 12 L S d for the
    attention scores and their weighted sum, without recomputation."""
    return 6 * n_params + 12 * n_layers * seq_len * d_model


def utilization(flop: float, seconds: float, peak: float) -> float:
    """Share, in percent, of ``peak`` FLOP/s that ``flop`` in ``seconds``
    reaches."""
    return 100.0 * flop / (seconds * peak)


# ---------------------------------------------------------------------------
# Kernel bytes (each input read once, each output written once)
# ---------------------------------------------------------------------------

def b2_bytes(W: int, N: int) -> int:
    """``fedavg_agg_flat``: reads the (W, N) f32 rows and the W weights,
    writes the (N,) f32 merge."""
    return 4 * (W * N + W + N)


def ef_encode_bytes(N: int, *, b: bool = False, c: bool = False,
                    quantize: bool = True) -> int:
    """The EF top-k(+int8) encode of ``x = (a - b) + c``: reads a (and b,
    c where given) as f32, writes q (int8) or the f32 reconstruction, and
    the f32 residual."""
    reads = 4 * N * (1 + int(b) + int(c))
    return reads + N * (1 if quantize else 4) + 4 * N


def roofline_share(byte_count: float, seconds: float,
                   bandwidth: float = PEAK_BYTES_PER_S) -> float:
    """Percent of the byte bound: the least time the bytes take at
    ``bandwidth`` over the time measured."""
    return 100.0 * byte_count / bandwidth / seconds


# ---------------------------------------------------------------------------
# Trace reduction
# ---------------------------------------------------------------------------

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals: Iterable[Interval], lo: float, hi: float
                 ) -> float:
    """Seconds of [lo, hi] in which at least one interval is open."""
    total = 0.0
    for s, e in union(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def idle_share(busy: float, window: float) -> float:
    """Percent of the window in which the device ran nothing."""
    return 100.0 * (1.0 - busy / window)


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for s, e in union(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(ops: Sequence[Tuple[float, float, str]], t: float,
              lookback: int = 4096) -> str:
    """Name of the shortest op in ``ops`` (sorted by start) that is open at
    ``t``; "host (no op)" where none is."""
    i = bisect.bisect_right(ops, (t, float("inf"), "\uffff"))
    best, best_len = "host (no op)", float("inf")
    for s, e, name in ops[max(0, i - lookback):i]:
        if s <= t <= e and e - s < best_len:
            best, best_len = name, e - s
    return best


def top(pairs: Iterable[Tuple[str, float]], n: int = 10
        ) -> List[List[object]]:
    """Seconds summed by name, the ``n`` largest, as [[name, seconds]]."""
    acc = {}
    for name, sec in pairs:
        acc[name] = acc.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
