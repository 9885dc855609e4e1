#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Card identity: ``nvidia-smi`` name and power limit; compute capability
   (9, 0) is required.
2. Build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   and print nvcc's ``-Xptxas -v`` report; B8's tensor-core body
   (``flash_wgmma``) must not spill registers.
3. Kernels: hold each kernel against its plain PyTorch version on the
   card at the paths' shapes (fedavg W = 30 and 2, N = 101,888, the
   scalar path's 101,890 and a ragged N = 1000: the aggregate bit-exact,
   the mix within 1e-6; encode and decode at N = 101,888 and
   1000, bit-exact; the server-optimizer step at N = 101,888, 29,184 (the
   padded MNIST CNN) and 1000 with the FedAvgM, FedDyn and FedAdam
   scalars, bit-exact, fresh and with its state written in place; flash
   attention at gemma2-2b's global and local layers, yi-9b's and two f32
   shapes with q at 8x the scale of k and v, elementwise within one bf16
   ulp of the plain output plus 1e-4 in bf16 and 2e-5 in f32, and the
   check must fail against a plain version given a fault: no softcap, the
   window 32 keys wider, KV head h % Kv); the WKV recurrence (B9) at
   rwkv6-3b's width (2 x 8192 tokens, 40 heads of 64) at ops.wkv's chunk
   of 16 in bf16 and f32 and at three small f32 shapes, elementwise within
   ``WKV_TOL``, and in the model's form (chunk 64, from a nonzero s0,
   returning the final state) in bf16 and f32, the state within
   ``WKV_STATE_TOL`` of its largest entry and s0 left unwritten; the check
   must fail against a plain version given each of ``WKV_FAULTS`` (no
   bonus, no state carried across chunks, an inclusive cumsum) and, in
   the state form, ``WKV_STATE_FAULTS`` (also s0 ignored, and the final
   state taken before the last chunk's update); then time kernel, plain
   version and one-call library
   yardstick with CUDA events (median of 50 cold-L2 runs after warm-up;
   10 for flash attention and WKV, whose sequential ``reference_wkv`` is
   timed too; kernel and library in turns: library, kernel, kernel,
   library), beside the least time the card could take and the time
   before B2's and B8's redesign.
4. Main path: the paper's 30-worker MNIST experiment at full MLP width
   (784-128-10, 101,770 parameters) through ``make_setup`` -> ``run_fl``,
   20 rounds x 10 local epochs, in sync / async / async_delta /
   time_based, with the raw transport and with top-k+int8 uplinks.
5. Heterogeneity: the non-IID experiment of ``benchmarks/fl_figures.py``
   (REGIME: 10 workers, batch 64, het extreme, Dirichlet alpha 0.3) at
   full MLP width, 10 local epochs: sync 40 rounds with FedAvgM
   (momentum 0.9), FedAdam (lr 0.05), FedDyn (gamma 0.25) and worker-side
   FedProx (mu 0.01); async FedAdam for 100 merges (alpha 0.9, staleness
   power 0.25, linear weights); sync FedAdam over symmetric top-k+int8
   links at frac 0.1, 40 rounds.
6. CNN: the thesis' Listing 4.1 CNN at MNIST width (28,938 parameters),
   the same regime without the Dirichlet split, sync FedAvg and FedAdam,
   20 rounds; FedAdam must reach 0.8 accuracy.

Every run of phases 4-6 starts with every launch counter at 0 and reads
them after; the counters must show each kernel on the runs that use it
(and the optimizer step exactly once per merge).  Every raw run is
repeated on the CPU in this process from the same initial weights: every
history field but accuracy must match exactly.  Accuracy cannot match
point for point: SGD over these runs is chaotic, and a one-ulp change to
one initial weight alone moves it (``SPREAD``, measured on the CPU with
``tools/torch_accuracy_spread.py``).  So the card must stay within
``gap_bounds`` of the CPU at every point and in the mean of the last five
points.  The top-k runs are not compared field by field (kept counts
follow the numerics).
7. LM serving: gemma2-2b at full width and depth (26 layers, seeded
   random weights on the card), attention through kernel B8: prefill of
   2 prompts of 8192 tokens from ``synthetic_token_batches`` (cut from
   ``SHAPES["prefill_32k"]``: batch 32 -> 2, 32,768 -> 8192 tokens), then
   32 greedy decode steps, every counter at 0 before and read after.
   Checks: B8 launches once per layer in the prefill, every launch
   through its tensor-core body, and never in decode; the prefill's
   last-token logits match the same prefill through ``mha_chunked``; the
   last 4 decode steps match a full forward over the 8224 positions; at
   one local/global pair (512-token prompt, 4 decode steps) the card
   matches a CPU run in this process; each within
   its ``LM_LIMITS`` entry.  Each check is repeated with B8 given a fault
   (``LM_FAULTS``); those in ``LM_CAUGHT`` must fail it.  Reports prefill
   seconds and tokens/s, decode seconds per step, peak device memory and
   the prefill's model FLOPs over its time as a share of the bf16 peak.
8. rwkv6: rwkv6-3b at full width and depth (32 layers, seeded random
   weights on the card), cut from ``SHAPES["prefill_32k"]`` as phase 7 is:
   prefill of 2 prompts of 8192 tokens, then 64 greedy decode steps,
   every counter at 0 before and read after.  The prefill's blocks run B9
   in its state form (chunk 64): exactly one launch a layer after the
   prefill, and no kernel of ours in decode (the plain ``wkv_step``, as in
   JAX); the full forward over the 8256 positions launches B9 once a
   layer too.  Checks: the last 4 decode steps against that forward; at
   two layers (512-token prompt, 4 decode steps) the card against a CPU
   run in this process (whose blocks run the plain ``wkv_chunked``); each
   within its ``RWKV_LIMITS`` entry, and each must fail with the WKV state
   zeroed after the prefill (the control).  Then B9 on layer 0's streams
   of the prefill (time_mix's r, k, v, w and bonus) against the plain
   ``wkv_chunked``: through ``ops.wkv`` (chunk 16, zero state; counters
   at 0 before and read after: one launch), y within ``WKV_TOL`` (a plain
   version with no carry must fail); and in the state form, y and the
   final state within their limits.  Reports as phase 7.
9. Result: the ``kernels`` JSON line, the card line, and last the
   ``{"ok": true, "device": ...}`` line.

A full report goes to ``chiprun_out/chip_smoke_report.json``, also when a
phase fails.
"""
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM bf16 tensor cores, dense
N_TIMED = 50
EPOCHS = 10
FIELDS = ("time", "version", "n_updates", "selected", "up_bytes",
          "down_bytes")
MODES = {
    "sync": dict(mode="sync", selector="all"),
    "async": dict(mode="async", selector="all", async_alpha=0.9,
                  async_latest_table=False, aggregator="linear"),
    "async_delta": dict(mode="async", selector="all", async_delta=True),
    "time_based": dict(mode="sync", selector="time_based",
                       selector_kw={"r": EPOCHS, "T0": 0.0, "A": 0.01}),
}
TRANSPORTS = {
    "raw": dict(transport="raw"),
    "uplink_only": dict(transport="topk_ef+int8", transport_down="raw",
                        transport_frac=0.1),
}
REGIME = dict(noise=0.2, batch_size=64, het="extreme")
DIRICHLET = dict(partition="dirichlet",
                 partition_kw={"alpha": 0.3, "seed": 0})
ASYNC_KW = dict(mode="async", selector="all", async_latest_table=False,
                async_alpha=0.9, async_stale_pow=0.25, aggregator="linear")
FEDAVGM = dict(server_opt="fedavgm", server_opt_kw={"momentum": 0.9})
FEDADAM = dict(server_opt="fedadam", server_opt_kw={"lr": 0.05})
FEDDYN = dict(server_opt="feddyn", server_opt_kw={"gamma": 0.25})
SYNC = MODES["sync"]


def _run(phase, model, rounds, run_kw, setup_kw=None, compare=True):
    return dict(phase=phase, model=model, rounds=rounds, run_kw=run_kw,
                setup_kw=setup_kw or {}, compare=compare)


# run key -> what it drives; "compare": repeated on the CPU field by field
RUNS = {f"{t}/{m}": _run("main", "mlp", 20, {**MODES[m], **TRANSPORTS[t]},
                         compare=t == "raw")
        for t in TRANSPORTS for m in MODES}
RUNS.update({
    "hetero/sync/fedavgm": _run("hetero", "mlp", 40,
                                {**SYNC, **DIRICHLET, **FEDAVGM}),
    "hetero/sync/fedadam": _run("hetero", "mlp", 40,
                                {**SYNC, **DIRICHLET, **FEDADAM}),
    "hetero/sync/feddyn": _run("hetero", "mlp", 40,
                               {**SYNC, **DIRICHLET, **FEDDYN}),
    "hetero/sync/fedprox": _run("hetero", "mlp", 40, {**SYNC, **DIRICHLET},
                                setup_kw={"fedprox_mu": 0.01}),
    "hetero/async/fedadam": _run("hetero", "mlp", 100,
                                 {**ASYNC_KW, **DIRICHLET, **FEDADAM}),
    "hetero/sync_topk/fedadam": _run(
        "hetero", "mlp", 40, {**SYNC, **DIRICHLET, **FEDADAM,
                              "transport": "topk_ef+int8",
                              "transport_frac": 0.1}, compare=False),
    "cnn/sync/fedavg": _run("cnn", "cnn", 20, SYNC),
    "cnn/sync/fedadam": _run("cnn", "cnn", 20, {**SYNC, **FEDADAM}),
})
# phase -> (batches per worker table, make_setup kwargs); MNIST width
PHASES = {"main": ("TABLE_4_2", dict(het="strong")),
          "hetero": ("TABLE_4_1", REGIME),
          "cnn": ("TABLE_4_1", REGIME)}
# How far one ulp of initial-weight noise moves accuracy on the CPU: the
# largest of 10 perturbations made by tools/torch_accuracy_spread.py, as
# (gap at any point, gap of the last-5 mean).
SPREAD = {
    "hetero/sync/fedavgm": (0.5645, 0.4695),
    "hetero/sync/fedadam": (0.2734, 0.1883),
    "hetero/sync/feddyn": (0.2461, 0.0152),
    "hetero/sync/fedprox": (0.2305, 0.0637),
    "hetero/async/fedadam": (0.0547, 0.0055),
    "cnn/sync/fedavg": (0.0117, 0.0008),
    "cnn/sync/fedadam": (0.1562, 0.0016),
}
GAP_FLOOR = (0.1, 0.05)
MAIN_GAPS = (0.2, 0.05)         # the main path's bounds


def gap_bounds(key):
    """Card vs CPU accuracy bounds of one run: MAIN_GAPS on the main
    path; elsewhere twice the run's CPU spread (the card's rounding
    differs at every operation, the spread's at one weight once), rounded
    up to 0.01, at least GAP_FLOOR and at most 1."""
    if RUNS[key]["phase"] == "main":
        return MAIN_GAPS
    return tuple(min(1.0, max(f, math.ceil(200 * s) / 100))
                 for s, f in zip(SPREAD[key], GAP_FLOOR))


# kernel -> (launch counter key, the runs that must show it)
REQUIRED = {
    "fedavg_agg_flat": ("agg", ["raw/sync", "raw/time_based",
                                "raw/async_delta", "hetero/sync/fedavgm",
                                "cnn/sync/fedavg"]),
    "fedavg_mix_flat": ("mix", ["raw/async", "raw/async_delta",
                                "hetero/async/fedadam"]),
    "topk_quant_encode": ("encode", [f"uplink_only/{m}" for m in MODES]
                          + ["hetero/sync_topk/fedadam"]),
    "dequant_add": ("decode", [f"uplink_only/{m}" for m in MODES]
                    + ["hetero/sync_topk/fedadam"]),
    "server_opt_step_flat_mom": ("mom", ["hetero/sync/fedavgm",
                                         "hetero/sync/feddyn"]),
    "server_opt_step_flat_adam": ("adam", [
        "hetero/sync/fedadam", "hetero/async/fedadam",
        "hetero/sync_topk/fedadam", "cnn/sync/fedadam"]),
}
# B8 (flash attention) is checked at these shapes, (B, S, H, Kv, D, dtype,
# window, softcap); the first three are timed.  gemma2-2b's global and
# local layers and yi-9b's at the LM phase's prompt lengths, then two f32
# shapes of tests/test_kernels.py.
FLASH_SHAPES = {
    "gemma2-2b global": (2, 8192, 8, 4, 256, torch.bfloat16, 0, 50.0),
    "gemma2-2b local": (2, 8192, 8, 4, 256, torch.bfloat16, 4096, 50.0),
    "yi-9b": (2, 4096, 32, 4, 128, torch.bfloat16, 0, 0.0),
    "f32 (2,256,2,1,64)": (2, 256, 2, 1, 64, torch.float32, 0, 0.0),
    "f32 window 64 softcap 50": (1, 128, 4, 2, 32, torch.float32, 64, 50.0),
}
# B8's limit, elementwise: |kernel - plain| <= rel * |plain| + abs.  f32:
# 2e-5 (ROADMAP (b)).  bf16: one bf16 ulp of the plain output (2^-7 |x|
# is at least an ulp anywhere in x's binade; both sides compute in f32
# and round once, so another summation order flips at most the last bit)
# plus 1e-4 for outputs near 0.
FLASH_TOL = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-4)}
# q is drawn at 8x the scale of k and v: scores of std 8 reach the softcap
# and peak the softmax, so a wrong cap, window edge or head map moves
# outputs by O(1).  Each timed shape must fail the limit against its plain
# version with the fault named here (a control of the check).
FLASH_Q_SCALE = 8.0
FLASH_FAULTS = {"gemma2-2b global": "no softcap",
                "gemma2-2b local": "window + 32 keys",
                "yi-9b": "head map h % Kv"}
N_TIMED_FLASH = 10
# The LM phase: gemma2-2b at full width and depth, cut from
# SHAPES["prefill_32k"] (32 prompts of 32,768 tokens) to 2 of 8192, then
# LM_DECODE greedy decode steps; the card-vs-CPU repeat keeps the width
# and one local/global pair, with a 512-token prompt and 4 decode steps.
LM_ARCH = "gemma2-2b"
LM_BATCH, LM_PROMPT, LM_DECODE = 2, 8192, 32
LM_CHECKED_STEPS = 4          # decode steps held against a full forward
LM_CUT = dict(n_layers=2, prompt=512, decode=4)
# The LM checks, each a relative gap (max |a - b| / max |b| over the
# logits, bf16 end to end) and its limit: the kernel prefill against
# mha_chunked's (which rounds P to bf16), decode against a full forward,
# and card against CPU at the cut depth.  Each check is also run with B8
# given a fault (LM_FAULTS, a control); the faults listed in LM_CAUGHT
# must exceed the check's limit.  The limits sit between the sound and the
# caught readings of an H100 run (both in PERF.md).  With random weights the scores stay far below the softcap, so "no
# softcap" moves the logits less than bf16 noise: B8's own check (q at 8x)
# catches it instead.  At 512 tokens the 4096 window never bites.
LM_LIMITS = {"kernel_vs_xla": 0.03, "decode_vs_forward": 0.03,
             "card_vs_cpu": 0.02}
LM_FAULTS = ("no softcap", "window + 32 keys", "no window",
             "head map h % Kv")
LM_CAUGHT = {"kernel_vs_xla": LM_FAULTS[1:],
             "decode_vs_forward": LM_FAULTS[1:],
             "card_vs_cpu": ("head map h % Kv",)}
# B9 (the WKV recurrence) is checked at these shapes, (B, S, H, K, chunk,
# dtype, state form): rwkv6-3b's 40 heads of 64 over the rwkv6 phase's 2 x
# 8192 tokens at ops.wkv's chunk of 16 (y from a zero state), in bf16
# (timed) and f32, then the three f32 shapes of tests/test_kernels.py; and
# the same width at the model's chunk of 64 in the state form time_mix
# runs (wkv_state: from a nonzero s0, returning the final state), in bf16
# (timed) and f32.  Inputs: r, k, v 0.5 N; w = exp(-exp(-4 + 0.5 N)) ~
# 0.98, the decay rwkv6's decay_base of -4 gives, so the state carries
# across thousands of tokens, far past one chunk; u 0.5 + 0.1 N; s0 1.25
# N, about the spread of the state these streams build up (0.25 / (1 -
# 0.98^2) per entry).
WKV_SHAPES = {
    "rwkv6-3b bf16": (2, 8192, 40, 64, 16, torch.bfloat16, False),
    "rwkv6-3b f32": (2, 8192, 40, 64, 16, torch.float32, False),
    "f32 (2,64,2,16) chunk 16": (2, 64, 2, 16, 16, torch.float32, False),
    "f32 (2,128,3,32) chunk 32": (2, 128, 3, 32, 32, torch.float32, False),
    "f32 (2,64,1,8) chunk 8": (2, 64, 1, 8, 8, torch.float32, False),
    "rwkv6-3b prefill bf16": (2, 8192, 40, 64, 64, torch.bfloat16, True),
    "rwkv6-3b prefill f32": (2, 8192, 40, 64, 64, torch.float32, True),
}
# B9's limit, elementwise: |kernel - plain| <= rel |plain| + abs max|plain|.
# Both sides compute in f32 and round once; bf16: one bf16 ulp of the plain
# output; f32: a bound relative to the largest output.  Set from an H100
# run's readings (PERF.md).
WKV_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
# B9's final state (f32 in both dtypes): |kernel - plain| <= WKV_STATE_TOL
# max|plain|.  Both sides compute the state in f32 from the same rounded
# inputs and differ only in the order of f32 sums: each chunk's 64-term
# increment, then 128 chunks of decayed carry (w < 1, so earlier errors
# shrink), which leaves ~1e-6 relative to the largest entry (an H100 run
# reads 3.7e-7, PERF.md); a fault moves the state by far more.
WKV_STATE_TOL = 1e-5
# the plain version given each fault must fail the limit (the controls);
# in the state form also these two, which only a state can show
WKV_FAULTS = ("u = 0", "no carry", "inclusive cumsum")
WKV_STATE_FAULTS = WKV_FAULTS + ("s0 ignored",
                                 "final state before the last chunk's update")
N_TIMED_WKV = 10
# exps and logs a second on the SFUs: 16 a clock on each of the 132 SMs
# (CUDA C++ Programming Guide, throughput of compute capability 9.0) at
# the 1.98 GHz that the 67 TFLOP/s f32 rate implies (132 x 128 x 2 x f)
SFU_RATE = 132 * 16 * 1.98e9
# The rwkv6 phase: rwkv6-3b at full width and depth, cut from
# SHAPES["prefill_32k"] as the LM phase is (2 prompts of 8192 tokens), then
# RWKV_DECODE greedy steps: 8256 positions in all, a multiple of
# wkv_chunked's chunk of 64, so a full forward over them checks decode.
RWKV_ARCH = "rwkv6-3b"
RWKV_N_PARAMS = 2_931_837_440        # the JAX package's init tree
RWKV_BATCH, RWKV_PROMPT, RWKV_DECODE = 2, 8192, 64
RWKV_CUT = dict(n_layers=2, prompt=512, decode=4)
# relative logit gaps as in LM_LIMITS; each check's control (the WKV state
# zeroed after the prefill) must exceed its limit.  Twice the sound reading
# of an H100 run, rounded up to a hundredth (PERF.md): decode against the
# forward read 0.1055 (control 1.2167), card against CPU 0.0120 (control
# 1.1565).  Decode's gap is bf16 noise that grows with depth and steps: in
# f32 the two agree within 1e-5 at 32 layers (CPU).
RWKV_LIMITS = {"decode_vs_forward": 0.22, "card_vs_cpu": 0.03}

# server_opt -> the launch counter of its form (B5a momentum, B5b adam)
OPT_COUNTER = {"fedavgm": "mom", "feddyn": "mom", "fedadam": "adam"}
OPT_SCALARS = {"fedavgm": [0.9, 1.0, 0.0, 1.0],
               "feddyn": [1.0, 1.0, 1.0, 0.25],
               "fedadam": [0.9, 0.99, 0.05, 1e-3, 0.0, 0.0]}


def ptxas_report(log: str, name: str) -> dict:
    """nvcc -Xptxas -v's registers, barriers, static shared memory, stack
    and spills of each entry function whose mangled name holds ``name``
    (the dynamic shared memory of a launch is not in it)."""
    out = {}
    for block in log.split("ptxas info    : Compiling entry function '")[1:]:
        kern = block.split("'", 1)[0]
        if name not in kern:
            continue
        info = {}
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("barriers", r"used (\d+) barriers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, block)
            if m:
                info[key] = int(m.group(1))
        out[kern] = info
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def attention_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention over S positions
    needs: query i sees min(i + 1, window) keys."""
    i = np.arange(S, dtype=np.int64)
    seen = i + 1 if not window else np.minimum(i + 1, window)
    return int(seen.sum())


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each.

    A spin of about a millisecond and the flush (256 MiB written) are
    queued before the start event, so the host has issued the timed call
    before the card reaches it: the events time the card's work, not the
    host's dispatch."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, n: int = N_TIMED) -> float:
        for _ in range(5):
            fn()
        pairs = []
        for _ in range(n):
            torch.cuda._sleep(2_000_000)
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def turns(self, kern, lib, n: int = N_TIMED):
        """``kern`` and the library call ``lib`` (or None) timed in turns,
        library, kernel, kernel, library: returns the kernel's and the
        library's mean of their two medians (None without a library) and
        the four readings."""
        if lib is None:
            return self(kern, n), None, None
        first = self(lib, n)
        k = [self(kern, n), self(kern, n)]
        lb = [first, self(lib, n)]
        return (statistics.mean(k), statistics.mean(lb),
                {"kernel": k, "library": lb})


def bound_ms(n_bytes: float, flops: float, peak: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def launch_counters():
    """Counter key -> the wrapper module's LAUNCHES dict."""
    from repro_torch.kernels import (fedavg_agg, flash_attention,
                                     rwkv6_kernel, server_opt, topk_quant)
    return {"agg": fedavg_agg.LAUNCHES, "mix": fedavg_agg.LAUNCHES,
            "encode": topk_quant.LAUNCHES, "decode": topk_quant.LAUNCHES,
            "mom": server_opt.LAUNCHES, "adam": server_opt.LAUNCHES,
            "flash": flash_attention.LAUNCHES,
            "flash_wgmma": flash_attention.LAUNCHES,
            "wkv": rwkv6_kernel.LAUNCHES}


def zero_counters():
    for c in launch_counters().values():
        for k in c:
            c[k] = 0


def check_server_opt(dev, g, errs):
    """B5a/B5b against the plain version, fresh and in place, at the
    paths' widths and every optimizer's scalars."""
    from repro_torch.kernels import ref, server_opt
    for n in (101_888, 29_184, 1000):
        prev, merged, m, v = (torch.randn(n, device=dev, generator=g)
                              for _ in range(4))
        v = v.abs()
        for opt, sc in OPT_SCALARS.items():
            adam = opt == "fedadam"
            name = ("server_opt_step_flat_adam" if adam
                    else "server_opt_step_flat_mom")
            sc = np.asarray(sc, np.float32)
            plain = ref.reference_server_opt(prev, merged, m, v, sc,
                                             adam=adam)
            fresh = server_opt.server_opt_step_flat(prev, merged, m, v, sc,
                                                    adam=adam)
            m2, v2 = m.clone(), v.clone()
            inplace = server_opt.server_opt_step_flat(
                prev, merged, m2, v2, sc, adam=adam, m_out=m2, v_out=v2)
            for got in (fresh, inplace):
                for a, b in zip(got, plain):
                    if b is not None:
                        errs[name] = max(errs[name], max_err(a, b))


def check_kernels(dev):
    """Phase 3: correctness at several shapes, then timing at the main
    path's shapes.  Returns one record per kernel."""
    from repro_torch.core import transport
    from repro_torch.kernels import fedavg_agg, ref, server_opt, topk_quant
    g = torch.Generator(device=dev).manual_seed(0)
    N = 101_888
    errs = {k: 0.0 for k in REQUIRED}
    # 101,890: the scalar path (N % 4 != 0) at the main path's width
    for W, n in ((30, N), (2, N), (30, 101_890), (30, 1000), (3, 1000)):
        rows = torch.randn(W, n, device=dev, generator=g)
        w = torch.rand(W, device=dev, generator=g)
        w /= w.sum()
        server = torch.randn(n, device=dev, generator=g)
        e = max_err(fedavg_agg.fedavg_agg_flat(rows, w),
                    ref.reference_fedavg(rows, w))
        errs["fedavg_agg_flat"] = max(errs["fedavg_agg_flat"], e)
        for s in (0.1, 1.0):
            wvec = torch.cat([torch.full((1,), s, device=dev), w])
            plain = ref.reference_fedavg_mix(rows, w, server, wvec[0])
            fresh = fedavg_agg.fedavg_mix_flat(rows, wvec, server)
            srv = server.clone()
            inplace = fedavg_agg.fedavg_mix_flat(rows, wvec, srv, out=srv)
            if not torch.equal(inplace, fresh):
                raise AssertionError("fedavg_mix_flat: in-place differs")
            errs["fedavg_mix_flat"] = max(errs["fedavg_mix_flat"],
                                          max_err(fresh, plain))
    for n in (N, 1000):
        x = torch.randn(n, device=dev, generator=g) * 0.01
        scale = transport._int8_scale(x)
        for thresh in (transport.topk_threshold(x, max(1, n // 10), n),
                       torch.zeros((), device=dev)):
            q, r = topk_quant.topk_quant_encode(x, thresh, scale)
            qp, rp = ref.reference_topk_quant_encode(x, thresh, scale)
            e = max(max_err(q, qp), max_err(r, rp))
            errs["topk_quant_encode"] = max(errs["topk_quant_encode"], e)
            base = torch.randn(n, device=dev, generator=g)
            e = max_err(topk_quant.dequant_add(q, scale, base),
                        ref.reference_dequant_add(q, scale, base))
            errs["dequant_add"] = max(errs["dequant_add"], e)
    check_server_opt(dev, g, errs)
    torch.cuda.synchronize()
    limits = {"fedavg_agg_flat": 0.0, "fedavg_mix_flat": 1e-6,
              "topk_quant_encode": 0.0, "dequant_add": 0.0,
              "server_opt_step_flat_mom": 0.0,
              "server_opt_step_flat_adam": 0.0}
    for k, lim in limits.items():
        if not errs[k] <= lim:
            raise AssertionError(f"{k}: max |kernel - plain| = {errs[k]} "
                                 f"> {lim}")
        print(f"check {k}: max |kernel - plain| = {errs[k]:g} "
              f"(limit {lim:g})")

    # timing at the main path's shapes: W = 30 rows of N = 101,888
    timer = Timer(dev)
    W = 30
    rows = torch.randn(W, N, device=dev, generator=g)
    w = torch.rand(W, device=dev, generator=g)
    w /= w.sum()
    wvec = torch.cat([torch.full((1,), 0.1, device=dev), w])
    server = torch.randn(N, device=dev, generator=g)
    x = torch.randn(N, device=dev, generator=g) * 0.01
    scale = transport._int8_scale(x)
    thresh = transport.topk_threshold(x, N // 10, N)
    q, _ = topk_quant.topk_quant_encode(x, thresh, scale)
    base = torch.randn(N, device=dev, generator=g)
    scale_f = float(scale)
    prev, merged, m, v = (torch.randn(N, device=dev, generator=g)
                          for _ in range(4))
    v = v.abs()
    mom_sc = np.asarray(OPT_SCALARS["fedavgm"], np.float32)
    adam_sc = np.asarray(OPT_SCALARS["fedadam"], np.float32)
    cases = {
        "fedavg_agg_flat": (
            lambda: fedavg_agg.fedavg_agg_flat(rows, w),
            lambda: ref.reference_fedavg(rows, w),
            lambda: torch.mv(rows.t(), w),
            (W * N + W + N) * 4, 2 * W * N),
        "fedavg_mix_flat": (
            lambda: fedavg_agg.fedavg_mix_flat(rows, wvec, server,
                                               out=server),
            lambda: ref.reference_fedavg_mix(rows, w, server, wvec[0]),
            lambda: torch.addmv(server, rows.t(), w, beta=0.1),
            (W * N + W + 1 + 2 * N) * 4, 2 * W * N + 2 * N),
        "topk_quant_encode": (
            lambda: topk_quant.topk_quant_encode(x, thresh, scale),
            lambda: ref.reference_topk_quant_encode(x, thresh, scale),
            None,
            N * 4 + 8 + N + N * 4, 6 * N),
        "dequant_add": (
            lambda: topk_quant.dequant_add(q, scale, base),
            lambda: ref.reference_dequant_add(q, scale, base),
            lambda: torch.add(base, q, alpha=scale_f),
            N + 4 + N * 4 + N * 4, 2 * N),
        # the main path's call: state updated in place; 3 reads, 2 writes
        "server_opt_step_flat_mom": (
            lambda: server_opt.server_opt_step_flat(
                prev, merged, m, None, mom_sc, adam=False, m_out=m),
            lambda: ref.reference_server_opt(prev, merged, m, None, mom_sc,
                                             adam=False),
            None,
            5 * N * 4 + 16, 8 * N),
        # 4 reads, 3 writes
        "server_opt_step_flat_adam": (
            lambda: server_opt.server_opt_step_flat(
                prev, merged, m, v, adam_sc, adam=True, m_out=m, v_out=v),
            lambda: ref.reference_server_opt(prev, merged, m, v, adam_sc,
                                             adam=True),
            None,
            7 * N * 4 + 16, 13 * N),
    }
    sources = {"fedavg_agg_flat": ("fedavg_agg.cu", "fedavg_agg.py:68"),
               "fedavg_mix_flat": ("fedavg_agg.cu", "fedavg_agg.py:111"),
               "topk_quant_encode": ("topk_quant.cu", "topk_quant.py:60"),
               "dequant_add": ("topk_quant.cu", "topk_quant.py:89"),
               "server_opt_step_flat_mom": ("server_opt.cu",
                                            "fedavg_agg.py:208"),
               "server_opt_step_flat_adam": ("server_opt.cu",
                                             "fedavg_agg.py:195")}
    records = {}
    for name, (kern, plain, lib, n_bytes, flops) in cases.items():
        b_ms, b_by = bound_ms(n_bytes, flops)
        src, tpu = sources[name]
        ms, lib_ms, turns = timer.turns(kern, lib)
        records[name] = {
            "name": name, "route": "cuda", "ok": True,
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": 0, "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": timer(plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "turns": turns}
        print(f"time {name}: kernel {records[name]['ms']:.6f} ms, plain "
              f"{records[name]['plain_ms']:.4f} ms, library "
              f"{records[name]['library_ms']} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
    records["flash_attention"] = check_flash(dev, timer)
    records.update(check_wkv(dev, timer))
    # the comparison launches above do not count toward the paths' runs:
    # each run sets every counter to 0 before it starts
    return records


def fault_args(fault, k, v, window, cap, n_heads):
    """(k, v, window, softcap) with which a correct attention computes the
    faulty one named ``fault``; None leaves them as they are."""
    if fault == "no softcap":
        cap = 0.0
    elif fault == "no window":
        window = 0
    elif fault == "window + 32 keys":
        window = window + 32 if window else 0
    elif fault == "head map h % Kv":
        rep = n_heads // k.shape[2]
        k, v = k.repeat(1, 1, rep, 1), v.repeat(1, 1, rep, 1)
    elif fault is not None:
        raise ValueError(fault)
    return k, v, window, cap


@contextlib.contextmanager
def attention_fault(fault):
    """Send the model's B8 calls through the kernel with ``fault`` applied:
    a control, what the LM checks must catch."""
    from repro_torch.models import attention
    real = attention.fa

    def faulty(q, k, v, *, causal, window, softcap):
        k, v, window, softcap = fault_args(fault, k, v, window, softcap,
                                           q.shape[2])
        return real.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
    attention.fa = types.SimpleNamespace(flash_attention=faulty)
    try:
        yield
    finally:
        attention.fa = real


def flash_ratio(got, want) -> float:
    """max |got - want| / (rel |want| + abs) under FLASH_TOL: the check
    passes at <= 1."""
    rel, tol = FLASH_TOL[want.dtype]
    want = want.double()
    return float(((got.double() - want).abs() / (rel * want.abs() + tol))
                 .max())


def check_flash(dev, timer):
    """B8 against its plain version at every FLASH_SHAPES shape, and the
    plain version given FLASH_FAULTS' fault against the kernel (it must
    fail); kernel, plain and (at yi-9b's shape, which has no softcap)
    PyTorch's scaled_dot_product_attention timed at the first three.
    Returns the record of the gemma2-2b global shape, the others under
    "shapes"."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = []
    for i, (label, (B, S, H, Kv, D, dt, window, cap)) in enumerate(
            FLASH_SHAPES.items()):
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=g)
                   for n in (H, Kv, Kv))
        q, k, v = (q * FLASH_Q_SCALE).to(dt), k.to(dt), v.to(dt)
        kw = dict(window=window, softcap=cap)

        def kern():
            return fa.flash_attention(q, k, v, **kw)

        def plain():
            return ref.reference_flash_attention(q, k, v, **kw)
        got, want = kern(), plain()
        err, ratio = max_err(got, want), flash_ratio(got, want)
        rel, tol = FLASH_TOL[dt]
        rec = {"shape": label, "B": B, "S": S, "H": H, "Kv": Kv, "D": D,
               "dtype": str(dt), "window": window, "softcap": cap,
               "q_scale": FLASH_Q_SCALE, "max_abs_err": err,
               "max_abs_out": float(want.float().abs().max()),
               "limit": f"{rel:g} |plain| + {tol:g}", "ratio": ratio}
        print(f"check flash_attention {label}: max |kernel - plain| = "
              f"{err:g}, max |kernel - plain| / ({rel:g} |plain| + {tol:g})"
              f" = {ratio:.4f} (limit 1)")
        if not ratio <= 1.0:
            raise AssertionError(f"flash_attention {label}: |kernel - "
                                 f"plain| reaches {ratio} x the limit")
        fault = FLASH_FAULTS.get(label)
        if fault:
            fk, fv, fw, fc = fault_args(fault, k, v, window, cap, H)
            bad = ref.reference_flash_attention(q, fk, fv, window=fw,
                                                softcap=fc)
            rec["control"] = {"fault": fault,
                              "ratio": flash_ratio(got, bad)}
            # mha_chunked rounds P to bf16: a reading, not a check
            rec["mha_chunked_ratio"] = flash_ratio(attention.mha_chunked(
                q, k, v, window=window, softcap_val=cap), want)
            print(f"check flash_attention {label}: control ({fault}) "
                  f"ratio {rec['control']['ratio']:.4g}; mha_chunked "
                  f"(bf16 P) ratio {rec['mha_chunked_ratio']:.4g}")
            if not rec["control"]["ratio"] > 1.0:
                raise AssertionError(f"flash_attention {label}: the check "
                                     f"does not catch {fault}")
            del bad, fk, fv
        del got, want
        if i < 3:
            # q and o, k and v, each moved once
            n_bytes = 2 * B * S * (H + Kv) * D * q.element_size()
            flops = 4 * B * H * D * attention_pairs(S, window)
            b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
            lib = None
            if not cap and not window:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))

                def lib():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)
            ms, lib_ms, turns = timer.turns(kern, lib, N_TIMED_FLASH)
            rec.update(ms=ms, plain_ms=timer(plain, N_TIMED_FLASH),
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       flops=flops, turns=turns)
            print(f"time flash_attention {label}: kernel {rec['ms']:.4f} ms "
                  f"({flops / rec['ms'] / 1e9:.1f} TFLOP/s), plain "
                  f"{rec['plain_ms']:.4f} ms, library {lib_ms} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})")
        shapes.append(rec)
        del q, k, v
    main = shapes[0]
    return {"name": "flash_attention", "route": "cuda", "ok": True,
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:93",
            "launches": 0, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shapes": shapes}


def wkv_inputs(g, B, S, H, K, dt):
    """r, k, v, w, u of B9's check (see WKV_SHAPES), drawn on g's device."""
    dev = g.device
    r, k, v = ((0.5 * torch.randn(B, S, H, K, device=dev, generator=g))
               .to(dt) for _ in range(3))
    w = torch.exp(-torch.exp(-4.0 + 0.5 * torch.randn(
        B, S, H, K, device=dev, generator=g)))
    u = 0.5 + 0.1 * torch.randn(H, K, device=dev, generator=g)
    return r, k, v, w, u


def wkv_ops(B, S, H, K, C) -> int:
    """Operations B9's function needs (each multiply, add, exp and log one):
    per chunk and (b, h) the log decay and cumsum, the C(C-1)/2 decayed
    pairs over K channels, the bonus, y's intra-chunk and state terms, the
    decayed k and the (K, K) state update."""
    pairs = C * (C - 1) // 2
    per_chunk = (4 * C * K + 6 * pairs * K + 3 * C * K
                 + 2 * (C * (C + 1) // 2) * K + 2 * C * K + 2 * C * K * K
                 + 4 * C * K + K * K * (2 + 2 * C))
    return per_chunk * B * H * (S // C)


def wkv_sfu(B, S, H, K, C) -> int:
    """The exps and logs among ``wkv_ops``, which run on the SFUs: per chunk
    and (b, h) the C(C-1)/2 pairwise decays and, per position and channel,
    the log decay, exp(A) and the decayed k's exp; exp(Atot) per channel."""
    return (C * (C - 1) // 2 * K + 3 * C * K + K) * B * H * (S // C)


def wkv_bound(B, S, H, K, C, esize, with_state):
    """B9's least time on the card: bytes (r, k, v and y at ``esize``, w
    f32, u, and with the state form s0 read and the final state written,
    f32) at the HBM rate, its operations at the f32 rate and its exps and
    logs on the SFUs; the largest binds (the last two are operations)."""
    n_bytes = B * S * H * K * (4 * esize + 4) + H * K * 4
    if with_state:
        n_bytes += 2 * B * H * K * K * 4
    ops = wkv_ops(B, S, H, K, C)
    times = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "f32 rate": ops / F32_FLOPS * 1e3,
             "sfu": wkv_sfu(B, S, H, K, C) / SFU_RATE * 1e3}
    binds = max(times, key=times.get)
    return {"bound_ms": times[binds],
            "bound_by": "bytes" if binds == "bytes" else "operations",
            "binds": binds, "bytes_ms": times["bytes"],
            "ops_ms": times["f32 rate"], "sfu_ms": times["sfu"], "ops": ops,
            "n_bytes": n_bytes}


def wkv_ratio(got, want) -> float:
    """max |got - want| / (rel |want| + abs max|want|) under WKV_TOL: the
    check passes at <= 1."""
    rel, tol = WKV_TOL[want.dtype]
    want = want.double()
    d = (got.double() - want).abs()
    return float((d / (rel * want.abs() + tol * want.abs().max())).max())


def state_ratio(got, want) -> float:
    """max |got - want| / (WKV_STATE_TOL max|want|): passes at <= 1."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / (WKV_STATE_TOL * want.abs().max()))


def wkv_fault_state(fault, r, k, v, w, u, chunk, s0=None):
    """B9's plain version (``ref.reference_wkv_chunked``'s arithmetic)
    given ``fault``, a control that the checks must catch: the bonus u
    dropped; no state carried from chunk to chunk (each starts from s0);
    an inclusive cumsum (A_t includes lw_t); s0 ignored (a zero state); or
    the final state taken before the last chunk's update.  Returns (y in
    r's dtype, final state f32)."""
    if fault not in WKV_STATE_FAULTS:
        raise ValueError(fault)
    f32 = torch.float32
    B, S, H, K = r.shape
    chunk = min(chunk, S)
    uf = (torch.zeros_like(u) if fault == "u = 0" else u).to(f32)
    uf = uf[None, :, None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)[..., None]
    start = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
             if s0 is None or fault == "s0 ignored" else s0.to(f32))
    state = before = start
    ys = []
    for c0 in range(0, S, chunk):
        if fault == "no carry":
            state = start
        rb, kb, vb, wb = (t[:, c0:c0 + chunk].transpose(1, 2).to(f32)
                          for t in (r, k, v, w))
        lw = torch.log(torch.clamp(wb, 1e-12, 1.0))
        A = torch.cumsum(lw, dim=2)
        if fault != "inclusive cumsum":
            A = A - lw
        Atot = A[:, :, -1] + lw[:, :, -1]
        D = A[:, :, :, None, :] - A[:, :, None, :, :] - lw[:, :, None, :, :]
        E = torch.where(tri, torch.exp(D), 0.0)
        y = torch.einsum("bhtk,bhtik,bhik->bhti", rb, E, kb) @ vb + \
            torch.sum(rb * uf * kb, dim=-1)[..., None] * vb
        y = y + (rb * torch.exp(A)) @ state
        kdec = kb * torch.exp(Atot[:, :, None, :] - A - lw)
        before = state
        state = state * torch.exp(Atot)[..., None] + \
            kdec.transpose(2, 3) @ vb
        ys.append(y.transpose(1, 2))
    if fault == "final state before the last chunk's update":
        state = before
    return torch.cat(ys, dim=1).to(r.dtype), state


def wkv_fault(fault, r, k, v, w, u, chunk):
    """y of B9's plain version from a zero state given ``fault`` (one of
    WKV_FAULTS)."""
    return wkv_fault_state(fault, r, k, v, w, u, chunk)[0]


def check_wkv(dev, timer):
    """B9 against its plain version at every WKV_SHAPES shape (y, and in
    the state form the final state too, with s0 left as it was), and each
    fault of the plain version against the kernel (each must fail the
    limit); at the rwkv6 shapes kernel and plain version timed, and in the
    y form also the sequential ``reference_wkv`` (a reading; bf16 timed).
    No single PyTorch call computes WKV: no library time.  Returns the
    records "wkv" (ops.wkv's form, the bf16 chunk-16 shape) and
    "wkv_state" (the model's, the bf16 chunk-64 shape), each with its
    shapes under "shapes"."""
    from repro_torch.kernels import ref, rwkv6_kernel
    g = torch.Generator(device=dev).manual_seed(2)
    shapes = {False: [], True: []}
    for label, (B, S, H, K, C, dt, with_state) in WKV_SHAPES.items():
        r, k, v, w, u = wkv_inputs(g, B, S, H, K, dt)
        s0 = (1.25 * torch.randn(B, H, K, K, device=dev, generator=g)
              if with_state else None)

        def kern():
            if with_state:
                return rwkv6_kernel.wkv_state(r, k, v, w, u, s0, chunk=C)
            return rwkv6_kernel.wkv(r, k, v, w, u, chunk=C), None

        def plain():
            if with_state:
                return ref.reference_wkv_chunked(r, k, v, w, u, chunk=C,
                                                 s0=s0, return_state=True)
            return ref.reference_wkv_chunked(r, k, v, w, u, chunk=C), None
        s0_before = None if s0 is None else s0.clone()
        (got, got_st), (want, want_st) = kern(), plain()
        torch.cuda.synchronize()

        def against(y, st):
            x = wkv_ratio(got, y)
            return max(x, state_ratio(got_st, st)) if with_state else x
        faults = WKV_STATE_FAULTS if with_state else WKV_FAULTS
        rel, tol = WKV_TOL[dt]
        rec = {"shape": label, "B": B, "S": S, "H": H, "K": K, "chunk": C,
               "dtype": str(dt), "state_form": with_state,
               "max_abs_err": max_err(got, want),
               "max_abs_out": float(want.float().abs().max()),
               "limit": f"{rel:g} |plain| + {tol:g} max|plain|",
               "ratio": wkv_ratio(got, want),
               "controls": {f: against(*wkv_fault_state(f, r, k, v, w, u, C,
                                                        s0))
                            for f in faults}}
        state_note = ""
        if with_state:
            rec.update(state_ratio=state_ratio(got_st, want_st),
                       state_max_abs_err=max_err(got_st, want_st),
                       max_abs_state=float(want_st.abs().max()),
                       state_limit=f"{WKV_STATE_TOL:g} max|plain|",
                       s0_unchanged=torch.equal(s0, s0_before))
            state_note = (f"; final state ratio {rec['state_ratio']:.4f} to "
                          f"{rec['state_limit']} (max |state| "
                          f"{rec['max_abs_state']:.4g}), s0 unchanged "
                          f"{rec['s0_unchanged']}")
        print(f"check wkv {label}: max |kernel - plain| = "
              f"{rec['max_abs_err']:g} (max |plain| "
              f"{rec['max_abs_out']:.4g}), ratio {rec['ratio']:.4f} to "
              f"{rec['limit']} (limit 1){state_note}; controls " + ", ".join(
                  f"{f} {x:.4g}" for f, x in rec["controls"].items()))
        if not rec["ratio"] <= 1.0:
            raise AssertionError(f"wkv {label}: |kernel - plain| reaches "
                                 f"{rec['ratio']} x the limit")
        if with_state and not rec["state_ratio"] <= 1.0:
            raise AssertionError(f"wkv {label}: the final state is off by "
                                 f"{rec['state_ratio']} x its limit")
        if with_state and not rec["s0_unchanged"]:
            raise AssertionError(f"wkv {label}: the kernel wrote s0")
        for f, x in rec["controls"].items():
            if not x > 1.0:
                raise AssertionError(f"wkv {label}: the check does not "
                                     f"catch {f} ({x})")
        if S == 8192:
            if not with_state:
                seq = ref.reference_wkv(r, k, v, w, u)
                rec["plain_vs_sequential"] = max_err(want, seq)
                print(f"check wkv {label}: max |plain - reference_wkv| = "
                      f"{rec['plain_vs_sequential']:g} (a reading)")
                del seq
            rec.update(wkv_bound(B, S, H, K, C, r.element_size(),
                                 with_state))
            rec.update(ms=timer(kern, N_TIMED_WKV),
                       plain_ms=timer(plain, N_TIMED_WKV), library_ms=None)
            if dt == torch.bfloat16 and not with_state:
                rec["reference_wkv_ms"] = timer(
                    lambda: ref.reference_wkv(r, k, v, w, u), 3)
            print(f"time wkv {label}: kernel {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms, reference_wkv "
                  f"{rec.get('reference_wkv_ms')} ms, bound "
                  f"{rec['bound_ms']:.4f} ms ({rec['binds']}; bytes "
                  f"{rec['bytes_ms']:.4f}, f32 rate {rec['ops_ms']:.4f}, "
                  f"SFUs {rec['sfu_ms']:.4f} ms)")
        shapes[with_state].append(rec)
        del r, k, v, w, s0, got, want, got_st, want_st
    out = {}
    for name, with_state in (("wkv", False), ("wkv_state", True)):
        main = shapes[with_state][0]
        out[name] = {
            "name": name, "route": "cuda", "ok": True,
            "source": "src/repro_torch/kernels/csrc/wkv.cu",
            "replaces": "src/repro/kernels/rwkv6_kernel.py:77",
            "launches": 0, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "shapes": shapes[with_state]}
    return out


class Setups:
    """One setup per (phase, model, make_setup extras) and device; every
    device starts from the card's initial weights of that model."""

    def __init__(self, dev):
        self.dev = dev
        self._made = {}
        self._weights0 = {}

    def get(self, spec, device):
        from repro_torch.configs.paper_cnn import MNIST_CNN
        from repro_torch import core
        table, kw = PHASES[spec["phase"]]
        key = (spec["phase"], spec["model"],
               tuple(sorted(spec["setup_kw"].items())), str(device))
        if key not in self._made:
            w0 = self._weights0.get((spec["phase"], spec["model"]))
            setup = core.make_setup(
                getattr(core, table)["mnist_even"], cfg=MNIST_CNN,
                model=spec["model"], seed=0, **kw, **spec["setup_kw"],
                weights0=w0, device=device)
            if w0 is None:
                self._weights0[(spec["phase"], spec["model"])] = {
                    k: v.cpu().numpy() for k, v in setup.weights0.items()}
            self._made[key] = setup
        return self._made[key]


def drive(key, setup, report):
    """One run on the card, every launch counter set to 0 just before it
    and read just after."""
    from repro_torch.core import run_fl
    spec = RUNS[key]
    counters = launch_counters()
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = run_fl(setup, epochs_per_round=EPOCHS, max_rounds=spec["rounds"],
               **spec["run_kw"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: counters[k][k] for k in counters}
    rounds = h[-1].version
    report[key] = {"history": [vars(p) for p in h], "launches": launches,
                   "wall_s": wall, "s_per_round": wall / max(rounds, 1)}
    print(f"run {key}: {rounds} rounds, final accuracy "
          f"{h[-1].accuracy:.4f}, {wall / max(rounds, 1):.4f} s per round, "
          f"launches {launches}")
    if rounds != spec["rounds"]:
        raise AssertionError(f"{key}: {rounds} rounds, not {spec['rounds']}")
    if not all(np.isfinite(p.accuracy) for p in h):
        raise AssertionError(f"{key}: non-finite accuracy")
    opt_ctr = OPT_COUNTER.get(spec["run_kw"].get("server_opt"))
    for ctr in ("mom", "adam"):
        want = rounds if ctr == opt_ctr else 0
        if launches[ctr] != want:
            raise AssertionError(f"{key}: {launches[ctr]} {ctr} optimizer "
                                 f"steps, expected one per merge ({want})")


def compare_with_cpu(key, setup, report):
    """The run again on the CPU from the same initial weights: every
    non-accuracy field equal, accuracy within ``gap_bounds``."""
    from repro_torch.core import run_fl
    spec = RUNS[key]
    h = run_fl(setup, epochs_per_round=EPOCHS, max_rounds=spec["rounds"],
               **spec["run_kw"])
    gpu = report[key]["history"]
    if len(gpu) != len(h):
        raise AssertionError(f"{key}: {len(gpu)} points on the card, "
                             f"{len(h)} on the CPU")
    for g, c in zip(gpu, h):
        for f in FIELDS:
            if g[f] != getattr(c, f):
                raise AssertionError(f"{key}: {f} {g[f]} on the card, "
                                     f"{getattr(c, f)} on the CPU")
    a_gpu = np.array([g["accuracy"] for g in gpu])
    a_cpu = np.array([c.accuracy for c in h])
    got = (float(np.abs(a_gpu - a_cpu).max()),
           float(abs(a_gpu[-5:].mean() - a_cpu[-5:].mean())))
    bounds = gap_bounds(key)
    report[key].update(cpu_accuracy=a_cpu.tolist(), cpu_gaps=got,
                       gap_bounds=bounds)
    print(f"cpu {key}: history fields equal; accuracy gap {got[0]:.4f} "
          f"at worst point, {got[1]:.4f} in the last-5 mean (limits "
          f"{bounds})")
    if any(g > b for g, b in zip(got, bounds)):
        raise AssertionError(f"{key}: card vs CPU accuracy gaps {got} "
                             f"above {bounds}")


def run_phase(phase, setups, report):
    """Phases 4-6: every run of ``phase`` on the card, then the raw ones
    on the CPU."""
    keys = [k for k, s in RUNS.items() if s["phase"] == phase]
    for key in keys:
        drive(key, setups.get(RUNS[key], setups.dev), report)
    if phase == "main":
        setup = setups.get(RUNS["raw/sync"], setups.dev)
        n_params = sum(p.numel() for p in setup.weights0.values())
        if n_params != 101_770:
            raise AssertionError(f"expected 101,770 MLP parameters, got "
                                 f"{n_params}")
        final = report["raw/sync"]["history"][-1]["accuracy"]
        if final < 0.50:
            raise AssertionError(f"raw/sync final accuracy {final} < 0.50")
    if phase == "cnn":
        setup = setups.get(RUNS["cnn/sync/fedavg"], setups.dev)
        n_params = sum(p.numel() for p in setup.weights0.values())
        if n_params != 28_938:
            raise AssertionError(f"expected 28,938 CNN parameters, got "
                                 f"{n_params}")
        best = max(p["accuracy"] for p in report["cnn/sync/fedadam"]
                   ["history"])
        if best < 0.8:
            raise AssertionError(f"cnn/sync/fedadam best accuracy {best} "
                                 f"< 0.8")
    for key in keys:
        if RUNS[key]["compare"]:
            compare_with_cpu(key, setups.get(RUNS[key], "cpu"), report)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _rel_gap(got, want) -> float:
    """max |got - want| / max |want| over logits, in f32."""
    got, want = got.float(), want.float().to(got.device)
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-3))


def _prefill(models, params, cfg, prompt, max_len):
    """(last-token logits, decode state, seconds) of one prefill."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = models.prefill_step(params, {"tokens": prompt}, cfg=cfg,
                                        max_len=max_len)
    torch.cuda.synchronize()
    return logits, state, time.perf_counter() - t0


def _decode(models, params, cfg, logits, state, start, n_steps,
            next_tokens=None):
    """``n_steps`` decode steps from position ``start`` (``state`` is
    written in place), fed the greedy token of the previous logits or, if
    given, ``next_tokens[:, i]``.  Returns (per-step logits, fed tokens,
    seconds)."""
    steps, fed = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        tok = (logits[:, -1].argmax(-1, keepdim=True) if next_tokens is None
               else next_tokens[:, i:i + 1])
        fed.append(tok)
        logits, state = models.serve_step(params, state, tok, start + i,
                                          cfg=cfg)
        steps.append(logits[:, 0])
    torch.cuda.synchronize()
    return steps, torch.cat(fed, dim=1), time.perf_counter() - t0


def _greedy_run(models, params, cfg, prompt, n_steps, next_tokens=None):
    """Prefill ``prompt`` then ``n_steps`` decode steps (see ``_decode``).
    Returns (prefill logits, per-step logits, fed tokens, prefill seconds,
    decode seconds)."""
    S = prompt.shape[1]
    logits, state, t_prefill = _prefill(models, params, cfg, prompt,
                                        S + n_steps)
    steps, fed, t_decode = _decode(models, params, cfg, logits, state, S,
                                   n_steps, next_tokens)
    return logits[:, 0], steps, fed, t_prefill, t_decode


def run_lm(dev, rec):
    """Phase 7: gemma2-2b serving at full width and depth through B8;
    fills ``rec`` and returns B8's launches on the main path."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import analytics
    from repro_torch.models import transformer
    cfg = configs.get_config(LM_ARCH).replace(attn_impl="pallas")
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    batch = next(lm.synthetic_token_batches(
        vocab=cfg.vocab_size, batch=LM_BATCH, seq_len=LM_PROMPT + LM_DECODE,
        seed=0))
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    prompt = tokens[:, :LM_PROMPT]
    max_len = LM_PROMPT + LM_DECODE
    # warm-up (cuBLAS handles, the allocator's pools): one prefill
    models.prefill_step(params, {"tokens": prompt}, cfg=cfg, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counters at 0, prefill, LM_DECODE greedy steps
    zero_counters()
    first, steps, fed, t_prefill, t_decode = _greedy_run(
        models, params, cfg, prompt, LM_DECODE)
    after = fa.LAUNCHES["flash"]
    wgmma = fa.LAUNCHES["flash_wgmma"]
    peak = torch.cuda.max_memory_allocated(dev)
    rec.update({
        "arch": LM_ARCH, "n_params": n_params,
        "n_params_model": cfg.n_params(), "batch": LM_BATCH,
        "prompt": LM_PROMPT, "decode_steps": LM_DECODE,
        "cut_from": "SHAPES['prefill_32k']: batch 32 -> 2, seq_len "
                    "32768 -> 8192",
        "launches": {k: c[k] for k, c in launch_counters().items()},
        "prefill_s": t_prefill,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t_prefill,
        "decode_s_per_step": t_decode / LM_DECODE,
        "max_memory_allocated": peak})
    mf = analytics.model_flops(LM_ARCH, "prefill_32k", batch=LM_BATCH,
                               seq_len=LM_PROMPT)["model_flops_total"]
    rec.update(prefill_model_flops=mf,
               prefill_mfu=mf / t_prefill / BF16_FLOPS)
    print(f"lm {LM_ARCH}: {n_params:,} parameters; prefill {LM_BATCH} x "
          f"{LM_PROMPT} tokens in {t_prefill:.4f} s "
          f"({rec['prefill_tokens_per_s']:.1f} tokens/s, model FLOPs "
          f"{mf:.4g} = {rec['prefill_mfu']:.4f} of {BF16_FLOPS:.3g} FLOP/s); "
          f"decode {rec['decode_s_per_step']:.4f} s per step; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; B8 launches "
          f"{after}, {wgmma} of them the tensor-core body")
    # check 1: B8 once per layer in prefill, never in decode
    if after != cfg.n_layers:
        raise AssertionError(f"B8 launched {after} times in one prefill and "
                             f"{LM_DECODE} decode steps, expected "
                             f"{cfg.n_layers} (one per layer, none in decode)")
    # gemma2-2b is bf16 at head_dim 256: every launch takes the wgmma body
    if wgmma != after:
        raise AssertionError(f"only {wgmma} of B8's {after} prefill launches "
                             f"ran the tensor-core body")
    if not all(torch.isfinite(x).all() for x in [first] + steps):
        raise AssertionError("non-finite logits")

    # check 2: the same prefill through mha_chunked ("xla")
    t0 = time.perf_counter()
    xla, _ = models.prefill_step(params, {"tokens": prompt},
                                 cfg=cfg.replace(attn_impl="xla"),
                                 max_len=max_len)
    torch.cuda.synchronize()
    rec["xla_prefill_s"] = time.perf_counter() - t0
    xla = xla[:, 0]
    print(f"lm: mha_chunked prefill {rec['xla_prefill_s']:.4f} s")

    # check 3: the last decode steps against a full forward over the
    # prompt and the fed tokens (8224 positions: a ragged last tile)
    seq = torch.cat([prompt, fed], dim=1)

    def forward_tail():
        h, _, _ = models.forward(params, cfg, tokens=seq)
        return transformer.logits_from_hidden(
            params, cfg, h[:, -LM_CHECKED_STEPS:])

    def gaps(fault):
        with attention_fault(fault):
            pre, _ = models.prefill_step(params, {"tokens": prompt},
                                         cfg=cfg, max_len=max_len)
            full = forward_tail()
        return {"kernel_vs_xla": [_rel_gap(pre[:, 0], xla)],
                "decode_vs_forward": [
                    _rel_gap(steps[-LM_CHECKED_STEPS + i], full[:, i])
                    for i in range(LM_CHECKED_STEPS)]}
    sound = {"kernel_vs_xla": [_rel_gap(first, xla)]}
    full = forward_tail()
    sound["decode_vs_forward"] = [
        _rel_gap(steps[-LM_CHECKED_STEPS + i], full[:, i])
        for i in range(LM_CHECKED_STEPS)]
    del full
    controls = {f: gaps(f) for f in LM_FAULTS}
    del params

    # check 4: full width, one local/global pair, card against CPU
    cut = cfg.replace(n_layers=LM_CUT["n_layers"])
    card = models.init_params(torch.Generator(device=dev).manual_seed(1),
                              cut, device=dev)
    cpu = _tree_to(card, "cpu")
    p_len, n_dec = LM_CUT["prompt"], LM_CUT["decode"]
    toks = tokens[:, :p_len + n_dec]

    def cut_run(prm, d):
        t = toks.to(d)
        f0, st, _, _, _ = _greedy_run(models, prm, cut, t[:, :p_len], n_dec,
                                      next_tokens=t[:, p_len:])
        return [f0] + st
    want = cut_run(cpu, "cpu")
    sound["card_vs_cpu"] = [_rel_gap(a.cpu(), b)
                            for a, b in zip(cut_run(card, dev), want)]
    for f in LM_FAULTS:
        with attention_fault(f):
            controls[f]["card_vs_cpu"] = [
                _rel_gap(a.cpu(), b) for a, b in zip(cut_run(card, dev), want)]

    rec["gaps"], rec["controls"], rec["limits"] = sound, controls, LM_LIMITS
    for check, limit in LM_LIMITS.items():
        print(f"lm check {check}: gap {max(sound[check]):.5f} (limit "
              f"{limit}); controls " + ", ".join(
                  f"{f} {max(controls[f][check]):.5f}" for f in LM_FAULTS))
        if not max(sound[check]) <= limit:
            raise AssertionError(f"lm {check}: gaps {sound[check]} > "
                                 f"{limit}")
        for f in LM_CAUGHT[check]:
            if not max(controls[f][check]) > limit:
                raise AssertionError(f"lm {check}: the check does not catch "
                                     f"{f} ({controls[f][check]})")
    return after


def _tree_clone(tree):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def run_rwkv(dev, rec):
    """Phase 8: rwkv6-3b serving at full width and depth (the prefill's
    blocks run B9's state form, decode the plain ``wkv_step``), then B9 on
    the prefill's own layer-0 streams, through ``ops.wkv`` and in the
    state form.  Fills ``rec`` and returns B9's launches on the model's
    path (prefill and decode) and on ``ops.wkv``'s."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    from repro_torch.kernels import ops, rwkv6_kernel
    from repro_torch.launch import analytics
    from repro_torch.models import layers, rwkv6, transformer
    cfg = configs.get_config(RWKV_ARCH)
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    if n_params != RWKV_N_PARAMS:
        raise AssertionError(f"{RWKV_ARCH}: {n_params:,} parameters, the "
                             f"JAX init tree has {RWKV_N_PARAMS:,}")
    batch = next(lm.synthetic_token_batches(
        vocab=cfg.vocab_size, batch=RWKV_BATCH,
        seq_len=RWKV_PROMPT + RWKV_DECODE, seed=0))
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    prompt = tokens[:, :RWKV_PROMPT]
    max_len = RWKV_PROMPT + RWKV_DECODE
    models.prefill_step(params, {"tokens": prompt}, cfg=cfg,
                        max_len=max_len)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the model's path: counters at 0, prefill, RWKV_DECODE greedy steps;
    # the control's state (WKV zeroed after the prefill) is copied aside,
    # since decode writes the state in place
    zero_counters()
    logits, state, t_prefill = _prefill(models, params, cfg, prompt, max_len)
    after_prefill = {k: c[k] for k, c in launch_counters().items()}
    zeroed = _tree_clone(state)
    zeroed["tm"]["wkv"].zero_()
    steps, fed, t_decode = _decode(models, params, cfg, logits, state,
                                   RWKV_PROMPT, RWKV_DECODE)
    launches = {k: c[k] for k, c in launch_counters().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    mf = analytics.model_flops(RWKV_ARCH, "prefill_32k", batch=RWKV_BATCH,
                               seq_len=RWKV_PROMPT)["model_flops_total"]
    rec.update({
        "arch": RWKV_ARCH, "n_params": n_params,
        "n_params_model": cfg.n_params(), "batch": RWKV_BATCH,
        "prompt": RWKV_PROMPT, "decode_steps": RWKV_DECODE,
        "cut_from": "SHAPES['prefill_32k']: batch 32 -> 2, seq_len "
                    "32768 -> 8192",
        "launches_after_prefill": after_prefill, "launches": launches,
        "prefill_s": t_prefill,
        "prefill_tokens_per_s": RWKV_BATCH * RWKV_PROMPT / t_prefill,
        "decode_s_per_step": t_decode / RWKV_DECODE,
        "max_memory_allocated": peak, "prefill_model_flops": mf,
        "prefill_mfu": mf / t_prefill / BF16_FLOPS})
    print(f"rwkv {RWKV_ARCH}: {n_params:,} parameters; prefill "
          f"{RWKV_BATCH} x {RWKV_PROMPT} tokens in {t_prefill:.4f} s "
          f"({rec['prefill_tokens_per_s']:.1f} tokens/s, model FLOPs "
          f"{mf:.4g} = {rec['prefill_mfu']:.4f} of {BF16_FLOPS:.3g} FLOP/s); "
          f"decode {rec['decode_s_per_step']:.4f} s per step; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; launches {launches}")
    # B9 once per block in the prefill, and nothing of ours in decode
    want = {k: 0 for k in launches}
    want["wkv"] = cfg.n_layers
    if after_prefill != want:
        raise AssertionError(f"the {RWKV_ARCH} prefill launched "
                             f"{after_prefill}, expected {want}")
    if launches != want:
        raise AssertionError(f"the {RWKV_ARCH} decode steps launched "
                             f"kernels of ours: {launches} after the "
                             f"prefill's {after_prefill}")
    if not all(torch.isfinite(x).all() for x in [logits] + steps):
        raise AssertionError("non-finite logits")

    # check 1: the last decode steps against a full forward over the
    # prompt and the fed tokens; the control decodes the same tokens from
    # the zeroed state
    seq = torch.cat([prompt, fed], dim=1)
    zero_counters()
    h, _, _ = models.forward(params, cfg, tokens=seq)
    rec["forward_launches"] = {k: c[k] for k, c in launch_counters().items()}
    if rec["forward_launches"] != want:
        raise AssertionError(f"the forward over {seq.shape[1]} positions "
                             f"launched {rec['forward_launches']}, expected "
                             f"{want}")
    full = transformer.logits_from_hidden(params, cfg,
                                          h[:, -LM_CHECKED_STEPS:])
    del h
    ctrl, _, _ = _decode(models, params, cfg, logits, zeroed, RWKV_PROMPT,
                         RWKV_DECODE, next_tokens=fed)

    def tail_gaps(st):
        return [_rel_gap(st[-LM_CHECKED_STEPS + i], full[:, i])
                for i in range(LM_CHECKED_STEPS)]
    sound = {"decode_vs_forward": tail_gaps(steps)}
    controls = {"decode_vs_forward": tail_gaps(ctrl)}
    del full, state, zeroed

    # check 3: B9 through ops.wkv (chunk 16, zero state) on layer 0's
    # streams of the prefill (time_mix's own r, k, v, w and bonus), against
    # the y of the plain wkv_chunked; the path's launches counted alone
    p0 = transformer._index(params["blocks"], 0)
    tm = p0["rwkv"]["tm"]
    x0 = layers.rmsnorm(p0["ln1"], layers.embed(
        params["embed"], prompt, scale=cfg.post_block_norm))
    r, k, v, w, _ = rwkv6._streams(tm, x0, cfg.n_heads, cfg.ssm_head_dim)
    model_y, model_st = rwkv6.wkv_chunked(r, k, v, w, tm["bonus"])
    zero_counters()
    b9_y = ops.wkv(r, k, v, w, tm["bonus"])
    torch.cuda.synchronize()
    b9_launches = {n: c[n] for n, c in launch_counters().items()}
    b9 = {"launches": b9_launches, "ratio": wkv_ratio(b9_y, model_y),
          "max_abs_err": max_err(b9_y, model_y),
          "max_abs_out": float(model_y.float().abs().max()),
          "control": {"no carry": wkv_ratio(wkv_fault(
              "no carry", r, k, v, w, tm["bonus"], 16), model_y)}}
    print(f"rwkv check b9_on_model_streams: max |ops.wkv - wkv_chunked| = "
          f"{b9['max_abs_err']:g} (max |y| {b9['max_abs_out']:.4g}), ratio "
          f"{b9['ratio']:.4f} (limit 1); control no carry "
          f"{b9['control']['no carry']:.4g}; launches {b9_launches}")
    if b9_launches["wkv"] != 1 or sum(b9_launches.values()) != 1:
        raise AssertionError(f"ops.wkv launched {b9_launches}, expected B9 "
                             f"once")
    if not b9["ratio"] <= 1.0:
        raise AssertionError(f"B9 on the model's streams: {b9['ratio']} x "
                             f"the limit")
    if not b9["control"]["no carry"] > 1.0:
        raise AssertionError("B9 on the model's streams: the check does not "
                             "catch no carry")
    # and in the form time_mix runs (chunk 64, the final state returned),
    # y and state against the plain wkv_chunked's
    st_y, st_st = rwkv6_kernel.wkv_state(r, k, v, w, tm["bonus"])
    b9["state_form"] = {"ratio": wkv_ratio(st_y, model_y),
                        "state_ratio": state_ratio(st_st, model_st)}
    print(f"rwkv check b9_state_on_model_streams: y ratio "
          f"{b9['state_form']['ratio']:.4f}, final state ratio "
          f"{b9['state_form']['state_ratio']:.4f} (limits 1)")
    if not max(b9["state_form"].values()) <= 1.0:
        raise AssertionError(f"B9's state form on the model's streams: "
                             f"{b9['state_form']} x the limits")
    del params, r, k, v, w, model_y, model_st, b9_y, st_y, st_st, x0, p0, tm

    # check 2: full width, two layers, card against CPU
    cut = cfg.replace(n_layers=RWKV_CUT["n_layers"])
    card = models.init_params(torch.Generator(device=dev).manual_seed(1),
                              cut, device=dev)
    cpu = _tree_to(card, "cpu")
    p_len, n_dec = RWKV_CUT["prompt"], RWKV_CUT["decode"]
    toks = tokens[:, :p_len + n_dec]

    def cut_run(prm, d, zero_wkv=False):
        t = toks.to(d)
        lg, st, _ = _prefill(models, prm, cut, t[:, :p_len], p_len + n_dec)
        if zero_wkv:
            st["tm"]["wkv"].zero_()
        out, _, _ = _decode(models, prm, cut, lg, st, p_len, n_dec,
                            next_tokens=t[:, p_len:])
        return [lg[:, 0]] + out
    want = cut_run(cpu, "cpu")
    sound["card_vs_cpu"] = [_rel_gap(a.cpu(), b)
                            for a, b in zip(cut_run(card, dev), want)]
    controls["card_vs_cpu"] = [_rel_gap(a.cpu(), b) for a, b in
                               zip(cut_run(card, dev, zero_wkv=True), want)]

    rec.update(gaps=sound, controls=controls, limits=RWKV_LIMITS,
               b9_on_model_streams=b9)
    for check, limit in RWKV_LIMITS.items():
        print(f"rwkv check {check}: gap {max(sound[check]):.5f} (limit "
              f"{limit}); control (WKV state zeroed after the prefill) "
              f"{max(controls[check]):.5f}")
        if not max(sound[check]) <= limit:
            raise AssertionError(f"rwkv {check}: gaps {sound[check]} > "
                                 f"{limit}")
        if not max(controls[check]) > limit:
            raise AssertionError(f"rwkv {check}: the check does not catch "
                                 f"a zeroed WKV state ({controls[check]})")
    return launches["wkv"], b9_launches["wkv"]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    print(f"capability: {cap}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise AssertionError(f"needs compute capability (9, 0), got {cap}")

    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().relative_to(ROOT)})")
    print(_build.build_log.strip())
    ptxas = ptxas_report(_build.build_log, "flash_wgmma")
    if not ptxas:
        raise AssertionError("no -Xptxas -v report of flash_wgmma in "
                             f"{_build.LOG_NAME} beside the library")
    for kern, info in ptxas.items():
        print(f"ptxas {kern}: {info}")
        if info.get("spill_stores") or info.get("spill_loads"):
            raise AssertionError(f"{kern} spills registers: {info}")

    records = check_kernels(dev)
    runs, lm_rec, rwkv_rec = {}, {}, {}
    try:
        setups = Setups(dev)
        for phase in PHASES:
            t0 = time.perf_counter()
            run_phase(phase, setups, runs)
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        for name, (ctr, keys) in REQUIRED.items():
            for key in keys:
                if runs[key]["launches"][ctr] < 1:
                    raise AssertionError(f"{name} never launched in {key}")
            records[name]["launches"] = sum(r["launches"][ctr]
                                            for r in runs.values())
        t0 = time.perf_counter()
        records["flash_attention"]["launches"] = run_lm(dev, lm_rec)
        print(f"phase lm: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        (records["wkv_state"]["launches"],
         records["wkv"]["launches"]) = run_rwkv(dev, rwkv_rec)
        print(f"phase rwkv: {time.perf_counter() - t0:.1f} s")
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        seconds = time.perf_counter() - t_script
        (out / "chip_smoke_report.json").write_text(json.dumps(
            {"card": card, "seconds": seconds,
             "kernels": list(records.values()), "runs": runs,
             "lm": lm_rec, "rwkv": rwkv_rec}, indent=1))
    print(f"script: {seconds:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
