#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. Card identity: ``nvidia-smi`` name and power limit; compute capability
   (9, 0) is required.
2. Build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   and print nvcc's ``-Xptxas -v`` report; B8's tensor-core body
   (``flash_wgmma``) must be there at every head dim of ``WGMMA_DIMS``
   and must not spill registers.
3. Kernels: hold each kernel against its plain PyTorch version on the
   card at the paths' shapes (fedavg W = 30, 2 and 1, N = 101,888, the
   scalar path's 101,890, a ragged N = 1000 and the paper phase's
   ``PAPER_N`` = 34,304 at W = 10, 3 and 1: the aggregate and the mix
   bit-exact; the fused merge and server-optimizer step
   ``merge_opt_flat`` at every W of ``MERGE_W`` and N of ``MERGE_N``, the
   aggregate and the mix at each ``MERGE_S``, each optimizer's scalars,
   bit for bit in new, m' and v', fresh and aliased as the merge path
   calls it (out = server = prev, m_out = m, v_out = v), an inf in a
   zero-weight row giving NaN as the chain does, a flat state's alpha 1
   merge never reading its server buffer, and each ``MERGE_FAULTS``
   control failing; encode and decode at N = 101,888 and
   1000, bit-exact; that ``t / 127.0`` on the card is ``t`` times
   fl32(1/127), as the plain chain's scale assumes; B3's redesign
   ``ef_encode`` (the whole EF top-k+int8
   encode, one cluster launch; above one cluster's size the grid form,
   three launches: a pass over x, the select, a second pass) on every
   ``EF_CASES`` input and the select
   alone on each top-k one, bit for bit in every output (q or recon,
   residual, threshold, scale, kept count), the grid form's cases also
   against the staged plain version and (below the pod width) each of
   their launches alone against its plain stage (``check_ef_stages``),
   with each ``EF_FAULTS``
   control failing (a threshold one rank lower, fmaxf for the
   NaN-propagating max, kept with ``>``); the grid form timed at
   ``GRID_TIMED`` and at the pod width (also with x = a alone, the pod
   round's call); B4's redesign
   ``dequant_add_rows`` (one merge's decodes into the row buffer) bit for
   bit at ``ROWS_W`` decodes with stale rows zeroed; B4's redesign around
   its path (``check_decode_fused``): ``ef_encode`` writing the decode
   ``b + q * scale`` itself (a quantised downlink's encode) and
   ``dequant_mix`` (async_delta's decode and delta merge in one launch),
   each at every ``DEC_SIZES`` width bit for bit against the chain it
   replaces (the encode, then B4; B4, ``torch.stack``, B1) and its plain
   version, launches under its own counter, each ``DEC_FAULTS`` control
   (an FMA-contracted decode; the delta merge reading row 1 as the
   decoded row) failing, both timed at ``DEC_TIMED`` in turns with the
   chain (chain, new, new, chain); the server-optimizer
   step at N = 101,888, 29,184 (the
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
   timed too, and 3 after one warm-up for their plain versions; kernel
   and library in turns: library, kernel, kernel, library), beside the
   least time the card could take; B1 at W = 1, 2 and 30 in turns with ``torch.addmv``; the fused merge at the paths'
   shapes in turns against the two launches it replaces (the merge, then
   B5); ``ef_encode`` and ``dequant_add_rows`` in turns against the
   parent's form of the same work (the chain of PyTorch ops around B3; 30
   x B4 + stack + zero_), with ``torch.topk`` alone and the portable
   8-CTA cluster read beside.
4. Main path: the paper's 30-worker MNIST experiment at full MLP width
   (784-128-10, 101,770 parameters) through ``make_setup`` -> ``run_fl``,
   20 rounds x 10 local epochs, in sync / async / async_delta /
   time_based, with the raw transport and with top-k+int8 uplinks.
   Then ``REPLAY_RUN`` once more with every encode and every merge's
   decodes recorded and replayed through the plain versions on the card:
   every output equal bit for bit.
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
(one fused merge and step per merge of a run with a server optimizer and
none of B5 anywhere, one launch of B2 or B1 per other merge, one
``ef_encode`` launch per encode (a quantised downlink's under
``ef_encode_dec``, which writes its decode) and none of B3 or of the
select alone, one ``dequant_add_rows`` launch per merge whose responses
waited encoded: sync, time_based and FedAsync async, one ``dequant_mix``
launch per async_delta merge of a quantised response and no B1 there,
and no B4 launch on its own).  Every raw run is
repeated on the CPU from the same initial weights (in ``CPU_WORKERS``
worker processes, all submitted before phase 4's first card run so that
they overlap the card's runs; ``CpuReruns``): every
history field but accuracy must match exactly.  Accuracy cannot match
point for point: SGD over these runs is chaotic, and a one-ulp change to
one initial weight alone moves it (``SPREAD``, measured on the CPU with
``tools/torch_accuracy_spread.py``).  So the card must stay within
``gap_bounds`` of the CPU at every point and in the mean of the last five
points.  The top-k runs are not compared field by field (kept counts
follow the numerics).
7. Fleet (``FLEET``): lossy links, the auto codec, cohorts and the
   hierarchical topology with its faults, at MNIST width, every run with
   the launch counters at 0 before it and read after.  lossy/sync and
   lossy/async: the main path with every worker link on
   ``LinkReliability(**FLEET_LOSS)`` (attached by
   ``inject_link_reliability`` with the estimator, in a 1x1 topology so
   ``audit_chaos_run`` closes its books); lossy/uplink_only the same over
   top-k+int8 uplinks, its ``ef_encode`` launches equal to its logical
   uplinks (the ledger's original sends) though copies were
   retransmitted; auto/backbone, edge and starved: ``fig_autotune_sweep``'s
   setup over ``AUTO_LOSS`` links, each link's resolved codec counted at
   every encode; cohort/scale: W = 10,000 workers on one shard, cohort 64
   (row buffer at most 2 x 64, at most 256 resident links, B2 once a
   round), beside W = 64 with no cohort; cohort/main (cohort = W) and
   topology/1x1, which must equal phase 4's raw/sync bit for bit over
   their 10 rounds (the auto runs, lossy/uplink_only and cohort/main_k10
   take 10 rounds too, lossy/sync and lossy/async 20);
   cohort/main_k10; chaos/1x2 (``fig_chaos_sweep`` at loss 0.1, failover
   on, target 0.8: one failover, t80 beside ``BENCH_chaos.json``) and
   chaos_raw/1x2.  Then the controls: a sender that re-encodes each
   retransmitted copy must fail the encode check, and a tuner that
   ignores the retransmit tax or the encode cost must move more than
   ``AUTO_CODEC_GAP`` of the edge tier's codecs.  Then the CPU: every
   non-accuracy field of lossy/sync, lossy/async, auto/backbone,
   cohort/scale, cohort/main_k10 and chaos_raw/1x2 equal (retransmits,
   the ledger, evictions, the failover included; the lossy runs'
   accuracy within ``MAIN_GAPS``), and every auto run's codec counts
   within ``AUTO_CODEC_GAP``.
8. Resume (``RESUME``, ``run_resume``): six runs at MNIST width (table
   4.2, het strong), ``RESUME_ROUNDS`` rounds: raw/sync,
   raw/async_delta, uplink_only/sync, async over the auto codec, FedAdam
   over a Dirichlet split and a 1x2 topology over top-k+int8 links.
   Each runs in a writer process of its own (this script with
   ``--resume-writer``, all started together) with ``checkpoint_every=
   RESUME_EVERY``, SIGKILLed as soon as its first snapshot is on disk;
   so does ``RESUME_CHAOS``, chaos/1x2's lossy setup without failover.
   One fresh process (``--resume-reader``) then resumes every run with
   ``resume=True``, every launch counter at 0 before each, while this
   one runs each of the six uninterrupted.  Each resumed history (the
   topology's leaves too) must equal the uninterrupted card run in
   every field, accuracy bits included; the resumed process must show
   each kernel of ``RESUME_REQUIRED``; the chaos run's
   ``audit_chaos_run`` must close.  Reports each snapshot's bytes and the
   seconds of its capture, of reading it and of the restore.
9. Shard (``run_shard``): the sharded aggregation substrate (B7) on
   meshes of D = 1, 2 and 4 that repeat the one card
   (``agg_mesh(devices=...)``).  ``check_b7``: each B7 wrapper
   (the mix at s = ``B7_S`` in the merge path's form,
   ``fedavg_mix_wvec_sharded``, the reference's ``fedavg_mix_flat_sharded``
   held equal to it; ``fedavg_agg_flat_sharded``, ``merge_opt_flat_sharded`` in its
   momentum form behind the aggregate and its adam form behind the mix,
   ``server_opt_step_flat_sharded`` in both forms) at each (W, N) of
   ``B7_SIZES`` (256 x 16,777,216: 17.2 GB of rows; the main path's MLP
   padded for D = 4 at W = 30 and W = 1), bit for bit equal to the
   unsharded kernel on the same data and to the plain sharded version,
   one launch a device (one on this card) covering D pieces, each
   ``B7_FAULTS`` control failing (checked at small sizes in the
   tests); timed with L2 flushed, D = 1 in turns with the unsharded
   kernel and ``torch.addmv``/``torch.mv``, D > 1 with the unsharded
   kernel, beside the byte bound.  ``check_shard_encode``: ef_encode's
   sharded form (a sharded server's link vectors) on ``Sharded`` a, b
   and c at each ``SHARD_ENC_SIZES`` width (the main path's MLP padded
   for D = 4, exact select; 16,777,216, sampled, stride 128) for each
   ``SHARD_ENC_FORMS`` codec (top-k, top-k+int8, int8) on meshes of 1, 2
   and 4: every output bit for bit equal to the unsharded kernel's on the
   gathered vectors and to the plain sharded (staged) version's, at
   D = 4 each launch alone against its plain stage, 2D + 2 launches (a
   pass 1 and a pass 2 a shard, the select and the kept partials' sum;
   2D + 1 for int8; one shard: the unsharded form's launches), each
   ``SHARD_ENC_FAULTS`` control
   failing.  ``check_shard_decode``: B4's sharded forms at the same
   widths and meshes, ``dequant_add`` on ``Sharded`` q and base and a
   merge's 30 encoded responses landed in a sharded row buffer (the
   sharded server's ``_set_rows``: ``dequant_add_rows`` over the pieces),
   bit for bit against the unsharded forms, one launch a device covering
   D pieces, the ``SHARD_DEC_FAULTS`` control failing.  Each timed with
   L2 flushed in turns with the unsharded form (and B4 with ``torch.add``
   on the whole vectors).  ``check_shard_fused``: B4's redesigns on
   ``Sharded`` vectors at the same widths and meshes, the decoding
   ``ef_encode`` (2D + 2 launches) and ``dequant_mix_sharded`` (one
   launch a device over D pieces, in place), bit for bit against the
   unsharded chains, timed at 102,400 and D = 4 in turns with the
   sharded chains.  Then each ``SHARD_RUNS`` run at MNIST
   width (phase 4's setup, ``SHARD_ROUNDS`` rounds) unsharded and at
   ``server_mesh`` 1, 2 and 4, counters at 0 before each run: every
   sharded history equals the unsharded one in every field, accuracy
   bits included (the topology's root and leaves), every link vector
   after the run is ``Sharded`` in D pieces of N/D, each merge kernel,
   ``dequant_add_rows``, ``dequant_mix`` and B4 launch as often as in the
   unsharded run (once a device of this card's mesh) over D times its
   pieces, every encode at D > 1 takes the sharded form and at D = 1 the
   unsharded one on its one piece (``shard_enc_launches``; a quantised
   downlink's under ``ef_encode_dec``), and B5 never;
   then ``SHARD_RESUME`` stopped at its first snapshot and resumed in
   this process, equal to the unsharded run.  Alone:
   ``chip_smoke.py --shard`` (report in
   ``chiprun_out/chip_smoke_shard.json``).
10. LM serving: gemma2-2b at full width and depth (26 layers, seeded
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
11. rwkv6: rwkv6-3b at full width and depth (32 layers, seeded random
   weights on the card), cut from ``SHAPES["prefill_32k"]`` as phase 10 is:
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
   final state within their limits.  Reports as phase 10.
12. Paper (``PAPER``, ``run_paper``): the thesis' time to 80% accuracy
   through ``make_setup`` -> ``run_sequential_baseline`` / ``run_fl``,
   with ``benchmarks/torch_fl_figures.py``'s constants, from the JAX
   package's initial weights (its ``load_weights0``: the fixture
   ``tests/golden/jax_init_mlp_seed0.npz``), at the reference's width
   (MLP 256-128-10 on 16x16 images, 10 workers, batch 64, 10 local
   epochs). ``paper/strong/*`` is
   ``tests/test_fl_system.py::test_paper_orderings``'s setup (het
   strong) and ``paper/table5_1/mnist/*`` table 5.1's mnist-class row
   (het extreme): sequential, sync with Algorithm 2 and async with
   Algorithm 2 (alpha 0.9, staleness power 0.25, linear weights), each
   stopped at 0.8 accuracy (round budgets ``PAPER_ROUNDS``), with
   every launch counter at 0 before it and read after: B2 once a sync
   merge, B1 once an async merge, nothing else of this repo's kernels,
   nothing at all in the sequential runs. ``PAPER_REPLAY`` (the strong
   sync and async runs) once more with every B2 and B1 call recorded,
   each replayed through its plain version on the card: bit for bit,
   all at ``PAPER_N``. Each run again on the CPU in this process:
   every non-accuracy field equal on the histories' common prefix, the
   largest accuracy gap there within ``ACC_GAPS`` and t80 within
   ``T80_GAPS`` (twice the CPU's one-ulp spreads, ``ACC_SPREAD`` and
   ``T80_SPREAD``). At het strong sync < sequential and async < sync
   on the card; the extreme row's orderings are reported, not gated
   (the reference's sync loses to sequential there). The control
   ``paper/strong/sync_all`` (every worker each round, Algorithm 2
   off) must fail sync + Alg 2's t80 check. Reports each run's t80,
   points, s/round and seconds to the target, and table 5.1's two
   percentages beside the thesis' and the CPU's (``PAPER_CPU_T80``).
13. Zoo (``ZOO``, ``run_zoo``): the LM zoo's last families serving
   through B8 at full width (seeded random bf16 weights on the card), cut
   from ``SHAPES["prefill_32k"]`` as phases 10-11 are: prefill of 2
   prompts of 8192 tokens, then 32 greedy decode steps, every counter at 0
   before and read after.  zamba2-7b at full depth (81 layers: 13 groups
   of 5 mamba2 blocks around the shared attention block, 3 trailing):
   B8 at head dim 112 (its tensor-core body) exactly 13 times in the
   prefill;
   mixtral-8x22b cut to 8 of 56 layers (window 4096, so its cache is a
   ring): B8's windowed tensor-core body 8 times; never in decode, and no
   other kernel.  Checks: the last 4 decode steps against a full forward
   (mixtral at capacity 4.0, where nothing drops, its forward padded to
   whole 2048-token groups); at a cut depth and a 128-token prompt the
   card against a CPU run in this process; each within ``ZOO_LIMITS``,
   each control of ``ZOO_FAULTS`` beyond it (an SSM state zeroed after the
   prefill, group 0's shared cache in every group's place, B8 faults).
   Reports prefill s, tokens/s, decode s/step, peak memory, MFU of the
   bf16 peak, and mixtral's choices dropped at capacity 1.25.
14. Pods (``TRAIN``, ``run_pods``): ``train_step`` with AdamW at full
   width, zamba2-7b cut to 13 layers and phi3.5-moe to 2, 3 steps on one
   repeated batch of 2 x 2048 tokens (the third over 2 microbatches):
   loss and gradient norm finite, the loss falling, B8 and B9 never
   launched (training runs at attn_impl "xla", as JAX's); the REDUCED
   first step against a CPU step (loss, gradient norm, Adam's first
   moment; the MoE control: aux_weight 0 on the CPU).  Then pod FL at
   yi-9b's width cut to 2 layers, 2 pods: two ``fl_local_step``s and
   ``fl_round`` (B2 once, every pod equal after it), one more local step
   and ``fl_round_delta_compressed`` with ``ErrorFeedbackCompressor(frac=
   0.1)`` (``ef_encode``'s grid form once over 1,216,389,120 elements,
   three launches,
   B6 once); B2, ``ef_encode`` and B6 each replayed through its plain
   version on the card, bit for bit.  Reports s/step, s/round and peak
   memory.
15. Launch (``run_launch``): the production training script, ``python -m
   repro_torch.launch.train``, in subprocesses at musicgen-medium's full
   width.  Single mode at full depth (48 layers, 1,815,234,048
   parameters, 30 steps of 8 x 128 tokens at ``LAUNCH_LR``, no
   checkpoint): the loss
   finite, its last ``LAUNCH_LAST`` values at least ``LAUNCH_FALL`` below
   the first, no kernel launched.  Fl mode, 2 pods, at the deepest depth
   whose estimated peak (``fl_peak_estimate``, with ``LAUNCH_RESERVE``)
   leaves ``LAUNCH_FREE`` of the card free, 3 steps with a round after
   the second: B2 exactly once, its output bit for bit its plain version's
   at this shape (chunk by chunk along N, in the trainer's process,
   ``b2_round_check``) and two controls that must fail, every pod equal
   after it, the run's reserved peak leaving ``LAUNCH_FREE``.  A run cut
   to 2 layers killed after its first checkpoint and resumed in a fresh
   process: the state the resumed process moved to the card equal to the
   file bit for bit (``tree_digest``), the resumed checkpoints equal to a
   continuation in this process on the reference's batches (its iterator
   starts again).  ``input_specs`` for all 40 cells on both
   production meshes: per-device bytes, no device memory allocated.
   Reports s/step, round s, peak memory and checkpoint bytes under
   ``launch``.
16. Dry run (``run_dryrun``; alone: ``chip_smoke.py --dryrun``): the
   dry run's analysis (``launch/hlo_cost.py``, ``hlo_analysis.py``) held
   against steps the card runs.  Phase 15's single-mode step at 48 layers
   (8 x 128 tokens, parameters and AdamW state resident), traced on fake
   CPU tensors whole and extrapolated, then profiled: the trace's flops
   against the profiler's matmuls that ran, ``peak_estimate_bytes``
   against ``max_memory_allocated`` over the step, each within
   ``DRY_LIMITS``, the ``DRY_CONTROLS`` estimates outside them, the
   device time at least max(t_compute_s, t_memory_s); one ``fl_round`` on
   phase 14's pods: B2 exactly once, the record's bytes for it
   4 (W N + W + N), the round's device time at least its bytes over the
   card's rate.  Reports under ``dryrun`` and on a ``dryrun`` line.
17. Result: the ``dryrun`` line, the ``kernels`` JSON line, the card line,
   and last the ``{"ok": true, "device": ...}`` line.

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
TOPK_RUNS = [f"uplink_only/{m}" for m in MODES] + ["hetero/sync_topk/fedadam"]
REQUIRED = {
    "fedavg_agg_flat": ("agg", ["raw/sync", "raw/time_based",
                                "raw/async_delta", "hetero/sync/fedprox",
                                "cnn/sync/fedavg"]),
    # B1 redesigned: FedAsync merges (W = 1) and async_delta's delta_vec
    # (W = 2)
    "fedavg_mix_flat": ("mix", ["raw/async", "raw/async_delta"]),
    # B3's redesign: every top-k+int8 encode, one launch each
    "ef_encode": ("ef_encode", TOPK_RUNS),
    # B4's redesigns: every merge whose responses waited encoded; every
    # quantised downlink encode, which writes its decode itself (the
    # symmetric codec); every async_delta merge of a quantised response,
    # decoded and merged in one launch
    "dequant_add_rows": ("decode_rows", [
        "uplink_only/sync", "uplink_only/async", "uplink_only/time_based",
        "hetero/sync_topk/fedadam"]),
    "ef_encode_dec": ("ef_encode_dec", ["hetero/sync_topk/fedadam"]),
    "dequant_mix": ("dequant_mix", ["uplink_only/async_delta"]),
    # B4 itself: no run of phases 4-6 decodes alone any more (the fleet
    # phase's chaos/1x2 does: its root decodes the leaves' pushes)
    "dequant_add": ("decode", []),
    # B5 redesigned: every server-optimizer merge, the merge (B2's or B1's
    # form) and the step in one launch
    "merge_opt_flat_mom": ("merge_mom", ["hetero/sync/fedavgm",
                                         "hetero/sync/feddyn"]),
    "merge_opt_flat_adam": ("merge_adam", [
        "hetero/sync/fedadam", "hetero/async/fedadam",
        "hetero/sync_topk/fedadam", "cnn/sync/fedadam"]),
}
# B3 and B5 themselves: no path calls them since ef_encode and the fused
# merge took their places; each keeps its check, its timing and a launch
# count (0) in the kernels line
RETIRED = {"topk_quant_encode": "encode", "server_opt_step_flat_mom": "mom",
           "server_opt_step_flat_adam": "adam"}
# ef_encode (B3 redesigned) is held bit for bit against its plain version
# (ref.reference_ef_encode, the parent's chain) at these inputs: (N,
# n_params, k, quantize, draw); k None is the int8 codec's form (threshold
# 0).  "parts" is x = (a - b) + c as an uplink forms it (a, b ~ N(0, 1) the
# new weights and the base, c ~ 0.01 N(0, 1) the residual); the other
# draws are x alone: "ties" 41 distinct values (ties at any threshold),
# "zeros" all zero (the threshold falls to its floor, nothing is kept),
# "nonfinite" N(0, 1) with a NaN, +inf, -inf and 100 -0.0 planted.  The
# MLP's and the CNN's widths at their k, k = 1 and k = n, and 2^17 + 512
# and 2^20 on the strided-sample path.
EF_CASES = {
    "mlp topk+int8": (101_888, 101_770, 10_177, True, "parts"),
    "mlp topk": (101_888, 101_770, 10_177, False, "parts"),
    "mlp int8": (101_888, 101_770, None, True, "parts"),
    "cnn topk+int8": (29_184, 28_938, 2_893, True, "parts"),
    "cnn topk": (29_184, 28_938, 2_893, False, "parts"),
    "cnn int8": (29_184, 28_938, None, True, "parts"),
    "k = 1": (101_888, 101_770, 1, True, "parts"),
    "k = n": (101_888, 101_888, 101_888, True, "parts"),
    "sampled 2^17 + 512": (131_584, 131_484, 13_148, True, "parts"),
    "sampled 2^20": (1_048_576, 1_048_476, 104_847, True, "parts"),
    "sampled 2^20 topk": (1_048_576, 1_048_476, 104_847, False, "parts"),
    "sampled 2^20 int8": (1_048_576, 1_048_476, None, True, "parts"),
    # phase 14's compressed pod round: the packed (2, 608,194,560) deltas
    # of yi-9b's width at 2 layers (a multiple of 512: no padding), the
    # grid form, 2 N < 2^31 for the int32 kept
    "pods 2 x yi-9b/2 layers": (1_216_389_120, 1_216_389_120, 121_638_912,
                                True, "parts"),
    "ties": (101_888, 101_770, 10_177, True, "ties"),
    "zeros": (101_888, 101_770, 10_177, True, "zeros"),
    "nonfinite": (101_888, 101_770, 10_177, True, "nonfinite"),
    "nonfinite topk": (101_888, 101_770, 10_177, False, "nonfinite"),
}
# the controls: ef_encode's plain version given each fault must disagree
# with the kernel on the case named
EF_FAULTS = {"threshold one rank lower": "mlp topk+int8",
             "fmaxf for the NaN-propagating max": "nonfinite",
             "kept with > for >=": "mlp topk+int8"}
# dequant_add_rows is held bit for bit at these numbers of decodes over N =
# 101,888, with two stale rows beyond them (NaN) that must come back zero
ROWS_W = (1, 30, 65)
# B4's redesign around its path: its decode folded into the launches next
# to it, ef_encode's decoded output (a quantised downlink's encode writes
# the receiver's model, base + q * scale, from its own last pass) and
# dequant_mix (async_delta's decode and delta merge of a quantised
# response in one launch).  Each is held bit for bit against the chain it
# replaces (the encode then B4; B4, torch.stack, B1) and its plain version
# at these (N, n_params): a ragged width, the MLP's, the scalar path's
# 101,890, 2^17 + 512 past the exact threshold's cap (sampled at stride 1,
# one cluster) and, for the encode, 2^20 (the grid form); both at
# DEC_TIMED, timed in turns against the chain.  The encode in the
# top-k+int8 codec (frac 0.1) and the int8 codec (k None).
DEC_SIZES = ((1000, 1000), (1001, 1001), (101_888, 101_770),
             (101_890, 101_890), (131_584, 131_484), (1_048_576, 1_048_476))
DEC_TIMED = (101_888, 16_777_216)
DEC_FRAC = 0.1
# the delta merge's weights: server + (new - base)
DEC_WVEC = (1.0, 1.0, -1.0)
# controls: the plain chain given each fault must disagree with the kernel
# of each form named, on DEC_SIZES[2]
DEC_FAULTS = {"an FMA-contracted decode": ("ef_encode_dec", "dequant_mix"),
              "the delta merge reading row 1 as the decoded row":
                  ("dequant_mix",)}
# the run whose every encode and merge is recorded and replayed through
# the plain versions on the card
REPLAY_RUN = "uplink_only/sync"
# B8 (flash attention) is checked at these shapes, (B, S, H, Kv, D, dtype,
# window, softcap); the bf16 ones are timed.  gemma2-2b's global and
# local layers, yi-9b's and zamba2-7b's shared block (head dim 112, the
# tensor-core body with its second 64-column chunk zero-padded) at the LM
# phases' prompt lengths, then two f32 shapes of tests/test_kernels.py (the
# SIMT body).
FLASH_SHAPES = {
    "gemma2-2b global": (2, 8192, 8, 4, 256, torch.bfloat16, 0, 50.0),
    "gemma2-2b local": (2, 8192, 8, 4, 256, torch.bfloat16, 4096, 50.0),
    "yi-9b": (2, 4096, 32, 4, 128, torch.bfloat16, 0, 0.0),
    "zamba2-7b": (2, 8192, 32, 32, 112, torch.bfloat16, 0, 0.0),
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
# version with each fault named here (controls of the check); at zamba2-7b's
# D = 112 also what a body that loses its padded second chunk computes.
FLASH_Q_SCALE = 8.0
FLASH_FAULTS = {"gemma2-2b global": ("no softcap",),
                "gemma2-2b local": ("window + 32 keys",),
                "yi-9b": ("head map h % Kv",),
                "zamba2-7b": ("kv shifted one position",
                              "v's columns 64..111 zeroed")}
# the head dims at which bf16 runs B8's tensor-core body (flash_wgmma<D>),
# each of which the build's -Xptxas -v report must hold without spills
WGMMA_DIMS = (64, 112, 128, 256)
N_TIMED_FLASH = 10
# the plain versions of B8 and B9 at full width (0.06-1.1 s a call) and
# B7's at 17.2 GB (~0.03 s, 18 cases): their yardstick readings take 3
# runs after 1 warm-up, not 10 after 5 (~35 s at 15 calls each)
N_TIMED_PLAIN, WARM_PLAIN = 3, 1
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

# server_opt -> B5's scalars of its form (B5a momentum, B5b adam)
OPT_SCALARS = {"fedavgm": [0.9, 1.0, 0.0, 1.0],
               "feddyn": [1.0, 1.0, 1.0, 0.25],
               "fedadam": [0.9, 0.99, 0.05, 1e-3, 0.0, 0.0]}
# server_opt -> the fused merge's launch counter of its form
MERGE_COUNTER = {"fedavgm": "merge_mom", "feddyn": "merge_mom",
                 "fedadam": "merge_adam"}
# The fused merge and step (merge_opt_flat) is held bit for bit against its
# plain version at every (W, N) of these, in the aggregate form and the
# mix at each server scale s, with each optimizer's scalars: W 1 (FedAsync
# merges), 2, 10 (the heterogeneity and CNN phases' sync merges), 30 (the
# main path's) and 65 (five groups of rows, the last partial); N the MLP's
# padded width, the scalar path's 101,890, the CNN's padded width, the
# paper phase's (PAPER_N) and a small one.
MERGE_W = (1, 2, 10, 30, 65)
MERGE_N = (101_888, 101_890, 29_184, 34_304, 1000)
MERGE_S = (0.1, 1.0)
# the controls: the plain version given each fault must differ from the
# kernel on the case named, (W, s, optimizer) at the first of MERGE_N (s
# None: the aggregate): merged = s * server + acc rounded once, as an FMA
# would, and m' = am * m + bm * d (b1 * m + (1 - b1) * d) rounded once
MERGE_FAULTS = {"FMA in the mix": (1, 0.1, "fedadam"),
                "FMA in the step": (10, None, "fedavgm")}
MERGE_OUTPUTS = ("new", "m'", "v'")


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

    def __call__(self, fn, n: int = N_TIMED, warm: int = 5) -> float:
        for _ in range(warm):
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
            "merge_mom": fedavg_agg.LAUNCHES,
            "merge_adam": fedavg_agg.LAUNCHES,
            "dequant_mix": fedavg_agg.LAUNCHES,
            "encode": topk_quant.LAUNCHES, "decode": topk_quant.LAUNCHES,
            "ef_encode": topk_quant.LAUNCHES,
            "ef_encode_sharded": topk_quant.LAUNCHES,
            "ef_encode_dec": topk_quant.LAUNCHES,
            "select": topk_quant.LAUNCHES,
            "sample": topk_quant.LAUNCHES,
            "decode_rows": topk_quant.LAUNCHES,
            "mom": server_opt.LAUNCHES, "adam": server_opt.LAUNCHES,
            "flash": flash_attention.LAUNCHES,
            "flash_wgmma": flash_attention.LAUNCHES,
            "wkv": rwkv6_kernel.LAUNCHES}


def piece_counters():
    """Counter key -> the PIECES dict of a kernel whose wrapper takes
    pieces (the merges, B5, B4 and the rows): the pieces its launches
    covered, one a launch unsharded, every piece a device holds sharded."""
    from repro_torch.kernels import fedavg_agg, server_opt, topk_quant
    return {**{k: fedavg_agg.PIECES for k in fedavg_agg.PIECES},
            **{k: server_opt.PIECES for k in server_opt.PIECES},
            **{k: topk_quant.PIECES for k in topk_quant.PIECES}}


def zero_counters():
    for c in (*launch_counters().values(), *piece_counters().values()):
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


def merge_inputs(g, W, N, s):
    """One merge's operands on g's device: W unit-normal rows, normalised
    weights (after the server scale s in the mix; s None: the aggregate's
    weights alone), server, prev, m and |v|."""
    dev = g.device
    rows = torch.randn(W, N, device=dev, generator=g)
    w = torch.rand(W, device=dev, generator=g) + 0.1
    w /= w.sum()
    if s is not None:
        w = torch.cat([torch.full((1,), s, device=dev), (1.0 - s) * w])
    server, prev, m, v = (torch.randn(N, device=dev, generator=g)
                          for _ in range(4))
    return rows, w, server, prev, m, v.abs()


def merge_plain_fault(fault, stacked, wvec, server, prev, m, v, scalars, *,
                      adam):
    """merge_opt_flat's plain version (ref.reference_merge_opt) given
    ``fault`` (MERGE_FAULTS), a control that the check must catch: the
    mix's ``s * server + acc`` or the step's ``m'`` rounded once, in f64
    and then to f32, as an FMA would round it."""
    from repro_torch.kernels import ref
    if fault not in MERGE_FAULTS:
        raise ValueError(fault)

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()
    if server is None:
        merged = ref.reference_fedavg(stacked, wvec)
    elif fault == "FMA in the mix":
        merged = fma(wvec[0], server, ref.reference_fedavg(stacked,
                                                           wvec[1:]))
    else:
        merged = ref.reference_fedavg_mix(stacked, wvec[1:], server, wvec[0])
    if fault != "FMA in the step":
        return ref.reference_server_opt(prev, merged, m, v, scalars,
                                        adam=adam)
    sc = torch.as_tensor(np.asarray(scalars, np.float32)).to(prev.device)
    d = merged - prev
    if adam:
        mo = fma(sc[0], m, (1.0 - sc[0]) * d)
        vo = sc[1] * v + (1.0 - sc[1]) * d * d
        return prev + sc[2] * mo / (torch.sqrt(vo) + sc[3]), mo, vo
    mo = fma(sc[0], m, sc[1] * d)
    return prev + sc[2] * d + sc[3] * mo, mo, None


def merge_mismatch(got, want):
    """The names of the outputs on which two merge_opt_flat results
    differ."""
    return [n for n, a, b in zip(MERGE_OUTPUTS, got, want)
            if not same_bits(a, b)]


def check_merge_opt(dev, ns=MERGE_N, ws=MERGE_W):
    """merge_opt_flat (the merge and the server optimizer's step in one
    launch) against its plain version (ref.reference_merge_opt, the
    unfused chain) at every (W, N) of ws x ns, in the aggregate form and
    the mix at each of MERGE_S, with each optimizer's scalars: every output
    bit for bit, with a prev apart from the server and, in the mix, with
    prev the server itself; the call aliased as the merge path makes it
    (out = server = prev in the mix, m_out = m, v_out = v) equal to the
    fresh one.  An inf in a zero-weight row gives NaN as the chain does;
    each MERGE_FAULTS control differs.  Raises on any failure; returns the
    record (the largest |kernel - plain| of each optimizer form)."""
    from repro_torch.kernels import fedavg_agg, ref
    g = torch.Generator(device=dev).manual_seed(4)
    cases, errs = [], {"mom": 0.0, "adam": 0.0}

    def call(rows, w, srv, prev, m, v, sc, adam, alias):
        plain = ref.reference_merge_opt(rows, w, srv, prev, m, v, sc,
                                        adam=adam)
        got = fedavg_agg.merge_opt_flat(rows, w, srv, prev, m, v, sc,
                                        adam=adam)
        bad = merge_mismatch(got, plain)
        if alias:
            out = None if srv is None else srv.clone()
            m2, v2 = m.clone(), v.clone()
            inplace = fedavg_agg.merge_opt_flat(
                rows, w, out, prev if out is None else out, m2, v2, sc,
                adam=adam, out=out, m_out=m2, v_out=v2)
            bad += [f"aliased {n}" for n in merge_mismatch(inplace, got)]
        err = max(max_err(a, b) for a, b in zip(got, plain) if b is not None)
        return bad, err

    for N in ns:
        for W in ws:
            for s in (None,) + MERGE_S:
                rows, w, server, prev, m, v = merge_inputs(g, W, N, s)
                srv = None if s is None else server
                for opt, sc in OPT_SCALARS.items():
                    adam, sc = opt == "fedadam", np.asarray(sc, np.float32)
                    form = "adam" if adam else "mom"
                    bad, err = call(rows, w, srv, prev, m, v, sc, adam,
                                    alias=s is None)
                    if srv is not None:
                        # the merge path's call: the server buffer is prev
                        b2, e2 = call(rows, w, srv, srv, m, v, sc, adam,
                                      alias=True)
                        bad, err = bad + b2, max(err, e2)
                    errs[form] = max(errs[form], err)
                    cases.append({"W": W, "N": N, "s": s, "opt": opt,
                                  "mismatch": bad})
                    if bad:
                        raise AssertionError(
                            f"merge_opt_flat W {W} N {N} s {s} {opt}: "
                            f"kernel and plain version differ in {bad}")
    nonfinite = []
    for s in (None, 0.1):
        rows, w, server, prev, m, v = merge_inputs(g, 3, ns[0], s)
        w[-1] = 0.0
        rows[-1, 5] = float("inf")
        srv = None if s is None else server
        for opt, sc in OPT_SCALARS.items():
            adam = opt == "fedadam"
            got = fedavg_agg.merge_opt_flat(rows, w, srv, prev, m, v, sc,
                                            adam=adam)
            plain = ref.reference_merge_opt(rows, w, srv, prev, m, v, sc,
                                            adam=adam)
            ok = (not merge_mismatch(got, plain) and bool(got[0][5].isnan())
                  and bool(torch.isfinite(got[0][6:]).all()))
            nonfinite.append({"s": s, "opt": opt, "nan_as_chain": ok})
            if not ok:
                raise AssertionError(f"merge_opt_flat s {s} {opt}: an inf "
                                     f"in a zero-weight row")
    controls = {}
    for fault, (W, s, opt) in MERGE_FAULTS.items():
        rows, w, server, prev, m, v = merge_inputs(g, W, ns[0], s)
        srv = None if s is None else server
        adam, sc = opt == "fedadam", np.asarray(OPT_SCALARS[opt], np.float32)
        got = fedavg_agg.merge_opt_flat(rows, w, srv, prev, m, v, sc,
                                        adam=adam)
        controls[fault] = merge_mismatch(got, merge_plain_fault(
            fault, rows, w, srv, prev, m, v, sc, adam=adam))
        print(f"check merge_opt_flat control ({fault}, W {W} s {s} {opt}): "
              f"outputs differing: {controls[fault]}")
        if not controls[fault]:
            raise AssertionError(f"merge_opt_flat: the check does not catch "
                                 f"{fault}")
    unread = check_unread_server(dev)
    print(f"check merge_opt_flat: {len(cases)} cases bit for bit (W "
          f"{ws}, N {ns}, the aggregate and s {MERGE_S}, "
          f"{sorted(OPT_SCALARS)}), aliased equal to fresh; max |kernel - "
          f"plain| {errs}; inf in a zero-weight row: NaN as the chain; "
          f"the server buffer under alpha 1: {unread}")
    return {"cases": cases, "errs": errs, "nonfinite": nonfinite,
            "controls": controls, "unread_server": unread}


def check_unread_server(dev):
    """The alpha >= 1 rule through the fused merge: two FlatServerStates
    with FedAdam on ``dev`` take the same first merge; then one's packed
    server mirror (the buffer an alpha < 1 merge would read) is filled
    with inf, and both anchors re-pack from the finite server dict
    (rebase).  An alpha 1 merge with its step never reads the mirror: it
    stays finite and equals the other state's.  An alpha 0.9 merge reads
    it: NaN where the other state stays finite."""
    from repro_torch.core import flatbuf, server_opt
    g = torch.Generator(device=dev).manual_seed(6)

    def tree():
        return {"b": torch.randn(40, device=dev, generator=g),
                "w": torch.randn(64, 33, device=dev, generator=g)}
    s0, first, second = tree(), [tree(), tree()], [tree() for _ in range(3)]
    rec = {}
    for alpha in (1.0, 0.9):
        got = []
        for poison in (True, False):
            st = flatbuf.FlatServerState(s0)
            st.server_opt = server_opt.make_server_opt("fedadam", lr=0.05)
            srv = st.merge(s0, first, [1.0, 2.0], 1.0)
            if poison:
                st._server_flat.fill_(float("inf"))
            st.server_opt.rebase()
            new = st.merge(srv, second, [1.0, 2.0, 1.0], alpha)
            got.append(torch.cat([new[k].reshape(-1) for k in sorted(new)]))
        if alpha == 1.0:
            rec["alpha 1 finite"] = bool(torch.isfinite(got[0]).all())
            rec["alpha 1 equals unpoisoned"] = same_bits(got[0], got[1])
        else:
            rec["alpha 0.9 NaN"] = bool(got[0].isnan().all())
            rec["alpha 0.9 unpoisoned finite"] = bool(
                torch.isfinite(got[1]).all())
    if not all(rec.values()):
        raise AssertionError(f"merge_opt_flat: the server buffer under "
                             f"alpha 1: {rec}")
    return rec


def check_kernels(dev):
    """Phase 3: correctness at several shapes, then timing at the main
    path's shapes.  Returns one record per kernel."""
    from repro_torch.core import transport
    from repro_torch.kernels import fedavg_agg, ref, server_opt, topk_quant
    g = torch.Generator(device=dev).manual_seed(0)
    N = 101_888
    errs = {k: 0.0 for k in (*REQUIRED, *RETIRED)}
    # 101,890: the scalar path (N % 4 != 0) at the main path's width;
    # PAPER_N at phase 12's sync (W up to 10) and async (W 1) merges
    for W, n in ((30, N), (2, N), (1, N), (30, 101_890), (30, 1000),
                 (3, 1000), (10, PAPER_N), (3, PAPER_N), (1, PAPER_N)):
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
            fresh = fedavg_agg.fedavg_mix_wvec(rows, wvec, server)
            srv = server.clone()
            inplace = fedavg_agg.fedavg_mix_wvec(rows, wvec, srv, out=srv)
            if not torch.equal(inplace, fresh):
                raise AssertionError("fedavg_mix_flat: in-place differs")
            errs["fedavg_mix_flat"] = max(errs["fedavg_mix_flat"],
                                          max_err(fresh, plain))
    for n in (N, 1000):
        x = torch.randn(n, device=dev, generator=g) * 0.01
        scale = ref.reference_int8_scale(x)
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
    merge_rec = check_merge_opt(dev)
    errs["merge_opt_flat_mom"] = merge_rec["errs"]["mom"]
    errs["merge_opt_flat_adam"] = merge_rec["errs"]["adam"]
    torch.cuda.synchronize()
    limits = {"fedavg_agg_flat": 0.0, "fedavg_mix_flat": 0.0,
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
    x = torch.randn(N, device=dev, generator=g) * 0.01
    scale = ref.reference_int8_scale(x)
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
    records.update(time_merges(dev, timer, merge_rec,
                               errs["fedavg_mix_flat"]))
    records.update(check_codec_fused(dev, timer))
    records.update(check_decode_fused(dev, timer))
    records["flash_attention"] = check_flash(dev, timer)
    records.update(check_wkv(dev, timer))
    # the comparison launches above do not count toward the paths' runs:
    # each run sets every counter to 0 before it starts
    return records


def _merge_form(timer, label, W, s, opt, g, N):
    """One fused merge form timed in turns against the two-launch chain
    it replaces (chain, fused, fused, chain) at W rows of N, the server
    scale s (None: the aggregate), the optimizer's scalars, with the state
    updated in place as the merge path updates it; the mix's server buffer
    is also prev, the chain's prev (the parent's re-packed anchor) a vector
    apart.  Returns its record."""
    from repro_torch.kernels import fedavg_agg, ref, server_opt
    rows, w, server, prev, m, v = merge_inputs(g, W, N, s)
    adam, sc = opt == "fedadam", np.asarray(OPT_SCALARS[opt], np.float32)
    srv = None if s is None else server
    kern_prev = prev if srv is None else srv

    def kern():
        return fedavg_agg.merge_opt_flat(rows, w, srv, kern_prev, m, v, sc,
                                         adam=adam, out=srv, m_out=m, v_out=v)

    def chain():
        merged = (fedavg_agg.fedavg_agg_flat(rows, w) if srv is None else
                  fedavg_agg.fedavg_mix_wvec(rows, w, srv, out=srv))
        return server_opt.server_opt_step_flat(prev, merged, m, v, sc,
                                               adam=adam, m_out=m, v_out=v)
    ms, chain_ms, turns = timer.turns(kern, chain)
    state = 3 if adam else 2            # prev, m (, v) read; new, m' (, v')
    n_bytes = (W * N + len(w) + 2 * state * N) * 4
    b_ms, b_by = bound_ms(n_bytes, (2 * W + (2 if srv is not None else 0)
                                    + (13 if adam else 8)) * N)
    rec = {"form": label, "W": W, "N": N, "s": s, "opt": opt, "ms": ms,
           "chain_ms": chain_ms, "turns": turns,
           "plain_ms": timer(lambda: ref.reference_merge_opt(
               rows, w, srv, kern_prev, m, v, sc, adam=adam)),
           "bound_ms": b_ms, "bound_by": b_by, "n_bytes": n_bytes}
    print(f"time merge_opt_flat {label}: fused {ms:.6f} ms, the chain it "
          f"replaces {chain_ms:.6f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by})")
    return rec


def time_b1(timer, g, N=101_888):
    """B1 (fedavg_mix_flat) at the paths' W = 1 (FedAsync merges, s =
    0.1) and W = 2 (async_delta's delta_vec: s = 1, weights [1, -1]) and
    at W = 30, s = 0.1, each in turns with torch.addmv (the one-call
    library form), on g's device at width N.  It imports repro_torch when
    called, so ``tools/torch_merge_times.py`` times another checkout's B1
    with it.  Returns one record per W."""
    from repro_torch.kernels import fedavg_agg, ref
    # an older checkout's fedavg_mix_flat is this wvec form itself
    mix = getattr(fedavg_agg, "fedavg_mix_wvec", fedavg_agg.fedavg_mix_flat)
    dev = g.device
    by_w = []
    for W, s in ((1, 0.1), (2, 1.0), (30, 0.1)):
        rows = torch.randn(W, N, device=dev, generator=g)
        w = (torch.tensor([1.0, -1.0], device=dev) if W == 2 else
             torch.rand(W, device=dev, generator=g) + 0.1)
        w = w if W == 2 else (1.0 - s) * w / w.sum()
        wvec = torch.cat([torch.full((1,), s, device=dev), w])
        server = torch.randn(N, device=dev, generator=g)
        ms, lib_ms, turns = timer.turns(
            lambda: mix(rows, wvec, server, out=server),
            lambda: torch.addmv(server, rows.t(), w, beta=s))
        b_ms, b_by = bound_ms((W * N + W + 1 + 2 * N) * 4,
                              2 * W * N + 2 * N)
        by_w.append({"W": W, "s": s, "ms": ms, "library_ms": lib_ms,
                     "turns": turns, "bound_ms": b_ms, "bound_by": b_by,
                     "plain_ms": timer(lambda: ref.reference_fedavg_mix(
                         rows, w, server, wvec[0]))})
        print(f"time fedavg_mix_flat W = {W}, s = {s}: kernel {ms:.6f} ms, "
              f"torch.addmv {lib_ms:.6f} ms, plain "
              f"{by_w[-1]['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return by_w


def time_merges(dev, timer, merge_rec, b1_err):
    """B1 by W (time_b1); the fused merge and step at the paths' shapes
    in turns against the chain it replaces: the aggregate at W = 10 (the
    heterogeneity and CNN phases' sync merges) in both optimizer forms,
    the mix at W = 1 with s = 0.1 under adam (FedAsync under FedAdam), and
    the aggregate at W = 30 under adam.  N = 101,888.  Returns the records
    of fedavg_mix_flat (its headline fields at W = 30, s = 0.1, the shape
    of earlier records, beside ``by_w``), merge_opt_flat_mom and
    merge_opt_flat_adam."""
    g = torch.Generator(device=dev).manual_seed(7)
    N = 101_888
    by_w = time_b1(timer, g, N)
    b1 = {"name": "fedavg_mix_flat", "route": "cuda", "ok": True,
          "source": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
          "replaces": "src/repro/kernels/fedavg_agg.py:111",
          "launches": 0, "max_abs_err": b1_err,
          **{k: by_w[2][k] for k in ("W", "s", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "turns")},
          "by_w": by_w}
    forms = [_merge_form(timer, *f, g, N) for f in (
        ("agg W = 10, momentum", 10, None, "fedavgm"),
        ("agg W = 10, adam", 10, None, "fedadam"),
        ("mix W = 1, s = 0.1, adam, server = prev", 1, 0.1, "fedadam"),
        ("agg W = 30, adam", 30, None, "fedadam"))]
    out = {"fedavg_mix_flat": b1}
    for form, tpu, mine in (("mom", "fedavg_agg.py:208", forms[:1]),
                            ("adam", "fedavg_agg.py:195", forms[1:])):
        head = mine[0]
        out[f"merge_opt_flat_{form}"] = {
            "name": f"merge_opt_flat_{form}", "route": "cuda", "ok": True,
            "source": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": 0, "max_abs_err": merge_rec["errs"][form],
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "chain_ms", "turns")},
            "library_ms": None, "forms": mine,
            "check": {k: merge_rec[k] for k in ("nonfinite", "controls",
                                                "unread_server")},
            "cases": len(merge_rec["cases"])}
    return out


def ef_inputs(g, N, draw):
    """(a, b, c) of an EF_CASES draw on g's device (b, c None but for
    "parts")."""
    dev = g.device
    if draw == "parts":
        a, b = (torch.randn(N, device=dev, generator=g) for _ in range(2))
        return a, b, 0.01 * torch.randn(N, device=dev, generator=g)
    if draw == "ties":
        x = 0.001 * torch.randint(-20, 21, (N,), device=dev, generator=g)
    elif draw == "zeros":
        x = torch.zeros(N, device=dev)
    elif draw == "nonfinite":
        x = torch.randn(N, device=dev, generator=g)
        x[5], x[77], x[99] = float("nan"), float("inf"), -float("inf")
        x[1000:1100] = -0.0
    else:
        raise ValueError(draw)
    return x.float(), None, None


def ef_plain_fault(fault, a, b, c, *, k, n_params, quantize):
    """ef_encode's plain chain (ref.reference_ef_encode) given ``fault``,
    a control that the check must catch: the threshold taken one rank
    lower (the (k+1)-th largest |x|); max|x| with fmaxf's semantics (a NaN
    dropped, not propagated); the kept count with ``>``."""
    from repro_torch.kernels import ref
    if fault not in EF_FAULTS:
        raise ValueError(fault)
    x = a if b is None else a - b
    x = x if c is None else x + c
    rank = k + 1 if fault == "threshold one rank lower" else k
    thresh = ref.reference_topk_threshold(x, rank, n_params)
    xa = x.abs()
    kept = torch.sum(xa > thresh if fault == "kept with > for >=" else
                     xa >= thresh)
    if not quantize:
        recon = torch.where(xa >= thresh, x, torch.zeros_like(x))
        return recon, x - recon, thresh, None, kept
    if fault == "fmaxf for the NaN-propagating max":
        xa = torch.where(torch.isnan(xa), torch.zeros_like(xa), xa)
    scale = torch.clamp_min(xa.max(), 1e-12) * ref.INV_127
    q, r = ref.reference_topk_quant_encode(x, thresh, scale)
    return q, r, thresh, scale, kept


EF_OUTPUTS = ("q or recon", "residual", "thresh", "scale", "kept")


def same_bits(a, b) -> bool:
    """Equal bit for bit (a NaN equals a NaN of the same bits); 0-d counts
    compare as integers, whatever their type."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype != b.dtype:
        return a.numel() == b.numel() == 1 and int(a) == int(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def ef_mismatch(got, want):
    """The names of the outputs on which two ef_encode results differ."""
    return [n for n, g, w in zip(EF_OUTPUTS, got, want)
            if not same_bits(g, w)]


def rows_inputs(g, W, N):
    """W decodes over N: int8 q, 0-d scales, bases from 3 distinct
    vectors (a round's responses share their dispatch base)."""
    dev = g.device
    qs = [torch.randint(-127, 128, (N,), device=dev, generator=g,
                        dtype=torch.int8) for _ in range(W)]
    scales = [0.01 * torch.rand((), device=dev, generator=g)
              for _ in range(W)]
    distinct = [torch.randn(N, device=dev, generator=g) for _ in range(3)]
    return qs, scales, [distinct[i % 3] for i in range(W)]


def check_codec_fused(dev, timer):
    """The scale's division on the card (a product with fl32(1/127));
    ef_encode (B3 redesigned: the whole EF top-k+int8 encode in one
    cluster launch) against its plain version on every EF_CASES input, bit
    for bit in every output, and each EF_FAULTS control failing; the
    select alone (topk_threshold) against its plain version on the same
    inputs; dequant_add_rows (B4 redesigned: one merge's decodes into the
    row buffer) bit for bit at ROWS_W with stale rows zeroed.  Then both
    timed at the main path's shapes, with L2 flushed, in turns against the
    parent's form of the same work: the chain of PyTorch ops around B3 for
    ef_encode (torch.topk alone and the portable 8-CTA cluster read beside
    it),
    30 x B4 + torch.stack + zero_ for dequant_add_rows.  Returns their
    records."""
    from repro_torch.kernels import ref, topk_quant
    g = torch.Generator(device=dev).manual_seed(3)
    # the chain's scale, `t / 127.0` on a CUDA tensor, is PyTorch's product
    # with fl32(1/127) (a division by a host scalar goes through its
    # reciprocal), not a correctly rounded division: ef_encode and
    # ref.reference_int8_scale spell that product
    v = torch.rand(1 << 20, device=dev, generator=g) * torch.exp(
        5 * torch.randn(1 << 20, device=dev, generator=g))
    div = v / 127.0
    off = int((div != (v.double() / 127).float()).sum())
    print(f"check scale: t / 127.0 on the card equals t * fl32(1/127) on "
          f"2^20 values: {same_bits(div, v * ref.INV_127)}; {off} of them "
          f"differ from a correctly rounded division")
    if not same_bits(div, v * ref.INV_127):
        raise AssertionError("t / 127.0 on the card is not t * fl32(1/127)")
    cases, controls, pods = [], {}, None
    for label, (N, n_params, k, quantize, draw) in EF_CASES.items():
        a, b, c = ef_inputs(g, N, draw)
        kw = dict(k=k, n_params=n_params, quantize=quantize)
        stride, m = (1, N) if k is None else ref.sample_plan(N, k,
                                                             n_params)[:2]
        grid = not (stride == 1 and m <= topk_quant.CLUSTER_MAX)
        before = topk_quant.LAUNCHES["ef_encode"]
        got = topk_quant.ef_encode(a, b, c, **kw)
        launches = topk_quant.LAUNCHES["ef_encode"] - before
        want = ref.reference_ef_encode(a, b, c, **kw)
        bad = ef_mismatch(got, want)
        rec = {"case": label, "N": N, "n_params": n_params, "k": k,
               "quantize": quantize, "draw": draw, "launches": launches,
               "form": "grid" if grid else "cluster",
               "kept": int(want[4]), "thresh": float(want[2]),
               "scale": None if want[3] is None else float(want[3]),
               "mismatch": bad}
        if launches != (3 if grid else 1):
            raise AssertionError(f"ef_encode {label}: {launches} launches "
                                 f"for its {rec['form']} form")
        if grid:
            # the grid form's staged plain version too, and each of its
            # launches alone against its stage
            del want
            outs, rs, *rest = ref.reference_ef_encode_sharded(
                [a], *(None if t is None else [t] for t in (b, c)), **kw,
                home=dev)
            rec["mismatch_staged"] = ef_mismatch(got, (outs[0], rs[0],
                                                       *rest))
            bad = bad + rec["mismatch_staged"]
            del outs, rs, rest
            if N <= 1 << 24:
                rec["stages"] = check_ef_stages(
                    [a], *(None if t is None else [t] for t in (b, c)), **kw)
                bad = bad + rec["stages"]
            else:
                pods = time_pods(timer, label, a, b, c, kw)
        if k is not None:
            x = a if b is None else (a - b) + c
            rec["select_equal"] = same_bits(
                topk_quant.topk_threshold(x, k, n_params),
                ref.reference_topk_threshold(x, k, n_params))
        for fault, on in EF_FAULTS.items():
            if on == label:
                controls[fault] = ef_mismatch(got, ef_plain_fault(
                    fault, a, b, c, **kw))
        print(f"check ef_encode {label}: N {N}, k {k}, {launches} "
              f"launch(es), kept {rec['kept']}, "
              f"thresh {rec['thresh']!r}, scale {rec['scale']!r}; outputs "
              f"differing from the plain version: {bad or 'none'}"
              + (f"; select alone equal {rec['select_equal']}"
                 if k is not None else ""))
        if bad or not rec.get("select_equal", True):
            raise AssertionError(f"ef_encode {label}: kernel and plain "
                                 f"version differ in {bad or 'the select'}")
        cases.append(rec)
        del a, b, c, got
        torch.cuda.empty_cache()
    for fault, bad in controls.items():
        print(f"check ef_encode control ({fault}, on {EF_FAULTS[fault]}): "
              f"outputs differing: {bad}")
        if not bad:
            raise AssertionError(f"ef_encode: the check does not catch "
                                 f"{fault}")
    N = 101_888
    rows_checks = []
    for W in ROWS_W:
        qs, scales, bases = rows_inputs(g, W, N)
        rows = torch.full((W + 2, N), float("nan"), device=dev)
        plain = torch.full((W + 2, N), float("nan"), device=dev)
        topk_quant.dequant_add_rows(qs, scales, bases, rows)
        ref.reference_dequant_add_rows(qs, scales, bases, plain)
        ok = same_bits(rows, plain) and not rows[W:].any()
        rows_checks.append({"W": W, "equal": ok})
        print(f"check dequant_add_rows W = {W}: rows equal the plain "
              f"version's and the 2 stale rows zeroed: {ok}")
        if not ok:
            raise AssertionError(f"dequant_add_rows W = {W}: kernel and "
                                 f"plain version differ")

    # timing at the main path's shapes
    k, n_params = 10_177, 101_770
    a, b, c = ef_inputs(g, N, "parts")

    def kern():
        return topk_quant.ef_encode(a, b, c, k=k, n_params=n_params,
                                    quantize=True)

    def parent():
        # the parent's encode: x, torch.topk's threshold, the kept count
        # (then synced to the host), the scale, B3, and the recon the
        # parent built and dropped
        x = (a - b) + c
        t = torch.clamp_min(torch.topk(x.abs(), k).values[-1], 1e-30)
        kept = torch.sum(x.abs() >= t)
        s = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        q, r = topk_quant.topk_quant_encode(x, t, s)
        return q.to(torch.float32) * s, r, kept

    xa = ((a - b) + c).abs()
    ms, parent_ms, turns = timer.turns(kern, parent)
    ctas = topk_quant.CLUSTER_CTAS
    topk_quant.CLUSTER_CTAS = 8
    try:
        ms8 = timer(kern)
    finally:
        topk_quant.CLUSTER_CTAS = ctas
    n_bytes = 3 * N * 4 + N + N * 4 + 12
    b_ms, b_by = bound_ms(n_bytes, 8 * N)
    enc = {"name": "ef_encode", "route": "cuda", "ok": True,
           "source": "src/repro_torch/kernels/csrc/topk_quant.cu",
           "replaces": "src/repro/kernels/topk_quant.py:60",
           "launches": 0, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": timer(lambda: ref.reference_ef_encode(
               a, b, c, k=k, n_params=n_params, quantize=True)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "parent_ms": parent_ms, "turns": turns,
           "topk_ms": timer(lambda: torch.topk(xa, k)),
           "ctas": ctas, "ms_8_ctas": ms8, "div127_off_correct": off,
           "clusters_active": cluster_occupancy(N),
           "cases": cases, "controls": controls}
    print(f"time ef_encode: kernel {ms:.6f} ms ({ctas} CTAs; 8 CTAs "
          f"{ms8:.6f}), the "
          f"parent's chain {parent_ms:.6f} ms (torch.topk alone "
          f"{enc['topk_ms']:.6f}), plain {enc['plain_ms']:.6f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}); clusters the card holds at once "
          f"{enc['clusters_active']}")
    grid = time_grid(timer, g, pods)
    W = 30
    qs, scales, bases = rows_inputs(g, W, N)
    bases = [bases[0]] * W               # one round: one dispatch base
    rows = torch.empty(W, N, device=dev)

    def rows_kern():
        return topk_quant.dequant_add_rows(qs, scales, bases, rows)

    def rows_parent():
        vecs = [topk_quant.dequant_add(q, s, bv)
                for q, s, bv in zip(qs, scales, bases)]
        torch.stack(vecs, out=rows[:W])
        rows[W:].zero_()

    ms, parent_ms, turns = timer.turns(rows_kern, rows_parent)
    n_bytes = W * N + N * 4 + W * N * 4 + 4 * W
    b_ms, b_by = bound_ms(n_bytes, 2 * W * N)
    dec = {"name": "dequant_add_rows", "route": "cuda", "ok": True,
           "source": "src/repro_torch/kernels/csrc/topk_quant.cu",
           "replaces": "src/repro/kernels/topk_quant.py:89",
           "launches": 0, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": timer(lambda: ref.reference_dequant_add_rows(
               qs, scales, bases, rows)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "parent_ms": parent_ms, "turns": turns, "checks": rows_checks}
    print(f"time dequant_add_rows W = {W}: kernel {ms:.6f} ms, the parent's "
          f"30 x B4 + stack + zero_ {parent_ms:.6f} ms, plain "
          f"{dec['plain_ms']:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"ef_encode": enc, "ef_encode_grid": grid,
            "dequant_add_rows": dec}


def dec_inputs(g, N):
    """The new forms' inputs at width N on g's device: a downlink encode's
    a (the server model) and b (the acked base), and a quantised response
    for the delta merge: int8 q, a 0-d scale, its base and the server."""
    dev = g.device
    a, b, base, server = (torch.randn(N, device=dev, generator=g)
                          for _ in range(4))
    q = torch.randint(-127, 128, (N,), device=dev, generator=g,
                      dtype=torch.int8)
    return a, b, q, 0.01 * torch.rand((), device=dev, generator=g), base, \
        server


def dec_kw(N, n_params, codec):
    """ef_encode's keywords for one of the two quantised codecs."""
    from repro_torch.core import transport
    k = transport.topk_k(n_params, DEC_FRAC) if codec == "topk_ef+int8" \
        else None
    return dict(k=k, n_params=n_params, quantize=True)


def dec_chain(form, args, kw=None, out=None):
    """The parent's route for one form: the encode then B4
    (``ef_encode_dec``: the encode's outputs and the decode), or B4, the
    stack of (new, base) and B1 into ``out`` (``dequant_mix``)."""
    from repro_torch.kernels import fedavg_agg, topk_quant
    if form == "ef_encode_dec":
        a, b = args
        enc = topk_quant.ef_encode(a, b, **kw)
        return (*enc, topk_quant.dequant_add(enc[0], enc[3], b))
    q, scale, base, server, w = args
    new = topk_quant.dequant_add(q, scale, base)
    return fedavg_agg.fedavg_mix_wvec(torch.stack([new, base]), w, server,
                                      out=out)


def dec_plain_fault(fault, form, args, kw=None):
    """The plain chain of ``form`` given ``fault``: the decode as one
    fused multiply-add (q * s + b in f64, rounded once to f32: what fmaf
    gives but for double rounding), or the delta merge with its rows
    swapped (row 1, the base, read as the decoded row)."""
    from repro_torch.kernels import ref

    def fma(q, s, b):
        return (q.double() * s.double() + b.double()).float()
    if form == "ef_encode_dec":
        a, b = args
        enc = ref.reference_ef_encode(a, b, **kw)
        return (*enc, fma(enc[0], enc[3], b))
    q, scale, base, server, w = args
    new = fma(q, scale, base) if fault == "an FMA-contracted decode" \
        else ref.reference_dequant_add(q, scale, base)
    rows = [new, base]
    if fault == "the delta merge reading row 1 as the decoded row":
        rows.reverse()
    return ref.reference_fedavg_mix(torch.stack(rows), w[1:], server, w[0])


DEC_OUTPUTS = EF_OUTPUTS + ("decoded",)


def dec_mismatch(got, want):
    """The outputs on which two results of a form differ (one name,
    "merged", for dequant_mix's one output)."""
    if isinstance(got, torch.Tensor):
        return [] if same_bits(got, want) else ["merged"]
    return [n for n, g, w in zip(DEC_OUTPUTS, got, want)
            if not same_bits(g, w)]


def dec_bytes(form, N) -> tuple:
    """A form's own bytes (each input read once, each output written
    once) and operations.  The encode: a and b, then q, r, the decoded
    vector and the three 0-d outputs; the merge: q, base and server, the
    scale and three weights, then out."""
    if form == "ef_encode_dec":
        return 8 * N + N + 4 * N + 4 * N + 12, 10 * N
    return N + 8 * N + 16 + 4 * N, 7 * N


def dec_grid(N, kw) -> bool:
    """Whether ef_encode takes its grid form (three launches) at N."""
    from repro_torch.kernels import ref, topk_quant
    if kw["k"] is None:
        return N > topk_quant.CLUSTER_MAX
    stride, m, _ = ref.sample_plan(N, kw["k"], kw["n_params"])
    return stride > 1 or m > topk_quant.CLUSTER_MAX


def check_decode_forms(dev, sizes=DEC_SIZES):
    """``ef_encode`` with its decoded output (top-k+int8 and int8) and
    ``dequant_mix`` at each width of ``sizes``, bit for bit against the
    chain each replaces, run on ``dev`` (every output), and against their
    plain versions; on the card each form's launches (one, three for the
    encode's grid form; the merge fresh and in place) under its own
    counter and none under the chain's; each DEC_FAULTS control, on
    DEC_SIZES[2] where ``sizes`` has it, disagreeing.  Returns ``(checks,
    controls)``."""
    from repro_torch.kernels import fedavg_agg, ref, topk_quant
    on_card = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(30)
    w = torch.tensor(DEC_WVEC, dtype=torch.float32, device=dev)
    checks, controls = [], {}
    counters = (topk_quant.LAUNCHES, fedavg_agg.LAUNCHES)

    def launched(before):
        return {k: c[k] - b[k] for c, b in zip(counters, before)
                for k in c if c[k] != b[k]}
    for N, n_params in sizes:
        a, b, q, scale, base, server = dec_inputs(g, N)
        for codec in ("topk_ef+int8", "int8"):
            kw = dec_kw(N, n_params, codec)
            want = dec_chain("ef_encode_dec", (a, b), kw)
            before = [dict(c) for c in counters]
            dec = torch.empty(N, device=dev)
            got = (*topk_quant.ef_encode(a, b, **kw, decoded=dec), dec)
            moved = launched(before)
            bad = dec_mismatch(got, want) + [
                f"plain {n}" for n in dec_mismatch(
                    got, ref.reference_ef_encode_decoded(
                        a, b, k=kw["k"], n_params=n_params))]
            checks.append({"form": "ef_encode_dec", "codec": codec, "N": N,
                           "launches": moved, "mismatch": bad})
            print(f"check ef_encode decoded {codec} N = {N}: launches "
                  f"{moved}; outputs differing from the chain (encode, B4) "
                  f"or the plain version: {bad or 'none'}")
            if bad or (on_card and moved != {
                    "ef_encode_dec": 3 if dec_grid(N, kw) else 1}):
                raise AssertionError(f"ef_encode decoded {codec} N = {N}: "
                                     f"{bad}, launches {moved}")
        args = (q, scale, base, server, w)
        want = dec_chain("dequant_mix", args)
        before = [dict(c) for c in counters]
        fresh = fedavg_agg.dequant_mix(q, scale, base, w, server)
        srv = server.clone()
        inplace = fedavg_agg.dequant_mix(q, scale, base, w, srv, out=srv)
        moved = launched(before)
        bad = [n for n, x in (("fresh", fresh), ("in place", inplace),
                              ("plain", ref.reference_dequant_mix(
                                  q, scale, base, server, w)))
               if not same_bits(x, want)]
        if inplace.data_ptr() != srv.data_ptr():
            bad.append("not in place")
        checks.append({"form": "dequant_mix", "N": N, "launches": moved,
                       "mismatch": bad})
        print(f"check dequant_mix N = {N}: launches {moved}; differing "
              f"from the chain (B4, stack, B1): {bad or 'none'}")
        if bad or (on_card and moved != {"dequant_mix": 2}):
            raise AssertionError(f"dequant_mix N = {N}: {bad}, launches "
                                 f"{moved}")
        if N == DEC_SIZES[2][0]:
            kw = dec_kw(N, n_params, "topk_ef+int8")
            dec = torch.empty(N, device=dev)
            mine = {"ef_encode_dec": (
                        (*topk_quant.ef_encode(a, b, **kw, decoded=dec), dec),
                        (a, b)),
                    "dequant_mix": (fresh, args)}
            for fault, forms in DEC_FAULTS.items():
                for form in forms:
                    got, fargs = mine[form]
                    controls[f"{fault} ({form})"] = dec_mismatch(
                        got, dec_plain_fault(fault, form, fargs, kw))
        del a, b, q, base, server, want, fresh, srv, inplace
    for name, bad in controls.items():
        print(f"check B4 redesign control {name}: outputs differing: {bad}")
        if not bad:
            raise AssertionError(f"the decode check does not catch {name}")
    return checks, controls


def check_decode_fused(dev, timer):
    """Phase 3's part for B4's redesign: ``check_decode_forms`` at
    DEC_SIZES, then both forms timed at each DEC_TIMED width with L2
    flushed, in turns with the chain each replaces (chain, new, new,
    chain), beside the plain version and the byte bound.  Returns the two
    records of the kernels line (headline: the MLP's width)."""
    from repro_torch.kernels import fedavg_agg, ref, topk_quant
    checks, controls = check_decode_forms(dev)
    g = torch.Generator(device=dev).manual_seed(31)
    w = torch.tensor(DEC_WVEC, dtype=torch.float32, device=dev)
    records = {}
    for form, src in (("ef_encode_dec", "topk_quant.cu"),
                      ("dequant_mix", "fedavg_agg.cu")):
        by_n = []
        for N in DEC_TIMED:
            a, b, q, scale, base, server = dec_inputs(g, N)
            kw = dec_kw(N, 101_770 if N == 101_888 else N, "topk_ef+int8")
            dec = torch.empty(N, device=dev)
            srv = server.clone()
            if form == "ef_encode_dec":
                def kern():
                    return topk_quant.ef_encode(a, b, **kw, decoded=dec)

                def chain():
                    return dec_chain(form, (a, b), kw)

                def plain():
                    return ref.reference_ef_encode_decoded(
                        a, b, k=kw["k"], n_params=kw["n_params"])
            else:
                def kern():
                    return fedavg_agg.dequant_mix(q, scale, base, w, srv,
                                                  out=srv)

                def chain():
                    return dec_chain(form, (q, scale, base, srv, w),
                                     out=srv)

                def plain():
                    return ref.reference_dequant_mix(q, scale, base, srv, w)
            ms, chain_ms, turns = timer.turns(kern, chain)
            n_bytes, flops = dec_bytes(form, N)
            b_ms, b_by = bound_ms(n_bytes, flops)
            by_n.append({"N": N, "ms": ms, "chain_ms": chain_ms,
                         "turns": {"new": turns["kernel"],
                                   "chain": turns["library"]},
                         "plain_ms": timer(plain), "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"time {form} N = {N}: kernel {ms:.6f} ms, the chain it "
                  f"replaces {chain_ms:.6f} ms (chain, new, new, chain: "
                  f"{turns['library'][0]:.6f}, {turns['kernel'][0]:.6f}, "
                  f"{turns['kernel'][1]:.6f}, {turns['library'][1]:.6f}), "
                  f"plain {by_n[-1]['plain_ms']:.6f} ms, bound "
                  f"{b_ms:.6f} ms ({b_by})")
            del a, b, q, base, server, dec, srv
            torch.cuda.empty_cache()
        head = by_n[0]
        records[form] = {
            "name": form, "route": "cuda", "ok": True,
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": "src/repro/kernels/topk_quant.py:89",
            "launches": 0, "max_abs_err": 0.0,
            **{k: head[k] for k in ("N", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "chain_ms")},
            "library_ms": None, "by_n": by_n,
            "checks": [c for c in checks if c["form"] == form],
            "controls": {k: v for k, v in controls.items()
                         if k.endswith(f"({form})")}}
    return records


# ef_encode's grid form is timed here, top-k+int8 on "parts" inputs (the
# pod width also with x = a alone, as the compressed pod round calls it)
GRID_TIMED = (16_777_216, 16_777_216, 1_677_721)
N_TIMED_PODS = 5


def _ef_bytes(N, abc: bool) -> int:
    """A top-k+int8 encode's own bytes: a (and b, c) read once, q and r
    written once, the three 0-d outputs."""
    return (3 if abc else 1) * 4 * N + N + 4 * N + 12


def time_pods(timer, label, a, b, c, kw):
    """The grid form at the pod width: the kernel and the staged plain
    version on ``label``'s inputs, and the kernel on x = (a - b) + c
    alone (the compressed pod round's call), N_TIMED_PODS runs each."""
    from repro_torch.kernels import ref, topk_quant
    N = a.numel()
    ms = timer(lambda: topk_quant.ef_encode(a, b, c, **kw), N_TIMED_PODS)
    plain_ms = timer(lambda: ref.reference_ef_encode_sharded(
        [a], [b], [c], **kw, home=a.device), N_TIMED_PODS)
    x = (a - b) + c
    ms_a = timer(lambda: topk_quant.ef_encode(x, **kw), N_TIMED_PODS)
    del x
    b_ms, b_by = bound_ms(_ef_bytes(N, True), 8 * N)
    ba_ms, _ = bound_ms(_ef_bytes(N, False), 8 * N)
    rec = {"case": label, "N": N, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "ms_x_alone": ms_a,
           "bound_ms_x_alone": ba_ms}
    print(f"time ef_encode grid form {label} (N = {N:,}): kernel "
          f"{ms:.6f} ms, plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms "
          f"({b_by}); x alone (the pod round's call) {ms_a:.6f} ms, bound "
          f"{ba_ms:.6f} ms")
    return rec


def time_grid(timer, g, pods):
    """The grid form's record of the kernels line: top-k+int8 at
    GRID_TIMED's width on "parts" inputs, kernel and staged plain version
    timed with L2 flushed, beside the pod width's ``pods`` record."""
    from repro_torch.kernels import ref, topk_quant
    N, n_params, k = GRID_TIMED
    kw = dict(k=k, n_params=n_params, quantize=True)
    a, b, c = ef_inputs(g, N, "parts")
    ms = timer(lambda: topk_quant.ef_encode(a, b, c, **kw))
    plain_ms = timer(lambda: ref.reference_ef_encode_sharded(
        [a], [b], [c], **kw, home=a.device))
    b_ms, b_by = bound_ms(_ef_bytes(N, True), 8 * N)
    print(f"time ef_encode grid form N = {N:,}: kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"name": "ef_encode_grid", "route": "cuda", "ok": True,
            "source": "src/repro_torch/kernels/csrc/topk_quant.cu",
            "replaces": "src/repro/kernels/topk_quant.py:60",
            "launches": 0, "max_abs_err": 0.0, "N": N, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "pods": pods}


def cluster_occupancy(N):
    """Clusters of 8 and of 16 CTAs the card holds at once with ef_encode's
    shared memory at N (cudaOccupancyMaxActiveClusters)."""
    import ctypes
    from repro_torch.kernels import _build
    out = {}
    for ctas in (8, 16):
        smem = (-(-N // ctas) + 3) // 4 * 4 * 4
        n = ctypes.c_int(0)
        status = _build.lib().ef_cluster_max_active(ctas, smem,
                                                    ctypes.byref(n))
        if status:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters: {status}")
        out[ctas] = n.value
    return out


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
    elif fault == "kv shifted one position":
        k, v = k.roll(1, 1), v.roll(1, 1)
    elif fault == "v's columns 64..111 zeroed":
        v = v.clone()
        v[..., 64:112] = 0
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
    plain version given each of FLASH_FAULTS' faults against the kernel
    (each must fail); kernel and plain timed at the bf16 shapes, with PyTorch's
    scaled_dot_product_attention where there is no softcap and no window
    (yi-9b's and zamba2-7b's shapes).
    Returns the record of the gemma2-2b global shape, the others under
    "shapes"."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = []
    for label, (B, S, H, Kv, D, dt, window, cap) in FLASH_SHAPES.items():
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
        faults = FLASH_FAULTS.get(label, ())
        if faults:
            rec["controls"] = {}
            for fault in faults:
                fk, fv, fw, fc = fault_args(fault, k, v, window, cap, H)
                bad = ref.reference_flash_attention(q, fk, fv, window=fw,
                                                    softcap=fc)
                rec["controls"][fault] = flash_ratio(got, bad)
                print(f"check flash_attention {label}: control ({fault}) "
                      f"ratio {rec['controls'][fault]:.4g}")
                if not rec["controls"][fault] > 1.0:
                    raise AssertionError(f"flash_attention {label}: the "
                                         f"check does not catch {fault}")
                del bad, fk, fv
            # mha_chunked rounds P to bf16: a reading, not a check
            rec["mha_chunked_ratio"] = flash_ratio(attention.mha_chunked(
                q, k, v, window=window, softcap_val=cap), want)
            print(f"check flash_attention {label}: mha_chunked (bf16 P) "
                  f"ratio {rec['mha_chunked_ratio']:.4g}")
        del got, want
        if dt == torch.bfloat16:
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
            rec.update(ms=ms, plain_ms=timer(plain, N_TIMED_PLAIN,
                                             WARM_PLAIN),
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
                       plain_ms=timer(plain, N_TIMED_PLAIN, WARM_PLAIN),
                       library_ms=None)
            if dt == torch.bfloat16 and not with_state:
                rec["reference_wkv_ms"] = timer(
                    lambda: ref.reference_wkv(r, k, v, w, u), N_TIMED_PLAIN,
                    WARM_PLAIN)
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
    with counted_encodes() as encodes:
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_fl(setup, epochs_per_round=EPOCHS,
                   max_rounds=spec["rounds"], **spec["run_kw"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: counters[k][k] for k in counters}
    rounds = h[-1].version
    merges = sum(p.n_updates > 0 for p in h[1:])
    report[key] = {"history": [vars(p) for p in h], "launches": launches,
                   "encodes": encodes[0], "merges": merges, "wall_s": wall,
                   "s_per_round": wall / max(rounds, 1)}
    print(f"run {key}: {rounds} rounds, {merges} merges, {encodes[0]} "
          f"encodes, final accuracy {h[-1].accuracy:.4f}, "
          f"{wall / max(rounds, 1):.4f} s per round, launches {launches}")
    if rounds != spec["rounds"]:
        raise AssertionError(f"{key}: {rounds} rounds, not {spec['rounds']}")
    # every encode is one fused launch (the FL paths' widths fit one
    # cluster) and nothing else encodes, a quantised downlink's under
    # ef_encode_dec (it writes its decode too); every merge whose responses
    # waited encoded is one dequant_add_rows launch, every async_delta
    # merge of a quantised response one dequant_mix launch (no B1, no
    # stack); and no decode runs alone
    run_kw = spec["run_kw"]
    topk = run_kw.get("transport", "raw") != "raw"
    symmetric = topk and run_kw.get("transport_down") != "raw"
    delta = topk and run_kw["mode"] == "async" and run_kw.get("async_delta")
    deferred = topk and (run_kw["mode"] == "sync" or not (
        run_kw.get("async_delta") or run_kw.get("async_latest_table", True)))
    enc = launches["ef_encode"] + launches["ef_encode_dec"]
    if (enc != encodes[0] or bool(encodes[0]) != topk
            or bool(launches["ef_encode_dec"]) != symmetric
            or launches["encode"] or launches["select"]):
        raise AssertionError(f"{key}: {encodes[0]} encodes took "
                             f"{launches['ef_encode']} ef_encode and "
                             f"{launches['ef_encode_dec']} decoding "
                             f"ef_encode launches, {launches['encode']} of "
                             f"B3, {launches['select']} selects")
    if launches["decode_rows"] != (merges if deferred else 0):
        raise AssertionError(f"{key}: {launches['decode_rows']} "
                             f"dequant_add_rows launches for {merges} merges")
    if launches["dequant_mix"] != (merges if delta else 0) or \
            launches["decode"] or (delta and launches["mix"]):
        raise AssertionError(f"{key}: {launches['dequant_mix']} dequant_mix, "
                             f"{launches['decode']} B4 and {launches['mix']} "
                             f"B1 launches for {merges} merges")
    if not all(np.isfinite(p.accuracy) for p in h):
        raise AssertionError(f"{key}: non-finite accuracy")
    # a server-optimizer merge is one fused launch and B5 never launches;
    # any other merge is one launch of B2 (alpha >= 1) or B1 (alpha < 1).
    # async_delta's B1 launches are its delta_vecs, one a response.
    fused = MERGE_COUNTER.get(run_kw.get("server_opt"))
    for ctr in ("merge_mom", "merge_adam", "mom", "adam"):
        want = merges if ctr == fused else 0
        if launches[ctr] != want:
            raise AssertionError(f"{key}: {launches[ctr]} {ctr} launches, "
                                 f"expected {want} ({merges} merges)")
    plain = launches["agg"] + (0 if run_kw.get("async_delta")
                               else launches["mix"])
    if plain != (0 if fused else merges):
        raise AssertionError(f"{key}: {launches['agg']} B2 and "
                             f"{launches['mix']} B1 launches for {merges} "
                             f"merges")


@contextlib.contextmanager
def counted_encodes():
    """Count the calls of ``topk_quant.ef_encode`` (the codec's encodes)
    while the block runs: yields a one-element list."""
    from repro_torch.kernels import topk_quant
    real, n = topk_quant.ef_encode, [0]

    def counted(*args, **kw):
        n[0] += 1
        return real(*args, **kw)
    topk_quant.ef_encode = counted
    try:
        yield n
    finally:
        topk_quant.ef_encode = real


@contextlib.contextmanager
def recorded_codec(encodes, merges):
    """While the block runs, ``topk_quant.ef_encode`` and
    ``dequant_add_rows`` append copies of their inputs and outputs to
    ``encodes`` and ``merges`` (an encode's ``decoded`` output after its
    other outputs, its keywords without it)."""
    from repro_torch.kernels import topk_quant

    def copy(ts):
        return [None if t is None else t.clone() for t in ts]
    real_enc, real_rows = topk_quant.ef_encode, topk_quant.dequant_add_rows

    def enc(a, b=None, c=None, *, decoded=None, **kw):
        out = real_enc(a, b, c, decoded=decoded, **kw)
        encodes.append((copy((a, b, c)), kw, copy(
            out if decoded is None else (*out, decoded))))
        return out

    def rows_fn(qs, scales, bases, rows):
        out = real_rows(qs, scales, bases, rows)
        merges.append((copy(qs), copy(scales), copy(bases), rows.clone()))
        return out
    topk_quant.ef_encode, topk_quant.dequant_add_rows = enc, rows_fn
    try:
        yield
    finally:
        topk_quant.ef_encode, topk_quant.dequant_add_rows = (real_enc,
                                                             real_rows)


def replay_run(setups, report):
    """REPLAY_RUN once more on the card with every encode and every merge's
    decodes recorded, then each replayed through the plain versions on the
    card: every output equal bit for bit.  Its history is held against
    the run of phase 4 (a reading: both ran on the card)."""
    from repro_torch.core import run_fl
    from repro_torch.kernels import ref
    spec = RUNS[REPLAY_RUN]
    encodes, merges = [], []
    with recorded_codec(encodes, merges):
        h = run_fl(setups.get(spec, setups.dev), epochs_per_round=EPOCHS,
                   max_rounds=spec["rounds"], **spec["run_kw"])
    bad = []
    for i, (ins, kw, out) in enumerate(encodes):
        diff = dec_mismatch(out, ref.reference_ef_encode(*ins, **kw)
                            if len(out) == 5 else
                            ref.reference_ef_encode_decoded(
                                *ins, k=kw["k"], n_params=kw["n_params"]))
        if diff:
            bad.append(f"encode {i}: {diff}")
    for i, (qs, scales, bases, rows) in enumerate(merges):
        plain = torch.full_like(rows, float("nan"))
        ref.reference_dequant_add_rows(qs, scales, bases, plain)
        if not same_bits(rows, plain):
            bad.append(f"merge {i}")
    same = [vars(p) for p in h] == report[REPLAY_RUN]["history"]
    report["replay"] = {"run": REPLAY_RUN, "encodes": len(encodes),
                        "merges": len(merges), "mismatches": bad,
                        "history_equals_phase_4": same}
    print(f"replay {REPLAY_RUN}: {len(encodes)} encodes and {len(merges)} "
          f"merges through the plain versions on the card: "
          f"{len(bad)} differ; history equal to phase 4's: {same}")
    if bad or not encodes or not merges:
        raise AssertionError(f"replay of {REPLAY_RUN}: {bad[:5]}")


def compare_with_cpu(key, h, report):
    """The run again on the CPU from the same initial weights (its history
    ``h``, from ``CpuReruns``): every non-accuracy field equal, accuracy
    within ``gap_bounds``."""
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


# The CPU reruns of phases 4-7 run in CPU_WORKERS worker processes
# (spawned: no CUDA state), CPU_THREADS torch threads each, all submitted
# before phase 4's first card run, so they overlap the card runs, which
# leave the host's other cores idle; the card process compares each run
# with its rerun in turn.  The card runs' host-clock readings (s/round,
# cohort/scale's rounds/s) are taken beside these workers.
CPU_WORKERS, CPU_THREADS = 3, 2


def _cpu_worker_init():
    torch.set_num_threads(CPU_THREADS)


def cpu_rerun(kind, key, weights0):
    """One CPU rerun, from the card's initial weights ``weights0``
    (numpy): kind "run", the history of RUNS run ``key``; "fleet", FLEET
    run ``key``'s ``(history, extras, codecs)``."""
    if kind == "run":
        from repro_torch.core import run_fl
        spec = RUNS[key]
        setups = Setups("cpu")
        setups._weights0[(spec["phase"], spec["model"])] = weights0
        return run_fl(setups.get(spec, "cpu"), epochs_per_round=EPOCHS,
                      max_rounds=spec["rounds"], **spec["run_kw"])
    with recorded_codecs() as codecs:
        h, extra = fleet_call(key, fleet_setup(key, "cpu", dict(weights0)))
    return h, extra, codecs


class CpuReruns:
    """Every CPU rerun of phases 4-7, submitted at once.  The card's
    initial weights are drawn first (each compared run's setup on the
    card, and one fleet setup of each kind that draws its own), so the
    reruns start from them."""

    def __init__(self, setups):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)
        jobs = []
        for key, spec in RUNS.items():
            if spec["compare"]:
                setups.get(spec, setups.dev)
                jobs.append(("run", key, setups._weights0[(spec["phase"],
                                                           spec["model"])]))
        main_w0 = setups._weights0[("main", "mlp")]
        self.fleet_weights0 = {"main": main_w0, "lossy": main_w0}
        for key, spec in FLEET.items():
            if spec["kind"] not in self.fleet_weights0:
                fleet_setup(key, setups.dev, self.fleet_weights0)
        jobs += [("fleet", key, self.fleet_weights0)
                 for key, spec in FLEET.items()
                 if spec["compare"] or spec["kind"] == "auto"]
        self.jobs = {(kind, key): self.pool.submit(cpu_rerun, kind, key, w)
                     for kind, key, w in jobs}

    def result(self, kind, key):
        return self.jobs[(kind, key)].result()

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)


def run_phase(phase, setups, report, cpu):
    """Phases 4-6: every run of ``phase`` on the card, then each compared
    one against its CPU rerun (``cpu``, a ``CpuReruns``)."""
    keys = [k for k, s in RUNS.items() if s["phase"] == phase]
    for key in keys:
        drive(key, setups.get(RUNS[key], setups.dev), report)
    if phase == "main":
        replay_run(setups, report)
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
            compare_with_cpu(key, cpu.result("run", key), report)


# ---------------------------------------------------------------------------
# Phase 7, the fleet: lossy links, the auto codec, cohorts and the
# hierarchical topology with its faults, at MNIST width (MLP 784-128-10)

# every link of the lossy runs: LinkReliability's drop, duplicate, seed
FLEET_LOSS = dict(drop_p=0.1, dup_p=0.05, seed=123)
# The auto runs are fl_figures.fig_autotune_sweep's setup over lossy links
# that drop 20%: the retransmit tax 1/(1 - 0.2) = 1.25 moves the edge
# tier's slowest third (1.2e8 B/s) from int8 to top-k+int8, so a tuner
# that ignores it is seen; at 10% nothing would move.
AUTO_LOSS = dict(drop_p=0.2, dup_p=0.05, seed=123)
AUTO_TIERS = {"backbone": 0.02, "edge": 0.25, "starved": 400.0}
AUTO_SETUP = dict(noise=0.1, batch_size=64, het="strong")
# card vs CPU: the share of encodes whose resolved codec differs, at most
# (see codec_gap; set from the readings in PERF.md)
AUTO_CODEC_GAP = 0.02
# the tuner's controls, each run at AUTO_FAULT_TIER: they must exceed it
AUTO_FAULTS = ("ignores retx", "ignores encode_cost")
AUTO_FAULT_TIER = "edge"
# benchmarks/scale_bench.py: W workers share one batch of one shard
SCALE = dict(W=10_000, cohort=64, rounds=5, epochs=1, plain_W=64)
# fl_figures.fig_chaos_sweep's run at loss 0.1, failover on
CHAOS = dict(seed=123, drop_p=0.1, dup_p=0.05, n_worker_kills=0)
CHAOS_SETUP = dict(noise=0.2, batch_size=64, het="strong")
CHAOS_KILL_AFTER = 2             # the root dies after this global version
CHAOS_TARGET = 0.8
CHAOS_MAX_ROUNDS = 120
BASE_SERVER_BW = 200e6           # fl_figures' server bandwidth before /40
RAW_SYNC = {**MODES["sync"], **TRANSPORTS["raw"]}


def _fleet(kind, rounds, run_kw=None, compare=True, **extra):
    return dict(kind=kind, rounds=rounds, run_kw=run_kw or {},
                compare=compare, **extra)


# run key -> what it drives; "compare": every non-accuracy field equal to
# a CPU run's; "same_as": equal to that phase 4 run on the card, bit for
# bit, accuracy included (its first rounds, where this run has fewer).
# Rounds are leaf rounds, root rounds for the chaos runs.  The runs held
# to no accuracy bound take 10 rounds, not 20 (chip_smoke.py inside half
# its time limit); lossy/sync, held to MAIN_GAPS, keeps 20.
FLEET = {
    "lossy/sync": _fleet("lossy", 20, RAW_SYNC),
    "lossy/async": _fleet("lossy", 20,
                          {**MODES["async"], **TRANSPORTS["raw"]}),
    # top-k kept counts follow the numerics, so not field by field
    "lossy/uplink_only": _fleet(
        "lossy", 10, {**MODES["sync"], **TRANSPORTS["uplink_only"]},
        compare=False),
    **{f"auto/{t}": _fleet("auto", 10, {**SYNC, "transport": "auto"},
                           compare=t == "backbone", div=d)
       for t, d in AUTO_TIERS.items()},
    "cohort/scale": _fleet("scale", SCALE["rounds"],
                           {**SYNC, "cohort": SCALE["cohort"]},
                           W=SCALE["W"]),
    "cohort/scale_plain": _fleet("scale", SCALE["rounds"], SYNC,
                                 compare=False, W=SCALE["plain_W"]),
    "cohort/main": _fleet("main", 10, {**RAW_SYNC, "cohort": 30},
                          compare=False, same_as="raw/sync"),
    "cohort/main_k10": _fleet("main", 10, {**RAW_SYNC, "cohort": 10}),
    "topology/1x1": _fleet("main", 10, {**RAW_SYNC, "topology": "1x1"},
                           compare=False, same_as="raw/sync"),
    "chaos/1x2": _fleet("chaos", CHAOS_MAX_ROUNDS, compare=False,
                        codec="topk_ef+int8", target=CHAOS_TARGET),
    "chaos_raw/1x2": _fleet("chaos", 10, codec="raw", target=None),
}
FLEET_FIELDS = FIELDS + ("retransmits",)
# kernel -> (launch counter key, the fleet runs that must show it)
FLEET_REQUIRED = {
    "fedavg_agg_flat": ("agg", ["lossy/sync", "cohort/scale", "cohort/main",
                                "topology/1x1", "chaos_raw/1x2"]),
    "fedavg_mix_flat": ("mix", ["lossy/async"]),
    "ef_encode": ("ef_encode", ["lossy/uplink_only", "auto/edge",
                                "auto/starved", "chaos/1x2"]),
    "dequant_add_rows": ("decode_rows", ["lossy/uplink_only"]),
    # quantised downlinks: the auto codec's and the 1x2 fan-out's
    "ef_encode_dec": ("ef_encode_dec", ["auto/edge", "chaos/1x2"]),
    # the root's decode of the leaves' top-k+int8 pushes
    "dequant_add": ("decode", ["chaos/1x2"]),
}


def fleet_setup(key, device, weights0):
    """The setup of fleet run ``key`` on ``device``.  ``weights0`` maps
    the run's kind to its initial weights (numpy), drawn by the first
    setup made of that kind and shared by every later one."""
    import dataclasses

    from repro_torch import core
    from repro_torch.configs.paper_cnn import MNIST_CNN
    spec = FLEET[key]
    kind = spec["kind"]
    if kind in ("lossy", "main"):
        table, kw = core.TABLE_4_2["mnist_even"], PHASES["main"][1]
    elif kind == "auto":
        table, kw = core.TABLE_4_1["mnist_even"], AUTO_SETUP
    elif kind == "scale":
        table, kw = [1], {}
    else:
        table, kw = [1] * 12, CHAOS_SETUP
    setup = core.make_setup(table, cfg=MNIST_CNN, seed=0, **kw,
                            weights0=weights0.get(kind), device=device)
    weights0.setdefault(kind, {k: v.cpu().numpy()
                               for k, v in setup.weights0.items()})
    if kind == "auto":
        for p in setup.profiles:
            p.bandwidth /= spec["div"]
    if kind == "scale":
        W = spec["W"]
        setup = dataclasses.replace(
            setup, shards=setup.shards * W,
            device_shards=setup.device_shards * W,
            profiles=core.heterogeneous_profiles(W, "mixed", [1] * W, 0))
    return setup


def _ledger(audit) -> dict:
    import dataclasses
    out = {f.name: getattr(audit, f.name)
           for f in dataclasses.fields(audit) if f.name != "fetch_versions"}
    out["fetches"] = sum(len(v) for v in audit.fetch_versions.values())
    return out


def _lossy_on_build(loss):
    """An ``on_build`` that puts every worker link of a 1x1 topology on a
    lossy channel priced by the leaf's estimator, with ``UplinkCopies``
    as its ledger."""
    from repro_torch.core import transport
    from repro_torch.runtime import faults

    def on_build(topo):
        (lf,) = topo.leaves.values()
        faults.inject_link_reliability(
            lf.server.transport, transport.LinkReliability(**loss),
            estimator=lf.server.est)
        lf.server.transport.audit = uplink_copies()
    return on_build


def uplink_copies():
    """A ``TransportAudit`` that also counts the retransmitted uplink
    copies (``retx_up``): the ledger's ``retx_count`` is both ways."""
    from repro_torch.core import transport

    class UplinkCopies(transport.TransportAudit):
        retx_up = 0

        def note_sent(self, direction, nbytes, retransmit):
            super().note_sent(direction, nbytes, retransmit)
            if retransmit and direction == "up":
                self.retx_up += 1
    return UplinkCopies()


def fleet_call(key, setup, rounds=None):
    """Run fleet run ``key`` on ``setup`` (through the entry points a user
    calls: ``run_fl``, ``run_fl_topology``, ``build_experiment``); returns
    ``(history, extras)``.  ``rounds`` overrides the table's (root rounds
    of the chaos runs)."""
    from repro_torch.core import build_experiment, run_fl, topology
    from repro_torch.runtime import faults
    spec = FLEET[key]
    kind = spec["kind"]
    rounds = spec["rounds"] if rounds is None else rounds
    if kind in ("lossy", "auto"):
        res = topology.run_fl_topology(
            setup, topology="1x1", epochs_per_round=EPOCHS,
            max_rounds=rounds, on_build=_lossy_on_build(
                FLEET_LOSS if kind == "lossy" else AUTO_LOSS),
            **spec["run_kw"])
        stats = faults.audit_chaos_run(res.topology)     # books must close
        (lf,) = res.topology.leaves.values()
        aud = lf.server.transport.audit
        return res.root_history, {"audit": stats, "ledger": _ledger(aud),
                                  "retx_up": aud.retx_up}
    if kind == "scale":
        loop, server = build_experiment(
            setup, epochs_per_round=SCALE["epochs"], max_rounds=rounds,
            **spec["run_kw"])
        server.start()
        loop.run()
        tr = server.transport
        return server.history, {"capacity": server._flat.capacity,
                                "resident_links": len(tr._links),
                                "evictions": tr.total_link_evictions}
    if kind == "main":
        return run_fl(setup, epochs_per_round=EPOCHS, max_rounds=rounds,
                      **spec["run_kw"]), {}
    sched = faults.ChaosSchedule(**CHAOS)

    def on_build(topo):
        sched.apply(topo)            # lossy channel + ledger on every tier
        merge = topo._merge

        def merge_then_kill():
            merge()
            if topo.version == CHAOS_KILL_AFTER and not topo.done:
                topo.loop.schedule(1e-3, topo.kill_root)
        topo._merge = merge_then_kill
    codec = spec["codec"]
    cfg = topology.parse_topology(
        "1x2", push="sync", server_codec=codec, server_frac=0.1,
        server_bandwidth=BASE_SERVER_BW / 40, root_failover=True,
        root_rounds=None if spec["target"] else rounds)
    res = topology.run_fl_topology(
        setup, topology=cfg, mode="sync", selector="all",
        epochs_per_round=EPOCHS,
        max_rounds=rounds if spec["target"] else CHAOS_MAX_ROUNDS,
        target_accuracy=spec["target"], transport=codec, transport_frac=0.1,
        on_build=on_build)
    stats = faults.audit_chaos_run(res.topology)         # books must close
    return res.root_history, {
        "audit": stats, "failover_dispatches": [
            list(d) for d in res.topology.failover_dispatches],
        "leaf_histories": {k: [vars(p) for p in h]
                           for k, h in res.leaf_histories.items()}}


@contextlib.contextmanager
def recorded_codecs():
    """Count the codec every link resolves at every encode, per direction
    (``Transport.resolve_up``/``resolve_down``) while the block runs:
    yields ``{"up": {codec: n}, "down": {codec: n}}``."""
    from repro_torch.core import transport
    counts = {"up": {}, "down": {}}
    real = {d: getattr(transport.Transport, f"resolve_{d}") for d in counts}

    def wrap(d):
        def resolve(self, link):
            spec, frac = real[d](self, link)
            counts[d][spec.name] = counts[d].get(spec.name, 0) + 1
            return spec, frac
        return resolve
    for d in counts:
        setattr(transport.Transport, f"resolve_{d}", wrap(d))
    try:
        yield counts
    finally:
        for d in counts:
            setattr(transport.Transport, f"resolve_{d}", real[d])


def codec_gap(got, want) -> float:
    """The share of encodes whose resolved codec differs between two
    runs' counts: half the L1 distance over the larger total."""
    gap, total = 0, 0
    for d in ("up", "down"):
        names = set(got[d]) | set(want[d])
        gap += sum(abs(got[d].get(n, 0) - want[d].get(n, 0)) for n in names)
        total += max(sum(got[d].values()), sum(want[d].values()))
    return gap / 2 / max(total, 1)


@contextlib.contextmanager
def faulty_tuner(fault):
    """``AutoTuner.expected_latency`` given one of ``AUTO_FAULTS``."""
    from repro_torch.core import autotune
    real = autotune.AutoTuner.expected_latency
    if fault == "ignores retx":
        def latency(self, name, frac, bw, retx):
            return real(self, name, frac, bw, 1.0)
    elif fault == "ignores encode_cost":
        def latency(self, name, frac, bw, retx):
            return self.codec_bytes(name, frac) * retx / max(bw, 1.0)
    else:
        raise ValueError(fault)
    autotune.AutoTuner.expected_latency = latency
    try:
        yield
    finally:
        autotune.AutoTuner.expected_latency = real


@contextlib.contextmanager
def reencode_on_retransmit():
    """The retransmit control: ``transport.transmit`` with a fault, each
    retransmitted uplink copy encoded again from the weights the first
    copy was encoded from (as a sender keeping no copy of what it sent
    would) before it goes out.  Otherwise the lossy path as it is."""
    from repro_torch.core import transport, worker
    real_transmit, real_encode = transport.transmit, transport.Link.encode_up

    def encode_up(self, new_tree):
        self.sent_tree = new_tree
        return real_encode(self, new_tree)

    def transmit(loop, link, payload, t_tx, deliver, direction="up"):
        rel, t = link.reliability, link.t
        if rel is None or direction != "up":
            return real_transmit(loop, link, payload, t_tx, deliver,
                                 direction)
        aud, ch = t.audit, link.channel()
        seq = ch.next_seq()
        timer = [None]

        def arrive():
            if seq in ch.delivered:
                if aud is not None:
                    aud.note_dup(direction)
                return
            ch.delivered.add(seq)
            if timer[0] is not None:
                loop.cancel(timer[0])
                timer[0] = None
            if aud is not None:
                aud.note_delivered(direction, payload.wire_bytes)
            deliver()

        def send(attempt):
            if aud is not None:
                aud.note_sent(direction, payload.wire_bytes, attempt > 0)
            if attempt > 0:
                t.total_retransmits += 1
                real_encode(link, link.sent_tree)          # the fault
            dropped = ch.rng.random_sample() < rel.drop_p
            duped = ch.rng.random_sample() < rel.dup_p
            if not dropped:
                loop.schedule(t_tx, arrive)
                if duped:
                    loop.schedule(rel.dup_delay * t_tx, arrive)
            if attempt + 1 < rel.max_attempts:
                timer[0] = loop.schedule(
                    link.rto(payload.wire_bytes, t_tx, attempt), check,
                    attempt)

        def check(attempt):
            timer[0] = None
            if seq in ch.delivered or t.closed:
                return
            send(attempt + 1)

        send(0)
    transport.transmit = worker.transmit = transmit
    transport.Link.encode_up = encode_up
    try:
        yield
    finally:
        transport.transmit = worker.transmit = real_transmit
        transport.Link.encode_up = real_encode


def check_encodes(encodes: int, ledger: dict, retx_up: int, key: str):
    """A lossy top-k run encodes once per logical uplink payload (the
    ledger's original uplink sends), however many copies went out: a
    retransmit re-sends the same payload.  ``encodes`` is the run's
    ``ef_encode`` launches on the card (its calls on the CPU)."""
    if retx_up < 1:
        raise AssertionError(f"{key}: no uplink copy was retransmitted, "
                             "so the check cannot tell")
    if encodes != ledger["sent_count"]["up"]:
        raise AssertionError(
            f"{key}: {encodes} encodes for {ledger['sent_count']['up']} "
            f"logical uplink payloads ({retx_up} retransmitted copies)")


def fleet_drive(key, setup, report, rounds=None):
    """One fleet run on the card, every launch counter set to 0 just
    before it and read just after; checks the launches it must show."""
    spec = FLEET[key]
    counters = launch_counters()
    with counted_encodes() as encodes, recorded_codecs() as codecs:
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, extra = fleet_call(key, setup, rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: counters[k][k] for k in counters}
    done = h[-1].version
    merges = sum(p.n_updates > 0 for p in h[1:])
    report[key] = {"history": [vars(p) for p in h], "launches": launches,
                   "encodes": encodes[0], "codecs": codecs, "merges": merges,
                   "wall_s": wall, "s_per_round": wall / max(done, 1),
                   "rounds_per_s": done / wall, **extra}
    print(f"fleet {key}: {done} rounds, {merges} merges, retransmits "
          f"{h[-1].retransmits}, final accuracy {h[-1].accuracy:.4f}, "
          f"{wall / max(done, 1):.4f} s per round, codecs {codecs}, "
          f"launches {launches}"
          + "".join(f", {k} {extra[k]}" for k in
                    ("capacity", "resident_links", "evictions", "audit")
                    if k in extra))
    for ctr in ("encode", "select", "mom", "adam", "merge_mom",
                "merge_adam"):
        if launches[ctr]:
            raise AssertionError(f"{key}: {launches[ctr]} {ctr} launches")
    if not all(np.isfinite(p.accuracy) for p in h):
        raise AssertionError(f"{key}: non-finite accuracy")
    kind, run_kw = spec["kind"], spec["run_kw"]
    if kind in ("lossy", "main", "scale"):
        # the worker tier's merges: one B2 (sync) or B1 (FedAsync) each
        ctr = "mix" if run_kw["mode"] == "async" else "agg"
        other = "agg" if ctr == "mix" else "mix"
        if launches[ctr] != merges or launches[other]:
            raise AssertionError(f"{key}: {launches['agg']} B2 and "
                                 f"{launches['mix']} B1 launches for "
                                 f"{merges} merges")
    if kind == "lossy" and h[-1].retransmits < 1:
        raise AssertionError(f"{key}: no retransmit on lossy links")
    if key == "lossy/uplink_only":
        check_encodes(launches["ef_encode"], extra["ledger"],
                      extra["retx_up"], key)
        if launches["decode_rows"] != merges:
            raise AssertionError(f"{key}: {launches['decode_rows']} "
                                 f"dequant_add_rows for {merges} merges")
    if kind == "scale" and "cohort" in run_kw:
        cap, links = extra["capacity"], extra["resident_links"]
        cohort = run_kw["cohort"]
        if launches["agg"] != done:
            raise AssertionError(f"{key}: {launches['agg']} B2 launches "
                                 f"in {done} rounds")
        if cap > 2 * cohort or links > max(4 * cohort, 64):
            raise AssertionError(f"{key}: row buffer of {cap} rows, "
                                 f"{links} resident links")
    return report[key]


def fleet_compare(key, cpu_run, report):
    """Fleet run ``key`` against its CPU rerun (``cpu_run``, ``(history,
    extras, codecs)`` from ``CpuReruns``): every non-accuracy field equal
    (retransmits included), and what the kind adds (the lossy runs'
    ledger, the scale runs' evictions, the chaos runs' failover and
    audit); the auto runs' codec counts within AUTO_CODEC_GAP, at the
    backbone every field too.  Returns the CPU history and extras."""
    spec = FLEET[key]
    h, extra, codecs = cpu_run
    gpu = report[key]
    if spec["compare"]:
        if len(gpu["history"]) != len(h):
            raise AssertionError(f"{key}: {len(gpu['history'])} points on "
                                 f"the card, {len(h)} on the CPU")
        for g, c in zip(gpu["history"], h):
            for f in FLEET_FIELDS:
                if g[f] != getattr(c, f):
                    raise AssertionError(f"{key}: {f} {g[f]} on the card, "
                                         f"{getattr(c, f)} on the CPU")
        for k in ("ledger", "evictions", "capacity", "resident_links",
                  "failover_dispatches", "audit", "leaf_histories"):
            if k in extra and _without_accuracy(extra[k]) != \
                    _without_accuracy(gpu[k]):
                raise AssertionError(f"{key}: {k} {gpu[k]} on the card, "
                                     f"{extra[k]} on the CPU")
    gap = codec_gap(gpu["codecs"], codecs)
    a_gpu = np.array([g["accuracy"] for g in gpu["history"]])
    a_cpu = np.array([c.accuracy for c in h])
    n = min(len(a_gpu), len(a_cpu))
    acc = (float(np.abs(a_gpu[:n] - a_cpu[:n]).max()),
           float(abs(a_gpu[-5:].mean() - a_cpu[-5:].mean())))
    gpu.update(cpu_history=[vars(p) for p in h], cpu_codecs=codecs,
               codec_gap=gap, cpu_accuracy_gaps=acc)
    print(f"cpu {key}: {'every non-accuracy field equal; ' if spec['compare'] else ''}"
          f"codec gap {gap:.4f}; accuracy gap {acc[0]:.4f} at worst point, "
          f"{acc[1]:.4f} in the last-5 mean")
    if spec["kind"] == "auto" and gap > AUTO_CODEC_GAP:
        raise AssertionError(f"{key}: codec counts {gpu['codecs']} on the "
                             f"card, {codecs} on the CPU (gap {gap:.4f} > "
                             f"{AUTO_CODEC_GAP})")
    if spec["kind"] == "lossy" and spec["compare"] and any(
            g > b for g, b in zip(acc, MAIN_GAPS)):
        raise AssertionError(f"{key}: card vs CPU accuracy gaps {acc} "
                             f"above {MAIN_GAPS}")
    return h, extra, codecs


def _without_accuracy(x):
    """``x`` with every ``accuracy`` entry of its histories dropped."""
    if isinstance(x, dict):
        return {k: _without_accuracy(v) for k, v in x.items()
                if k != "accuracy"}
    if isinstance(x, (list, tuple)):
        return [_without_accuracy(v) for v in x]
    return x


def run_fleet(setups, report, cpu):
    """Phase 7: every FLEET run on the card, the card-only checks, the
    controls, then the comparisons with the CPU reruns (``cpu``)."""
    from repro_torch.core import server, time_to_accuracy
    dev = setups.dev
    weights0 = cpu.fleet_weights0
    for key in FLEET:
        fleet_drive(key, fleet_setup(key, dev, weights0), report)
    # the cohort covering every worker and the passthrough topology are
    # the single-server run: phase 4's on the card, bit for bit
    for key, spec in FLEET.items():
        if "same_as" in spec:
            mine = report[key]["history"]
            same = (len(mine) == spec["rounds"] + 1 and mine
                    == report[spec["same_as"]]["history"][:len(mine)])
            report[key]["equals_" + spec["same_as"]] = same
            print(f"fleet {key}: history equal to phase 4's "
                  f"{spec['same_as']} bit for bit: {same}")
            if not same:
                raise AssertionError(f"{key} differs from phase 4's "
                                     f"{spec['same_as']}")
    chaos = report["chaos/1x2"]
    if chaos["audit"]["failovers"] != 1:
        raise AssertionError(f"chaos/1x2: {chaos['audit']['failovers']} "
                             "failovers")
    bench = json.loads((ROOT / "benchmarks" / "results" /
                        "BENCH_chaos.json").read_text())
    h = [server.HistoryPoint(**p) for p in chaos["history"]]
    chaos["t80"] = time_to_accuracy(h, CHAOS_TARGET)
    chaos["bench_t80"] = bench["derived"]["loss0.1/failover_on"]["t80"]
    print(f"fleet chaos/1x2: t80 {chaos['t80']} s (sim), "
          f"BENCH_chaos.json loss0.1/failover_on {chaos['bench_t80']} s; "
          f"{h[-1].version} root versions")
    plain, big = report["cohort/scale_plain"], report["cohort/scale"]
    print(f"fleet cohort/scale: W {SCALE['W']} cohort {SCALE['cohort']} "
          f"{big['rounds_per_s']:.3f} rounds/s, W {SCALE['plain_W']} with "
          f"no cohort {plain['rounds_per_s']:.3f} rounds/s")
    controls = report["fleet_controls"] = {}
    # the retransmit control: a sender that re-encodes each retransmitted
    # copy must fail the encode check
    key = "lossy/uplink_only"
    with reencode_on_retransmit():
        counters = launch_counters()
        zero_counters()
        _, extra = fleet_call(key, fleet_setup(key, dev, weights0), 3)
        got = counters["ef_encode"]["ef_encode"]
    try:
        check_encodes(got, extra["ledger"], extra["retx_up"], key)
        caught = False
    except AssertionError:
        caught = True
    controls["reencode_on_retransmit"] = {
        "ef_encode": got, "logical": extra["ledger"]["sent_count"]["up"],
        "retx_up": extra["retx_up"], "caught": caught}
    print(f"control reencode_on_retransmit: {got} ef_encode launches for "
          f"{extra['ledger']['sent_count']['up']} logical uplinks "
          f"({extra['retx_up']} retransmitted copies); caught: {caught}")
    if not caught:
        raise AssertionError("the re-encoding control passed the check")
    cpu_runs = {}
    for key, spec in FLEET.items():
        if spec["compare"] or spec["kind"] == "auto":
            cpu_runs[key] = fleet_compare(key, cpu.result("fleet", key),
                                          report)
    # the tuner's controls, on the card against the CPU's correct counts
    key = f"auto/{AUTO_FAULT_TIER}"
    for fault in AUTO_FAULTS:
        with faulty_tuner(fault), recorded_codecs() as codecs:
            fleet_call(key, fleet_setup(key, dev, weights0))
        gap = codec_gap(codecs, cpu_runs[key][2])
        controls[f"tuner {fault}"] = {"codecs": codecs, "codec_gap": gap}
        print(f"control tuner {fault}: codecs {codecs}, gap {gap:.4f} "
              f"against the CPU (limit {AUTO_CODEC_GAP})")
        if gap <= AUTO_CODEC_GAP:
            raise AssertionError(f"the faulty tuner ({fault}) passed the "
                                 "codec check")


# ---------------------------------------------------------------------------
# Phase 8, resume: checkpoints across a process boundary, at MNIST width

RESUME_ROUNDS = 6
RESUME_EVERY = 2
RESUME_TIMEOUT_S = 600.0     # a writer's first snapshot; the reader's run
# run key -> run_fl kwargs on the main setup (table 4.2, het strong); a
# "topology" entry runs run_fl_topology, whose leaf histories are held too
RESUME = {
    "raw/sync": RAW_SYNC,
    "raw/async_delta": {**MODES["async_delta"], **TRANSPORTS["raw"]},
    "uplink_only/sync": {**SYNC, **TRANSPORTS["uplink_only"]},
    "auto/async": {**MODES["async"], "transport": "auto"},
    "hetero/sync/fedadam": {**SYNC, **DIRICHLET, **FEDADAM},
    "topology/1x2": {**SYNC, "transport": "topk_ef+int8",
                     "transport_frac": 0.1,
                     "topology": dict(n_leaves=2, push="sync")},
}
# the lossy run: chaos/1x2's setup (ChaosSchedule(**CHAOS) on every tier)
# without failover, RESUME_ROUNDS root versions; its bar is the audit
RESUME_CHAOS = "chaos/1x2"
# kernel -> (launch counter key, the runs whose RESUMED process must show it)
RESUME_REQUIRED = {
    "fedavg_agg_flat": ("agg", ["raw/sync", "uplink_only/sync",
                                "topology/1x2"]),
    "fedavg_mix_flat": ("mix", ["raw/async_delta", "auto/async"]),
    "ef_encode": ("ef_encode", ["uplink_only/sync", "topology/1x2"]),
    "dequant_add_rows": ("decode_rows", ["uplink_only/sync",
                                         "topology/1x2"]),
    "ef_encode_dec": ("ef_encode_dec", ["topology/1x2", RESUME_CHAOS]),
    "dequant_add": ("decode", [RESUME_CHAOS]),
    "merge_opt_flat_adam": ("merge_adam", ["hetero/sync/fedadam"]),
}


def resume_setup(key, device, weights0):
    """The setup of resume run ``key`` on ``device``.  ``weights0`` maps
    the run's kind ("main": phase 4's setup, "chaos": chaos/1x2's) to its
    initial weights (numpy), drawn by the first setup made of that kind."""
    from repro_torch import core
    from repro_torch.configs.paper_cnn import MNIST_CNN
    if key == RESUME_CHAOS:
        return fleet_setup(key, device, weights0)
    setup = core.make_setup(core.TABLE_4_2["mnist_even"], cfg=MNIST_CNN,
                            seed=0, **PHASES["main"][1],
                            weights0=weights0.get("main"), device=device)
    weights0.setdefault("main", {k: v.cpu().numpy()
                                 for k, v in setup.weights0.items()})
    return setup


def resume_call(key, setup, rounds=RESUME_ROUNDS, epochs=EPOCHS, **ckpt):
    """Resume run ``key`` through ``run_fl`` or ``run_fl_topology`` with
    the checkpoint arguments ``ckpt``; returns ``(histories, topology)``,
    histories keyed "root" (the run's own) and by leaf."""
    from repro_torch.core import run_fl, topology
    from repro_torch.runtime import faults
    if key == RESUME_CHAOS:
        cfg = topology.parse_topology(
            "1x2", push="sync", server_codec="topk_ef+int8",
            server_frac=0.1, server_bandwidth=BASE_SERVER_BW / 40,
            root_failover=False, root_rounds=rounds)
        # the schedule is applied once: a resumed run's snapshot carries
        # the lossy channels and their ledgers
        on_build = (None if ckpt.get("resume")
                    else faults.ChaosSchedule(**CHAOS).apply)
        res = topology.run_fl_topology(
            setup, topology=cfg, mode="sync", selector="all",
            epochs_per_round=epochs, max_rounds=CHAOS_MAX_ROUNDS,
            transport="topk_ef+int8", transport_frac=0.1,
            on_build=on_build, **ckpt)
    elif "topology" in RESUME[key]:
        kw = dict(RESUME[key])
        cfg = topology.parse_topology(topology.TopologyConfig(
            **kw.pop("topology")))
        res = topology.run_fl_topology(setup, topology=cfg,
                                       epochs_per_round=epochs,
                                       max_rounds=rounds, **kw, **ckpt)
    else:
        h = run_fl(setup, epochs_per_round=epochs, max_rounds=rounds,
                   **RESUME[key], **ckpt)
        return {"root": h}, None
    return {"root": res.root_history, **res.leaf_histories}, res.topology


def _hex_histories(hists) -> dict:
    """Histories as dicts of every field, floats as ``float.hex``."""
    return {name: [{k: v.hex() if isinstance(v, float) else v
                    for k, v in vars(p).items()} for p in h]
            for name, h in hists.items()}


@contextlib.contextmanager
def timed_snapshots(log):
    """While the block runs, each snapshot capture, manager restore and
    federation restore appends ``(what, seconds, detail)`` to ``log``."""
    from repro_torch.checkpoint import CheckpointManager, FederationSnapshot
    real = {n: FederationSnapshot.__dict__[n] for n in (
        "capture_run", "capture_topology", "restore_run",
        "restore_topology")}
    real_latest = CheckpointManager.restore_latest

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            log.append((name, time.perf_counter() - t0, None))
            return out
        return call

    def latest(self):
        t0 = time.perf_counter()
        got = real_latest(self)
        log.append(("read", time.perf_counter() - t0,
                    None if got is None else got[0]))
        return got
    for n in ("capture_run", "capture_topology"):
        setattr(FederationSnapshot, n, classmethod(
            timed("capture", real[n].__func__)))
    for n in ("restore_run", "restore_topology"):
        setattr(FederationSnapshot, n, timed("restore", real[n]))
    CheckpointManager.restore_latest = latest
    try:
        yield log
    finally:
        for n, fn in real.items():
            setattr(FederationSnapshot, n, fn)
        CheckpointManager.restore_latest = real_latest


def _child_weights0(work) -> dict:
    w0 = dict(np.load(Path(work) / "weights0.npz"))
    return {kind: {k[len(kind) + 1:]: v for k, v in w0.items()
                   if k.startswith(kind + "/")} for kind in ("main", "chaos")}


def resume_writer(key, work, device, rounds, epochs, hold):
    """Child process: run resume run ``key`` with ``checkpoint_every``;
    the parent SIGKILLs it once its first snapshot is on disk.  With
    ``hold`` it waits to be killed after that save, so the kill lands
    before the run ends however fast the device runs it."""
    from repro_torch.checkpoint import CheckpointManager
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    setup = resume_setup(key, device, _child_weights0(work))
    d = Path(work) / key.replace("/", "_")
    log = []
    real_save = CheckpointManager.save

    def save(self, step, state, metadata=None, *, raw=False):
        # the capture ran just before: its time goes out before the
        # snapshot is published (the parent kills at the publish)
        (d.parent / (d.name + ".capture.json")).write_text(json.dumps(
            {"step": step, "capture_s": log[-1][1]}))
        real_save(self, step, state, metadata, raw=raw)
        if hold:
            time.sleep(600)
    CheckpointManager.save = save
    with timed_snapshots(log):
        resume_call(key, setup, rounds, epochs,
                    checkpoint_every=RESUME_EVERY, checkpoint_dir=str(d))
    print(f"resume writer {key}: the run ended before its kill",
          flush=True)
    return 3


def resume_reader(work, device, rounds, epochs):
    """Child process: resume every killed run of ``work`` from its newest
    snapshot (``resume=True``), every launch counter at 0 before each and
    read after; writes ``resumed.json``."""
    from repro_torch.runtime import faults
    device = torch.device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    out, setups, weights0 = {}, {}, _child_weights0(work)
    for key in list(RESUME) + [RESUME_CHAOS]:
        d = Path(work) / key.replace("/", "_")
        kind = "chaos" if key == RESUME_CHAOS else "main"
        if kind not in setups:
            setups[kind] = resume_setup(key, device, weights0)
        setup = setups[kind]
        counters = launch_counters()
        log = []
        with timed_snapshots(log):
            zero_counters()
            hists, topo = resume_call(key, setup, rounds, epochs,
                                      checkpoint_dir=str(d), resume=True)
            if device.type == "cuda":
                torch.cuda.synchronize()
        (_, read_s, step), (_, restore_s, _) = log
        rec = {"histories": _hex_histories(hists), "step": step,
               "launches": {k: counters[k][k] for k in counters},
               "bytes": (d / f"ckpt_{step:012d}.pkl").stat().st_size,
               "read_s": read_s, "restore_s": restore_s}
        if key == RESUME_CHAOS:
            rec["audit"] = faults.audit_chaos_run(topo)  # books must close
        out[key] = rec
    (Path(work) / "resumed.json").write_text(json.dumps(out))
    return 0


def _spawn(args, work, name):
    log = open(Path(work) / f"{name}.log", "wb")
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             *map(str, args)], stdout=log,
                            stderr=subprocess.STDOUT), log


def _log_tail(work, name, n=2000) -> str:
    p = Path(work) / f"{name}.log"
    return p.read_text(errors="replace")[-n:] if p.exists() else ""


def run_resume(device, report, weights0, rounds=RESUME_ROUNDS,
               epochs=EPOCHS):
    """Phase 8: each RESUME run (and RESUME_CHAOS) in a child process with
    ``checkpoint_every``, all in parallel, each SIGKILLed once its first
    snapshot is published; then one fresh process resumes them all while
    this one runs each RESUME run uninterrupted.  Each resumed history
    must equal the uninterrupted one in every field, accuracy bits
    included (root and leaves), the resumed process must have launched
    each kernel of RESUME_REQUIRED, and the chaos run's audit must close.
    On the CPU (the tests' rehearsal, where a round takes milliseconds)
    each writer waits for its kill after its first save."""
    import shutil
    import signal
    import tempfile
    device = torch.device(device)
    hold = device.type == "cpu"
    keys = list(RESUME) + [RESUME_CHAOS]
    main_setup = resume_setup(keys[0], device, weights0)
    resume_setup(RESUME_CHAOS, device, weights0)     # draws its weights
    work = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    procs = {}
    try:
        np.savez(Path(work) / "weights0.npz", **{
            f"{kind}/{k}": v for kind, w in weights0.items()
            for k, v in w.items()})
        for key in keys:
            procs[key] = _spawn(["--resume-writer", key, work, device.type,
                                 rounds, epochs, int(hold)], work,
                                "writer_" + key.replace("/", "_"))
        deadline = time.perf_counter() + RESUME_TIMEOUT_S
        pending = dict(procs)
        while pending:
            for key in list(pending):
                proc, _ = pending[key]
                d = Path(work) / key.replace("/", "_")
                if d.is_dir() and any(d.glob("ckpt_*.pkl")):
                    proc.send_signal(signal.SIGKILL)
                    proc.wait(timeout=60)
                    del pending[key]
                elif proc.poll() is not None:
                    raise AssertionError(
                        f"resume writer {key} exited ({proc.returncode}) "
                        f"before its first snapshot:\n"
                        + _log_tail(work, "writer_" + key.replace("/", "_")))
            if time.perf_counter() > deadline:
                raise AssertionError(f"resume writers {sorted(pending)} "
                                     f"published no snapshot in "
                                     f"{RESUME_TIMEOUT_S} s")
            time.sleep(0.01)
        for key, (proc, _) in procs.items():
            if proc.returncode != -signal.SIGKILL:
                raise AssertionError(f"resume writer {key} ended with "
                                     f"{proc.returncode}, not by SIGKILL")
        reader, _ = procs["reader"] = _spawn(
            ["--resume-reader", work, device.type, rounds, epochs], work,
            "reader")
        full = {}
        for key in RESUME:
            counters = launch_counters()
            zero_counters()
            t0 = time.perf_counter()
            hists, _ = resume_call(key, main_setup, rounds, epochs)
            if device.type == "cuda":
                torch.cuda.synchronize()
            full[key] = {"histories": _hex_histories(hists),
                         "wall_s": time.perf_counter() - t0,
                         "launches": {k: counters[k][k] for k in counters}}
        if reader.wait(timeout=RESUME_TIMEOUT_S) != 0:
            raise AssertionError("resume reader failed:\n"
                                 + _log_tail(work, "reader"))
        resumed = json.loads((Path(work) / "resumed.json").read_text())
        if device.type == "cuda":
            print(f"resume: the readings below were taken on "
                  f"{card_line()}")
        rec = report["resume"] = {}
        for key in keys:
            got = resumed[key]
            cap = json.loads((Path(work) / (key.replace("/", "_")
                                            + ".capture.json")).read_text())
            r = rec[key] = {
                "snapshot_step": got["step"], "snapshot_bytes": got["bytes"],
                "capture_s": cap["capture_s"], "read_s": got["read_s"],
                "restore_s": got["restore_s"],
                "launches_resumed": got["launches"]}
            if key == RESUME_CHAOS:
                r["audit"] = got["audit"]
            else:
                r.update(launches_uninterrupted=full[key]["launches"],
                         uninterrupted_wall_s=full[key]["wall_s"],
                         history=full[key]["histories"],
                         equal=got["histories"] == full[key]["histories"])
            print(f"resume {key}: snapshot of version {got['step']} "
                  f"({got['bytes']} bytes), capture {cap['capture_s']:.4f} "
                  f"s, read {got['read_s']:.4f} s, restore "
                  f"{got['restore_s']:.4f} s; "
                  + (f"audit {got['audit']}" if key == RESUME_CHAOS else
                     f"resumed == uninterrupted in every field: "
                     f"{r['equal']}")
                  + f"; resumed launches {got['launches']}")
            if key != RESUME_CHAOS and not r["equal"]:
                diff = [(name, i) for name, h in full[key][
                    "histories"].items() for i, (a, b) in enumerate(
                        zip(h, got["histories"].get(name, [])))
                        if a != b]
                raise AssertionError(f"resume {key}: the resumed history "
                                     f"differs from the uninterrupted one "
                                     f"at {diff[:4]}")
        # the kernels' plain versions (CPU tensors) count no launches
        for name, (ctr, need) in RESUME_REQUIRED.items():
            for key in need:
                if device.type == "cuda" and \
                        resumed[key]["launches"][ctr] < 1:
                    raise AssertionError(f"{name} never launched in the "
                                         f"resumed process of {key}")
        return rec
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            log.close()
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 9, the sharded substrate (B7): the aggregation server's row buffer
# and vectors split along N over a mesh that repeats the one card
# (agg_mesh(devices=...)), the card's pieces merged by one launch of B1,
# B2 or merge_opt_flat

# (W, N) of the B7 checks: benchmarks/agg_shard_bench.py's largest cell
# (mlp_16m, 256 rows: 17.2 GB of rows), the main path's MLP padded for
# D = 4 (101,770 parameters -> 102,400) at W = 30, and FedAsync's W = 1
B7_SIZES = ((256, 16_777_216), (30, 102_400), (1, 102_400))
B7_MESHES = (1, 2, 4)
B7_FORMS = ("mix", "agg", "merge_mom", "merge_adam", "opt_mom", "opt_adam")
B7_S = 0.4                      # the mix's server scale
# controls: a faulty wrapper's result must fail the check
B7_FAULTS = ("shards written back one block off",
             "a shard's server term dropped",
             "a device's group covers only its first piece")
# kernels-line record -> (form, the counter of the kernel it launches a
# device, the TPU function it replaces)
B7_RECORDS = {
    "fedavg_mix_flat_sharded": ("mix", "mix", "fedavg_agg.py:234"),
    "fedavg_agg_flat_sharded": ("agg", "agg", "fedavg_agg.py:268"),
    "merge_opt_flat_sharded_mom": ("merge_mom", "merge_mom",
                                   "fedavg_agg.py:289"),
    "merge_opt_flat_sharded_adam": ("merge_adam", "merge_adam",
                                    "fedavg_agg.py:289"),
    "server_opt_step_flat_sharded_mom": ("opt_mom", "mom",
                                         "fedavg_agg.py:289"),
    "server_opt_step_flat_sharded_adam": ("opt_adam", "adam",
                                          "fedavg_agg.py:289"),
}
N_TIMED_B7 = 10
SHARD_ROUNDS = 3
# phase 9's FL runs: the main phase's setup (table 4.2, het strong)
SHARD_RUNS = {
    "raw/sync": {**MODES["sync"], **TRANSPORTS["raw"]},
    "uplink_only/sync": {**MODES["sync"], **TRANSPORTS["uplink_only"]},
    "uplink_only/async_delta": {**MODES["async_delta"],
                                **TRANSPORTS["uplink_only"]},
    # raw responses still take the delta merge's stack and B1, which the
    # top-k run above no longer launches (its merge is dequant_mix)
    "raw/async_delta": {**MODES["async_delta"], **TRANSPORTS["raw"]},
    "hetero/sync/fedavgm": {**SYNC, **DIRICHLET, **FEDAVGM},
    "hetero/sync/fedadam": {**SYNC, **DIRICHLET, **FEDADAM},
    "time_based/T0=0": {**MODES["time_based"], **TRANSPORTS["raw"]},
    "topology/1x2": {**SYNC, "topology": "1x2",
                     "transport": "topk_ef+int8", "transport_frac": 0.1},
}
SHARD_RESUME = ("raw/sync", 2)   # killed at its first snapshot, resumed
# counters of the kernels a sharded run launches once a device per merge
# or decode, over every piece the device holds: its launches are the
# distinct devices times the unsharded run's, its pieces D times; the
# counters it leaves as the unsharded run has them; a sharded run over
# D > 1 devices encodes only through ef_encode's sharded form, over one
# device through the unsharded form (shard_enc_launches)
GROUPED = ("agg", "mix", "merge_mom", "merge_adam", "decode_rows",
           "decode", "dequant_mix")
UNSHARDED = ("encode", "select", "sample", "mom", "adam")


def shard_enc_launches(D: int, unsharded: int) -> tuple[int, int]:
    """(unsharded, sharded) ef_encode launches of a SHARD_RUNS run on D
    shards whose unsharded twin launched ``unsharded`` (one a top-k
    encode: the exact path at MNIST width).  One shard: the unsharded form
    on its one piece, the same launches.  D > 1: a pass 1 and a pass 2 a
    shard, the select and the kept partials' sum on the home device, for
    each encode."""
    if D == 1:
        return unsharded, 0
    return 0, (2 * D + 2) * unsharded


# check_shard_encode: ef_encode on Sharded a, b, c, all present (a sharded
# server's uplink encode), at D = 1, 2 and 4 repeating the card, bit for
# bit against the unsharded kernel on the gathered vectors at the same
# width: (N, n_params, k) at the main path's MLP padded for D = 4 (the
# exact path, k = 10,177) and at B7's width (the sampled path, stride 128)
SHARD_ENC_SIZES = ((102_400, 101_770, 10_177),
                   (16_777_216, 16_777_216, 1_677_721))
# codec -> (top-k, quantize): the int8 codec encodes with k None
SHARD_ENC_FORMS = {"topk_ef": (True, False), "topk_ef+int8": (True, True),
                   "int8": (False, True)}
# controls, on the top-k+int8 form at D = 2: what a faulty sharded encode
# would return must fail the check (the inputs put max |x| at the first
# element of the last shard)
SHARD_ENC_FAULTS = ("a shard's sample offset one element off",
                    "the last shard's partials left out of the reduction",
                    "a shard's kept partials left out of the total")
N_TIMED_SHARD = 20
# check_shard_decode: a merge's decodes into a sharded row buffer (the main
# path's 30 workers); controls: a faulty grouped decode must fail the check
SHARD_DEC_W = 30
# (one for each form: the fault applies to the form it names)
SHARD_DEC_FAULTS = {"decode": "a device's B4 covers only its first piece",
                    "rows": "a device's row decode covers only its first "
                            "piece"}


def b7_inputs(dev, W, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(W, N, device=dev, generator=g)
    w = torch.rand(W, device=dev, generator=g) + 0.1
    w /= w.sum()
    server, prev, m = (torch.randn(N, device=dev, generator=g)
                       for _ in range(3))
    v = torch.rand(N, device=dev, generator=g)
    w_mix = (1.0 - B7_S) * w
    wvec = torch.cat([torch.full((1,), B7_S, device=dev), w_mix])
    return dict(rows=rows, w=w, w_mix=w_mix, wvec=wvec, server=server,
                prev=prev, m=m, v=v)


def b7_sharded(o, mesh):
    """The inputs ``o`` placed on ``mesh``: rows and (N,) vectors split,
    the weights whole."""
    from repro_torch.parallel import sharding as psh
    N = o["rows"].shape[1]
    return {k: (psh.split(t, mesh) if k == "rows" or t.numel() == N else t)
            for k, t in o.items()}


def _b7_scalars(form):
    return np.asarray(OPT_SCALARS["fedadam" if form.endswith("adam")
                                  else "fedavgm"], np.float32)


def b7_call(form, o, mesh=None):
    """One form on the inputs ``o``: through its B7 wrapper over ``mesh``
    (the inputs whole or already sharded), or with mesh None through the
    unsharded wrapper.  Returns the outputs, fresh (new, then the state)."""
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.kernels import server_opt
    sc, adam = _b7_scalars(form), form.endswith("adam")
    v = o["v"] if adam else None
    if form == "mix":                   # the merge path's (wvec) form
        if mesh is None:
            return (fa.fedavg_mix_wvec(o["rows"], o["wvec"], o["server"]),)
        return (fa.fedavg_mix_wvec_sharded(o["rows"], o["wvec"],
                                           o["server"], mesh=mesh),)
    if form == "agg":
        if mesh is None:
            return (fa.fedavg_agg_flat(o["rows"], o["w"]),)
        return (fa.fedavg_agg_flat_sharded(o["rows"], o["w"], mesh=mesh),)
    if form.startswith("merge"):
        # momentum behind the aggregate, adam behind the mix
        wv, srv = (o["wvec"], o["server"]) if adam else (o["w"], None)
        args = (o["rows"], wv, srv, o["prev"], o["m"], v, sc)
        out = (fa.merge_opt_flat(*args, adam=adam) if mesh is None else
               fa.merge_opt_flat_sharded(*args, adam=adam, mesh=mesh))
        return out if adam else out[:2]
    args = (o["prev"], o["server"], o["m"], v, sc)
    out = (server_opt.server_opt_step_flat(*args, adam=adam) if mesh is None
           else fa.server_opt_step_flat_sharded(*args, adam=adam, mesh=mesh))
    return out if adam else out[:2]


def b7_plain(form, o, D):
    """The form's plain sharded version: the plain version on each of D
    equal ranges of N, concatenated."""
    from repro_torch.kernels import ref
    sc, adam = _b7_scalars(form), form.endswith("adam")
    v = o["v"] if adam else None
    if form == "mix":
        return (ref.reference_fedavg_sharded(o["rows"], o["w_mix"],
                                             o["server"], B7_S, D),)
    if form == "agg":
        S = o["rows"].shape[1] // D
        return (torch.cat([ref.reference_fedavg(
            o["rows"][:, d * S:(d + 1) * S], o["w"]) for d in range(D)]),)
    if form.startswith("merge"):
        wv, srv = (o["wvec"], o["server"]) if adam else (o["w"], None)
        out = ref.reference_merge_opt_sharded(
            o["rows"], wv, srv, o["prev"], o["m"], v, sc, adam=adam,
            n_shards=D)
    else:
        out = ref.reference_server_opt_sharded(
            o["prev"], o["server"], o["m"], v, sc, adam=adam, n_shards=D)
    return out if adam else out[:2]


def first_pieces_only(sh):
    """What a grouped launch that covered only each device's first piece
    would leave in the ``Sharded`` ``sh``: the device's other pieces never
    written (zeros stand for what they held)."""
    from repro_torch.parallel import sharding as psh
    pieces = list(sh.shards)
    for _, idx in psh.device_groups(sh.mesh):
        for i in idx[1:]:
            pieces[i] = torch.zeros_like(pieces[i])
    return psh.Sharded(pieces, sh.mesh)


def b7_fault(fault, form, out, o_sh):
    """What a faulty wrapper would return: shard pieces written back one
    block off, the last shard's mix taken without its server term, or a
    device's launch over its first piece only."""
    from repro_torch.core.flatbuf import BLOCK
    from repro_torch.kernels import fedavg_agg as fa
    from repro_torch.parallel import sharding as psh
    first = out[0]
    if fault == B7_FAULTS[2]:
        return tuple(first_pieces_only(x) for x in out)
    pieces = list(first.shards)
    if fault == B7_FAULTS[0]:
        pieces = [p.roll(BLOCK) for p in pieces]
    elif form in ("mix", "merge_adam"):
        rows = o_sh["rows"].shards[-1]
        if form == "mix":
            pieces[-1] = fa.fedavg_agg_flat(rows, o_sh["w_mix"])
        else:
            last = [o_sh[k].shards[-1].clone() for k in ("prev", "m", "v")]
            pieces[-1] = fa.merge_opt_flat(
                rows, o_sh["w_mix"], None, *last, _b7_scalars(form),
                adam=True)[0]
    return (psh.Sharded(pieces, first.mesh),) + tuple(out[1:])


def _turns3(timer, kern, other, lib, n):
    """``kern`` in turns with ``other`` and the library call ``lib`` (or
    None): lib, other, kern, kern, other, lib; the means of each."""
    first = timer(lib, n) if lib is not None else None
    o = [timer(other, n)]
    k = [timer(kern, n), timer(kern, n)]
    o.append(timer(other, n))
    lb = None if lib is None else statistics.mean([first, timer(lib, n)])
    return statistics.mean(k), statistics.mean(o), lb, {
        "kernel": k, "unsharded": o}


def _b7_bound(form, W, N):
    """(bytes, flops) of one form: every input read once, every output
    written once."""
    return {"mix": ((W * N + W + 1 + 2 * N) * 4, 2 * W * N + 2 * N),
            "agg": ((W * N + W + N) * 4, 2 * W * N),
            "merge_mom": ((W * N + W + 4 * N) * 4, (2 * W + 8) * N),
            "merge_adam": ((W * N + W + 1 + 7 * N) * 4, (2 * W + 15) * N),
            "opt_mom": (5 * N * 4 + 16, 8 * N),
            "opt_adam": (7 * N * 4 + 16, 13 * N)}[form]


def check_b7(dev, sizes=B7_SIZES, meshes=B7_MESHES, fault=None):
    """B7 on ``dev``: each form of B7_FORMS at each (W, N) of ``sizes``
    and each D of ``meshes`` (a mesh repeating ``dev``), its result equal
    bit for bit to the unsharded kernel's on the same data and to the
    plain sharded version.  On the card each form is also timed (D = 1 in
    turns with the unsharded kernel and the one-call library form, D > 1
    with the unsharded kernel), L2 flushed.  With ``fault`` the B7 result
    is altered as a faulty wrapper would leave it: the check must fail.
    On the card each call must make one launch a device of the mesh (one
    here) covering D pieces.  Returns the record: cases, errors, launches
    and pieces, and timings."""
    from repro_torch.kernels import fedavg_agg
    from repro_torch.parallel import sharding as psh
    on_card = dev.type == "cuda"
    timer = Timer(dev) if on_card and fault is None else None
    ctr = {form: c for form, c, _ in B7_RECORDS.values()}
    launched, covered = launch_counters(), piece_counters()
    rec = {"cases": 0, "err": {f: 0.0 for f in B7_FORMS}, "by_case": []}
    for i, (W, N) in enumerate(sizes):
        o = b7_inputs(dev, W, N, seed=100 + i)
        whole = {f: b7_call(f, o) for f in B7_FORMS}
        libs = {"mix": lambda: torch.addmv(o["server"], o["rows"].t(),
                                           o["w_mix"], beta=B7_S),
                "agg": lambda: torch.mv(o["rows"].t(), o["w"])}
        lib_ms = {}
        for D in meshes:
            mesh = psh.agg_mesh(devices=(dev,) * D)
            o_sh = b7_sharded(o, mesh)
            shard_bytes = W * (N // D) * 4
            # the reference's form of the sharded mix is the same launch
            ref_form = fedavg_agg.fedavg_mix_flat_sharded(
                o_sh["rows"], o["w_mix"], o_sh["server"], B7_S, mesh=mesh)
            if not torch.equal(ref_form.gather(), whole["mix"][0]):
                raise AssertionError(f"B7 fedavg_mix_flat_sharded W = {W} "
                                     f"N = {N} D = {D} differs from the "
                                     f"unsharded kernel")
            n_dev = len(psh.device_groups(mesh))
            for form in B7_FORMS:
                k = ctr[form]
                before = launched[k][k], covered[k][k]
                got = b7_call(form, o_sh, mesh)
                counts = (launched[k][k] - before[0],
                          covered[k][k] - before[1])
                if on_card and counts != (n_dev, D):
                    raise AssertionError(
                        f"B7 {form} W = {W} N = {N} D = {D}: {counts[0]} "
                        f"launches over {counts[1]} pieces, {n_dev} over "
                        f"{D} expected")
                if fault is not None:
                    got = b7_fault(fault, form, got, o_sh)
                plain = b7_plain(form, o, D)
                for name, g, u, p in zip(MERGE_OUTPUTS, got, whole[form],
                                         plain):
                    g = g.gather()
                    e = max_err(g, p)
                    rec["err"][form] = max(rec["err"][form], e)
                    if not (torch.equal(g, u) and torch.equal(g, p)):
                        raise AssertionError(
                            f"B7 {form} W = {W} N = {N} D = {D}: {name} "
                            f"differs from the unsharded kernel "
                            f"({max_err(g, u)}) or the plain sharded "
                            f"version ({e})")
                rec["cases"] += 1
                if timer is None:
                    continue
                n = N_TIMED_B7 if W * N > 1 << 28 else 2 * N_TIMED_B7
                kern = lambda: b7_call(form, o_sh, mesh)
                unsh = lambda: b7_call(form, o)
                lib = libs.get(form) if D == meshes[0] else None
                ms, ums, lms, turns = _turns3(timer, kern, unsh, lib, n)
                if lms is not None:
                    lib_ms[form] = lms
                n_bytes, flops = _b7_bound(form, W, N)
                b_ms, b_by = bound_ms(n_bytes, flops)
                case = {"form": form, "W": W, "N": N, "D": D, "ms": ms,
                        "launches": counts[0], "pieces": counts[1],
                        "unsharded_ms": ums,
                        "library_ms": lib_ms.get(form),
                        "plain_ms": timer(lambda: b7_plain(form, o, D),
                                          *((N_TIMED_PLAIN, WARM_PLAIN)
                                            if W * N > 1 << 28 else (n,))),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "n_bytes": n_bytes, "shard_row_bytes": shard_bytes,
                        "turns": turns}
                rec["by_case"].append(case)
                print(f"time B7 {form} W = {W} N = {N} D = {D} ({shard_bytes}"
                      f" B of rows a shard): {ms:.4f} ms, unsharded "
                      f"{ums:.4f} ms, library {case['library_ms']} ms, "
                      f"plain {case['plain_ms']:.4f} ms, bound {b_ms:.4f} "
                      f"ms ({b_by})")
            del o_sh
        del o, whole
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["ok"] = True
    return rec


def shard_enc_inputs(g, N):
    """(a, b, c) of an uplink encode (as ef_inputs "parts" draws them)
    with max |x| at element N / 2: the first element of the last shard at
    D = 2."""
    dev = g.device
    a, b = (torch.randn(N, device=dev, generator=g) for _ in range(2))
    a[N // 2] = 40.0
    return a, b, 0.01 * torch.randn(N, device=dev, generator=g)


def shard_enc_fault(fault, sh, *, k, n_params, quantize):
    """What a sharded ef_encode with ``fault`` would return on the
    ``Sharded`` inputs ``sh`` (gathered): the plain sharded decomposition
    (``ref.reference_ef_encode_sharded``) with the last shard's share of
    the sample read one element late, with the last shard's max and kept
    count left out of the reduction, or with only its kept partials left
    out of the kept total (the sum after the passes 2)."""
    from repro_torch.kernels import ref
    if fault not in SHARD_ENC_FAULTS:
        raise ValueError(fault)
    mesh = sh[0].mesh
    home = mesh.home
    xs = [(a - b) + c for a, b, c in zip(*(t.shards for t in sh))]
    n = sum(x.numel() for x in xs)
    if fault == SHARD_ENC_FAULTS[0]:
        stride, _, ks = ref.sample_plan(n, k, n_params)
        plan = ref.shard_samples(n, len(xs), stride)
        plan[-1] = (plan[-1][0] + 1, plan[-1][1] - 1)
        sample = torch.cat([x[off::stride][:m].to(home)
                            for x, (off, m) in zip(xs, plan)])
        t = (torch.topk(sample.abs(), ks).values[-1]
             if n_params <= ref.SAMPLE_CAP
             else sample.abs().sort().values[-ks])
        thresh = torch.clamp_min(t, ref.THRESH_FLOOR)
        keep = xs
    else:
        thresh = ref.reference_topk_threshold_sharded(xs, k, n_params, home)
        keep = xs[:-1] if fault == SHARD_ENC_FAULTS[1] else xs
    counted = xs[:-1] if fault != SHARD_ENC_FAULTS[0] else xs
    x = torch.cat(xs)
    kept = sum(torch.sum(p.abs() >= thresh) for p in counted)
    if not quantize:
        recon = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
        return recon, x - recon, thresh, None, kept
    scale = ref.reference_int8_scale(torch.stack([p.abs().max()
                                                  for p in keep]))
    q, r = ref.reference_topk_quant_encode(x, thresh, scale)
    return q, r, thresh, scale, kept


def _gathered(out):
    """An encode's outputs with its ``Sharded`` ones gathered."""
    from repro_torch.parallel import sharding as psh
    return tuple(o.gather() if isinstance(o, psh.Sharded) else o
                 for o in out)


def check_ef_stages(pa, pb, pc, *, k, n_params, quantize):
    """Each launch of ef_encode's grid form, alone, against its stage of
    the plain staged version (``ref.reference_ef_pass1``,
    ``reference_ef_select``, ``reference_ef_pass2``) on the same inputs:
    the pieces ``pa``, ``pb``, ``pc`` (one vector: one piece; ``pb``,
    ``pc`` None or all present) in shard order.  Pass 1 a piece: its share
    of the sample, x where stored, the max of its max keys and (int8) its
    kept partials' sum; the select (top-k) or the reduce (int8) on the
    first piece's device: thresh and scale; pass 2 a piece: q or recon, r
    and its kept partials' sum; the kept total.  Launches here do not
    count as the path's.  Returns the names of the stages' outputs that
    differ."""
    from repro_torch.kernels import ref, topk_quant as tq
    D, S = len(pa), pa[0].numel()
    n, home = D * S, pa[0].device
    topk = k is not None
    if topk:
        stride, m, ks = ref.sample_plan(n, k, n_params)
        plan = ref.shard_samples(n, D, stride)
    else:
        stride, plan = 1, [(0, 0)] * D
    G = tq.grid_blocks(S)
    store = pb is not None
    bad, p1, k_pass1 = [], [], []
    i32 = torch.int32
    for d, (off, md) in enumerate(plan):
        a, b, c = pa[d], pb and pb[d], pc and pc[d]
        sample = torch.empty(md, device=home) if md else None
        x = torch.empty(S, device=home) if store else None
        pm = torch.empty(G, dtype=i32, device=home)
        pk = None if topk else torch.empty(G, dtype=i32, device=home)
        tq.ef_pass1(a, b, c, blocks=G, off=off, stride=stride, sample=sample,
                    x=x, part_max=pm, part_kept=pk)
        xv, smp, mx, k0 = ref.reference_ef_pass1(a, b, c, off=off,
                                                 stride=stride, m=md,
                                                 count=not topk)
        for name, got, want in (("x", x, xv if store else None),
                                ("sample", sample, smp if md else None),
                                ("max", tq.key_max(pm), mx)):
            if got is not None and not same_bits(got, want):
                bad.append(f"pass 1 piece {d}: {name}")
        if pk is not None and int(pk.sum()) != int(k0):
            bad.append(f"pass 1 piece {d}: kept partials")
        p1.append((x if store else a, sample, pm, pk, xv, mx, k0))
        k_pass1.append(k0)
    stats = torch.empty(3, device=home)
    maxes = torch.stack([mx for *_, mx, _ in p1])
    pmax = torch.cat([pm for _, _, pm, *_ in p1])
    if topk:
        smp = torch.cat([t for _, t, *_ in p1 if t is not None])
        tq.ef_select(smp, ks, stats, exact=n_params <= ref.SAMPLE_CAP,
                     part_max=pmax if quantize else None)
        t, sc = ref.reference_ef_select(smp, ks, maxes if quantize else None,
                                        exact=n_params <= ref.SAMPLE_CAP)
    else:
        tq.ef_reduce(stats, part_max=pmax,
                     part_kept=torch.cat([pk for _, _, _, pk, *_ in p1]),
                     thresh=True)
        t = torch.zeros((), device=home)
        sc = ref.reference_int8_scale(maxes)
        if int(tq.kept_word(stats)[0]) != int(sum(k_pass1)):
            bad.append("reduce: kept")
    if not same_bits(stats[0], t):
        bad.append("select: thresh")
    if quantize and not same_bits(stats[1], sc):
        bad.append("select: scale")
    kparts, total = [], 0
    for d, (x, _, _, _, xv, _, _) in enumerate(p1):
        out = torch.empty(S, dtype=torch.int8 if quantize else torch.float32,
                          device=home)
        r = torch.empty(S, device=home)
        pk = torch.empty(G, dtype=i32, device=home)
        tq.ef_pass2(x, stats, blocks=G, quantize=quantize, out=out, r=r,
                    part_kept=pk)
        o, rr, kd = ref.reference_ef_pass2(xv, t, sc if quantize else None)
        for name, got, want in (("out", out, o), ("r", r, rr)):
            if not same_bits(got, want):
                bad.append(f"pass 2 piece {d}: {name}")
        if int(pk.sum()) != int(kd):
            bad.append(f"pass 2 piece {d}: kept partials")
        kparts.append(pk)
        total += int(kd)
        del out, r, o, rr
    if topk:
        tq.ef_reduce(stats, part_kept=torch.cat(kparts))
        if int(tq.kept_word(stats)[0]) != total:
            bad.append("kept sum")
    return bad


def check_shard_encode(dev, sizes=SHARD_ENC_SIZES, meshes=B7_MESHES,
                       fault=None):
    """ef_encode's sharded form on ``dev``: each SHARD_ENC_FORMS codec at
    each (N, n_params, k) of ``sizes`` on each D of ``meshes`` (a mesh
    repeating ``dev``), a, b and c all sharded; every output (q or recon
    and the residual gathered, thresh, scale, kept) equal bit for bit to
    the unsharded ef_encode's on the whole vectors and to the plain
    sharded version's, at the largest D each launch alone against its
    plain stage (``check_ef_stages``), and on the card 2D + 2 launches
    (2D + 1 for int8; at D = 1 the unsharded form's, under its own
    counter).  On the card each is timed, L2 flushed, in turns with the
    unsharded form.
    With ``fault`` (top-k+int8 at the first size, D = 2) the sharded
    result is replaced by what a faulty encode would return: the check
    must fail.  Returns the record."""
    from repro_torch.kernels import ref, topk_quant
    from repro_torch.parallel import sharding as psh
    on_card = dev.type == "cuda"
    timer = Timer(dev) if on_card and fault is None else None
    g = torch.Generator(device=dev).manual_seed(27)
    rec = {"cases": 0, "err": 0.0, "by_case": []}
    if fault is not None:
        sizes, meshes = sizes[:1], (2,)
    ctr = topk_quant.LAUNCHES
    for N, n_params, k in sizes:
        a, b, c = shard_enc_inputs(g, N)
        for form, (topk, quantize) in SHARD_ENC_FORMS.items():
            if fault is not None and form != "topk_ef+int8":
                continue
            kw = dict(k=k if topk else None, n_params=n_params,
                      quantize=quantize)
            before = ctr["ef_encode"]
            whole = topk_quant.ef_encode(a, b, c, **kw)
            whole_l = ctr["ef_encode"] - before
            for D in meshes:
                mesh = psh.agg_mesh(devices=(dev,) * D)
                sh = [psh.split(t, mesh) for t in (a, b, c)]
                # one shard: the unsharded form on its piece
                key = "ef_encode" if D == 1 else "ef_encode_sharded"
                before = ctr[key]
                got = _gathered(topk_quant.ef_encode(*sh, **kw))
                launches = ctr[key] - before
                if fault is not None:
                    got = shard_enc_fault(fault, sh, **kw)
                pout, pr, *rest = ref.reference_ef_encode_sharded(
                    *(t.shards for t in sh), **kw, home=mesh.home)
                plain = (torch.cat(pout), torch.cat(pr), *rest)
                bad, bad_plain = ef_mismatch(got, whole), ef_mismatch(got,
                                                                      plain)
                finite = torch.isfinite(whole[1])
                e = max_err(got[1][finite], whole[1][finite])
                rec["err"] = max(rec["err"], e)
                stride = ref.sample_plan(N, k, n_params)[0] if topk else 1
                want_l = whole_l if D == 1 else 2 * D + (2 if topk else 1)
                if bad or bad_plain:
                    raise AssertionError(
                        f"sharded ef_encode {form} N = {N} D = {D}: "
                        f"{bad or 'nothing'} differ(s) from the unsharded "
                        f"kernel, {bad_plain or 'nothing'} from the plain "
                        f"sharded version")
                if on_card and launches != want_l:
                    raise AssertionError(
                        f"sharded ef_encode {form} N = {N} D = {D}: "
                        f"{launches} launches, {want_l} expected")
                rec["cases"] += 1
                case = {"form": form, "N": N, "n_params": n_params,
                        "k": kw["k"], "D": D, "stride": stride,
                        "launches": launches, "kept": int(whole[4]),
                        "equal": True}
                if fault is None and D == max(meshes) and D > 1:
                    # each launch of the form alone, against its stage
                    stages = check_ef_stages(
                        *(None if t is None else t.shards for t in sh), **kw)
                    if stages:
                        raise AssertionError(
                            f"sharded ef_encode {form} N = {N} D = {D}: "
                            f"stages differ from the plain stages: {stages}")
                    case["stages_equal"] = True
                if timer is not None:
                    ms, ums, turns = timer.turns(
                        lambda: topk_quant.ef_encode(*sh, **kw),
                        lambda: topk_quant.ef_encode(a, b, c, **kw),
                        N_TIMED_SHARD)
                    n_bytes = 3 * N * 4 + N * (1 if quantize else 4) \
                        + N * 4 + 12
                    b_ms, b_by = bound_ms(n_bytes, 8 * N)
                    case.update(ms=ms, unsharded_ms=ums, turns=turns,
                                plain_ms=timer(
                                    lambda: ref.reference_ef_encode_sharded(
                                        *(t.shards for t in sh), **kw,
                                        home=mesh.home), N_TIMED_SHARD),
                                bound_ms=b_ms, bound_by=b_by)
                    print(f"time sharded ef_encode {form} N = {N} D = {D}: "
                          f"{ms:.6f} ms, unsharded {ums:.6f} ms, plain "
                          f"{case['plain_ms']:.6f} ms, bound {b_ms:.6f} ms "
                          f"({b_by})")
                rec["by_case"].append(case)
                print(f"check sharded ef_encode {form} N = {N} D = {D}: "
                      f"equal to the unsharded kernel and the plain sharded "
                      f"version in every output; {launches} launch(es)")
                del sh, got, plain
            del whole
        del a, b, c
        if on_card:
            torch.cuda.empty_cache()
    rec["ok"] = True
    return rec


def shard_dec_inputs(g, N, W):
    """B4's sharded forms' inputs at width N: an int8 payload, its scale
    and base (the B4 call), and a merge's W payloads and scales over one
    dispatch base (the rows)."""
    dev = g.device
    qs = [torch.randint(-127, 128, (N,), device=dev, generator=g,
                        dtype=torch.int8) for _ in range(W)]
    scales = [0.01 * torch.rand((), device=dev, generator=g)
              for _ in range(W)]
    return qs, scales, torch.randn(N, device=dev, generator=g)


def shard_dec_time(timer, kern, unsh, lib, n_bytes, flops, plain):
    """kern in turns with the unsharded form and the library call (or
    None), the plain version and the bound: the case's fields."""
    ms, ums, lms, turns = _turns3(timer, kern, unsh, lib, N_TIMED_SHARD)
    b_ms, b_by = bound_ms(n_bytes, flops)
    return dict(ms=ms, unsharded_ms=ums, library_ms=lms, turns=turns,
                plain_ms=timer(plain, N_TIMED_SHARD), bound_ms=b_ms,
                bound_by=b_by)


def check_shard_decode(dev, sizes=SHARD_ENC_SIZES, meshes=B7_MESHES,
                       W=SHARD_DEC_W, fault=None):
    """B4's sharded forms on ``dev`` at each width of ``sizes`` and each D
    of ``meshes`` (a mesh repeating ``dev``): ``dequant_add`` on
    ``Sharded`` q and base, bit for bit against the unsharded B4, and a
    merge's W encoded responses landed in a sharded row buffer
    (``ParamBundle._set_rows``, the sharded server's path: one
    ``dequant_add_rows`` launch a device over its pieces), bit for bit
    against the unsharded ``dequant_add_rows`` and the plain version; on
    the card each call one launch a device (one here) covering D pieces.
    On the card each is timed, L2 flushed, in turns with the unsharded form
    and, for B4, ``torch.add`` on the whole vectors (at the first D, in
    turns there).  With ``fault`` (the first size, D = 2) the sharded
    results are replaced by what a faulty wrapper would leave: the check
    must fail.  Returns the record."""
    from repro_torch.core import flatbuf
    from repro_torch.kernels import ref, topk_quant
    from repro_torch.parallel import sharding as psh
    on_card = dev.type == "cuda"
    timer = Timer(dev) if on_card and fault is None else None
    g = torch.Generator(device=dev).manual_seed(29)
    rec = {"decode": [], "rows": []}
    if fault is not None:
        sizes, meshes = sizes[:1], (2,)
    launched, covered = topk_quant.LAUNCHES, topk_quant.PIECES
    for N, _, _ in sizes:
        qs, scales, base = shard_dec_inputs(g, N, W)
        whole = topk_quant.dequant_add(qs[0], scales[0], base)
        rows = torch.empty(W, N, device=dev)
        topk_quant.dequant_add_rows(qs, scales, [base] * W, rows)
        plain = ref.reference_dequant_add_rows(qs, scales, [base] * W,
                                               torch.empty_like(rows))
        if not same_bits(rows, plain):
            raise AssertionError(f"dequant_add_rows N = {N}: differs from "
                                 f"its plain version")
        scale_f = float(scales[0])
        lib_ms = {}
        for D in meshes:
            mesh = psh.agg_mesh(devices=(dev,) * D)
            n_dev = len(psh.device_groups(mesh))
            q_sh, b_sh = psh.split(qs[0], mesh), psh.split(base, mesh)
            bundle = flatbuf.ParamBundle(
                {"w": torch.empty(N, device="meta")}, mesh=mesh)
            vecs = [flatbuf.EncodedVec(psh.split(q, mesh), s, b_sh)
                    for q, s in zip(qs, scales)]
            rows_sh = psh.split(torch.empty(W, N, device=dev), mesh)
            for kind, call, want in (
                    ("decode", lambda: topk_quant.dequant_add(
                        q_sh, scales[0], b_sh), whole),
                    ("rows", lambda: bundle._set_rows(rows_sh, vecs),
                     rows)):
                key = "decode_rows" if kind == "rows" else kind
                before = launched[key], covered[key]
                got = call()
                counts = (launched[key] - before[0],
                          covered[key] - before[1])
                if fault == SHARD_DEC_FAULTS[kind]:
                    got = first_pieces_only(got)
                if not same_bits(got.gather(), want) or (
                        on_card and counts != (n_dev, D)):
                    raise AssertionError(
                        f"sharded {kind} N = {N} D = {D}: differs from the "
                        f"unsharded form, or {counts[0]} launches over "
                        f"{counts[1]} pieces where {n_dev} over {D}")
                case = {"N": N, "D": D, "launches": counts[0],
                        "pieces": counts[1], "equal": True}
                print(f"check sharded {kind} N = {N} D = {D}: equal to the "
                      f"unsharded form; {counts[0]} launch(es) over "
                      f"{counts[1]} pieces")
                if timer is not None and kind == "decode":
                    case.update(shard_dec_time(
                        timer, call,
                        lambda: topk_quant.dequant_add(qs[0], scales[0],
                                                       base),
                        None if lib_ms else (lambda: torch.add(
                            base, qs[0], alpha=scale_f)),
                        9 * N + 4, 2 * N, lambda: ref.reference_dequant_add(
                            qs[0], scales[0], base)))
                elif timer is not None:
                    case.update(W=W, **shard_dec_time(
                        timer, call,
                        lambda: topk_quant.dequant_add_rows(
                            qs, scales, [base] * W, rows),
                        None, W * N * 5 + 4 * N + 4 * W, 2 * W * N,
                        lambda: ref.reference_dequant_add_rows(
                            qs, scales, [base] * W, plain)))
                if timer is not None:
                    if case["library_ms"] is not None:
                        lib_ms[kind] = case["library_ms"]
                    case["library_ms"] = lib_ms.get(kind)
                    print(f"time sharded {kind} N = {N} D = {D}: "
                          f"{case['ms']:.6f} ms, unsharded "
                          f"{case['unsharded_ms']:.6f} ms, library "
                          f"{case['library_ms']} ms, bound "
                          f"{case['bound_ms']:.6f} ms ({case['bound_by']})")
                rec[kind].append(case)
            del q_sh, b_sh, vecs, rows_sh
        del qs, scales, base, whole, rows, plain
        if on_card:
            torch.cuda.empty_cache()
    rec["ok"] = True
    return rec


def check_shard_fused(dev, sizes=SHARD_ENC_SIZES, meshes=B7_MESHES,
                      timed=True):
    """B4's redesigns on a sharded server's vectors at each width of
    ``sizes`` and each D of ``meshes`` (a mesh repeating ``dev``): the
    top-k+int8 ``ef_encode`` on ``Sharded`` a and b with a ``Sharded``
    decoded output (a sharded server's downlink), every output bit for bit
    against the unsharded chain (the encode, then B4) on the whole
    vectors; ``dequant_mix_sharded`` (async_delta's delta merge on a
    sharded server, in place) bit for bit against the unsharded chain (B4,
    stack, B1).  On the card the encode takes its sharded form's 2D + 2
    launches (D = 1: the unsharded form's, one or three) under
    ``ef_encode_dec``, and the merge one launch a device over D pieces (a
    launch every 32 pieces).  On the card with ``timed``, at the first
    width and the largest D, each is timed with
    L2 flushed in turns with the sharded chain the parent ran (the sharded
    encode then B4 on the pieces; B4 on the pieces, a stack a piece, B1
    over the pieces).  Returns the record."""
    from repro_torch.kernels import fedavg_agg, group_launches, topk_quant
    from repro_torch.parallel import sharding as psh
    on_card = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(300)
    w = torch.tensor(DEC_WVEC, dtype=torch.float32, device=dev)
    rec = {"ef_encode_dec": [], "dequant_mix": []}
    tl, fl = topk_quant.LAUNCHES, fedavg_agg.LAUNCHES
    for N, n_params, _ in sizes:
        a, b, q, scale, base, server = dec_inputs(g, N)
        kw = dec_kw(N, n_params, "topk_ef+int8")
        want_enc = dec_chain("ef_encode_dec", (a, b), kw)
        want_mix = dec_chain("dequant_mix", (q, scale, base, server, w))
        for D in meshes:
            mesh = psh.agg_mesh(devices=(dev,) * D)
            n_dev = sum(group_launches(len(idx))
                        for _, idx in psh.device_groups(mesh))
            a_sh, b_sh = psh.split(a, mesh), psh.split(b, mesh)
            dec = b_sh.empty_like()
            before = tl["ef_encode_dec"]
            got = _gathered((*topk_quant.ef_encode(a_sh, b_sh, **kw,
                                                   decoded=dec), dec))
            enc_l = tl["ef_encode_dec"] - before
            want_l = (3 if dec_grid(N, kw) else 1) if D == 1 else 2 * D + 2
            bad = dec_mismatch(got, want_enc)
            if bad or (on_card and enc_l != want_l):
                raise AssertionError(f"sharded decoding ef_encode N = {N} "
                                     f"D = {D}: {bad}, {enc_l} launches")
            q_sh, base_sh = psh.split(q, mesh), psh.split(base, mesh)
            srv = psh.split(server, mesh)
            before = fl["dequant_mix"], fedavg_agg.PIECES["dequant_mix"]
            out = fedavg_agg.dequant_mix_sharded(q_sh, scale, base_sh, w,
                                                 srv, mesh=mesh, out=srv)
            mix_l = (fl["dequant_mix"] - before[0],
                     fedavg_agg.PIECES["dequant_mix"] - before[1])
            in_place = all(o.data_ptr() == s_.data_ptr()
                           for o, s_ in zip(out.shards, srv.shards))
            if not same_bits(out.gather(), want_mix) or not in_place or (
                    on_card and mix_l != (n_dev, D)):
                raise AssertionError(
                    f"dequant_mix_sharded N = {N} D = {D}: differs from the "
                    f"chain, in place {in_place}, {mix_l[0]} launches over "
                    f"{mix_l[1]} pieces where {n_dev} over {D}")
            rec["ef_encode_dec"].append({"N": N, "D": D, "launches": enc_l,
                                         "equal": True})
            rec["dequant_mix"].append({"N": N, "D": D, "launches": mix_l[0],
                                       "pieces": mix_l[1], "equal": True})
            print(f"check sharded B4 redesigns N = {N} D = {D}: decoding "
                  f"ef_encode ({enc_l} launches) and dequant_mix ({mix_l[0]} "
                  f"launch(es) over {mix_l[1]} pieces) equal to the "
                  f"unsharded chains")
            if timed and on_card and N == sizes[0][0] and D == max(meshes):
                rec["timed"] = time_shard_fused(
                    Timer(dev), mesh, (a_sh, b_sh, dec, kw),
                    (q_sh, scale, base_sh, srv, w), N, D)
            del a_sh, b_sh, dec, q_sh, base_sh, srv, out, got
        del a, b, q, base, server, want_enc, want_mix
        if on_card:
            torch.cuda.empty_cache()
    rec["ok"] = True
    return rec


def time_shard_fused(timer, mesh, enc_args, mix_args, N, D):
    """The sharded forms at one (N, D), L2 flushed, in turns with the
    sharded chain the parent ran (chain, new, new, chain), beside the
    plain version and the byte bound: {form: fields}."""
    from repro_torch.kernels import fedavg_agg, ref, topk_quant
    from repro_torch.parallel import sharding as psh
    a_sh, b_sh, dec, kw = enc_args
    q_sh, scale, base_sh, srv, w = mix_args
    a, b = a_sh.gather(), b_sh.gather()
    q, base = q_sh.gather(), base_sh.gather()

    def enc_chain():
        out = topk_quant.ef_encode(a_sh, b_sh, **kw)
        return topk_quant.dequant_add(out[0], out[3], b_sh)

    def mix_chain():
        new = topk_quant.dequant_add(q_sh, scale, base_sh)
        rows = psh.Sharded([torch.stack([n, bb]) for n, bb in
                            zip(new.shards, base_sh.shards)], mesh)
        return fedavg_agg.fedavg_mix_wvec_sharded(rows, w, srv, mesh=mesh,
                                                  out=srv)
    cases = {
        "ef_encode_dec": (
            lambda: topk_quant.ef_encode(a_sh, b_sh, **kw, decoded=dec),
            enc_chain, lambda: ref.reference_ef_encode_decoded(
                a, b, k=kw["k"], n_params=kw["n_params"])),
        "dequant_mix": (
            lambda: fedavg_agg.dequant_mix_sharded(
                q_sh, scale, base_sh, w, srv, mesh=mesh, out=srv),
            mix_chain, lambda: ref.reference_dequant_mix(
                q, scale, base, srv.gather(), w))}
    out = {}
    for form, (kern, chain, plain) in cases.items():
        ms, chain_ms, lib_ms, turns = _turns3(timer, kern, chain, None,
                                              N_TIMED_SHARD)
        n_bytes, flops = dec_bytes(form, N)
        b_ms, b_by = bound_ms(n_bytes, flops)
        out[form] = dict(N=N, D=D, ms=ms, chain_ms=chain_ms,
                         turns={"new": turns["kernel"],
                                "chain": turns["unsharded"]},
                         plain_ms=timer(plain, N_TIMED_SHARD),
                         bound_ms=b_ms, bound_by=b_by)
        print(f"time sharded {form} N = {N} D = {D}: {ms:.6f} ms, the "
              f"sharded chain it replaces {chain_ms:.6f} ms, plain "
              f"{out[form]['plain_ms']:.6f} ms, bound {b_ms:.6f} ms "
              f"({b_by})")
    return out


def shard_dec_controls(dev) -> dict:
    """Each SHARD_DEC_FAULTS control on ``dev``: check_shard_decode given
    the fault must fail.  Returns fault -> caught."""
    out = {}
    for fault in SHARD_DEC_FAULTS.values():
        try:
            check_shard_decode(dev, fault=fault)
            out[fault] = False
        except AssertionError:
            out[fault] = True
        print(f"check sharded B4 control ({fault}): caught {out[fault]}")
        if not out[fault]:
            raise AssertionError(f"sharded B4: the check does not catch "
                                 f"{fault}")
    return out


def shard_enc_controls(dev) -> dict:
    """Each SHARD_ENC_FAULTS control on ``dev``: check_shard_encode given
    the fault must fail.  Returns fault -> caught."""
    out = {}
    for fault in SHARD_ENC_FAULTS:
        try:
            check_shard_encode(dev, fault=fault)
            out[fault] = False
        except AssertionError:
            out[fault] = True
        print(f"check sharded ef_encode control ({fault}): caught "
              f"{out[fault]}")
        if not out[fault]:
            raise AssertionError(f"sharded ef_encode: the check does not "
                                 f"catch {fault}")
    return out


def recorded_transports():
    """A context in which every ``Transport`` built is appended to the
    list it yields."""
    import contextlib
    from repro_torch.core import transport as T

    @contextlib.contextmanager
    def ctx():
        made, init = [], T.Transport.__init__

        def recording(self, *args, **kw):
            init(self, *args, **kw)
            made.append(self)
        T.Transport.__init__ = recording
        try:
            yield made
        finally:
            T.Transport.__init__ = init
    return ctx()


def link_vectors(tr):
    """(where, vector) for every link vector a transport holds: each
    link's tx_base, residual, acked base and downlink residual, the ack
    chain's residuals, the pending downlink's payload and pinned base, the
    auto seam's residual; a payload's vector is its data (a quantised
    one's q)."""
    def of_payload(p):
        d = p.data
        if isinstance(d, tuple):
            return d[0]
        return None if isinstance(d, dict) else d
    for wid, ln in tr._links.items():
        yield f"{wid}.tx_base", ln.tx_base
        yield f"{wid}.residual", ln.residual
        yield f"{wid}.acked_base", ln._ack.acked_base
        yield f"{wid}.down_residual", ln._ack.down_residual
        for i, e in enumerate(ln._ack._entries):
            yield f"{wid}.entry{i}.before", e[0]
            yield f"{wid}.entry{i}.wrote", e[1]
        if ln._pending_down is not None:
            yield f"{wid}.pending_down", of_payload(ln._pending_down[0])
            yield f"{wid}.pending_base", ln._pending_down[2]
        if ln._up_restore is not None:
            yield f"{wid}.up_restore", ln._up_restore[1]


def check_shard_local(transports, D: int) -> int:
    """Every link vector of every transport built over a mesh is a
    ``Sharded`` of D pieces of N/D elements (N the bundle's padded
    width); returns how many were checked.  Raises on a whole one."""
    from repro_torch.parallel import sharding as psh
    n = 0
    for tr in transports:
        if tr.mesh is None:
            continue
        S = tr.bundle.padded_size // D
        for where, v in link_vectors(tr):
            if v is None:
                continue
            if not (isinstance(v, psh.Sharded) and len(v.shards) == D
                    and all(p.shape == (S,) for p in v.shards)):
                raise AssertionError(f"link vector {where} is not {D} "
                                     f"pieces of {S}: {type(v).__name__} "
                                     f"{tuple(v.shape)}")
            n += 1
    return n


def shard_run(key, setup, rounds=SHARD_ROUNDS, epochs=EPOCHS,
              meshes=B7_MESHES):
    """One SHARD_RUNS run unsharded, then at each D of ``meshes``
    (``server_mesh=1``; D > 1 a mesh repeating the setup's device), every
    launch counter at 0 before each run and read after.  Each sharded run
    must equal the unsharded one in every field, accuracy bits included
    (the topology's root and leaves), and after it every link vector of
    its transports must be a ``Sharded`` of D pieces of N/D elements.  On
    the card each merge kernel's launches, ``dequant_add_rows``' and B4's
    must be the mesh's distinct devices times the unsharded run's (one a
    device per merge or decode: as many as unsharded on one card) and
    their pieces D times the unsharded run's, every encode at D > 1 must
    take the sharded form and at D = 1 the unsharded one
    (``shard_enc_launches``), and the standalone B5's 0.  Returns the
    run's record."""
    from repro_torch.core import run_fl
    from repro_torch.core import topology as ttop
    from repro_torch.parallel import sharding as psh
    kw = dict(SHARD_RUNS[key])
    topo = kw.pop("topology", None)
    dev = next(iter(setup.weights0.values())).device
    counters, covered = launch_counters(), piece_counters()

    def call(mesh, D=None):
        zero_counters()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_transports() as made:
            if topo is not None:
                res = ttop.run_fl_topology(setup, topology=topo,
                                           epochs_per_round=epochs,
                                           max_rounds=rounds,
                                           server_mesh=mesh, **kw)
                hists = {"root": res.root_history, **res.leaf_histories}
            else:
                hists = {"server": run_fl(setup, epochs_per_round=epochs,
                                          max_rounds=rounds,
                                          server_mesh=mesh, **kw)}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: counters[k][k] for k in counters}
        pieces = {k: covered[k][k] for k in covered}
        n_vec = None if D is None else check_shard_local(made, D)
        return _hex_histories(hists), launches, pieces, wall, n_vec

    base, base_l, base_p, base_wall, _ = call(None)
    rec = {"rounds": rounds, "histories": base, "launches": {"0": base_l},
           "pieces": {"0": base_p}, "wall_s": {"0": base_wall},
           "equal": {}, "link_vectors": {}}
    if dev.type == "cuda" and not any(base_l[k] for k in GROUPED[:4]):
        raise AssertionError(f"shard {key}: no merge kernel launched")
    for D in meshes:
        mesh = 1 if D == 1 else psh.agg_mesh(devices=(dev,) * D)
        n_dev = 1 if D == 1 else len(psh.device_groups(mesh))
        hist, launches, pieces, wall, n_vec = call(mesh, D)
        rec["launches"][str(D)] = launches
        rec["pieces"][str(D)] = pieces
        rec["wall_s"][str(D)] = wall
        rec["link_vectors"][str(D)] = n_vec
        if hist != base:
            raise AssertionError(f"shard {key} D = {D}: the history differs "
                                 f"from the unsharded run")
        rec["equal"][str(D)] = True
        if dev.type != "cuda":
            continue
        for k in GROUPED:
            if (launches[k], pieces[k]) != (n_dev * base_l[k],
                                            D * base_p[k]):
                raise AssertionError(
                    f"shard {key} D = {D}: {launches[k]} {k} launches over "
                    f"{pieces[k]} pieces, {n_dev} x {base_l[k]} over "
                    f"{D} x {base_p[k]} expected")
        for k in UNSHARDED:
            if launches[k] != base_l[k]:
                raise AssertionError(f"shard {key} D = {D}: {launches[k]} "
                                     f"{k} launches, the unsharded run "
                                     f"{base_l[k]}")
        want = shard_enc_launches(D, base_l["ef_encode"])
        if (launches["ef_encode"], launches["ef_encode_sharded"]) != want:
            raise AssertionError(
                f"shard {key} D = {D}: {launches['ef_encode']} unsharded "
                f"and {launches['ef_encode_sharded']} sharded ef_encode "
                f"launches, {want[0]} and {want[1]} expected")
        # a quantised downlink's encode that writes its decode, in either
        # form: the unsharded one at D = 1, the sharded one above
        want = sum(shard_enc_launches(D, base_l["ef_encode_dec"]))
        if launches["ef_encode_dec"] != want:
            raise AssertionError(
                f"shard {key} D = {D}: {launches['ef_encode_dec']} decoding "
                f"ef_encode launches, {want} expected")
        if launches["mom"] or launches["adam"]:
            raise AssertionError(f"shard {key} D = {D}: B5 launched")
    print(f"shard {key}: D = {', '.join(map(str, meshes))} equal to the "
          f"unsharded run in every field; link vectors shard-local "
          f"{rec['link_vectors']}; wall {rec['wall_s']}; launches "
          f"{ {D: {k: v for k, v in l.items() if v} for D, l in rec['launches'].items()} }")
    return rec


def shard_resume(setup, key=SHARD_RESUME[0], D=SHARD_RESUME[1],
                 rounds=SHARD_ROUNDS, epochs=EPOCHS, want=None):
    """``key`` at D shards stopped at its first snapshot and resumed from
    disk in this process: equal in every field to ``want`` (the unsharded
    run's hex histories)."""
    import shutil
    import tempfile
    from repro_torch.core import run_fl
    from repro_torch.parallel import sharding as psh
    dev = next(iter(setup.weights0.values())).device
    mesh = psh.agg_mesh(devices=(dev,) * D)
    work = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        kw = dict(SHARD_RUNS[key], epochs_per_round=epochs,
                  max_rounds=rounds, server_mesh=mesh,
                  checkpoint_dir=work)
        run_fl(setup, **kw, checkpoint_every=1, stop_after_checkpoints=1)
        h = run_fl(setup, **kw, resume=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    got = _hex_histories({"server": h})
    if want is not None and got != want:
        raise AssertionError(f"shard resume {key} D = {D}: the resumed "
                             f"history differs from the unsharded run")
    print(f"shard resume {key} D = {D}: split at the first snapshot and "
          f"resumed, equal to the unsharded run in every field")
    return {"key": key, "D": D, "equal": want is not None}


def run_shard(dev, setups, report):
    """Phase 9: B7 at full size (check_b7), the sharded encode and B4's
    sharded forms, then every SHARD_RUNS run at MNIST width (shard_run)
    and one sharded split and resume.  Returns the B7 and sharded codec
    records of the kernels line.  A run with a server mesh merges only
    through B7 (its merge kernels launch once a device and cover D times
    the unsharded run's pieces, which shard_run holds), so a record's
    launches and pieces are its kernel's counters summed over the sharded
    runs."""
    rec = check_b7(dev)
    enc = check_shard_encode(dev)
    enc["controls"] = shard_enc_controls(dev)
    dec = check_shard_decode(dev)
    dec["controls"] = shard_dec_controls(dev)
    fused = check_shard_fused(dev)
    setup = setups.get(RUNS["raw/sync"], dev)
    runs = {key: shard_run(key, setup) for key in SHARD_RUNS}
    resume = shard_resume(setup, want=runs[SHARD_RESUME[0]]["histories"])
    report["shard"] = {"b7": rec, "encode": enc, "decode": dec,
                       "fused": fused, "runs": runs, "resume": resume}

    def summed(what, ctr):
        return sum(r[what][str(D)][ctr] for r in runs.values()
                   for D in B7_MESHES)
    records = {}
    big = max(W * N for W, N in B7_SIZES)
    for name, (form, ctr, tpu) in B7_RECORDS.items():
        mine = [c for c in rec["by_case"] if c["form"] == form]
        # the headline: the largest size at the largest mesh
        head = max((c for c in mine if c["W"] * c["N"] == big),
                   key=lambda c: c["D"])
        src = "server_opt.cu" if form.startswith("opt") else "fedavg_agg.cu"
        records[name] = {
            "name": name, "route": "cuda", "ok": True,
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "wrapper": "src/repro_torch/kernels/fedavg_agg.py",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": summed("launches", ctr),
            "pieces": summed("pieces", ctr),
            "max_abs_err": rec["err"][form],
            **{k: head[k] for k in ("W", "N", "D", "ms", "unsharded_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shard_row_bytes")},
            "by_case": mine}
    # the sharded codec: its headline the main path's width at the
    # largest mesh, in the uplink's top-k+int8 form
    N0 = SHARD_ENC_SIZES[0][0]
    D0 = max(B7_MESHES)
    head = next(c for c in enc["by_case"] if c["N"] == N0 and c["D"] == D0
                and c["form"] == "topk_ef+int8")
    src = "src/repro_torch/kernels/csrc/topk_quant.cu"
    wrapper = "src/repro_torch/kernels/topk_quant.py"
    keys = ("N", "D", "ms", "unsharded_ms", "plain_ms", "bound_ms",
            "bound_by")
    records["ef_encode_sharded"] = {
        "name": "ef_encode_sharded", "route": "cuda", "ok": True,
        "source": src, "wrapper": wrapper,
        "replaces": "src/repro/kernels/topk_quant.py:60",
        "launches": summed("launches", "ef_encode_sharded"),
        "max_abs_err": enc["err"], "library_ms": None,
        **{k: head[k] for k in keys}, "form": head["form"],
        "by_case": enc["by_case"]}
    # B4's sharded forms, their headlines likewise
    for name, kind, ctr in (("dequant_add_sharded", "decode", "decode"),
                            ("dequant_add_rows_sharded", "rows",
                             "decode_rows")):
        head = next(c for c in dec[kind] if c["N"] == N0 and c["D"] == D0)
        records[name] = {
            "name": name, "route": "cuda", "ok": True, "source": src,
            "wrapper": wrapper,
            "replaces": "src/repro/kernels/topk_quant.py:89",
            "launches": summed("launches", ctr),
            "pieces": summed("pieces", ctr), "max_abs_err": 0.0,
            **{k: head[k] for k in keys + ("library_ms",)},
            "by_case": dec[kind]}
    # B4's redesigns on the sharded server: the downlink encode of the
    # top-k+int8 1x2 run and async_delta's delta merge
    src_of = {"ef_encode_dec": src,
              "dequant_mix": "src/repro_torch/kernels/csrc/fedavg_agg.cu"}
    for form in ("ef_encode_dec", "dequant_mix"):
        name = f"{form}_sharded"
        t = fused["timed"][form]
        records[name] = {
            "name": name, "route": "cuda", "ok": True,
            "source": src_of[form], "wrapper": wrapper if form ==
            "ef_encode_dec" else "src/repro_torch/kernels/fedavg_agg.py",
            "replaces": "src/repro/kernels/topk_quant.py:89",
            "launches": summed("launches", form), "max_abs_err": 0.0,
            **({"pieces": summed("pieces", form)} if form == "dequant_mix"
               else {}),
            "library_ms": None, **t, "by_case": fused[form]}
    # B4 alone on a sharded server: phase 9's runs no longer launch it
    # (the downlink's decode rides in its encode, async_delta's in its
    # merge); its check, timing and launch count (0) stay in the line
    for name in ("fedavg_mix_flat_sharded", "fedavg_agg_flat_sharded",
                 "merge_opt_flat_sharded_mom", "merge_opt_flat_sharded_adam",
                 "ef_encode_sharded", "dequant_add_rows_sharded",
                 "ef_encode_dec_sharded", "dequant_mix_sharded"):
        if records[name]["launches"] < 1:
            raise AssertionError(f"{name} never launched in phase 9's runs")
    return records


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
    """Phase 8: gemma2-2b serving at full width and depth through B8;
    fills ``rec`` and returns B8's launches on the main path."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import analytics
    from repro_torch.models import transformer
    from repro_torch.tree import leaves, tree_map
    cfg = configs.get_config(LM_ARCH).replace(attn_impl="pallas")
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
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
    cpu = tree_map(lambda t: t.cpu(), card)
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


def run_rwkv(dev, rec):
    """Phase 9: rwkv6-3b serving at full width and depth (the prefill's
    blocks run B9's state form, decode the plain ``wkv_step``), then B9 on
    the prefill's own layer-0 streams, through ``ops.wkv`` and in the
    state form.  Fills ``rec`` and returns B9's launches on the model's
    path (prefill and decode) and on ``ops.wkv``'s."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    from repro_torch.kernels import ops, rwkv6_kernel
    from repro_torch.launch import analytics
    from repro_torch.models import layers, rwkv6, transformer
    from repro_torch.tree import leaves, tree_map
    cfg = configs.get_config(RWKV_ARCH)
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
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
    zeroed = tree_map(torch.clone, state)
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
    cpu = tree_map(lambda t: t.cpu(), card)
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


# ---------------------------------------------------------------------------
# Phase 12, the paper: the thesis' time to 80% accuracy (table 5.1) through
# the port's experiment layer (benchmarks/torch_fl_figures.py's setups), from
# the JAX package's initial weights (tests/golden/jax_init_mlp_seed0.npz, read
# with numpy), at the reference's width: the MLP 256-128-10 on 16x16 images
# (FAST_MNIST_CNN's, 34,186 parameters), 10 workers of one batch of 64.

PAPER_IN_DIM = 256
PAPER_N = 34_304        # its 34,186 parameters packed in blocks of 512
PAPER_TARGET = 0.8
# tests/test_fl_system.py's setup (het strong); table 5.1's mnist-class
# row is the figures' REGIME (het extreme)
PAPER_STRONG = dict(noise=0.2, batch_size=64, het="strong")
# the reference's round budgets (test_paper_orderings; table5_1); every run
# stops at the target, since t80 does not depend on what comes after it
PAPER_ROUNDS = {"strong": {"sequential": 60, "sync_alg2": 300,
                           "async_alg2": 900, "sync_all": 300},
                "table5_1/mnist": {"sequential": 80, "sync_alg2": 400,
                                   "async_alg2": 1200}}
PAPER = {f"paper/{s}/{k}": dict(setup=s, kind=k, rounds=r)
         for s, kinds in PAPER_ROUNDS.items() for k, r in kinds.items()}
PAPER_CONTROL = ("paper/strong/sync_all", "paper/strong/sync_alg2")
# the runs whose every B2 and B1 call is recorded and replayed through the
# plain versions on the card
PAPER_REPLAY = ("paper/strong/sync_alg2", "paper/strong/async_alg2")


def figures():
    """``benchmarks/torch_fl_figures.py``, the port's experiment layer,
    whose constants (``REGIME``, ``ALG2``, ``ASYNC_KW``) and fixture
    reader (``load_weights0``) phase 12 uses.  Imported when first asked
    for: it imports ``repro_torch``, and a tool may put another
    checkout's ``src`` first after importing this script."""
    path = str(ROOT / "benchmarks")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_fl_figures
    return torch_fl_figures


def paper_setups() -> dict:
    """Setup name -> ``make_setup`` keywords."""
    return {"strong": PAPER_STRONG, "table5_1/mnist": figures().REGIME}


def paper_kinds() -> dict:
    """Run kind -> ``run_fl`` keywords (None: the sequential baseline),
    as ``table5_1_time_to_accuracy`` calls them, and the control."""
    f = figures()
    return {
        "sequential": None,
        "sync_alg2": dict(mode="sync", selector="time_based",
                          selector_kw=f.ALG2),
        "async_alg2": dict(mode="async", selector="time_based",
                           selector_kw=f.ALG2, **f.ASYNC_KW),
        # the control: every worker each round, Algorithm 2 off
        "sync_all": dict(mode="sync", selector="all"),
    }


def paper_weights0() -> dict:
    """The fixture's initial weights at ``PAPER_IN_DIM``."""
    return figures().load_weights0()[PAPER_IN_DIM]


# How far one ulp of initial-weight noise moves t80 (simulated seconds) and
# accuracy (the largest per-point gap on the common prefix) on the CPU: the
# largest of 10 perturbations of the fixture's w1 made by
# tools/torch_accuracy_spread.py --phase paper.
# The sequential runs' t80 move is one test sample (1/512) at their
# crossing, between points 5 s apart; no perturbation moved the FL runs'.
T80_SPREAD = {
    "paper/strong/sequential": 0.3014,
    "paper/strong/sync_alg2": 0.0,
    "paper/strong/async_alg2": 0.0,
    "paper/table5_1/mnist/sequential": 0.3014,
    "paper/table5_1/mnist/sync_alg2": 0.0,
    "paper/table5_1/mnist/async_alg2": 0.0,
}
# About three test samples at sync + Alg 2's crossing (points 1.884 s and
# 0.043 of accuracy apart: 0.086 s a sample); the control sits ~14 s away.
T80_FLOOR = 0.25


def t80_gap(key):
    """Card vs CPU t80 bound of one run: twice its CPU spread, rounded up
    to 0.01 s, at least T80_FLOOR (the card rounds differently at every
    operation, the spread's perturbation at one weight once)."""
    return max(T80_FLOOR, math.ceil(200 * T80_SPREAD[key]) / 100)


T80_GAPS = {key: t80_gap(key) for key in T80_SPREAD}
# The sequential runs' accuracy move is four test samples at one point;
# no perturbation moved the FL runs' accuracy at any point.
ACC_SPREAD = {
    "paper/strong/sequential": 0.0078,
    "paper/strong/sync_alg2": 0.0,
    "paper/strong/async_alg2": 0.0,
    "paper/table5_1/mnist/sequential": 0.0078,
    "paper/table5_1/mnist/sync_alg2": 0.0,
    "paper/table5_1/mnist/async_alg2": 0.0,
}
# Five test samples of 512: the accuracy bound where one ulp moved nothing.
ACC_FLOOR = 0.01


def acc_gap(key):
    """Card vs CPU bound on the largest per-point accuracy gap of one run
    on the common prefix: twice its CPU spread, rounded up to 0.01, at
    least ACC_FLOOR."""
    return max(ACC_FLOOR, math.ceil(200 * ACC_SPREAD[key]) / 100)


ACC_GAPS = {key: acc_gap(key) for key in ACC_SPREAD}
# the CPU's t80s, the JAX package's and the port's from the same weights
# (tests/test_torch_paper.py runs both), and the thesis' table 5.1
PAPER_CPU_T80 = {
    "jax": {"strong": (15.404, 13.051, 10.531),
            "table5_1/mnist": (15.404, 16.111, 10.531)},
    "port": {"strong": (15.705, 13.051, 10.531),
             "table5_1/mnist": (15.705, 16.111, 10.531)}}
PAPER_CLAIMS = {"sync_vs_seq_pct": 33.9, "async_vs_sync_pct": 63.3}
PAPER_MERGE_CTR = {"sync": "agg", "async": "mix"}


def paper_setup(key, device, weights0):
    from repro_torch import core
    return core.make_setup(core.TABLE_4_1["mnist_even"], seed=0,
                           **paper_setups()[PAPER[key]["setup"]],
                           weights0=weights0, device=device)


def paper_call(key, setup):
    """One run of ``key`` up to the target: its history."""
    from repro_torch import core
    spec = PAPER[key]
    run_kw = paper_kinds()[spec["kind"]]
    if run_kw is None:
        return core.run_sequential_baseline(
            setup, epochs_per_round=EPOCHS, max_rounds=spec["rounds"],
            target_accuracy=PAPER_TARGET)
    return core.run_fl(setup, epochs_per_round=EPOCHS,
                       max_rounds=spec["rounds"],
                       target_accuracy=PAPER_TARGET, **run_kw)


def check_paper_launches(key, launches, merges, on_card):
    """B2 once a sync merge, B1 once an async merge, nothing else of this
    repo's kernels (the sequential runs: nothing at all).  On the CPU no
    kernel launches, so every count is 0."""
    run_kw = paper_kinds()[PAPER[key]["kind"]]
    want = dict.fromkeys(launches, 0)
    if run_kw is not None and on_card:
        want[PAPER_MERGE_CTR[run_kw["mode"]]] = merges
    if launches != want:
        bad = {k: (v, want[k]) for k, v in launches.items() if v != want[k]}
        raise AssertionError(f"{key}: launches (got, want) {bad} for "
                             f"{merges} merges")


def check_t80(key, got, want, bound):
    if got is None or want is None or abs(got - want) > bound:
        raise AssertionError(f"{key}: t80 {got} against {want}, limit "
                             f"{bound}")


def paper_drive(key, setup, report):
    """One run on the setup's device, every launch counter at 0 just
    before it and read just after."""
    from repro_torch.core import time_to_accuracy
    counters = launch_counters()
    on_card = setup.device.type == "cuda"
    zero_counters()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = paper_call(key, setup)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: counters[k][k] for k in counters}
    merges = sum(p.n_updates > 0 for p in h[1:])
    rounds = len(h) - 1
    t80 = time_to_accuracy(h, PAPER_TARGET)
    report[key] = {"history": [vars(p) for p in h], "launches": launches,
                   "merges": merges, "t80": t80, "points": len(h),
                   "wall_s": wall, "s_per_round": wall / max(rounds, 1)}
    print(f"paper {key}: t80 {t80}, {len(h)} points, {merges} merges, "
          f"{wall:.3f} s to the target, {wall / max(rounds, 1):.4f} s per "
          f"round, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if not all(np.isfinite(p.accuracy) for p in h):
        raise AssertionError(f"{key}: non-finite accuracy")
    if t80 is None:
        raise AssertionError(f"{key}: never reached {PAPER_TARGET}")
    check_paper_launches(key, launches, merges, on_card)


def paper_compare(key, setup, report):
    """The run again on ``setup`` (the CPU): every non-accuracy field
    equal on the two histories' common prefix (each stops at its own
    crossing), the largest accuracy gap there within ``ACC_GAPS``, t80
    within ``T80_GAPS``."""
    from repro_torch.core import time_to_accuracy
    h = paper_call(key, setup)
    got = report[key]["history"]
    n = min(len(got), len(h))
    for i, (g, c) in enumerate(zip(got[:n], h[:n])):
        for f in FIELDS:
            if g[f] != getattr(c, f):
                raise AssertionError(f"{key}: point {i} {f} {g[f]} on the "
                                     f"card, {getattr(c, f)} on the CPU")
    gap = max(abs(g["accuracy"] - c.accuracy)
              for g, c in zip(got[:n], h[:n]))
    t80_cpu = time_to_accuracy(h, PAPER_TARGET)
    report[key].update(cpu_t80=t80_cpu, cpu_points=len(h),
                       t80_gap=T80_GAPS[key], common_points=n,
                       accuracy_gap=gap, accuracy_limit=ACC_GAPS[key])
    print(f"paper {key}: fields equal on {n} common points, accuracy gap "
          f"{gap:.4f} at worst (limit {ACC_GAPS[key]}); t80 "
          f"{report[key]['t80']} here, {t80_cpu} on the CPU (limit "
          f"{T80_GAPS[key]})")
    if gap > ACC_GAPS[key]:
        raise AssertionError(f"{key}: card vs CPU accuracy gap {gap} above "
                             f"{ACC_GAPS[key]}")
    check_t80(key, report[key]["t80"], t80_cpu, T80_GAPS[key])


@contextlib.contextmanager
def recorded_merges(calls):
    """While the block runs, B2 (``fedavg_agg_flat``) and B1
    (``fedavg_mix_wvec``) append ``(form, copies of the inputs, copy of
    the output)`` to ``calls``."""
    from repro_torch.kernels import fedavg_agg
    real_agg, real_mix = fedavg_agg.fedavg_agg_flat, fedavg_agg.fedavg_mix_wvec

    def agg(stacked, weights):
        out = real_agg(stacked, weights)
        calls.append(("agg", (stacked.clone(), weights.clone()), out.clone()))
        return out

    def mix(stacked, wvec, server, out=None):
        ins = (stacked.clone(), wvec.clone(), server.clone())
        res = real_mix(stacked, wvec, server, out=out)
        calls.append(("mix", ins, res.clone()))
        return res
    fedavg_agg.fedavg_agg_flat, fedavg_agg.fedavg_mix_wvec = agg, mix
    try:
        yield
    finally:
        fedavg_agg.fedavg_agg_flat, fedavg_agg.fedavg_mix_wvec = (real_agg,
                                                                  real_mix)


def paper_replay(key, setup, report):
    """``key`` once more on ``setup``'s device with every B2 and B1 call
    recorded, then each replayed through its plain version there: every
    output equal bit for bit, every call at ``PAPER_N`` and of the run's
    one merge form, one a merge.  Its history is compared with the run
    ``paper_drive`` made (a reading: both ran on the card)."""
    from repro_torch.kernels import ref
    calls = []
    with recorded_merges(calls):
        h = paper_call(key, setup)
    form = PAPER_MERGE_CTR[paper_kinds()[PAPER[key]["kind"]]["mode"]]
    bad = []
    for i, (f, ins, out) in enumerate(calls):
        if f == "agg":
            plain = ref.reference_fedavg(*ins)
        else:
            rows, wvec, server = ins
            plain = ref.reference_fedavg_mix(rows, wvec[1:], server, wvec[0])
        if f != form or ins[0].shape[1] != PAPER_N or not same_bits(out,
                                                                    plain):
            bad.append(f"{f} {i} at {tuple(ins[0].shape)}")
    ws = sorted({ins[0].shape[0] for _, ins, _ in calls})
    same = [vars(p) for p in h] == report[key]["history"]
    report[key]["replay"] = {"calls": len(calls), "W": ws,
                             "mismatches": bad, "history_equals_run": same}
    print(f"replay {key}: {len(calls)} {form} calls (W {ws}, N {PAPER_N}) "
          f"through the plain versions: {len(bad)} differ; history equal "
          f"to the run's: {same}")
    if bad or len(calls) != report[key]["merges"]:
        raise AssertionError(f"replay of {key}: {len(calls)} calls for "
                             f"{report[key]['merges']} merges, differing "
                             f"{bad[:5]}")


def paper_pcts(t80s):
    s, y, a = t80s
    return {"sync_vs_seq_pct": 100 * (1 - y / s),
            "async_vs_sync_pct": 100 * (1 - a / y)}


def run_paper(dev, report, cpu="cpu", weights0=None):
    """Phase 12: every PAPER run on ``dev`` from the fixture's weights;
    the PAPER_REPLAY runs replayed through the plain versions on ``dev``;
    then each run again on ``cpu``; the orderings at het strong; the
    control; table 5.1's percentages beside the thesis' and the CPU's."""
    weights0 = paper_weights0() if weights0 is None else weights0
    rec = report.setdefault("paper", {})
    for key in PAPER:
        paper_drive(key, paper_setup(key, dev, weights0), rec)
    for key in PAPER_REPLAY:
        paper_replay(key, paper_setup(key, dev, weights0), rec)
    for key in PAPER:
        if key != PAPER_CONTROL[0]:
            paper_compare(key, paper_setup(key, cpu, weights0), rec)
    kinds = ("sequential", "sync_alg2", "async_alg2")
    table = {}
    for s in PAPER_ROUNDS:
        t80s = tuple(rec[f"paper/{s}/{k}"]["t80"] for k in kinds)
        cpu_t80s = tuple(rec[f"paper/{s}/{k}"]["cpu_t80"] for k in kinds)
        table[s] = {"t80": dict(zip(kinds, t80s)), **paper_pcts(t80s),
                    "ordered": t80s[1] < t80s[0] and t80s[2] < t80s[1],
                    "cpu": {"t80": dict(zip(kinds, cpu_t80s)),
                            **paper_pcts(cpu_t80s)},
                    **{f"{side}_cpu": paper_pcts(PAPER_CPU_T80[side][s])
                       for side in PAPER_CPU_T80}}
        print(f"paper {s}: t80 {t80s} here, {cpu_t80s} on the CPU; sync + "
              f"Alg 2 {table[s]['sync_vs_seq_pct']:.1f}% faster than "
              f"sequential, async a further "
              f"{table[s]['async_vs_sync_pct']:.1f}% (the thesis: "
              f"{PAPER_CLAIMS['sync_vs_seq_pct']}%, "
              f"{PAPER_CLAIMS['async_vs_sync_pct']}%; the JAX package on "
              f"the CPU: {table[s]['jax_cpu']['sync_vs_seq_pct']:.1f}%, "
              f"{table[s]['jax_cpu']['async_vs_sync_pct']:.1f}%); ordered: "
              f"{table[s]['ordered']}")
    rec["table5_1"] = table
    rec["claims"] = PAPER_CLAIMS
    # the orderings are gated at het strong; the extreme row's sync loses
    # to sequential in the reference itself, so it is reported only
    if not table["strong"]["ordered"]:
        raise AssertionError(f"paper strong: t80s {table['strong']['t80']} "
                             "not in the thesis' order")
    control, held = PAPER_CONTROL
    try:
        check_t80(control, rec[control]["t80"], rec[held]["cpu_t80"],
                  T80_GAPS[held])
        caught = False
    except AssertionError:
        caught = True
    rec["control"] = {"run": control, "against": held,
                      "t80": rec[control]["t80"],
                      "held_t80_cpu": rec[held]["cpu_t80"],
                      "limit": T80_GAPS[held], "caught": caught}
    print(f"control {control}: t80 {rec[control]['t80']} against {held}'s "
          f"{rec[held]['cpu_t80']} (limit {T80_GAPS[held]}); caught: "
          f"{caught}")
    if not caught:
        raise AssertionError(f"the control {control} passed {held}'s t80 "
                             "check")
    return {ctr: sum(r["launches"][ctr] for k, r in rec.items()
                     if k in PAPER)
            for ctr in PAPER_MERGE_CTR.values()}


# Phase 13, "zoo": the LM zoo's last families serving through B8, at full
# width (seeded random bf16 weights drawn on the card), cut from
# SHAPES["prefill_32k"] as phases 10-11 are: 2 prompts of 8192 tokens, then
# ZOO_DECODE greedy decode steps.  zamba2-7b at full depth (B8 at head dim
# 112 once a group: 13 launches, the tensor-core body); mixtral-8x22b cut
# to 8 of its 56 layers (its bf16 weights are 281 GB at full depth), B8's
# windowed tensor-core body once a layer.  The card-vs-CPU repeat keeps
# the width and cuts depth (zamba2: one group and one trailing block;
# mixtral: one layer) and the prompt.
ZOO_BATCH, ZOO_PROMPT, ZOO_DECODE = 2, 8192, 32
# every decode step is held against a full forward: with random weights
# the mamba2 state forgets in a few tokens, so a state zeroed after the
# prefill shows only in the first steps
ZOO_CHECKED = ZOO_DECODE
ZOO = {
    "zamba2-7b": dict(n_layers=81, flash=13, wgmma=13,
                      n_params=5_622_728_000,
                      cut=dict(n_layers=7, prompt=128, decode=4)),
    "mixtral-8x22b": dict(n_layers=8, flash=8, wgmma=8,
                          n_params=20_233_820_160,
                          cut=dict(n_layers=1, prompt=128, decode=4)),
}
# the decode-vs-forward check runs mixtral at capacity 4.0, where no token
# is dropped (tests/test_decode_consistency.py's setting: a forward over
# 2048-token groups drops what single-token decode does not); its forward
# is padded to whole groups (causal attention, and no capacity competition
# at 4.0, so the padding moves no earlier logit)
ZOO_CHECK_CF = 4.0
# Each check's limit on max |a - b| / max |b| over the logits, between the
# sound readings (decode vs forward at most 0.021, card vs CPU 0.018) and
# the controls' (at least 0.078) of an H100 run (PERF.md, PR 23), and the
# controls each must exceed it: state faults applied after the prefill
# ("ssm zeroed": every mamba2 SSM state; "group 0's shared cache": the
# shared block's group-0 KV cache in every group's place), B8 faults
# (LM_FAULTS' spelling) and an MoE fault ("expert slots shifted": the
# combine gathers the slot before each token's own), the last two in the
# prefill only.  With random weights the mamba2 state forgets in a few
# tokens, so "ssm zeroed" moves only the first decode steps (0.078).
ZOO_LIMITS = {"decode_vs_forward": 0.05, "card_vs_cpu": 0.05}
ZOO_FAULTS = {
    "zamba2-7b": {"decode_vs_forward": ("ssm zeroed",
                                        "group 0's shared cache"),
                  "card_vs_cpu": ("ssm zeroed",)},
    "mixtral-8x22b": {"decode_vs_forward": ("no window", "head map h % Kv"),
                      "card_vs_cpu": ("head map h % Kv",
                                      "expert slots shifted")},
}
STATE_FAULTS = ("ssm zeroed", "group 0's shared cache")


@contextlib.contextmanager
def moe_fault():
    """The MoE combine gathers the wrong slot: every expert's outputs
    moved one slot on, so each token takes the output of the token in
    the slot before its own (a control)."""
    from repro_torch.models import moe
    real = moe._experts

    def shifted(*args):
        return torch.roll(real(*args), 1, dims=1)
    moe._experts = shifted
    try:
        yield
    finally:
        moe._experts = real


def state_fault(fault, state):
    """Corrupt a decode state after its prefill (a control)."""
    if fault == "ssm zeroed":
        for part in ("groups", "tail"):
            if part in state:
                state[part]["ssm"].zero_()
    elif fault == "group 0's shared cache":
        for name in ("k", "v", "slot_pos"):
            t = state["shared_kv"][name]
            t[1:] = t[0]
    elif fault is not None:
        raise ValueError(fault)


@contextlib.contextmanager
def any_fault(fault):
    """B8 faults through ``attention_fault``, "expert slots shifted"
    through ``moe_fault``; state faults are applied by ``zoo_run`` after
    the prefill."""
    if fault in STATE_FAULTS or fault is None:
        yield
    elif fault == "expert slots shifted":
        with moe_fault():
            yield
    else:
        with attention_fault(fault):
            yield


def zoo_run(models, params, cfg, prompt, n_steps, next_tokens=None,
            fault=None):
    """Prefill ``prompt``, then ``n_steps`` decode steps (greedy, or fed
    ``next_tokens``), ``fault`` applied.  Returns (prefill logits, per-step
    logits, fed tokens, prefill s, decode s)."""
    S = prompt.shape[1]
    with any_fault(fault):
        logits, state, t_pre = _prefill(models, params, cfg, prompt,
                                        S + n_steps)
    if fault in STATE_FAULTS:
        state_fault(fault, state)
    steps, fed, t_dec = _decode(models, params, cfg, logits, state, S,
                                n_steps, next_tokens)
    return logits[:, 0], steps, fed, t_pre, t_dec


def lm_flops(cfg, kind, B, S):
    """Model FLOPs of a (cut) config, by launch.analytics' conventions."""
    from repro_torch.launch import analytics
    n_attn = (cfg.n_layers if cfg.block_type == "attn"
              else cfg.n_shared_attn_applications())
    mult = 6 if kind == "train" else 2
    return (mult * cfg.n_active_params() * B * S + n_attn
            * analytics._attn_flops_per_layer(cfg, B, S, kind == "train"))


def drop_counter():
    """Records every MoE routing's (dropped, routed) (token, choice) pairs,
    0-d tensors (no host sync), in ``.calls``."""
    from repro_torch.models import moe
    return CallRecorder(moe, "route", keep=lambda args, kw, r: (
        (~r["keep"]).sum(), r["keep"].numel()))


def _padded_forward_tail(models, transformer, params, cfg, seq, n):
    """Logits of the last ``n`` positions of ``seq`` from a full forward;
    for MoE configs ``seq`` is padded (with its own tokens) to whole
    2048-token groups, and no token may be dropped."""
    S = seq.shape[1]
    if cfg.is_moe:
        per = 2048 // seq.shape[0]
        pad = -S % per
        seq = torch.cat([seq, seq[:, :pad]], dim=1)
    with drop_counter() as drops:
        h, _, _ = models.forward(params, cfg, tokens=seq)
    out = transformer.logits_from_hidden(params, cfg, h[:, S - n:S])
    dropped = int(sum(d for d, _ in drops.calls))
    if dropped:
        raise AssertionError(f"{cfg.name}: the padded forward at capacity "
                             f"{cfg.capacity_factor} dropped {dropped} "
                             f"choices")
    return out


def run_zoo_arch(dev, arch, rec):
    """One arch of phase 13: the main path (counters at 0 before, read
    after), the decode-vs-forward and card-vs-CPU checks with their
    controls.  Returns B8's launches on the main path."""
    from repro_torch import configs, models
    from repro_torch.data import lm
    from repro_torch.models import transformer
    from repro_torch.tree import leaves, tree_map
    spec = ZOO[arch]
    cfg = configs.get_config(arch).replace(attn_impl="pallas",
                                           n_layers=spec["n_layers"])
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != spec["n_params"]:
        raise AssertionError(f"{arch}: {n_params} parameters, expected "
                             f"{spec['n_params']}")
    batch = next(lm.synthetic_token_batches(
        vocab=cfg.vocab_size, batch=ZOO_BATCH,
        seq_len=ZOO_PROMPT + ZOO_DECODE, seed=0))
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    prompt = tokens[:, :ZOO_PROMPT]
    # warm-up (cuBLAS handles, the allocator's pools): one prefill
    models.prefill_step(params, {"tokens": prompt}, cfg=cfg,
                        max_len=ZOO_PROMPT + ZOO_DECODE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path
    zero_counters()
    with drop_counter() as drops:
        first, steps, fed, t_pre, t_dec = zoo_run(models, params, cfg,
                                                  prompt, ZOO_DECODE)
    launches = {k: c[k] for k, c in launch_counters().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    mf = lm_flops(cfg, "prefill", ZOO_BATCH, ZOO_PROMPT)
    rec.update({
        "arch": arch, "n_layers": cfg.n_layers,
        "n_layers_full": configs.get_config(arch).n_layers,
        "n_params": n_params, "batch": ZOO_BATCH, "prompt": ZOO_PROMPT,
        "decode_steps": ZOO_DECODE, "head_dim": cfg.hd,
        "cut_from": "SHAPES['prefill_32k']: batch 32 -> 2, seq_len 32768 "
                    "-> 8192" + ("" if cfg.n_layers == 81 else
                                 f"; depth 56 -> {cfg.n_layers} layers"),
        "launches": launches, "prefill_s": t_pre,
        "prefill_tokens_per_s": ZOO_BATCH * ZOO_PROMPT / t_pre,
        "decode_s_per_step": t_dec / ZOO_DECODE,
        "max_memory_allocated": peak, "prefill_model_flops": mf,
        "prefill_mfu": mf / t_pre / BF16_FLOPS})
    if cfg.is_moe:
        # the prefill's groups are where tokens compete for capacity
        rec["dropped_choices_cf1.25"] = int(sum(d for d, _ in drops.calls))
        rec["routed_choices"] = int(sum(n for _, n in drops.calls))
    print(f"zoo {arch}: {n_params:,} parameters, {cfg.n_layers} layers; "
          f"prefill {ZOO_BATCH} x {ZOO_PROMPT} in {t_pre:.4f} s "
          f"({rec['prefill_tokens_per_s']:.1f} tokens/s, MFU "
          f"{rec['prefill_mfu']:.4f} of {BF16_FLOPS:.3g}); decode "
          f"{rec['decode_s_per_step']:.4f} s per step; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; B8 launches {launches['flash']} "
          f"({launches['flash_wgmma']} tensor-core body)"
          + (f"; choices dropped at capacity {cfg.capacity_factor}: "
             f"{rec['dropped_choices_cf1.25']} of {rec['routed_choices']}"
             if cfg.is_moe else ""))
    if launches["flash"] != spec["flash"] or \
            launches["flash_wgmma"] != spec["wgmma"]:
        raise AssertionError(f"{arch}: B8 launched {launches['flash']} "
                             f"times ({launches['flash_wgmma']} tensor-core)"
                             f" in one prefill and {ZOO_DECODE} decode "
                             f"steps, expected {spec['flash']} "
                             f"({spec['wgmma']}) and none in decode")
    others = {k: v for k, v in launches.items()
              if v and k not in ("flash", "flash_wgmma")}
    if others:
        raise AssertionError(f"{arch}: other kernels launched: {others}")
    if not all(torch.isfinite(x).all() for x in [first] + steps):
        raise AssertionError(f"{arch}: non-finite logits")

    # check 1: the last decode steps against a full forward
    ccfg = cfg.replace(capacity_factor=ZOO_CHECK_CF) if cfg.is_moe else cfg
    seq = torch.cat([prompt, fed], dim=1)

    def dvf(fault):
        if cfg.is_moe or fault is not None:
            _, st, _, _, _ = zoo_run(models, params, ccfg, prompt,
                                     ZOO_DECODE, next_tokens=fed,
                                     fault=fault)
        else:
            st = steps
        with any_fault(fault if fault not in STATE_FAULTS else None):
            full = _padded_forward_tail(models, transformer, params, ccfg,
                                        seq, ZOO_CHECKED)
        return [_rel_gap(st[-ZOO_CHECKED + i], full[:, i])
                for i in range(ZOO_CHECKED)]
    sound = {"decode_vs_forward": dvf(None)}
    faults = ZOO_FAULTS[arch]
    controls = {f: {"decode_vs_forward": dvf(f)}
                for f in faults["decode_vs_forward"]}
    del params

    # check 2: full width at a cut depth, card against CPU
    cut = spec["cut"]
    ccut = cfg.replace(n_layers=cut["n_layers"])
    card = models.init_params(torch.Generator(device=dev).manual_seed(1),
                              ccut, device=dev)
    cpu = tree_map(lambda t: t.cpu(), card)
    p_len, n_dec = cut["prompt"], cut["decode"]
    toks = tokens[:, :p_len + n_dec]

    def cut_run(prm, d, fault=None):
        t = toks.to(d)
        f0, st, _, _, _ = zoo_run(models, prm, ccut, t[:, :p_len], n_dec,
                                  next_tokens=t[:, p_len:], fault=fault)
        return [f0] + st
    t0 = time.perf_counter()
    want = cut_run(cpu, "cpu")
    rec["cpu_cut_s"] = time.perf_counter() - t0
    sound["card_vs_cpu"] = [_rel_gap(a.cpu(), b)
                            for a, b in zip(cut_run(card, dev), want)]
    for f in faults["card_vs_cpu"]:
        controls.setdefault(f, {})["card_vs_cpu"] = [
            _rel_gap(a.cpu(), b) for a, b in zip(cut_run(card, dev, f),
                                                 want)]
    del card, cpu
    rec.update(gaps=sound, controls=controls, limits=ZOO_LIMITS,
               cut=dict(cut, capacity_factor_check=ZOO_CHECK_CF))
    for check, limit in ZOO_LIMITS.items():
        print(f"zoo {arch} check {check}: gap {max(sound[check]):.5f} "
              f"(limit {limit}); controls " + ", ".join(
                  f"{f} {max(c[check]):.5f}" for f, c in controls.items()
                  if check in c))
        if not max(sound[check]) <= limit:
            raise AssertionError(f"zoo {arch} {check}: gaps {sound[check]} "
                                 f"> {limit}")
        for f in faults[check]:
            if not max(controls[f][check]) > limit:
                raise AssertionError(f"zoo {arch} {check}: the check does "
                                     f"not catch {f} "
                                     f"({controls[f][check]})")
    return launches["flash"]


def run_zoo(dev, rec):
    """Phase 13: zamba2-7b and mixtral-8x22b serving through B8.  Returns
    B8's launches on the main paths."""
    n = 0
    for arch in ZOO:
        t0 = time.perf_counter()
        rec[arch] = {}
        n += run_zoo_arch(dev, arch, rec[arch])
        rec[arch]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return n


# Phase 14, "pods": LM training and pod-level FL at full width.
# train_step with AdamW on one repeated batch of 2 x 2048 tokens, 3 steps
# (the third over 2 microbatches): zamba2-7b cut to 13 layers (2 groups and
# 1 trailing block), phi3.5-moe cut to 2 of 32 layers (its experts alone
# are 80.5 GB at full depth).  Then pod FL at yi-9b's width cut to 2
# layers, 2 pods: two local steps, fl_round (B2), one local step,
# fl_round_delta_compressed with ErrorFeedbackCompressor(frac=0.1)
# (ef_encode's grid form over the packed 2 x 608,194,560 deltas, then B6).
TRAIN = {"zamba2-7b": dict(n_layers=13, n_params=1_177_978_352),
         "phi3.5-moe-42b-a6.6b": dict(n_layers=2, n_params=2_731_954_176)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
TRAIN_LR = 1e-4
PODS_ARCH, PODS_LAYERS, PODS_N = "yi-9b", 2, 2
PODS_BATCH, PODS_SEQ = 2, 1024          # per pod
PODS_N_PARAMS = 608_194_560             # per pod
# the REDUCED first step, card against the CPU: the loss and the gradient
# norm within 1e-3 relative, Adam's first moment (0.1 x the clipped
# gradient, linear in it) leaf by leaf within TRAIN_M_LIMIT of the leaf's
# largest |value| (bf16 gradients: the JAX comparison's 0.06); the MoE
# run's control, the CPU step at aux_weight 0, must exceed a limit
TRAIN_LOSS_LIMIT = 1e-3
TRAIN_M_LIMIT = 0.06
# n_microbatch 2 on the card, at REDUCED width: the gradients train_step
# hands its optimizer within MB_LIMIT (four bf16 ulps at each leaf's
# largest |value|) of the whole batch's, as tests/test_torch_train.py
# holds them on the CPU; the first microbatch alone and the sum not
# divided must exceed it.  MoE configs run at capacity 4.0 with no aux
# loss, so that neither the drops nor the per-group aux loss depend on
# how the batch is split.
MB_LIMIT = 2.0 ** -6
MB_CONTROLS = ("control first microbatch only", "control sum not divided")


def _train_batch(cfg, dev, B, S, seed=0):
    from repro_torch.data import lm
    b = next(lm.synthetic_token_batches(vocab=cfg.vocab_size, batch=B,
                                        seq_len=S + 1, seed=seed))
    t = torch.from_numpy(b["tokens"]).to(dev)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def reduced_step_gaps(arch, dev, cpu="cpu"):
    """The first AdamW ``train_step`` of ``arch``'s REDUCED config on
    ``dev`` against the same step on ``cpu``; the MoE control (the CPU at
    aux_weight 0).  Returns {name: gap}, the control's under
    "control aux_weight 0"."""
    from repro_torch import configs, models, optim
    from repro_torch.tree import leaves, tree_map
    cfg = configs.get_config(arch, reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    batch = _train_batch(cfg, "cpu", 4, 64, seed=1)

    def step(d, aux_weight=0.01):
        # a copy: the optimizer updates in place
        p = tree_map(lambda t: t.to(d, copy=True), params)
        opt = optim.adamw(1e-3)
        st = opt.init(p)
        b = tree_map(lambda t: t.to(d), batch)
        _, st, met = models.train_step(p, st, b, cfg=cfg, optimizer=opt,
                                       aux_weight=aux_weight)
        return met, st["m"]

    def gaps(a, b):
        (ma, mom_a), (mb, mom_b) = a, b
        out = {k: abs(float(ma[k]) - float(mb[k])) / abs(float(mb[k]))
               for k in ("loss", "grad_norm")}
        out["adam m"] = max(
            float((x.cpu() - y.cpu()).abs().max())
            / max(float(y.abs().max()), 1e-12)
            for x, y in zip(leaves(mom_a), leaves(mom_b)))
        return out
    card, ref_cpu = step(dev), step(cpu)
    out = gaps(card, ref_cpu)
    if cfg.is_moe:
        ctl = gaps(card, step(cpu, aux_weight=0.0))
        out["control aux_weight 0"] = ctl
    return out


def microbatch_gaps(arch, dev):
    """max over leaves of max |a - b| / max |b| between the gradients that
    ``train_step`` with n_microbatch 2 hands its optimizer and those of the
    whole batch, and the two controls' gaps (MB_CONTROLS)."""
    from repro_torch import configs, models, optim
    from repro_torch.tree import leaves, tree_map
    cfg = configs.get_config(arch, reduced=True)
    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=4.0)
    aux_weight = 0.0 if cfg.is_moe else 0.01
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    batch = _train_batch(cfg, dev, 4, 64, seed=1)
    # an optimizer that returns the gradients in the parameters' place
    seen = optim.Optimizer(init=lambda p: {}, update=lambda p, g, s: (g, s))

    def grads(b, n=1):
        g, _, _ = models.train_step(params, {}, b, cfg=cfg, optimizer=seen,
                                    aux_weight=aux_weight, n_microbatch=n)
        return [t.float() for t in leaves(g)]

    def gap(got, want):
        return max(float((a - b).abs().max()
                         / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(got, want))
    whole, two = grads(batch), grads(batch, 2)
    first = grads(tree_map(lambda t: t[:2], batch))
    return {"n_microbatch 2 vs 1": gap(two, whole),
            MB_CONTROLS[0]: gap(first, whole),
            MB_CONTROLS[1]: gap([2 * t for t in two], whole)}


def train_check(gaps, arch):
    bad = [k for k in ("loss", "grad_norm") if not gaps[k] <= TRAIN_LOSS_LIMIT]
    if not gaps["adam m"] <= TRAIN_M_LIMIT:
        bad.append("adam m")
    if bad:
        raise AssertionError(f"pods {arch} REDUCED step, card vs CPU: {bad} "
                             f"beyond the limits ({gaps})")
    ctl = gaps.get("control aux_weight 0")
    if ctl is not None and ctl["loss"] <= TRAIN_LOSS_LIMIT and \
            ctl["adam m"] <= TRAIN_M_LIMIT:
        raise AssertionError(f"pods {arch}: the step check does not catch "
                             f"aux_weight 0 ({ctl})")


def run_train_arch(dev, arch, rec):
    """Full-width training of one arch (cut depth), counters at 0 before
    and read after: B8 and B9 never launch (the configs' attn_impl "xla";
    no kernel has a backward)."""
    from repro_torch import configs, models, optim
    from repro_torch.tree import leaves
    spec = TRAIN[arch]
    cfg = configs.get_config(arch).replace(n_layers=spec["n_layers"])
    if cfg.attn_impl != "xla":
        raise AssertionError(f"{arch}: training runs at attn_impl 'xla'")
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != spec["n_params"]:
        raise AssertionError(f"{arch}: {n_params} parameters, expected "
                             f"{spec['n_params']}")
    opt = optim.adamw(TRAIN_LR)
    st = opt.init(params)
    batch = _train_batch(cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    losses, norms, secs = [], [], []
    for i in range(TRAIN_STEPS):
        nmb = 2 if i == TRAIN_STEPS - 1 else 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, met = models.train_step(params, st, batch, cfg=cfg,
                                            optimizer=opt, n_microbatch=nmb)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    launches = {k: c[k] for k, c in launch_counters().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    mf = lm_flops(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    rec.update({"arch": arch, "n_layers": cfg.n_layers, "n_params": n_params,
                "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
                "microbatches": [1] * (TRAIN_STEPS - 1) + [2],
                "losses": losses, "grad_norms": norms, "s_per_step": secs,
                "launches": launches, "max_memory_allocated": peak,
                "model_flops_per_step": mf,
                "mfu_step2": mf / secs[1] / BF16_FLOPS})
    print(f"pods train {arch}: {n_params:,} parameters, {cfg.n_layers} "
          f"layers; losses {losses}, grad norms {norms}; s/step {secs}; "
          f"MFU (step 2) {rec['mfu_step2']:.4f}; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"{arch}: non-finite loss or gradient norm")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    used = {k: v for k, v in launches.items() if v}
    if used:
        raise AssertionError(f"{arch}: kernels launched in training: {used}")
    del params, st
    torch.cuda.empty_cache()


class CallRecorder:
    """Wraps ``module.name`` so every call is kept: its (args, kwargs,
    result), for a replay through the plain version, or what ``keep`` makes
    of them."""

    def __init__(self, module, name, keep=None):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.keep = keep or (lambda args, kw, out: (args, kw, out))
        self.calls = []

    def __enter__(self):
        def rec(*args, **kw):
            out = self.real(*args, **kw)
            self.calls.append(self.keep(args, kw, out))
            return out
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def run_pods_fl(dev, rec):
    """Pod FL at yi-9b's width: launch counts, every pod equal after
    fl_round, and B2, ef_encode and B6 replayed through their plain
    versions on the card, bit for bit.  Returns the launches."""
    from repro_torch import configs, models, optim
    from repro_torch.core import compression, federated
    from repro_torch.kernels import fedavg_agg, ref, topk_quant
    from repro_torch.tree import leaves, tree_map
    cfg = configs.get_config(PODS_ARCH).replace(n_layers=PODS_LAYERS)
    params = models.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != PODS_N_PARAMS:
        raise AssertionError(f"pods: {n_params} parameters a pod, expected "
                             f"{PODS_N_PARAMS}")
    opt = optim.adamw(TRAIN_LR)
    sp = federated.stack_for_pods(params, PODS_N)
    so = federated.stack_for_pods(opt.init(params), PODS_N)
    del params
    batch = _train_batch(cfg, dev, PODS_N * PODS_BATCH, PODS_SEQ, seed=2)
    w = torch.ones(PODS_N, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp, so, met = federated.fl_local_step(sp, so, batch, cfg=cfg,
                                              optimizer=opt, n_pods=PODS_N)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    losses = [float(x) for x in met["loss"]]
    t0 = time.perf_counter()
    with CallRecorder(fedavg_agg, "fedavg_agg_flat") as b2:
        sp = federated.fl_round(sp, w)
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    after_round = {k: c[k] for k, c in launch_counters().items()}
    same = all(torch.equal(t[0], t[i]) for t in leaves(sp)
               for i in range(1, PODS_N))
    anchor = tree_map(torch.clone, federated.unstack_pod(sp, 0))   # the merge
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, so, met = federated.fl_local_step(sp, so, batch, cfg=cfg,
                                          optimizer=opt, n_pods=PODS_N)
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    comp = compression.ErrorFeedbackCompressor(frac=0.1)
    zero_counters()
    t0 = time.perf_counter()
    with CallRecorder(topk_quant, "ef_encode") as enc, \
            CallRecorder(fedavg_agg, "fedavg_mix_wvec") as b6:
        sp = federated.fl_round_delta_compressed(
            sp, anchor, w, compressor=lambda d: comp.compress(d)[0])
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    after_comp = {k: c[k] for k, c in launch_counters().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    del so, anchor
    torch.cuda.empty_cache()

    # replays, each through its plain version on the card
    (a_b2, _, out_b2), = b2.calls
    b2_same = same_bits(out_b2, ref.reference_fedavg(*a_b2))
    del b2
    (a_enc, kw_enc, out_enc), = enc.calls
    n_enc = a_enc[0].numel()
    enc_bad = ef_mismatch(out_enc, ref.reference_ef_encode(*a_enc, **kw_enc))
    kept = int(out_enc[4])
    del enc
    (a_b6, _, out_b6), = b6.calls
    stacked, wvec, server = a_b6[:3]
    b6_same = same_bits(out_b6, ref.reference_fedavg_mix(
        stacked, wvec[1:], server, wvec[0]))
    del b6
    rec.update({
        "arch": PODS_ARCH, "n_layers": PODS_LAYERS, "n_pods": PODS_N,
        "n_params_per_pod": n_params, "batch_per_pod": PODS_BATCH,
        "seq": PODS_SEQ, "local_step_s": secs, "fl_round_s": t_round,
        "fl_round_delta_compressed_s": t_comp, "losses": losses,
        "launches_round": after_round, "launches_compressed": after_comp,
        "pods_equal_after_round": same, "b2_replay_equal": b2_same,
        "ef_encode_N": n_enc, "ef_encode_kept": kept,
        "ef_encode_replay_mismatch": enc_bad, "b6_replay_equal": b6_same,
        "max_memory_allocated": peak})
    print(f"pods fl {PODS_ARCH} x {PODS_N} pods ({n_params:,} parameters a "
          f"pod, {PODS_LAYERS} layers): local step s {secs}, fl_round "
          f"{t_round:.4f} s, fl_round_delta_compressed {t_comp:.4f} s; "
          f"pods equal after fl_round {same}; B2 replay equal {b2_same}; "
          f"ef_encode over {n_enc:,} elements (kept {kept:,}) replay "
          f"mismatches {enc_bad or 'none'}; B6 replay equal {b6_same}; "
          f"launches {after_round['agg']} B2, {after_comp['ef_encode']} "
          f"ef_encode, {after_comp['mix']} B6; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    want_round = {"agg": 1}
    want_comp = {"ef_encode": 3, "mix": 1}
    for got, want, what in ((after_round, want_round, "two local steps and "
                             "fl_round"),
                            (after_comp, want_comp, "fl_round_delta_"
                             "compressed")):
        used = {k: v for k, v in got.items() if v}
        if used != want:
            raise AssertionError(f"pods: {what} launched {used}, expected "
                                 f"{want}")
    if not (same and b2_same and b6_same) or enc_bad:
        raise AssertionError("pods: a pod differs after fl_round, or a "
                             "replay differs from its plain version")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"pods: non-finite losses {losses}")
    return {"agg": after_round["agg"], "mix": after_comp["mix"],
            "ef_encode": after_comp["ef_encode"]}


def run_pods(dev, rec):
    """Phase 14.  Returns the pod FL's kernel launches."""
    for arch in TRAIN:
        t0 = time.perf_counter()
        rec[arch] = {}
        run_train_arch(dev, arch, rec[arch])
        gaps = reduced_step_gaps(arch, dev)
        rec[arch]["reduced_step_vs_cpu"] = gaps
        print(f"pods train {arch} REDUCED first step, card vs CPU: {gaps} "
              f"(limits {TRAIN_LOSS_LIMIT}, adam m {TRAIN_M_LIMIT})")
        train_check(gaps, arch)
        mb = microbatch_gaps(arch, dev)
        rec[arch]["microbatch_vs_whole"] = mb
        print(f"pods train {arch} REDUCED n_microbatch 2 vs 1 on the card: "
              f"{mb} (limit {MB_LIMIT})")
        if not mb["n_microbatch 2 vs 1"] <= MB_LIMIT or \
                not all(mb[c] > MB_LIMIT for c in MB_CONTROLS):
            raise AssertionError(f"pods {arch}: n_microbatch 2 vs 1 beyond "
                                 f"{MB_LIMIT}, or a control within it "
                                 f"({mb})")
        rec[arch]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["fl"] = {}
    out = run_pods_fl(dev, rec["fl"])
    rec["fl"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return out


# Phase 15, "launch": the production training script, ``python -m
# repro_torch.launch.train``, in subprocesses at musicgen-medium's full
# width (d_model 1536, 24 heads, d_ff 6144, vocab 2048).  Single mode at
# full depth (48 layers); fl mode with 2 pods at the deepest depth whose
# estimated peak (``fl_peak_estimate``) leaves LAUNCH_FREE of the card
# free, one round (B2) inside the run; a kill after the first checkpoint
# and a resume in a fresh process at LAUNCH_RESUME_LAYERS layers (full
# depth writes 25 GB a checkpoint; the check does not depend on depth).
# Then input_specs for every cell on both production meshes.  The fl run
# and the resumed run are the trainer's ``main`` under ``chip_smoke.py
# --launch-train b2|restore``, which checks one call inside the process
# (``launch_train_checked``); the others are ``python -m
# repro_torch.launch.train``.
LAUNCH_ARCH = "musicgen-medium"
LAUNCH_SIZE = ("--full",)          # the tests' rehearsal: () for REDUCED
LAUNCH_N_PARAMS = 1_815_234_048
LAUNCH_LAYERS = 48
# tools/torch_train_lr_scan.py on the card (30 steps on the same batches,
# no warmup): at lr 0 the losses span 7.870-7.981 and the last five
# average 0.051 above the first; the last five average 0.012 below the
# first at 1e-4, 0.218 at 3e-4, 0.083 at 1e-3, and 0.250 above it at
# 3e-3, the trainer's default (the reference's, for REDUCED configs),
# which climbs from 7.895 to 8.591 in 3 steps.  So single mode runs 30
# steps at LAUNCH_LR and "falls" means the last LAUNCH_LAST losses average
# at least LAUNCH_FALL below the first.
LAUNCH_LR = 3e-4
LAUNCH_LAST, LAUNCH_FALL = 5, 0.1
# single mode writes no checkpoint: at 48 layers one is 25 GB (14 B a
# parameter), and the trainer's default (every 20 steps) would write one
# at step 20 that nothing here reads; the kill-and-resume run below holds
# the checkpoints, at 2 layers
LAUNCH_SINGLE = ["--steps", "30", "--batch", "8", "--seq", "128", "--lr",
                 LAUNCH_LR, "--ckpt-every", "31"]
LAUNCH_FL = ["--mode", "fl", "--pods", "2", "--steps", "3", "--fl-every",
             "2", "--batch", "8", "--seq", "128", "--lr", LAUNCH_LR]
LAUNCH_FREE = 10e9
# the allocator's reserve beyond the allocated peak (1.21 GB at 48 layers:
# 73.89 against 72.68 GB reserved on an H100 80GB HBM3 at 700 W)
LAUNCH_RESERVE = 1.5e9
LAUNCH_RESUME_LAYERS = 2
# the kill lands after the first of three checkpoints: the writer would
# need 8 more steps and 2 more writes to finish (each 1.1 GB write and
# the manager's reads of the kept files cost seconds; two resumed
# checkpoints check what more would)
LAUNCH_RESUME = ["--steps", "12", "--ckpt-every", "4", "--batch", "8",
                 "--seq", "128", "--lr", LAUNCH_LR]
LAUNCH_TIMEOUT_S = 600.0
# training runs at attn_impl "xla": fl mode's one round is the only launch
LAUNCH_KERNELS_FL = {"fedavg_agg": {"agg": 1}}


# B2's output is compared with its plain version in chunks of this many
# columns, so the check needs ~0.2 GB beside the round's own buffers
B2_CHUNK = 1 << 24


def train_argv(dev, *args, check=None):
    """The trainer's command line: ``python -m repro_torch.launch.train``,
    or with ``check`` its ``main`` under ``launch_train_checked``."""
    head = [sys.executable, "-m", "repro_torch.launch.train"] \
        if check is None else \
        [sys.executable, str(ROOT / "chip_smoke.py"), "--launch-train", check]
    return [*head, "--arch", LAUNCH_ARCH, *LAUNCH_SIZE, "--device", dev.type,
            *map(str, args)]


def tree_digest(tree) -> str:
    """sha256 over every leaf's dtype, shape and bytes, in leaf order."""
    import hashlib
    from repro_torch.tree import leaves
    h = hashlib.sha256()
    for t in leaves(tree):
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def b2_round_check(rows, w, out) -> dict:
    """One fl round's B2 output held against its plain version on the same
    device, chunk by chunk along N (the plain version is columnwise, so
    the chunks give its whole output bit for bit), with two controls that
    the same comparison must reject: the merge zeroed, and the last pod's
    row dropped (the mean of the others)."""
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    W, N = rows.shape
    w_drop = w[:-1] / w[:-1].sum()
    equal, zero_passes, drop_passes, err, differ = True, True, True, 0.0, 0
    for s in range(0, N, B2_CHUNK):
        part = rows[:, s:s + B2_CHUNK]
        got, want = out[s:s + B2_CHUNK], ref.reference_fedavg(part, w)
        equal &= same_bits(got, want)
        err = max(err, float((got - want).abs().max()))
        zero_passes &= same_bits(torch.zeros_like(want), want)
        drop_passes &= same_bits(ref.reference_fedavg(part[:-1], w_drop),
                                 want)
        differ += int((part[0] != part[-1]).sum())
    return {"W": W, "N": N, "equal": bool(equal), "max_abs_err": err,
            "columns_where_pods_differ": differ,
            "check_s": time.perf_counter() - t0,
            "controls_pass": {"merge zeroed": bool(zero_passes),
                              "last pod's row dropped": bool(drop_passes)}}


def launch_train_checked(check, argv) -> int:
    """``chip_smoke.py --launch-train b2|restore <trainer arguments>``: the
    trainer's ``main`` in this process with one call checked, then one
    ``[check]`` JSON line of what each call gave.  ``b2``: every
    ``fedavg_agg_flat`` call (``fl_round``'s B2) through
    ``b2_round_check``.  ``restore``: the digest of every tree
    ``to_device`` moved to the device (the resumed params and opt
    state)."""
    from repro_torch.kernels import fedavg_agg
    from repro_torch.launch import train
    rec = CallRecorder(fedavg_agg, "fedavg_agg_flat",
                       keep=lambda a, kw, out: b2_round_check(*a, out)) \
        if check == "b2" else \
        CallRecorder(train, "to_device",
                     keep=lambda a, kw, out: tree_digest(out))
    with rec:
        train.main(argv)
    print("[check] " + json.dumps(rec.calls), flush=True)
    return 0


def _train_env():
    import os
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def train_summary(log: str, tag="[train] summary "):
    lines = [l for l in log.splitlines() if l.startswith(tag)]
    if len(lines) != 1:
        raise AssertionError(f"launch: {len(lines)} {tag.strip()!r} lines "
                             f"in the trainer's output:\n{log[-3000:]}")
    return json.loads(lines[0][len(tag):])


def run_train(dev, work, name, *args, check=None):
    """One trainer process to its end: its summary, and with ``check``
    (see ``launch_train_checked``) the checked calls under "checked"."""
    log = Path(work) / f"{name}.log"
    t0 = time.perf_counter()
    with open(log, "wb") as f:
        proc = subprocess.run(train_argv(dev, *args, check=check), stdout=f,
                              stderr=subprocess.STDOUT, cwd=ROOT,
                              env=_train_env(), timeout=LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    text = log.read_text(errors="replace")
    if proc.returncode != 0:
        raise AssertionError(f"launch {name}: exit {proc.returncode}:\n"
                             f"{text[-3000:]}")
    out = train_summary(text)
    out["wall_s"] = wall
    print(f"launch {name}: the process took {wall:.1f} s")
    if check is not None:
        out["checked"] = train_summary(text, "[check] ")
    return out


def used_kernels(summary) -> dict:
    return {mod: {k: v for k, v in c.items() if v}
            for mod, c in summary["launches"].items()
            if any(c.values())}


def launch_cfg(n_layers):
    from repro_torch import configs
    return configs.get_config(LAUNCH_ARCH, reduced="--full" not in
                              LAUNCH_SIZE).replace(n_layers=n_layers)


def fl_peak_estimate(n_layers, n_pods=2) -> int:
    """Device bytes fl mode peaks at, from the abstract parameters: while
    ``opt_state`` is stacked (the single copy, 12 B a parameter, beside the
    stacked 2 + 12 B) and in ``fl_round`` (the stacked state, the packed
    (n_pods, N) f32 and the merged (N,) f32) the live bytes are (2 + 12) N
    n_pods + 4 N n_pods + 4 N = 40 N at 2 pods; a step adds gradients (2 N)
    and AdamW's f32 temporaries of its largest leaf (4 of them).
    tools/torch_train_memory.py at 48 layers on the card: stacking 72.609
    GB, a step 61.775 GB, B2 in the round 72.681 GB (the check in
    ``b2_round_check`` adds its chunks)."""
    from repro_torch.launch import specs
    from repro_torch.tree import leaves
    shapes = list(leaves(specs._param_shapes(launch_cfg(n_layers))))
    n = sum(t.numel() for t in shapes)
    biggest = max(t.numel() for t in shapes)
    stack_or_round = 14 * n * n_pods + 4 * n * n_pods + 4 * n
    step = 14 * n * n_pods + 2 * n + 4 * 4 * biggest
    return max(stack_or_round, step)


def fl_depth(free_bytes) -> int:
    """The deepest cut of LAUNCH_ARCH whose fl estimate leaves LAUNCH_FREE
    of ``free_bytes`` free."""
    for n_layers in range(LAUNCH_LAYERS, 0, -1):
        if fl_peak_estimate(n_layers) + LAUNCH_RESERVE + LAUNCH_FREE <= \
                free_bytes:
            return n_layers
    raise AssertionError(f"launch: no depth of {LAUNCH_ARCH} fits "
                         f"{free_bytes / 1e9:.1f} GB with "
                         f"{LAUNCH_FREE / 1e9:.0f} GB left free")


def launch_kill_resume(dev, work, rec):
    """A trainer killed after its first checkpoint, resumed in a fresh
    process; the state that process moved to the device equals the file
    bit for bit (digests), and the resumed checkpoints equal a
    continuation in this process from that state on the reference's
    batches (the iterator starts again)."""
    import signal
    from repro_torch import optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import synthetic_token_batches
    from repro_torch.launch import train
    from repro_torch.models import train_step
    from repro_torch.tree import leaves
    ckpt = Path(work) / "ckpt"
    args = ["--layers", LAUNCH_RESUME_LAYERS, *LAUNCH_RESUME,
            "--ckpt-dir", ckpt]
    log = open(Path(work) / "writer.log", "wb")
    proc = subprocess.Popen(train_argv(dev, *args), stdout=log,
                            stderr=subprocess.STDOUT, cwd=ROOT,
                            env=_train_env())
    try:
        deadline = time.perf_counter() + LAUNCH_TIMEOUT_S
        while not any(ckpt.glob("ckpt_*.pkl")):
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(
                    f"launch writer: exit {proc.returncode} before its "
                    f"first checkpoint:\n"
                    f"{(Path(work) / 'writer.log').read_text()[-3000:]}")
            time.sleep(0.02)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    mgr = CheckpointManager(ckpt)
    saved = mgr.steps()
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"launch writer not killed mid-run (exit "
                             f"{proc.returncode}, checkpoints {saved})")
    nbytes = (ckpt / f"ckpt_{saved[-1]:012d}.pkl").stat().st_size
    step0, host, _ = mgr.restore(saved[-1])   # the reader's GC may drop it
    res = run_train(dev, work, "reader", *args, "--resume", check="restore")
    if res["start_step"] != step0:
        raise AssertionError(f"launch: resumed at {res['start_step']}, the "
                             f"newest checkpoint is {step0}")
    # what the reader moved to its device, against the file
    restored_equal = res.pop("checked") == [tree_digest(host["params"]),
                                            tree_digest(host["opt_state"])]
    params = train.to_device(host["params"], dev)
    opt_state = train.to_device(host["opt_state"], dev)
    del host
    # the continuation in this process: the reference's batches from the
    # first, the step's embeds
    cfg = launch_cfg(LAUNCH_RESUME_LAYERS)
    a = train.parse_args([str(x) for x in LAUNCH_RESUME])
    opt = optim.adamw(a.lr)
    data = synthetic_token_batches(vocab=cfg.vocab_size, batch=a.batch,
                                   seq_len=a.seq)
    losses, ckpt_equal = [], {}
    kept = set(mgr.steps())           # the manager keeps the newest three
    for step in range(step0, a.steps):
        b = next(data)
        batch = {"embeds": train.step_embeds(step, (a.batch, a.seq,
                                                    cfg.d_model), dev),
                 "labels": torch.as_tensor(b["labels"], device=dev)}
        params, opt_state, met = train_step(params, opt_state, batch,
                                            cfg=cfg, optimizer=opt)
        losses.append(float(met["loss"]))
        if step + 1 in kept:
            _, want, _ = mgr.restore(step + 1)
            ckpt_equal[step + 1] = all(
                torch.equal(x.cpu(), y) for x, y in zip(
                    list(leaves(params)) + list(leaves(opt_state)),
                    list(leaves(want["params"]))
                    + list(leaves(want["opt_state"]))))
            del want
    rec.update({"layers": LAUNCH_RESUME_LAYERS, "killed_after": saved,
                "checkpoint_bytes": nbytes, "resumed_at": res["start_step"],
                "restored_equal": restored_equal,
                "resumed_losses": res["losses"],
                "continuation_losses": losses,
                "resumed_checkpoints_equal": ckpt_equal,
                "reader_s": res["step_s"]})
    print(f"launch resume ({LAUNCH_RESUME_LAYERS} layers, "
          f"{res['n_params']:,} parameters): killed with checkpoints "
          f"{saved} ({nbytes:,} bytes each), resumed at {res['start_step']}; "
          f"state on the resumed process's device equal to the file "
          f"{restored_equal}; resumed "
          f"checkpoints equal to this process's continuation {ckpt_equal}; "
          f"losses {res['losses']} / {losses}")
    if not restored_equal or not ckpt_equal or not all(ckpt_equal.values()) \
            or losses != res["losses"]:
        raise AssertionError("launch: the resumed run is not the "
                             "continuation of its checkpoint")
    if used_kernels(res):
        raise AssertionError(f"launch: the resumed run launched "
                             f"{used_kernels(res)}")


def _device_bytes(dev):
    """(allocated, peak allocated) bytes of ``dev``; 0, 0 off the card."""
    if dev.type != "cuda":
        return 0, 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev), \
        torch.cuda.max_memory_allocated(dev)


def launch_abstract(dev, rec):
    """input_specs for every cell on both production meshes: per-device
    bytes, and no device memory allocated."""
    from repro_torch.configs import SHAPES, list_archs
    from repro_torch.launch import mesh, specs
    from repro_torch.tree import leaves
    import gc
    gc.collect()               # what earlier phases left to the collector
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before, _ = _device_bytes(dev)
    t0 = time.perf_counter()
    cells = {}
    for multi in (False, True):
        m = mesh.make_production_mesh(multi_pod=multi)
        label = "x".join(map(str, m.devices.shape))
        for arch in list_archs():
            for shape in SHAPES:
                kind, inputs = specs.input_specs(arch, shape, m)
                if not all(a.tensor.is_meta for a in leaves(inputs)):
                    raise AssertionError(f"launch: {arch} {shape} holds a "
                                         f"tensor with storage")
                cells[f"{label}/{arch}/{shape}"] = \
                    specs.per_device_bytes(inputs)
    seconds = time.perf_counter() - t0
    after, peak = _device_bytes(dev)
    rec.update({"cells": cells, "seconds": seconds,
                "device_bytes_allocated": after - before,
                "device_peak_over_before": peak - before})
    for label in ("16x16", "2x16x16"):
        print(f"launch input_specs on {label}: " + "; ".join(
            f"{k.split('/', 1)[1]} {v / 2**30:.3f} GiB"
            for k, v in cells.items() if k.startswith(label + "/")))
    print(f"launch input_specs: {len(cells)} cells in {seconds:.2f} s, "
          f"device memory {after - before} bytes more, peak "
          f"{peak - before} over")
    if len(cells) != 80 or after > before or peak > before:
        raise AssertionError("launch: input_specs allocated device memory "
                             "or missed a cell")


def run_launch(dev, rec):
    """Phase 15.  Returns the fl run's B2 launches."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    try:
        torch.cuda.empty_cache()
        single = run_train(dev, work, "single", *LAUNCH_SINGLE)
        rec["single"] = single
        losses = single["losses"]
        per = statistics.median(single["step_s"][1:])
        print(f"launch single {LAUNCH_ARCH} full ({single['n_layers']} "
              f"layers, {single['n_params']:,} parameters): s/step "
              f"{single['step_s']} (median after the first {per:.4f}), "
              f"losses {losses}, peak {single['peak_bytes'] / 2**30:.3f} GiB"
              f" allocated, {single['peak_reserved_bytes'] / 2**30:.3f} GiB "
              f"reserved")
        if single["n_params"] != LAUNCH_N_PARAMS or \
                single["n_layers"] != LAUNCH_LAYERS:
            raise AssertionError(f"launch single: {single['n_params']} "
                                 f"parameters, {single['n_layers']} layers")
        fall = losses[0] - statistics.mean(losses[-LAUNCH_LAST:])
        rec["single_fall"] = fall
        print(f"launch single: the last {LAUNCH_LAST} losses average "
              f"{fall:.4f} below the first (at least {LAUNCH_FALL})")
        if not all(math.isfinite(x) for x in losses) or fall < LAUNCH_FALL:
            raise AssertionError(f"launch single: losses {losses} not "
                                 f"finite and falling")
        if used_kernels(single):
            raise AssertionError(f"launch single launched "
                                 f"{used_kernels(single)}")

        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        depth = fl_depth(free)
        est = fl_peak_estimate(depth)
        fl = run_train(dev, work, "fl", "--layers", depth, *LAUNCH_FL,
                       check="b2")
        b2s = fl.pop("checked")
        rec["fl"] = dict(fl, free_before=free, total=total,
                         estimate_bytes=est, b2_checks=b2s)
        left = free - fl["peak_reserved_bytes"]
        print(f"launch fl {LAUNCH_ARCH} x 2 pods, cut to {depth} of "
              f"{LAUNCH_LAYERS} layers ({fl['n_params']:,} parameters a "
              f"pod; estimate {est / 1e9:.2f} GB, free before "
              f"{free / 1e9:.2f} of {total / 1e9:.2f} GB): s/step "
              f"{fl['step_s']}, rounds {fl['rounds']}, losses "
              f"{fl['losses']}, peak {fl['peak_bytes'] / 1e9:.2f} GB "
              f"allocated, {fl['peak_reserved_bytes'] / 1e9:.2f} GB "
              f"reserved, {left / 1e9:.2f} GB left free; launches "
              f"{used_kernels(fl)}")
        print(f"launch fl: B2 against its plain version in the round "
              f"{b2s}")
        if len(b2s) != 1 or not b2s[0]["equal"] or \
                any(b2s[0]["controls_pass"].values()) or \
                not b2s[0]["columns_where_pods_differ"]:
            raise AssertionError(f"launch fl: B2's round output {b2s}")
        if [r["step"] for r in fl["rounds"]] != [2] or \
                not all(r["pods_equal"] for r in fl["rounds"]):
            raise AssertionError(f"launch fl: rounds {fl['rounds']}")
        if used_kernels(fl) != LAUNCH_KERNELS_FL:
            raise AssertionError(f"launch fl launched {used_kernels(fl)}, "
                                 f"expected {LAUNCH_KERNELS_FL}")
        if not all(math.isfinite(x) for x in fl["losses"]):
            raise AssertionError(f"launch fl: losses {fl['losses']}")
        if left < LAUNCH_FREE:
            raise AssertionError(f"launch fl: {left / 1e9:.2f} GB left "
                                 f"free, under {LAUNCH_FREE / 1e9:.0f}")

        rec["resume"] = {}
        launch_kill_resume(dev, work, rec["resume"])
        torch.cuda.empty_cache()
        rec["abstract"] = {}
        launch_abstract(dev, rec["abstract"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return fl["launches"]["fedavg_agg"]["agg"]


# Phase 16, "dry run": the dry run's analysis (launch/hlo_cost.py and
# launch/hlo_analysis.py, what ``python -m repro_torch.launch.dryrun``
# records for every cell) held against steps the card runs.  (a)-(c): one
# AdamW train_step of phase 15's single mode, musicgen-medium at full
# width and depth on DRY_BATCH x DRY_SEQ tokens with its parameters and
# AdamW state resident, counted on fake CPU tensors (traced whole, and
# extrapolated from 1, 2 and 3 layers) and then run on the card: the
# trace's flops against the profiler's (``with_flops``), the memory
# summary's peak_estimate_bytes against max_memory_allocated over the step
# (above what was allocated before the parameters), and the profiler's
# device time at least max(t_compute_s, t_memory_s).  (d): one fl_round on
# phase 14's pods (yi-9b's width cut to PODS_LAYERS, PODS_N pods): B2
# launched exactly once, the record's bytes for that call 4 (W N + W + N)
# (B2's byte bound), and the round's device time at least the record's
# t_memory_s for the whole round (the record divides it over the PODS_N
# devices of its mesh; the card runs every pod).
DRY_ARCH, DRY_LAYERS = LAUNCH_ARCH, LAUNCH_LAYERS
DRY_FULL = True                   # the tests' rehearsal: REDUCED widths
DRY_BATCH, DRY_SEQ = 8, 128
# |estimate / measured - 1|.  Measured on an NVIDIA H100 80GB HBM3 at
# 700.00 W: flops 0 (the matmuls that ran, as the profiler counts them
# from shapes); peak 0.0018 whole and extrapolated with phase 16 run alone
# (36,294,655,492 against 36,361,764,864 bytes: cuBLAS's workspace,
# allocated in the warm-up step above the base), 2.6e-5 in the whole
# script (36,295,585,792); the control without the optimizer's
# temporaries 0.181-0.183
DRY_LIMITS = {"flops": 1e-3, "peak": 0.01}
# estimates for controls: the step traced without remat's checkpoints,
# and with an optimizer that keeps no temporaries (its update returns the
# state unchanged)
DRY_ESTIMATES = ("no remat", "no optimizer temporaries")
# the ones the check holds: at full width the step peaks in AdamW's pass
# (remat changes only the backward's activations, below that peak)
DRY_CONTROLS = ("no optimizer temporaries",)
# cuBLAS's GEMM kernels, by the names they carry on Hopper
GEMM_NAMES = ("gemm", "cutlass", "nvjet", "xmma", "sm90_")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def dry_mesh(pods=1):
    """A one-device mesh (with a pod axis of ``pods`` for the fl round),
    abstract as the production meshes are."""
    from repro_torch.parallel.sharding import Mesh
    if pods > 1:
        return Mesh(np.full((pods, 1, 1), None, dtype=object),
                    ("pod", "data", "model"))
    return Mesh(np.full((1, 1), None, dtype=object), ("data", "model"))


def dry_cfg(arch, n_layers, **kw):
    from repro_torch import configs
    return configs.get_config(arch, reduced=not DRY_FULL).replace(
        n_layers=n_layers, **kw)


def no_temporaries(optimizer):
    """``optimizer`` whose update returns the state unchanged: the peak
    check's control without the optimizer's temporaries."""
    from repro_torch import optim
    return optim.Optimizer(init=optimizer.init,
                           update=lambda params, grads, state: (params,
                                                                state))


def dry_record(cfg, optimizer, full_trace_s, i=0, pods=1, batch=None,
               seq=None):
    """(traced, record) of step ``i`` of a train cell of ``cfg`` on
    ``dry_mesh(pods)`` (``fl`` with pods > 1: 0 the local step, 1 the
    round), counted as ``launch.dryrun`` counts a cell: whole when
    ``full_trace_s`` allows, else extrapolated."""
    from repro_torch.launch import dryrun
    batch, seq = batch or DRY_BATCH, seq or DRY_SEQ
    mesh = dry_mesh(pods)
    kw = dict(batch=batch, seq_len=seq, fl=pods > 1, n_microbatch=1,
              optimizer=optimizer)
    name, traced = dryrun.trace_cell_step(cfg, "train", mesh, i,
                                          full_trace_s=full_trace_s, **kw)
    inputs = dryrun.cell_steps(cfg, "train", mesh, **kw)[i][3]
    return traced, dryrun.step_record(name, traced, cfg, inputs, mesh,
                                      batch=batch, seq_len=seq,
                                      n_microbatch=1)


def device_us(evt, dev) -> float:
    """An event's own time on ``dev`` in microseconds (on the CPU, its
    own CPU time)."""
    if dev.type == "cuda":
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))
    return float(evt.self_cpu_time_total)


def profiled(dev, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` with flops: wall s, the
    device's busy s (on the CPU, the ops' own CPU time), of it cuBLAS's
    GEMMs, and the flops the profiler counts (all ops, and the matmuls'
    alone)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=acts, with_flops=True, record_shapes=True) \
            as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    avg = prof.key_averages()
    kind = torch.autograd.DeviceType.CUDA if dev.type == "cuda" \
        else torch.autograd.DeviceType.CPU
    on_dev = [e for e in avg if e.device_type == kind]
    busy = sum(device_us(e, dev) for e in on_dev) / 1e6
    gemm = sum(device_us(e, dev) for e in on_dev
               if dev.type == "cuda"
               and any(n in e.key.lower() for n in GEMM_NAMES)) / 1e6
    flops = sum(float(e.flops or 0) for e in avg)
    mm = [e for e in prof.events() if e.name in MATMUL_OPS]
    ran = [e for e in mm if _ran(e)]
    return {"wall_s": wall, "device_s": busy, "gemm_s": gemm,
            "flops": flops,
            "matmul_flops": sum(float(e.flops or 0) for e in mm),
            "matmul_flops_ran": sum(float(e.flops or 0) for e in ran),
            "matmuls_aborted": len(mm) - len(ran),
            "n_kernels": sum(e.count for e in on_dev),
            "post_s": time.perf_counter() - t0}


def _ran(evt) -> bool:
    """Whether a profiled op ran.  Remat's recompute (a non-reentrant
    checkpoint) stops by raising from the saved-tensor hook, in autograd
    before the op's kernel: the profiler has recorded the op, with its
    flops, but it launched nothing and its only children are the
    detaches of its saved inputs."""
    return bool(evt.kernels) or any(
        c.name not in ("aten::detach", "detach") or _ran(c)
        for c in evt.cpu_children)


def _rel(est, got) -> float:
    return abs(est / got - 1.0) if got else math.inf


def dry_estimates(cfg, opt) -> dict:
    """The analysis of (a)-(c): DRY_ARCH's step counted whole, extrapolated,
    and as the controls."""
    est = {}
    for label, c, o, full_s in (
            ("full trace", cfg, opt, math.inf),
            ("extrapolated", cfg, opt, 0.0),
            ("no remat", cfg.replace(remat=False), opt, 0.0),
            ("no optimizer temporaries", cfg, no_temporaries(opt), 0.0)):
        traced, r = dry_record(c, o, full_s)
        est[label] = {"flops": r["roofline"]["hlo_flops_per_device"],
                      "hbm_bytes": r["roofline"]["hbm_bytes_per_device"],
                      "peak_estimate_bytes":
                          r["memory"]["peak_estimate_bytes"],
                      "t_compute_s": r["roofline"]["t_compute_s"],
                      "t_memory_s": r["roofline"]["t_memory_s"],
                      "counted": traced.how, "trace_s": traced.seconds,
                      "top_ops": r["top_ops"]}
    return est


def dry_gaps(est, measured_peak, prof) -> dict:
    """|estimate / measured - 1| of each estimate's flops (against the
    profiler's matmuls that ran) and peak."""
    return {label: {"flops": _rel(e["flops"], prof["matmul_flops_ran"]),
                    "peak": _rel(e["peak_estimate_bytes"], measured_peak)}
            for label, e in est.items()}


def dry_problems(gaps, device_s, bound) -> list:
    """What (a)-(c) find wrong: an estimate outside its limit, a control
    inside it, a device time under the bound."""
    bad = [f"{label} {k} {gaps[label][k]:.4f}" for label in
           ("full trace", "extrapolated") for k in DRY_LIMITS
           if not gaps[label][k] <= DRY_LIMITS[k]]
    bad += [f"control {c} passes ({gaps[c]['peak']:.4f})"
            for c in DRY_CONTROLS if gaps[c]["peak"] <= DRY_LIMITS["peak"]]
    if device_s < bound:
        bad.append(f"device time {device_s:.4f} s under the bound "
                   f"{bound:.4f} s")
    return bad


def dry_train(dev, rec):
    """(a)-(c) of phase 16 on DRY_ARCH's step."""
    from repro_torch import optim
    from repro_torch.launch import hlo_cost, train
    from repro_torch.models import init_params, train_step
    cfg = dry_cfg(DRY_ARCH, DRY_LAYERS)
    opt = optim.adamw(LAUNCH_LR)
    t0 = time.perf_counter()
    est = dry_estimates(cfg, opt)
    analysis_s = time.perf_counter() - t0

    gc_collect_cuda(dev)
    base, _ = _device_bytes(dev)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    opt_state = opt.init(params)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"embeds": train.step_embeds(0, (DRY_BATCH, DRY_SEQ,
                                             cfg.d_model), dev),
             "labels": torch.randint(0, cfg.vocab_size,
                                     (DRY_BATCH, DRY_SEQ), generator=g,
                                     device=dev, dtype=torch.int32)}
    state = {"params": params, "opt_state": opt_state}
    del params, opt_state

    def step():
        p, o, met = train_step(state["params"], state["opt_state"], batch,
                               cfg=cfg, optimizer=opt)
        state.update(params=p, opt_state=o)
        return met
    float(step()["loss"])                                 # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        float(step()["loss"])
        wall = time.perf_counter() - t0
        _, peak = _device_bytes(dev)
        measured_peak = peak - base
    else:          # the rehearsal: the live storages of a real CPU step
        t0 = time.perf_counter()
        measured_peak = hlo_cost.trace(lambda st, b: step(), state, batch,
                                       fake=False).peak_bytes
        wall = time.perf_counter() - t0
    prof = profiled(dev, step)
    del state, batch
    gc_collect_cuda(dev)

    full = est["full trace"]
    bound = max(full["t_compute_s"], full["t_memory_s"])
    gaps = dry_gaps(est, measured_peak, prof)
    rec.update({"arch": cfg.name, "n_layers": cfg.n_layers,
                "batch": DRY_BATCH, "seq": DRY_SEQ, "estimates": est,
                "analysis_s": analysis_s, "measured_peak_bytes":
                    measured_peak, "step_wall_s": wall, "profile": prof,
                "bound_s": bound, "gaps": gaps, "limits": DRY_LIMITS,
                "device_over_wall": prof["device_s"] / prof["wall_s"]})
    print(f"dryrun {cfg.name} ({cfg.n_layers} layers, {DRY_BATCH} x "
          f"{DRY_SEQ}): trace flops {full['flops']:.6e} (extrapolated "
          f"{est['extrapolated']['flops']:.6e}), profiler: the matmuls that "
          f"ran {prof['matmul_flops_ran']:.6e} (all {prof['matmul_flops']:.6e}"
          f", {prof['matmuls_aborted']} aborted by remat's early stop; every"
          f" op {prof['flops']:.6e}); peak estimate "
          f"{full['peak_estimate_bytes']:,} (extrapolated "
          f"{est['extrapolated']['peak_estimate_bytes']:,}), measured "
          f"{measured_peak:,}; controls "
          + ", ".join(f"{c} {est[c]['peak_estimate_bytes']:,}"
                      for c in DRY_ESTIMATES)
          + f"; device {prof['device_s']:.4f} s of wall {prof['wall_s']:.4f}"
          f" s (GEMMs {prof['gemm_s']:.4f} s, {prof['n_kernels']} "
          f"kernels; unprofiled wall {wall:.4f} s), bound {bound:.4f} s "
          f"(t_compute {full['t_compute_s']:.4f}, t_memory "
          f"{full['t_memory_s']:.4f}); analysis {analysis_s:.1f} s, "
          f"profile post-processing {prof['post_s']:.1f} s")
    print(f"dryrun gaps (limits {DRY_LIMITS}): {gaps}")
    bad = dry_problems(gaps, prof["device_s"], bound)
    if bad:
        raise AssertionError(f"dryrun: {bad}")


def gc_collect_cuda(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def pods_problems(launches, want, kern, bound_bytes, device_s, t_mem):
    """What (d) finds wrong."""
    bad = []
    if launches != want:
        bad.append(f"B2 launched {launches} times")
    if kern.get("calls") != 1 or kern.get("hbm_bytes") != bound_bytes:
        bad.append(f"the record's B2 call {kern}")
    if device_s < t_mem:
        bad.append(f"device time {device_s:.6f} s under t_memory_s "
                   f"{t_mem:.6f}")
    return bad


def dry_pods(dev, rec) -> int:
    """(d) of phase 16: one fl_round on phase 14's pods.  Returns B2's
    launches."""
    from repro_torch import optim
    from repro_torch.core import federated
    from repro_torch.kernels import fedavg_agg
    from repro_torch.models import init_params
    from repro_torch.tree import leaves
    cfg = dry_cfg(PODS_ARCH, PODS_LAYERS)
    traced, r = dry_record(cfg, optim.adamw(TRAIN_LR), math.inf, i=1,
                           pods=PODS_N, batch=PODS_N * PODS_BATCH,
                           seq=PODS_SEQ)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    N = sum(t.numel() for t in leaves(params))
    sp = federated.stack_for_pods(params, PODS_N)
    del params
    w = torch.ones(PODS_N, device=dev)
    zero_counters()
    out = {}
    prof = profiled(dev, lambda: out.update(p=federated.fl_round(sp, w)))
    launches = fedavg_agg.LAUNCHES["agg"]
    del sp, out
    gc_collect_cuda(dev)
    kern = traced.kernels.get("fedavg_agg_flat", {})
    W = PODS_N
    bound_bytes = 4 * (W * N + W + N)
    # the record is a device's share of a PODS_N-device mesh; the card
    # runs every pod, so it is held to the whole round's bytes
    from repro_torch.launch.hlo_analysis import HBM_BW
    t_mem = traced.hbm_bytes / HBM_BW
    want = 1 if dev.type == "cuda" else 0
    rec.update({"arch": cfg.name, "n_layers": cfg.n_layers, "pods": W,
                "N": N, "b2_launches": launches,
                "record_b2_bytes": kern.get("hbm_bytes"),
                "record_b2_calls": kern.get("calls"),
                "b2_byte_bound": bound_bytes, "record": r,
                "profile": prof, "t_memory_s": t_mem})
    print(f"dryrun fl_round {cfg.name} ({cfg.n_layers} layers) x {W} pods "
          f"of {N:,}: B2 launched {launches} (expected {want}), the "
          f"record's B2 bytes {kern.get('hbm_bytes')} in "
          f"{kern.get('calls')} call(s), 4 (W N + W + N) = {bound_bytes}; "
          f"device {prof['device_s']:.6f} s of wall {prof['wall_s']:.6f} s,"
          f" the round's bytes over the card's rate {t_mem:.6f} s "
          f"({traced.hbm_bytes:.6e} bytes; the record's t_memory_s a "
          f"device {r['roofline']['t_memory_s']:.6f})")
    bad = pods_problems(launches, want, kern, bound_bytes, prof["device_s"],
                        t_mem)
    if bad:
        raise AssertionError(f"dryrun fl_round: {bad}")
    return launches


def run_dryrun(dev, rec) -> int:
    """Phase 16.  Returns the round's B2 launches."""
    rec["train"] = {}
    dry_train(dev, rec["train"])
    rec["fl_round"] = {}
    return dry_pods(dev, rec["fl_round"])


def dryrun_line(rec) -> dict:
    """Phase 16's figures for the ``dryrun`` line."""
    t, f = rec.get("train", {}), rec.get("fl_round", {})
    est = t.get("estimates", {})
    return {
        "arch": t.get("arch"), "layers": t.get("n_layers"),
        "trace_flops": est.get("full trace", {}).get("flops"),
        "extrapolated_flops": est.get("extrapolated", {}).get("flops"),
        "profiler_flops": t.get("profile", {}).get("matmul_flops_ran"),
        "profiler_flops_all_ops": t.get("profile", {}).get("flops"),
        "peak_estimate_bytes":
            est.get("full trace", {}).get("peak_estimate_bytes"),
        "extrapolated_peak_bytes":
            est.get("extrapolated", {}).get("peak_estimate_bytes"),
        "measured_peak_bytes": t.get("measured_peak_bytes"),
        "control_peak_bytes": {c: est.get(c, {}).get("peak_estimate_bytes")
                               for c in DRY_ESTIMATES},
        "controls_checked": list(DRY_CONTROLS),
        "gaps": t.get("gaps"), "limits": DRY_LIMITS,
        "device_s": t.get("profile", {}).get("device_s"),
        "wall_s": t.get("profile", {}).get("wall_s"),
        "bound_s": t.get("bound_s"),
        "t_compute_s": est.get("full trace", {}).get("t_compute_s"),
        "t_memory_s": est.get("full trace", {}).get("t_memory_s"),
        "round_b2_launches": f.get("b2_launches"),
        "round_b2_bytes": f.get("record_b2_bytes"),
        "round_b2_bound_bytes": f.get("b2_byte_bound"),
        "round_device_s": f.get("profile", {}).get("device_s"),
        "round_t_memory_s": f.get("t_memory_s")}


def main() -> int:
    t_script = time.perf_counter()
    if sys.argv[1:2] == ["--resume-writer"]:
        key, work, dev, rounds, epochs, hold = sys.argv[2:8]
        return resume_writer(key, work, dev, int(rounds), int(epochs),
                             bool(int(hold)))
    if sys.argv[1:2] == ["--resume-reader"]:
        work, dev, rounds, epochs = sys.argv[2:6]
        return resume_reader(work, dev, int(rounds), int(epochs))
    if sys.argv[1:2] == ["--launch-train"]:
        return launch_train_checked(sys.argv[2], sys.argv[3:])
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
    missing = [D for D in WGMMA_DIMS
               if not any(f"flash_wgmmaILi{D}E" in k for k in ptxas)]
    if missing:
        raise AssertionError(f"no -Xptxas -v report of flash_wgmma at head "
                             f"dims {missing} in {_build.LOG_NAME} beside "
                             f"the library")
    for kern, info in ptxas.items():
        print(f"ptxas {kern}: {info}")
        if info.get("spill_stores") or info.get("spill_loads"):
            raise AssertionError(f"{kern} spills registers: {info}")

    if sys.argv[1:2] == ["--dryrun"]:       # phase 16 alone
        dry_rec = {}
        t0 = time.perf_counter()
        try:
            run_dryrun(dev, dry_rec)
        finally:
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            (out / "chip_smoke_dryrun.json").write_text(json.dumps(
                {"card": card, "dryrun": dry_rec}, indent=1))
        print(f"phase dryrun: {time.perf_counter() - t0:.1f} s")
        print("dryrun " + json.dumps(dryrun_line(dry_rec)))
        print(card)
        return 0
    if sys.argv[1:2] == ["--shard"]:        # phase 9 alone
        runs = {}
        t0 = time.perf_counter()
        try:
            records = run_shard(dev, Setups(dev), runs)
        finally:
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            (out / "chip_smoke_shard.json").write_text(json.dumps(
                {"card": card, "shard": runs.get("shard")}, indent=1))
        print(f"phase shard: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": list(records.values())}))
        print(card)
        return 0
    records = check_kernels(dev)
    runs, lm_rec, rwkv_rec, zoo_rec, pods_rec = {}, {}, {}, {}, {}
    launch_rec, dry_rec = {}, {}
    cpu = None
    try:
        setups = Setups(dev)
        cpu = CpuReruns(setups)
        for phase in PHASES:
            t0 = time.perf_counter()
            run_phase(phase, setups, runs, cpu)
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_fleet(setups, runs, cpu)
        print(f"phase fleet: {time.perf_counter() - t0:.1f} s")
        cpu.close()
        fl_runs = [r for r in runs.values() if "launches" in r]
        for required in (REQUIRED, FLEET_REQUIRED):
            for name, (ctr, keys) in required.items():
                for key in keys:
                    if runs[key]["launches"][ctr] < 1:
                        raise AssertionError(f"{name} never launched in "
                                             f"{key}")
        for name, (ctr, _) in REQUIRED.items():
            records[name]["launches"] = sum(r["launches"][ctr]
                                            for r in fl_runs)
        for name, ctr in RETIRED.items():
            records[name]["launches"] = sum(r["launches"][ctr]
                                            for r in fl_runs)
        t0 = time.perf_counter()
        resume = run_resume(dev, runs, {
            "main": setups._weights0[("main", "mlp")]})
        print(f"phase resume: {time.perf_counter() - t0:.1f} s")
        # the resumed processes' launches, and those of the uninterrupted
        # runs they were held against
        for name, ctr in [(n, c) for n, (c, _) in REQUIRED.items()] + \
                list(RETIRED.items()):
            records[name]["launches"] += sum(
                r["launches_resumed"][ctr]
                + r.get("launches_uninterrupted", {}).get(ctr, 0)
                for r in resume.values())
        t0 = time.perf_counter()
        records.update(run_shard(dev, setups, runs))
        print(f"phase shard: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        records["flash_attention"]["launches"] = run_lm(dev, lm_rec)
        print(f"phase lm: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        (records["wkv_state"]["launches"],
         records["wkv"]["launches"]) = run_rwkv(dev, rwkv_rec)
        print(f"phase rwkv: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paper = run_paper(dev, runs)
        for name, ctr in (("fedavg_agg_flat", "agg"),
                          ("fedavg_mix_flat", "mix")):
            if paper[ctr] < 1:
                raise AssertionError(f"{name} never launched in phase 12")
            records[name]["launches"] += paper[ctr]
        print(f"phase paper: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        records["flash_attention"]["launches"] += run_zoo(dev, zoo_rec)
        print(f"phase zoo: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pods = run_pods(dev, pods_rec)
        for name, ctr in (("fedavg_agg_flat", "agg"),
                          ("fedavg_mix_flat", "mix"),
                          ("ef_encode_grid", "ef_encode")):
            if pods[ctr] < 1:
                raise AssertionError(f"{name} never launched in phase 14")
            records[name]["launches"] += pods[ctr]
        print(f"phase pods: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        agg = run_launch(dev, launch_rec)
        if agg < 1:
            raise AssertionError("fedavg_agg_flat never launched in "
                                 "phase 15")
        records["fedavg_agg_flat"]["launches"] += agg
        rec_b2 = records["fedavg_agg_flat"]
        rec_b2["max_abs_err"] = max(
            rec_b2["max_abs_err"],
            *(c["max_abs_err"] for c in launch_rec["fl"]["b2_checks"]))
        print(f"phase launch: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        agg = run_dryrun(dev, dry_rec)
        if agg < 1:
            raise AssertionError("fedavg_agg_flat never launched in "
                                 "phase 16")
        records["fedavg_agg_flat"]["launches"] += agg
        print(f"phase dryrun: {time.perf_counter() - t0:.1f} s")
    finally:
        if cpu is not None:
            cpu.close()
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        seconds = time.perf_counter() - t_script
        (out / "chip_smoke_report.json").write_text(json.dumps(
            {"card": card, "seconds": seconds,
             "kernels": list(records.values()), "runs": runs,
             "lm": lm_rec, "rwkv": rwkv_rec, "zoo": zoo_rec,
             "pods": pods_rec, "launch": launch_rec, "dryrun": dry_rec},
            indent=1))
    print(f"script: {seconds:.1f} s")
    print("dryrun " + json.dumps(dryrun_line(dry_rec)))
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
