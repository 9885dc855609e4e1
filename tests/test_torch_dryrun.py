"""The port's dry run (``repro_torch.launch.{hlo_cost,hlo_analysis,dryrun}``)
on the CPU: the counterpart of the reference's trip-count test, depth
extrapolation against whole traces for every block layout, the record's
schema against the reference's, and the skip list.  Parity with JAX's own
analysis is in ``test_torch_dryrun_parity.py``; the committed sweep, the
roofline twin and phase 16's rehearsal in ``test_torch_roofline.py``."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import dryrun, hlo_analysis, hlo_cost
from repro_torch.parallel.sharding import Mesh

# extrapolated peak live bytes against the whole trace, |ratio - 1|: at
# most 0.0839 measured over the cases below (mixtral-8x22b's train step:
# where in the last block the peak falls moves with depth at these tiny
# widths, and 512-byte rounding makes small leaves' bytes non-linear);
# flops, bytes, op counts and kernel calls are exact
PEAK_EXTRAPOLATION_LIMIT = 0.09
# one block layout each: (arch, REDUCED depth with more than 3 units)
LAYOUTS = [("yi-9b", 5), ("gemma2-2b", 8), ("rwkv6-3b", 5),
           ("zamba2-7b", 13), ("mixtral-8x22b", 5)]
SIZES = dict(batch=4, seq_len=32)


def mesh(shape=(1, 1), axes=("data", "model")):
    return Mesh(np.full(shape, None, dtype=object), axes)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trace_counts_loop_trip_counts():
    """The counterpart of test_dryrun_mini's scan test: the Python loop runs
    every trip, so 10 x (64, 128) @ (128, 128) counts 10 x 2 x 64 x 128 x
    128 flops."""
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x.sum()
    res = hlo_cost.analyze(hlo_cost.trace(f, torch.empty(64, 128),
                                          torch.empty(128, 128)))
    expect = 10 * 2 * 64 * 128 * 128
    assert abs(res["flops"] - expect) / expect < 0.05
    # and one trip short is not within it
    assert abs(res["flops"] * 9 / 10 - expect) / expect >= 0.05


def test_trace_bytes_views_and_peak():
    """First-order bytes: operands + outputs, views free, a broadcast
    operand read once, a copy its read and its write; the peak counts the
    inputs and the live temporaries, rounded to 512-byte blocks."""
    def f(x, b):
        y = x.t().contiguous()            # a view, then one copy
        z = y + b                         # b broadcast over y's rows
        return z.to(torch.bfloat16)
    t = hlo_cost.trace(f, torch.empty(256, 128), torch.empty(256))
    n = 256 * 128 * 4
    assert t.hbm_bytes == (n + n) + (n + 256 * 4 + n) + (n + n // 2)
    assert t.arg_bytes == n + 1024
    assert t.peak_bytes == t.arg_bytes + 2 * n + n // 2
    assert t.out_bytes == n // 2 and t.alias_bytes == 0
    assert t.flops == 0


def test_kernel_call_counts_as_one_launch():
    """A kernel wrapper on the path (B2 in fl_round) counts its inputs read
    once and its output written once, whatever its plain version does."""
    from repro_torch.core import federated
    W, N = 2, 1000
    stacked = {"a": torch.empty((W, 600), dtype=torch.bfloat16),
               "b": torch.empty((W, 400), dtype=torch.bfloat16)}
    t = hlo_cost.trace(federated.fl_round, stacked, torch.empty(W),
                       kernels=dryrun.KERNELS)
    k = t.kernels["fedavg_agg_flat"]
    assert k["calls"] == 1
    assert k["hbm_bytes"] == 4 * (W * N + W + N)
    assert t.by_op["kernel fedavg_agg_flat"][2] == k["hbm_bytes"]


def _traces(arch, L, kind, m, fl=False, i=0):
    cfg = get_config(arch, reduced=True).replace(n_layers=L)
    kw = dict(SIZES, fl=fl, n_microbatch=1)
    _, ex = dryrun.trace_cell_step(cfg, kind, m, i, full_trace_s=0, **kw)
    _, fn, args, _ = dryrun.cell_steps(cfg, kind, m, **kw)[i]
    return ex, hlo_cost.trace(fn, *args, kernels=dryrun.KERNELS)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,L", LAYOUTS)
def test_extrapolation_equals_full_trace(arch, L, kind):
    ex, full = _traces(arch, L, kind, mesh())
    assert ex.how.startswith("extrapolated")
    assert ex.flops == full.flops
    assert ex.hbm_bytes == full.hbm_bytes
    assert ex.n_ops == full.n_ops
    assert abs(ex.peak_bytes / full.peak_bytes - 1) <= \
        PEAK_EXTRAPOLATION_LIMIT


@pytest.mark.parametrize("i", [0, 1])
def test_extrapolation_equals_full_trace_fl(i):
    """fl_local_step (three points) and fl_round (B2's call) on the pods."""
    ex, full = _traces("yi-9b", 5, "train",
                       mesh((2, 1, 1), ("pod", "data", "model")), fl=True,
                       i=i)
    assert (ex.flops, ex.hbm_bytes, ex.kernels) == \
        (full.flops, full.hbm_bytes, full.kernels)
    assert abs(ex.peak_bytes / full.peak_bytes - 1) <= \
        PEAK_EXTRAPOLATION_LIMIT


def test_extrapolation_controls_fail():
    """A step that differentiates moves bytes quadratic in depth (each
    block's select_backward materialises a stacked leaf's whole gradient):
    two points miss it, and a stack one unit short misses the flops."""
    cfg = get_config("yi-9b", reduced=True).replace(n_layers=5)
    m = mesh()
    kw = dict(SIZES, n_microbatch=2)      # and the microbatch loop

    def at(L):
        _, fn, args, _ = dryrun.cell_steps(cfg.replace(n_layers=L), "train",
                                           m, **kw)[0]
        return hlo_cost.trace(fn, *args)
    pts = {u: at(u) for u in (1, 2, 3)}
    full = at(5)
    linear = hlo_cost.extrapolate({1: pts[1], 2: pts[2]}, 5)
    assert linear.flops == full.flops
    assert linear.hbm_bytes != full.hbm_bytes
    short = hlo_cost.extrapolate(pts, 4)
    assert short.flops != full.flops
    assert hlo_cost.extrapolate(pts, 5).hbm_bytes == full.hbm_bytes


def test_applicable_skips_the_seven_full_attention_archs():
    skipped = sorted(a for a in list_archs()
                     if not dryrun.applicable(a, "long_500k"))
    assert skipped == sorted([
        "gemma2-2b", "yi-9b", "deepseek-67b", "starcoder2-15b",
        "phi3.5-moe-42b-a6.6b", "internvl2-26b", "musicgen-medium"])
    assert all(dryrun.applicable(a, s) for a in list_archs()
               for s in SHAPES if s != "long_500k")


def _reference_keys():
    """The reference's record keys (``src/repro/launch/dryrun.py:99-160``),
    its roofline and memory keys from its own ``hlo_analysis`` (a module
    without jax)."""
    from repro.launch import hlo_analysis as ref
    ma = types.SimpleNamespace(argument_size_in_bytes=1,
                               output_size_in_bytes=1, temp_size_in_bytes=1,
                               alias_size_in_bytes=0)
    mem = ref.memory_summary(types.SimpleNamespace(
        memory_analysis=lambda: ma))
    return {"ok": {"arch", "shape", "mesh", "fl", "status", "steps",
                   "n_params", "n_active_params", "model_flops",
                   "n_microbatch", "total_s"},
            "skipped": {"arch", "shape", "mesh", "status", "reason"},
            "step": {"compile_s", "memory", "roofline"},
            "memory": set(mem), "roofline": set(ref.roofline_terms({}))}


@pytest.fixture
def reduced_cells(monkeypatch):
    """run_cell at REDUCED widths on 8 x 32 tokens (the production meshes
    as they are)."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a, reduced=False: get_config(a, reduced=True))
    for k, v in SHAPES.items():
        monkeypatch.setitem(SHAPES, k, dict(v, global_batch=8, seq_len=32))
    monkeypatch.setattr(dryrun, "_TRACES", {})


@pytest.mark.parametrize("shape,multi_pod,fl", [
    ("train_4k", False, False), ("decode_32k", True, False),
    ("train_4k", True, True)])
def test_record_has_the_reference_keys(reduced_cells, monkeypatch, tmp_path,
                                       shape, multi_pod, fl):
    keys = _reference_keys()
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    rec = dryrun.run_cell("yi-9b", shape, multi_pod=multi_pod, fl=fl,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert keys["ok"] <= set(rec)
    names = {"train_4k": ["fl_local_step", "fl_round"] if fl
             else ["train_step"], "decode_32k": ["serve_step"]}[shape]
    assert list(rec["steps"]) == names
    for step in rec["steps"].values():
        assert keys["step"] <= set(step)
        assert keys["memory"] <= set(step["memory"])
        assert keys["roofline"] <= set(step["roofline"])
        assert step["roofline"]["collectives_model"] is True
        assert all(o["model"] for o in step["collectives"])
    mesh_dir = "multipod_2x16x16" if multi_pod else "pod_16x16"
    tag = f"yi-9b__{shape}" + ("__fl" if fl else "")
    assert (tmp_path / mesh_dir / f"{tag}.json").exists()
    if fl:
        rnd = rec["steps"]["fl_round"]["kernels"]["fedavg_agg_flat"]
        assert rnd["calls"] == 1
    skip = dryrun.run_cell("musicgen-medium", "long_500k",
                           multi_pod=multi_pod, verbose=False)
    assert set(skip) == keys["skipped"] and skip["status"] == "skipped"


def test_memory_summary_per_device():
    """Arguments from their shardings, the rest of the trace over the
    devices; peak = arguments + outputs + temporaries - aliases."""
    t = hlo_cost.Traced(peak_bytes=1000, arg_bytes=600, out_bytes=300,
                        alias_bytes=200)
    assert t.temp_bytes == 300
    m = hlo_analysis.memory_summary(t, None, 1)
    assert m["peak_estimate_bytes"] == 1000
    m4 = hlo_analysis.memory_summary(t, None, 4)
    assert m4["temp_bytes"] == 75 and m4["argument_bytes"] == 600


def test_roofline_terms_h100():
    r = hlo_analysis.roofline_terms({"flops": 989e12, "hbm_bytes": 6.7e12,
                                     "coll_wire_bytes": 0.0})
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["t_memory_s"] == pytest.approx(2.0)
    assert r["dominant"] == "memory"
    for op, g, want in (("all-gather", 4, 75.0), ("reduce-scatter", 4, 300.0),
                        ("all-reduce", 4, 150.0), ("all-to-all", 4, 75.0),
                        ("collective-permute", 1, 100.0),
                        ("all-reduce", 1, 0.0)):
        assert hlo_analysis.ring_wire_bytes(op, 100.0, g) == want
