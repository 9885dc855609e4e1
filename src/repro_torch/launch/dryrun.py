"""Multi-pod dry run of the port (port of ``repro/launch/dryrun.py``): trace
every (architecture x input shape) cell's step and record memory, cost and
collective analysis for the production meshes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--fl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Records land in benchmarks/results/torch/dryrun/<mesh>/<arch>__<shape>[__fl].json,
never in the reference's benchmarks/results/dryrun/.

There is no XLA and no compile here: each cell's step runs eagerly on fake
CPU tensors (``hlo_cost.trace``) built from ``launch.specs``' abstract
inputs, and ``hlo_analysis`` turns the count into the reference's memory
summary and roofline terms, with collectives from a model of the cell's
shardings.  It touches no device: every tensor is fake, so each kernel
wrapper on a path takes its plain version (at the cells' default
``attn_impl="xla"`` the only kernel on these paths is B2, in
``fl_round``), and nothing is allocated on a card.

What a cell traces: ``train_step`` with ``grad_specs`` over
``cfg.microbatches`` microbatches, ``prefill_step``, ``serve_step`` (the
decode step at position ``seq_len - 1``, with ``embeds`` for
``embeds_input`` archs), and with ``--fl`` ``fl_local_step`` over
``federated.stack_for_pods`` of the inputs, then ``fl_round``.  The
port's ``fl_round`` differs from JAX's on purpose: on a multi-device mesh
JAX's keeps a per-leaf einsum (``src/repro/core/federated.py:107-112``),
the port packs the pods into one ``(n_pods, N)`` f32 buffer and makes one
B2 call (``src/repro_torch/core/federated.py``); the record counts that
call under ``steps.fl_round.kernels.fedavg_agg_flat``.

A trace does not depend on the mesh, so each cell is traced once a
process and both meshes' records are derived from it.  A cell whose full
trace is estimated (its units times the one-unit trace's seconds) within
``FULL_TRACE_S`` is traced whole; the others at one, two (and three, for
the steps that differentiate) repeating units of blocks and extrapolated
(``hlo_cost.extrapolate``).  ``steps.<name>.counted`` says which.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch import optim
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import federated
from repro_torch.kernels import fedavg_agg
from repro_torch.launch import analytics, hlo_analysis, hlo_cost, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import prefill_step, serve_step, train_step
from repro_torch.models.transformer import _hybrid_layout
from repro_torch.parallel import param_specs
from repro_torch.parallel.sharding import NamedSharding, P
from repro_torch.tree import tree_map

RESULTS = Path(__file__).resolve().parents[3] / "benchmarks" / "results" / \
    "torch" / "dryrun"
FULL_TRACE_S = 60.0
SKIP_REASON = ("full-attention arch: long_500k requires sub-quadratic "
               "attention (DESIGN.md §4)")
# kernel wrappers on the traced paths, counted on their own in the records
KERNELS = {"fedavg_agg_flat": (fedavg_agg, "fedavg_agg_flat")}
DIFFERENTIATES = ("train_step", "fl_local_step")

_TRACES: dict = {}


def applicable(arch: str, shape: str) -> bool:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False  # pure full-attention archs skip 500k decode (DESIGN.md §4)
    return True


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _podded(tree, mesh, n_pods):
    """``federated.stack_for_pods`` of an ``Abstract`` tree, each leaf's
    spec led by "pod" (the reference's ``podded``)."""
    return tree_map(lambda a: specs.Abstract(
        federated.stack_for_pods(a.tensor, n_pods),
        NamedSharding(mesh, P("pod", *a.sharding.spec))), tree)


def _meta(tree):
    return tree_map(lambda a: a.tensor, tree)


def cell_steps(cfg, kind, mesh, *, batch, seq_len, fl=False,
               n_microbatch=1, optimizer=None):
    """The steps of one cell: ``[(step_name, fn, args, inputs)]``, ``args``
    the ``Abstract`` leaves ``fn`` takes and ``inputs`` them by name (the
    arguments the memory summary and the collective model read)."""
    optimizer = optimizer or optim.adamw()
    params = specs.abstract_params(cfg, mesh)
    if kind == "train":
        opt = specs.abstract_opt_state(cfg, mesh, optimizer)
        b = specs.batch_at(cfg, mesh, kind, batch, seq_len)
        if fl:
            n_pods = _mesh_sizes(mesh).get("pod", 1)
            assert n_pods > 1, "--fl requires the multi-pod mesh"
            sp = _podded(params, mesh, n_pods)
            so = _podded(opt, mesh, n_pods)
            step = functools.partial(federated.fl_local_step, cfg=cfg,
                                     optimizer=optimizer, n_pods=n_pods,
                                     n_microbatch=n_microbatch)
            w = specs.Abstract(torch.empty((n_pods,), dtype=torch.float32,
                                           device="meta"),
                               NamedSharding(mesh, P()))
            return [("fl_local_step", step, (sp, so, b),
                     {"params": sp, "opt_state": so, "batch": b}),
                    ("fl_round", federated.fl_round, (sp, w),
                     {"params": sp, "weights": w})]
        gspecs = param_specs(cfg, _meta(params), mesh)
        step = functools.partial(train_step, cfg=cfg, optimizer=optimizer,
                                 n_microbatch=n_microbatch,
                                 grad_specs=gspecs)
        return [("train_step", step, (params, opt, b),
                 {"params": params, "opt_state": opt, "batch": b})]
    if kind == "prefill":
        b = specs.batch_at(cfg, mesh, kind, batch, seq_len)
        return [("prefill_step", functools.partial(prefill_step, cfg=cfg),
                 (params, b), {"params": params, "batch": b})]
    if kind == "decode":
        b = specs.batch_at(cfg, mesh, kind, batch, seq_len)
        state = specs.decode_state_at(cfg, mesh, batch, seq_len)
        pos = seq_len - 1
        if cfg.embeds_input:
            def step(p, s, e):
                return serve_step(p, s, None, pos, cfg=cfg, embeds=e)
            args = (params, state, b["embeds"])
        else:
            def step(p, s, t):
                return serve_step(p, s, t, pos, cfg=cfg)
            args = (params, state, b["tokens"])
        return [("serve_step", step, args,
                 {"params": params, "state": state, "batch": b})]
    raise ValueError(kind)


def _layout(cfg):
    """(layers a repeating unit, units, trailing layers) of the stack."""
    if cfg.block_type == "mamba2":
        G, per, trailing = _hybrid_layout(cfg)
        return per + 1, G, trailing
    if cfg.alt_local_global:
        return 2, cfg.n_layers // 2, 0
    return 1, cfg.n_layers, 0


def trace_at_depth(cfg, name, build, full_trace_s=FULL_TRACE_S):
    """``name``'s step of ``cfg`` counted at full depth: ``build(cfg_cut)``
    gives the step's ``(fn, args)`` at a cut.  Traced whole when the
    estimate fits ``full_trace_s``, else extrapolated."""
    per, units, trailing = _layout(cfg)
    npts = 3 if name in DIFFERENTIATES else 2

    def at(u, t=0):
        fn, args = build(cfg.replace(n_layers=u * per + t))
        return hlo_cost.trace(fn, *args, kernels=KERNELS)
    if units <= npts:
        return at(units, trailing)
    one = at(1)
    if one.seconds * (units + trailing / per) <= full_trace_s:
        full = at(units, trailing)
        full.seconds += one.seconds
        return full
    points = {1: one}
    for u in range(2, npts + 1):
        points[u] = at(u)
    return hlo_cost.extrapolate(points, units,
                                at(1, trailing) if trailing else None)


def _sizes(shape):
    info = SHAPES[shape]
    return info["global_batch"], info["seq_len"]


def trace_cell_step(cfg, kind, mesh, i, *, full_trace_s=FULL_TRACE_S,
                    **kw):
    """``(step_name, traced)``: step ``i`` of ``cell_steps(cfg, kind, mesh,
    **kw)`` counted at ``cfg``'s full depth (``trace_at_depth``)."""
    def build(c):
        _, fn, args, _ = cell_steps(c, kind, mesh, **kw)[i]
        return fn, args
    name = cell_steps(cfg.replace(n_layers=_layout(cfg)[0]), kind, mesh,
                      **kw)[i][0]
    return name, trace_at_depth(cfg, name, build, full_trace_s)


def lower_cell(arch: str, shape: str, mesh, fl: bool = False,
               n_microbatch: int = 0):
    """``[(step_name, traced)]`` for the cell: each step counted at full
    depth (``hlo_cost.Traced``).  Traces are kept for the process, keyed
    by what they depend on (not the mesh, beyond its pod count)."""
    cfg = get_config(arch)
    n_microbatch = n_microbatch or cfg.microbatches
    kind = SHAPES[shape]["kind"]
    batch, seq_len = _sizes(shape)
    n_pods = _mesh_sizes(mesh).get("pod", 1) if fl else 1
    key = (cfg, kind, fl, n_pods, n_microbatch, batch, seq_len)
    if key not in _TRACES:
        n_steps = 2 if fl and kind == "train" else 1
        _TRACES[key] = [trace_cell_step(cfg, kind, mesh, i, batch=batch,
                                        seq_len=seq_len, fl=fl,
                                        n_microbatch=n_microbatch)
                        for i in range(n_steps)]
    return _TRACES[key]


def step_record(name, traced, cfg, inputs, mesh, *, batch, seq_len,
                n_microbatch) -> dict:
    """One step's record on ``mesh``: memory summary, roofline terms (the
    collective model among them), how the trace was counted, the kernel
    calls it made and the ops that moved the most bytes."""
    n_dev = math.prod(mesh.devices.shape)
    coll = hlo_analysis.collective_model(
        name, cfg, inputs, mesh, batch=batch, seq_len=seq_len,
        n_microbatch=n_microbatch)
    parsed = hlo_cost.analyze(traced, n_dev, coll)
    return {"compile_s": round(traced.seconds, 2),
            "counted": traced.how,
            "n_ops": traced.n_ops,
            "memory": hlo_analysis.memory_summary(traced, inputs, n_dev),
            "roofline": hlo_analysis.roofline_terms(parsed),
            "kernels": traced.kernels,
            "top_ops": hlo_cost.top_ops(traced),
            "collectives": coll.per_op}


def run_cell(arch: str, shape: str, *, multi_pod: bool, fl: bool = False,
             save: bool = True, verbose: bool = True):
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    tag = f"{arch}__{shape}" + ("__fl" if fl else "")
    out_path = RESULTS / mesh_name / f"{tag}.json"
    if not applicable(arch, shape):
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "skipped", "reason": SKIP_REASON}
        if save:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[skip] {mesh_name}/{tag}")
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "fl": fl,
           "status": "ok", "steps": {}}
    try:
        cfg = get_config(arch)
        kind = SHAPES[shape]["kind"]
        rec["n_params"] = cfg.n_params()
        rec["n_active_params"] = cfg.n_active_params()
        rec["model_flops"] = analytics.model_flops(arch, shape)
        rec["n_microbatch"] = cfg.microbatches if kind == "train" else None
        batch, seq_len = _sizes(shape)
        steps = lower_cell(arch, shape, mesh, fl=fl)
        inputs = {s[0]: s[3] for s in cell_steps(
            cfg, kind, mesh, batch=batch, seq_len=seq_len, fl=fl,
            n_microbatch=cfg.microbatches)}
        for name, traced in steps:
            rec["steps"][name] = step_record(
                name, traced, cfg, inputs[name], mesh, batch=batch,
                seq_len=1 if kind == "decode" else seq_len,
                n_microbatch=cfg.microbatches)
            if verbose:
                mem = rec["steps"][name]["memory"]
                terms = rec["steps"][name]["roofline"]
                pk = mem.get("peak_estimate_bytes", 0) / 2**30
                print(f"[ok] {mesh_name}/{tag}:{name} "
                      f"trace={traced.seconds:.1f}s ({traced.how}) "
                      f"peak/dev={pk:.2f}GiB dom={terms['dominant']} "
                      f"tc={terms['t_compute_s']:.4f} "
                      f"tm={terms['t_memory_s']:.4f} "
                      f"tx={terms['t_collective_s']:.4f}", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, they are bugs
        rec["status"] = "error"
        rec["error"] = f"{e.__class__.__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
        if verbose:
            print(f"[FAIL] {mesh_name}/{tag}: {rec['error']}", flush=True)
    rec["total_s"] = round(time.time() - t0, 2)
    if save:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fl", action="store_true",
                    help="trace the federated local step + aggregation "
                         "round (train shapes, multi-pod)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    n_fail = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                if args.fl and (SHAPES[shape]["kind"] != "train" or not mp):
                    continue
                rec = run_cell(arch, shape, multi_pod=mp, fl=args.fl)
                if rec["status"] == "error":
                    n_fail += 1
    print(f"done; failures={n_fail}; {time.time() - t0:.1f} s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
