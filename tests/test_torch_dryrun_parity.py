"""The port's dry-run analysis against JAX's own on REDUCED cells (CPU).

JAX's side runs in subprocesses: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices when imported, which only takes effect
before JAX initialises, so each subprocess forces 8 host devices, starts
JAX, and only then imports it; it lowers and compiles the cells with
``dryrun.lower_cell`` (its ``get_config`` giving REDUCED configs, every
shape at 8 sequences of 128 tokens) and reads ``hlo_cost.analyze`` and
``hlo_analysis.memory_summary``: the figures its records carry
(``analyze``'s collectives are ``parse_collectives``' ring formulas with
the while loops' trip counts multiplied through).  The port's
side traces the same cells (``repro_torch.launch.dryrun``) on abstract
meshes of the same shapes, 2 x 2 (data, model) and 2 x 2 x 2 (pod, data,
model), for train, prefill, decode and fl (``fl_local_step`` and
``fl_round``).  This pytest process never imports ``repro.launch.dryrun``.

What is compared, per device, as port / JAX, within bands measured on
these cells first (yi-9b, gemma2-2b, rwkv6-3b):

* flops: 1.000-1.027 except rwkv6-3b's decode step (0.776: its WKV state
  update is a dot in JAX's step, elementwise in the port's); band
  FLOPS_BAND.  Both count 0 for ``fl_round``.
* peak bytes: 0.263-1.969 (the port writes decode state in place, XLA's
  CPU buffers copy it; XLA's temporaries follow its own fusion and buffer
  assignment, torch's the order autograd frees saved tensors); PEAK_BAND.
* collective wire bytes, the record's figure (trip counts multiplied
  through) against the port's model of the shardings: 0.121-1.147 (XLA's
  partitioner at these tiny widths reshards activations with all-to-alls
  and permutes the model has no term for); COLL_BAND.  ``fl_round``'s
  all-reduce over pod equals JAX's exactly.

Control that must fail: the stack one repeating unit short, whose flops
leave FLOPS_BAND in every cell that counts any.  A collective model of
the shardings that sees none (zero bytes) leaves COLL_BAND.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.parallel.sharding import Mesh

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("yi-9b", "gemma2-2b", "rwkv6-3b")
BATCH, SEQ = 8, 128
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CELLS = [("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
         ("train_4k", True)]
FLOPS_BAND = (0.75, 1.05)
PEAK_BAND = (0.25, 2.0)
COLL_BAND = (0.1, 1.2)
_TRACES: dict = {}

JAX_SIDE = r"""
import json, os, sys
import jax
import numpy as np
jax.devices()                          # 8 host devices, before dryrun's flag
from repro.configs import SHAPES, get_config
from repro.launch import dryrun, hlo_analysis, hlo_cost, specs
for v in SHAPES.values():
    v.update(global_batch=int(sys.argv[2]), seq_len=int(sys.argv[3]))
red = lambda a, reduced=False: get_config(a, reduced=True)
dryrun.get_config = specs.get_config = red
cells = json.loads(sys.argv[4])
out = {}
for mname, (shape, axes) in json.loads(sys.argv[5]).items():
    n = int(np.prod(shape))
    m = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    for cell, fl in cells:
        if fl and "pod" not in axes:
            continue
        with jax.sharding.set_mesh(m):
            steps = dryrun.lower_cell(sys.argv[1], cell, m, fl=fl)
        for name, lowered in steps:
            c = lowered.compile()
            text = c.as_text()
            out[f"{mname}/{cell}/{name}"] = {
                "analyze": hlo_cost.analyze(text),
                "memory": hlo_analysis.memory_summary(c)}
print("JSON" + json.dumps(out))
"""


def _jax_env():
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return env


@pytest.fixture(scope="module")
def jax_side():
    """JAX's numbers for every cell, one subprocess an arch (in parallel,
    started before the port's traces run)."""
    meshes = {k: [list(s), list(a)] for k, (s, a) in MESHES.items()}
    procs = {a: subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, a, str(BATCH), str(SEQ),
         json.dumps(CELLS), json.dumps(meshes)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_jax_env(), cwd=ROOT) for a in ARCHS}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _jax_results(procs, arch):
    out, err = procs[arch].communicate(timeout=600)
    assert procs[arch].returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith("JSON")][-1]
    return json.loads(line[4:])


def _mesh(name):
    shape, axes = MESHES[name]
    return Mesh(np.full(shape, None, dtype=object), axes)


def _port(arch, mname, cell, fl, n_layers=None):
    """The port's per-device flops, peak and collective bytes of every step
    of one cell (REDUCED, at ``n_layers`` when given)."""
    cfg = get_config(arch, reduced=True)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    m = _mesh(mname)
    kind = SHAPES[cell]["kind"]
    kw = dict(batch=BATCH, seq_len=SEQ, fl=fl,
              n_microbatch=cfg.microbatches)
    steps = dryrun.cell_steps(cfg, kind, m, **kw)
    out = {}
    for i, (name, _, _, inputs) in enumerate(steps):
        # a trace does not depend on the mesh beyond its pod count
        key = (cfg, kind, fl, i)
        if key not in _TRACES:
            _TRACES[key] = dryrun.trace_cell_step(cfg, kind, m, i, **kw)[1]
        traced = _TRACES[key]
        rec = dryrun.step_record(
            name, traced, cfg, inputs, m, batch=BATCH,
            seq_len=1 if kind == "decode" else SEQ,
            n_microbatch=cfg.microbatches)
        out[name] = {"flops": rec["roofline"]["hlo_flops_per_device"],
                     "peak": rec["memory"]["peak_estimate_bytes"],
                     "coll": rec["roofline"][
                         "collective_wire_bytes_per_device"]}
    return out


def _inside(x, band):
    return band[0] <= x <= band[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_parity_with_jax(jax_side, arch):
    torch.set_num_threads(1)
    cfg = get_config(arch, reduced=True)
    unit = 2 if cfg.alt_local_global else 1
    port, short = {}, {}
    for mname in MESHES:
        for cell, fl in CELLS:
            if fl and mname == "2x2":
                continue
            for name, v in _port(arch, mname, cell, fl).items():
                port[f"{mname}/{cell}/{name}"] = v
            for name, v in _port(arch, mname, cell, fl,
                                 cfg.n_layers - unit).items():
                short[f"{mname}/{cell}/{name}"] = v
    jax = _jax_results(jax_side, arch)
    assert sorted(jax) == sorted(port)
    bad = []
    for key, want in jax.items():
        got = port[key]
        jf = want["analyze"]["flops"]
        jc = want["analyze"]["coll_wire_bytes"]
        jp = want["memory"]["peak_estimate_bytes"]
        if key.endswith("fl_round"):
            if got["flops"] != jf or abs(got["coll"] / jc - 1) > 1e-9:
                bad.append(f"{key}: flops {got['flops']} / {jf}, "
                           f"collectives {got['coll']} / {jc}")
        else:
            if not _inside(got["flops"] / jf, FLOPS_BAND):
                bad.append(f"{key}: flops {got['flops'] / jf:.3f}")
            # the control: one repeating unit short
            if _inside(short[key]["flops"] / jf, FLOPS_BAND):
                bad.append(f"{key}: one unit short passes "
                           f"({short[key]['flops'] / jf:.3f})")
            if not _inside(got["coll"] / jc, COLL_BAND):
                bad.append(f"{key}: collectives {got['coll'] / jc:.3f}")
            assert jc > 0 and not _inside(0.0, COLL_BAND)
        if not _inside(got["peak"] / jp, PEAK_BAND):
            bad.append(f"{key}: peak {got['peak'] / jp:.3f}")
    assert not bad, bad
