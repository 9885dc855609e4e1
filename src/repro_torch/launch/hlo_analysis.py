"""Roofline terms and memory summary of a traced step (port of
``repro/launch/hlo_analysis.py``), with H100 constants and a collective
model.

The reference reads per-device flops and bytes from XLA's compiled
module and parses each collective's result shape out of the SPMD HLO.
One process has no partitioner, so the port's trace (``hlo_cost``) holds
no collective: ``collective_model`` derives them from the cell's
shardings (``parallel/sharding.py`` ``param_specs``/``batch_specs``) and
prices each with the reference's ring formulas.  Every entry it returns
is marked ``"model": True``.  The terms it covers:

  * FSDP over ``data``: an all-gather of each data-sharded parameter
    before each use (a training step uses it twice a microbatch with
    remat -- forward and the recomputed forward -- else once), and a
    reduce-scatter of its gradient a microbatch; a parameter that is not
    data-sharded has its gradient all-reduced over the data-parallel
    axes instead;
  * the sync multi-pod step: each gradient shard all-reduced over
    ``pod`` a microbatch (the batch is split over pod x data);
  * tensor parallelism over ``model``: one all-reduce of the residual
    stream's activation (B_local x S x d_model, bf16) after each
    row-parallel matmul in the forward (and its recompute), and one
    after each column-parallel group in the backward; the embedding
    lookup and the tied logits add one each;
  * MoE with experts sharded over ``model``: an all-to-all of the
    dispatched tokens and one of the combined, each way;
  * ``fl_round``: an all-reduce over ``pod`` of every parameter shard, in
    f32.

Hardware constants: NVIDIA H100 SXM.  A 256- or 512-card mesh spans nodes
of 8 cards; the model prices every link at NVLink's rate, so the term is
a lower bound where an axis crosses nodes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

PEAK_FLOPS = 989e12          # bf16 dense / card (chip_smoke.py, PERF.md)
HBM_BW = 3.35e12             # bytes/s / card, HBM3
# bytes/s / card, one direction: NVLink 4, 18 links of 25 GB/s each way
# (900 GB/s both ways; NVIDIA H100 Tensor Core GPU datasheet, SXM5)
NVLINK_BW = 450e9


def ring_wire_bytes(op: str, result_bytes: float, g: int) -> float:
    """The reference's ring model (``hlo_analysis.py:82-91``): bytes one
    device sends for a collective over a group of ``g`` whose result is
    ``result_bytes`` a device."""
    if g <= 1 and op != "collective-permute":
        return 0.0
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return result_bytes                      # collective-permute


@dataclass
class CollectiveStats:
    per_op: List[dict] = field(default_factory=list)

    @property
    def wire_bytes(self) -> float:
        return sum(o["wire_bytes"] for o in self.per_op)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.per_op:
            out[o["op"]] = out.get(o["op"], 0.0) + o["wire_bytes"]
        return out

    def add(self, op: str, result_bytes: float, g: int, count: float,
            what: str) -> None:
        """``count`` collectives of kind ``op``, each with a result of
        ``result_bytes`` a device, over groups of ``g`` (``wire_bytes``:
        all of them)."""
        wire = ring_wire_bytes(op, result_bytes, g)
        if wire <= 0 or count <= 0:
            return
        self.per_op.append({"op": op, "result_bytes": result_bytes,
                            "group": g, "count": count,
                            "wire_bytes": wire * count, "what": what,
                            "model": True})


def _axes(spec) -> set:
    out = set()
    for entry in spec:
        if entry is None:
            continue
        out.update(entry if isinstance(entry, tuple) else (entry,))
    return out


def _block_counts(cfg) -> Dict[str, int]:
    """How many blocks of each kind one forward runs."""
    if cfg.block_type == "rwkv6":
        return {"rwkv": cfg.n_layers}
    if cfg.block_type == "mamba2":
        g = cfg.n_shared_attn_applications()
        return {"mamba": cfg.n_layers - g, "attn": g}
    return {"moe" if cfg.is_moe else "attn": cfg.n_layers}


def collective_model(step: str, cfg, inputs, mesh, *, batch: int,
                     seq_len: int, n_microbatch: int = 1) -> CollectiveStats:
    """The collectives one device takes part in for ``step``
    ("train_step", "prefill_step", "serve_step", "fl_local_step",
    "fl_round"), from the shardings of ``inputs`` (a tree of
    ``launch.specs.Abstract`` leaves) on ``mesh``; see the module
    docstring.  ``batch``, ``seq_len``: the global batch and the tokens a
    sequence this step runs (1 for decode)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    d, m, p = sizes.get("data", 1), sizes.get("model", 1), \
        sizes.get("pod", 1)
    stats = CollectiveStats()
    train = step in ("train_step", "fl_local_step")
    podded = step in ("fl_local_step", "fl_round")
    mb = max(1, n_microbatch) if train else 1
    uses = (2 if cfg.remat else 1) if train else 1
    dp = p * d if not podded else d          # the batch's data-parallel split
    b_pod = batch // p if podded else batch
    b_local = b_pod // (d if podded else dp) \
        if b_pod % (d if podded else dp) == 0 else b_pod

    params = [(path, a) for path, a in _flat_paths(inputs["params"])]
    for path, a in params:
        spec = a.sharding.spec
        ax = _axes(spec)
        lead = a.shape[1:] if podded else a.shape
        full = math.prod(lead) * a.tensor.element_size()
        mf = m if "model" in ax else 1
        df = d if "data" in ax else 1
        name = "/".join(path)
        if step == "fl_round":
            shard32 = math.prod(lead) * 4 / (mf * df)
            stats.add("all-reduce", shard32, p, 1, f"fl_round {name}")
            continue
        if df > 1:
            stats.add("all-gather", full / mf, d, uses * mb,
                      f"FSDP gather {name}")
        if not train:
            continue
        if df > 1:
            stats.add("reduce-scatter", full / (mf * df), d, mb,
                      f"gradient reduce-scatter {name}")
            if p > 1 and not podded:
                stats.add("all-reduce", full / (mf * df), p, mb,
                          f"gradient over pod {name}")
        else:
            stats.add("all-reduce", full / mf, dp, mb,
                      f"gradient all-reduce {name}")
    if step == "fl_round" or m <= 1:
        return stats

    # tensor parallelism over "model": the residual stream's activation
    tokens = (b_local // mb if train and b_local % mb == 0 else b_local) \
        * seq_len
    act = tokens * cfg.d_model * 2
    specs = {"/".join(path): _axes(a.sharding.spec) for path, a in params}

    def tp(*names):      # one of these leaves is sharded over "model"
        return any("model" in ax for k, ax in specs.items()
                   if any(k.endswith(n) for n in names))
    fwd = uses if train else 1
    per_block = {
        "attn": (int(tp("attn/wo")) + int(tp("mlp/wo")),
                 int(tp("attn/wq")) + int(tp("mlp/wi_gate"))),
        "moe": (int(tp("attn/wo")), int(tp("attn/wq"))),
        "rwkv": (int(tp("cm/wv")), int(tp("cm/wk"))),
        "mamba": (int(tp("out_proj")), int(tp("wx"))),
    }
    for kind, n in _block_counts(cfg).items():
        rows, cols = per_block[kind]
        stats.add("all-reduce", act, m, n * mb * (rows * fwd
                                                  + (cols if train else 0)),
                  f"tensor-parallel activations ({kind} blocks)")
        if kind == "moe" and cfg.n_experts % m == 0:
            routed = tokens * cfg.top_k * cfg.capacity_factor * \
                cfg.d_model * 2
            stats.add("all-to-all", routed, m,
                      n * mb * 2 * (fwd + (1 if train else 0)),
                      "MoE dispatch and combine")
        elif kind == "moe":
            stats.add("all-reduce", act, m, n * mb * (fwd + int(train)),
                      "tensor-parallel activations (MoE experts)")
    if tp("embedding"):
        stats.add("all-reduce", act, m, mb * (1 + int(train)),
                  "vocab-parallel embedding and logits")
    return stats


def _flat_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_paths(tree[k], path + (k,))
    else:
        yield path, tree


def roofline_terms(parsed: dict, xla_cost: dict | None = None) -> dict:
    """Three roofline terms in seconds (per device = per card).

    ``parsed`` comes from ``hlo_cost.analyze``.  ``xla_cost`` has no
    counterpart here (no compiler analysis to attach); it is kept for the
    reference's signature and attached when given."""
    flops = float(parsed.get("flops", 0.0))
    bytes_hbm = float(parsed.get("hbm_bytes", 0.0))
    wire = float(parsed.get("coll_wire_bytes", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_hbm / HBM_BW
    t_coll = wire / NVLINK_BW
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    out = {
        "hlo_flops_per_device": flops,
        "hbm_bytes_per_device": bytes_hbm,
        "collective_wire_bytes_per_device": wire,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "collectives_by_kind": parsed.get("coll_by_kind", {}),
        "n_collectives": parsed.get("n_collectives", 0),
        "parser_warnings": parsed.get("warnings", []),
        "collectives_model": True,
        "per_device": parsed.get("per_device", ""),
        "counted": parsed.get("counted", ""),
    }
    if xla_cost is not None:
        out["xla_cost_analysis_flops"] = float(xla_cost.get("flops", 0.0))
        out["xla_cost_analysis_bytes"] = float(
            xla_cost.get("bytes accessed", 0.0))
    return out


def memory_summary(traced, inputs=None, n_devices: int = 1) -> dict:
    """The reference's keys for a traced step: the arguments' bytes a
    device from their shardings (``launch.specs.per_device_bytes`` of
    ``inputs``; the trace's own without them), every other term the
    global trace divided over ``n_devices``."""
    from repro_torch.launch.specs import per_device_bytes
    arg = per_device_bytes(inputs) if inputs is not None \
        else traced.arg_bytes
    out = traced.out_bytes // n_devices
    temp = traced.temp_bytes // n_devices
    alias = traced.alias_bytes // n_devices
    return {
        "argument_bytes": int(arg),
        "output_bytes": int(out),
        "temp_bytes": int(temp),
        "alias_bytes": int(alias),
        "peak_estimate_bytes": int(arg + out + temp - alias),
        "per_device": "arguments from their shardings; outputs, "
                      "temporaries and aliases global trace / devices",
    }
