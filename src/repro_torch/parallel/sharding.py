"""Sharding recipes of the port (``repro/parallel/sharding.py``): the
aggregation server's mesh, and the LM half's parameter, batch and
decode-state ``PartitionSpec``\\ s.

**The aggregation server's mesh.**  One process drives every device, as
JAX does.  A mesh is a tuple of ``torch.device``\\ s over the one axis
``AGG_AXIS``; device 0 is the *home* device, where whole vectors (the
model, gathers, a codec's 0-d statistics) live.  The packed flat parameter axis N of
the server model and of the ``(W, N)`` update-row buffer shards over it:
a sharded vector is D contiguous ``(N/D,)`` pieces and a sharded row
buffer D contiguous ``(W, N/D)`` pieces (``Sharded``), piece d on device
d; so are every link's vectors.  Every worker's lane of a parameter sits
on one device, so the merge's W-reduce is shard-local.

Device counts.  ``agg_mesh(n)`` takes the first n CUDA devices.  On the
CPU the count comes from ``REPRO_HOST_DEVICES`` (default 1), the variable
through which the tests ask XLA for a forced host platform, and the mesh
repeats the one CPU device.  ``agg_mesh(devices=...)`` takes an explicit
sequence that may repeat a device: the counterpart of that forced host
platform on one card.

JAX's ``agg_vec_sharding``/``agg_row_sharding`` have no twin: both specs
split the last dim, so a placement is ``split(t, mesh)``;
``agg_vec_spec``/``agg_row_spec`` keep the names of the two layouts.

**The LM half** (``param_specs``, ``batch_specs``, ``state_specs``) says
how the production mesh (``launch.mesh``: ``data`` x ``model``, with a
leading ``pod`` axis across pods) would lay out an LM's parameters,
batch and decode state:

* ``data``  -- FSDP: weights and optimizer state sharded along a weight
  dim; the batch is data-parallel over (``pod``, ``data``);
* ``model`` -- tensor parallel: attention heads, FFN hidden, vocab,
  experts, mamba2 inner channels;
* ``pod``   -- data-parallel across pods; the federated axis of the
  paper's technique.

A dim is sharded only when its axis size divides it, so the same rules
serve the 256- and 512-device meshes and a 1 x 1 one.  The rules are
keyed by the last two dict keys of a leaf's path and read a mesh only
through ``axis_names`` and ``devices.shape``.  A spec is the port's
``PartitionSpec`` and a sharding a ``NamedSharding`` (mesh, spec), which
gives a leaf's per-device ``shard_shape``.  Nothing here places a
tensor: one process has no SPMD partitioner, so ``constrain_qkv`` and
``constrain_act`` return their inputs, as JAX's do with no mesh active.
"""
from __future__ import annotations

import contextlib
import math
import os
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map, tree_map_with_path

AGG_AXIS = "agg"


@dataclass(frozen=True)
class AggMesh:
    """A 1-D mesh over ``AGG_AXIS``; ``devices`` may repeat a device."""
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        return {AGG_AXIS: len(self.devices)}

    @property
    def home(self) -> torch.device:
        """Where whole vectors live and gathers land."""
        return self.devices[0]


def _available(platform: str) -> Tuple[torch.device, ...]:
    if platform == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if platform == "cpu":
        n = int(os.environ.get("REPRO_HOST_DEVICES") or 1)
        return (torch.device("cpu"),) * n
    raise ValueError(f"no aggregation mesh on platform {platform!r}")


def agg_mesh(n_devices: Optional[int] = None, *,
             devices: Optional[Sequence] = None,
             platform: Optional[str] = None) -> AggMesh:
    """1-D aggregation-server mesh over ``AGG_AXIS``: the first
    ``n_devices`` devices of ``platform`` (all of them when None), or
    ``devices`` as given.  With no platform the mesh is on the CUDA card,
    as every entry point's default device is (``resolve_device``), and
    raises when there is none."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f"server mesh of {n_devices} devices from "
                             f"{len(devs)} given")
        return AggMesh(devs)
    if platform is None:
        platform = resolve_device().type
    devs = _available(platform)
    n = len(devs) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devs):
        raise ValueError(f"server mesh of {n} devices, but only "
                         f"{len(devs)} available (CPU runs: set "
                         f"REPRO_HOST_DEVICES; one card: agg_mesh(devices="
                         f"...) may repeat it)")
    return AggMesh(devs[:n])


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: per dim, a mesh axis name, a tuple of
    names, or None; dims past its length are unsharded.  As JAX's does, it
    keeps a one-name tuple as the name and an empty tuple as None."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                return None if not a else a[0] if len(a) == 1 else a
            return a
        return super().__new__(cls, tuple(norm(a) for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def agg_vec_spec() -> PartitionSpec:
    """Packed flat parameter vector (N,): sharded along N."""
    return P(AGG_AXIS)


def agg_row_spec() -> PartitionSpec:
    """(W, N) update-row buffer: worker rows replicated, N sharded: every
    device holds all workers' slices of its own parameter range, so the
    merge's W-reduce is shard-local."""
    return P(None, AGG_AXIS)


def split(t: torch.Tensor, mesh: AggMesh) -> "Sharded":
    """``t`` placed on ``mesh`` (JAX's ``device_put`` with either spec
    above: every sharded tensor of the port splits its last dim): one
    contiguous copy of each equal slice on its device."""
    d = len(mesh.devices)
    n = t.shape[-1]
    if n % d:
        raise ValueError(f"width {n} not divisible by the {d}-device "
                         f"'{AGG_AXIS}' mesh axis")
    s = n // d
    return Sharded([t[..., i * s:(i + 1) * s].to(dev, copy=True,
                                                 non_blocking=True)
                    .contiguous() for i, dev in enumerate(mesh.devices)],
                   mesh)


class Sharded:
    """A logically whole tensor held as one contiguous piece per mesh
    device along its last dim (piece d on ``mesh.devices[d]``)."""

    def __init__(self, shards: Sequence[torch.Tensor], mesh: AggMesh):
        self.shards = tuple(shards)
        self.mesh = mesh

    @property
    def shape(self) -> Tuple[int, ...]:
        s = self.shards[0].shape
        return (*s[:-1], s[-1] * len(self.shards))

    def gather(self) -> torch.Tensor:
        """The whole tensor on the home device (JAX's ``all_gather``)."""
        home = self.mesh.home
        return torch.cat([s.to(home) for s in self.shards], dim=-1)

    def clone(self) -> "Sharded":
        return Sharded([s.clone() for s in self.shards], self.mesh)

    def zeros_like(self) -> "Sharded":
        return Sharded([torch.zeros_like(s) for s in self.shards],
                       self.mesh)

    def empty_like(self) -> "Sharded":
        return Sharded([torch.empty_like(s) for s in self.shards],
                       self.mesh)

    def to_mesh(self) -> "Sharded":
        """Each piece on its own device (a restore moves every tensor of
        a snapshot to the home device first)."""
        if all(s.device == d for s, d in zip(self.shards,
                                              self.mesh.devices)):
            return self
        return Sharded([s.to(d) for s, d in zip(self.shards,
                                                 self.mesh.devices)],
                       self.mesh)

    def __getitem__(self, row: int) -> "Sharded":
        """Row ``row`` of a sharded row buffer, as a sharded vector (views
        into the pieces)."""
        return Sharded([s[row] for s in self.shards], self.mesh)

    def _zip(self, other: "Sharded", op) -> "Sharded":
        if not (isinstance(other, Sharded) and other.mesh == self.mesh
                and len(other.shards) == len(self.shards)):
            raise ValueError("operands sharded over different meshes")
        return Sharded([op(a, b) for a, b in zip(self.shards, other.shards)],
                       self.mesh)

    # elementwise, piece by piece on each piece's device: the same bits
    # as the op on the whole tensors
    def __add__(self, other: "Sharded") -> "Sharded":
        return self._zip(other, torch.add)

    def __sub__(self, other: "Sharded") -> "Sharded":
        return self._zip(other, torch.sub)


def device_groups(mesh: AggMesh
                  ) -> List[Tuple[torch.device, List[int]]]:
    """The mesh's distinct devices in first-seen order, each with the
    indices of the pieces it holds: ``(cuda:0, cuda:1, cuda:0, cuda:1)``
    gives ``[(cuda:0, [0, 2]), (cuda:1, [1, 3])]``.  A sharded kernel
    wrapper makes one launch a group, so a mesh that repeats a device
    costs that device one launch, not one a piece."""
    groups: "OrderedDict[torch.device, List[int]]" = OrderedDict()
    for i, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(i)
    return list(groups.items())


def device_guard(device: torch.device):
    """The context a device's kernel launch runs in: the CUDA runtime
    launches on the thread's current device, so each device's launch makes
    that device current.  A no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Meshes and named shardings of the LM half
# ---------------------------------------------------------------------------

class Mesh:
    """JAX's ``Mesh``: an array of devices, one array axis per name.  The
    production meshes hold ``None`` in every place (``launch.mesh``): they
    name 256 or 512 devices that one host does not have."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(_sizes(self))

    def __repr__(self):
        return f"Mesh({dict(self.shape)})"


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a spec over a mesh's named axes."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """A leaf's per-device shape: each dim divided by the sizes of the
        axes it is sharded over, which must divide it."""
        sizes = _sizes(self.mesh)
        if len(self.spec) > len(global_shape):
            raise ValueError(f"spec {self.spec} longer than shape "
                             f"{tuple(global_shape)}")
        out = list(global_shape)
        for i, ax in enumerate(self.spec):
            if ax is None:
                continue
            n = math.prod(sizes[a] for a in
                          ((ax,) if isinstance(ax, str) else ax))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} is not "
                                 f"divisible by {n} ({ax!r} of {self.spec})")
            out[i] //= n
        return tuple(out)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _dp_total(mesh) -> int:
    s = _sizes(mesh)
    return math.prod(s[a] for a in dp_axes(mesh))


def named(mesh, spec: PartitionSpec) -> NamedSharding:
    return NamedSharding(mesh, spec)


def to_named_tree(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def pod_axis_is_vmapped():
    """The reference's marker for ``fl_local_step``'s stacked pod dim; it
    sets nothing here, since no constraint of the port reads it."""
    yield


def current_mesh_axes() -> dict:
    """Axis name -> size of the mesh active at trace time: always {} here,
    since one process has no trace-time mesh (JAX's outside jit or
    without a mesh context)."""
    return {}


def constrain_qkv(q, k, v):
    """The attention inputs' layout constraint: with no active mesh, the
    inputs unchanged, as JAX's."""
    return q, k, v


def constrain_act(x):
    """The residual stream's layout constraint: with no active mesh, the
    input unchanged, as JAX's."""
    return x


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _pspec(path_names, shape, mesh) -> PartitionSpec:
    s = _sizes(mesh)
    m, d = s.get("model", 1), s.get("data", 1)

    def tp(i):   # shard dim i over "model" when divisible
        return "model" if shape[i] % m == 0 else None

    def fs(i):   # shard dim i over "data" (FSDP) when divisible
        return "data" if shape[i] % d == 0 else None

    name = path_names[-1]
    parent = path_names[-2] if len(path_names) > 1 else ""
    r = len(shape)

    def pad(*trailing) -> PartitionSpec:
        return P(*([None] * (r - len(trailing)) + list(trailing)))

    if name == "embedding":
        return pad(tp(r - 2), fs(r - 1))
    if parent == "attn":
        if name in ("wq", "wk", "wv"):
            return pad(fs(r - 3), tp(r - 2), None)
        if name == "wo":
            return pad(tp(r - 3), None, fs(r - 1))
    if parent == "mlp":
        if name in ("wi_gate", "wi_up"):
            return pad(fs(r - 2), tp(r - 1))
        if name == "wo":
            return pad(tp(r - 2), fs(r - 1))
    if parent == "moe":
        if name == "router":
            return pad(fs(r - 2), None)
        ep = shape[r - 3] % m == 0          # experts divisible -> EP
        if name in ("wi_gate", "wi_up"):
            return pad("model", fs(r - 2), None) if ep else \
                pad(None, fs(r - 2), tp(r - 1))
        if name == "wo":
            return pad("model", None, fs(r - 1)) if ep else \
                pad(None, tp(r - 2), fs(r - 1))
    if parent == "tm":                       # rwkv6 time-mix
        if name in ("wr", "wk", "wv", "wg"):
            return pad(fs(r - 2), None)
        if name == "wo":
            return pad(None, fs(r - 1))
        if name == "decay_w1":
            return pad(fs(r - 2), None)
        if name == "decay_w2":
            return pad(None, fs(r - 1))
        if name == "mix_w1":
            return pad(fs(r - 3), None, None)
        if name == "mix_w2":
            return pad(None, None, fs(r - 1))
        return pad(*([None] * min(r, 2)))
    if parent == "cm":                       # rwkv6 channel-mix
        if name == "wk":
            return pad(fs(r - 2), tp(r - 1))
        if name == "wv":
            return pad(tp(r - 2), fs(r - 1))
        if name == "wr":
            return pad(fs(r - 2), None)
        return pad(None)
    # mamba2
    if name in ("wz", "wx", "wdt"):
        return pad(fs(r - 2), tp(r - 1))
    if name in ("wB", "wC"):
        return pad(fs(r - 2), None)
    if name == "conv_x_w":
        return pad(None, tp(r - 1))
    if name in ("conv_x_b", "norm_scale", "dt_bias", "a_log", "d_skip"):
        return pad(tp(r - 1))
    if name == "out_proj":
        return pad(tp(r - 2), fs(r - 1))
    return P(*([None] * r))


def param_specs(cfg, params_tree, mesh):
    """PartitionSpec tree matching a params tree (of tensors, abstract
    ones included)."""
    return tree_map_with_path(
        lambda path, leaf: _pspec(path, tuple(leaf.shape), mesh),
        params_tree)


# ---------------------------------------------------------------------------
# Batch
# ---------------------------------------------------------------------------

def batch_specs(cfg, batch_tree, mesh):
    dp = dp_axes(mesh)
    total = _dp_total(mesh)

    def f(path, leaf):
        lead = dp if leaf.shape[0] % total == 0 else None
        return P(lead, *([None] * (len(leaf.shape) - 1)))
    return tree_map_with_path(f, batch_tree)


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def state_specs(cfg, state_tree, mesh, batch: int):
    """KV caches: batch over dp when divisible, seq over ``model``; when the
    batch can't be sharded (long_500k B=1) the cache seq axis spreads over
    every mesh axis. SSM states: batch over dp, heads/channels over model."""
    s = _sizes(mesh)
    m = s.get("model", 1)
    dp = dp_axes(mesh)
    b_ok = batch % _dp_total(mesh) == 0
    all_axes = tuple(mesh.axis_names)
    n_all = math.prod(s[a] for a in all_axes)

    def f(path, leaf):
        name = path[-1]
        shp = tuple(leaf.shape)
        r = len(shp)

        def pad(*trailing):
            return P(*([None] * (r - len(trailing)) + list(trailing)))

        if name in ("k", "v"):               # (..., B, C, Kv, hd)
            if b_ok:
                seq_ax = "model" if shp[r - 3] % m == 0 else None
                return pad(dp, seq_ax, None, None)
            seq_ax = all_axes if shp[r - 3] % n_all == 0 else (
                "model" if shp[r - 3] % m == 0 else None)
            return pad(None, seq_ax, None, None)
        if name == "slot_pos":               # (..., C)
            if b_ok:
                return pad("model" if shp[r - 1] % m == 0 else None)
            return pad(all_axes if shp[r - 1] % n_all == 0 else None)
        if name == "wkv":                    # (..., B, H, K, K)
            return pad(dp if b_ok else None, None, None, None)
        if name == "shift":                  # (..., B, 1, D)
            return pad(dp if b_ok else None, None, None)
        if name == "ssm":                    # (..., B, nh, hd, n)
            nh_ax = "model" if shp[r - 3] % m == 0 else None
            return pad(dp if b_ok else None, nh_ax, None, None)
        if name in ("conv_x", "conv_bc"):    # (..., B, K-1, C)
            ch_ax = "model" if shp[r - 1] % m == 0 else None
            return pad(dp if b_ok else None, None, ch_ax)
        return P(*([None] * r))
    return tree_map_with_path(f, state_tree)
