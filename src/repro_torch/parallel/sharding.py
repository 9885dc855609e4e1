"""The aggregation server's mesh (port of the ``agg`` half of
``repro/parallel/sharding.py``; the LM half waits for ROADMAP A8).

One process drives every device, as JAX does.  A mesh is a tuple of
``torch.device``\\ s over the one axis ``AGG_AXIS``; device 0 is the *home*
device, where whole vectors (the model, every link's vectors) live.  The
packed flat parameter axis N of the server model and of the ``(W, N)``
update-row buffer shards over it: a sharded vector is D contiguous
``(N/D,)`` pieces and a sharded row buffer D contiguous ``(W, N/D)``
pieces (``Sharded``), piece d on device d.  Every worker's lane of a
parameter sits on one device, so the merge's W-reduce is shard-local.

Device counts.  ``agg_mesh(n)`` takes the first n CUDA devices.  On the
CPU the count comes from ``REPRO_HOST_DEVICES`` (default 1), the variable
through which the tests ask XLA for a forced host platform, and the mesh
repeats the one CPU device.  ``agg_mesh(devices=...)`` takes an explicit
sequence that may repeat a device: the counterpart of that forced host
platform on one card.

JAX's ``NamedSharding`` objects (``agg_vec_sharding``,
``agg_row_sharding``) have no twin: both specs split the last dim, so a
placement is ``split(t, mesh)``; ``agg_vec_spec``/``agg_row_spec`` keep
the names of the two layouts.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device

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
    """JAX's ``PartitionSpec``: one mesh axis name (or None) per dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


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


def device_guard(device: torch.device):
    """The context a per-shard kernel launch runs in: the CUDA runtime
    launches on the thread's current device, so each shard's launch makes
    its own device current.  A no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
