"""Production mesh construction (port of ``repro/launch/mesh.py``).

A function, not a module-level constant, so importing this module
touches no device.  Single pod: 16 x 16 = 256 devices over ``data`` x
``model``; multi-pod: 2 pods x 256 = 512 devices with a leading ``pod``
axis, the data-parallel axis of the sync baseline and the federated
worker axis of the paper's technique.

The production meshes are abstract: they hold no device (one host has no
256 H100s) and answer what the sharding rules read, ``axis_names`` and
``devices.shape``.  ``make_host_mesh`` is the mesh of the cards present.
"""
from __future__ import annotations

import numpy as np

from repro_torch import resolve_device
from repro_torch.parallel.sharding import Mesh, _available


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, None, dtype=object), axes)


def make_host_mesh(device=None) -> Mesh:
    """(1, n) over ``data`` x ``model``: the n CUDA cards of this host, or
    with ``device="cpu"`` the CPU (``REPRO_HOST_DEVICES`` repeats of it,
    as ``agg_mesh`` counts them).  Raises with no card and no device."""
    devs = _available(resolve_device(device).type)
    grid = np.empty((1, len(devs)), dtype=object)
    grid[0, :] = devs
    return Mesh(grid, ("data", "model"))
