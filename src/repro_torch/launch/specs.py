"""Abstract input construction for every (arch x shape) dry-run cell (port
of ``repro/launch/specs.py``).

``input_specs`` returns ``Abstract`` leaves, the counterpart of JAX's
``jax.ShapeDtypeStruct`` with a sharding: a meta tensor (shape and dtype,
no storage) and its ``NamedSharding``.  The parameters, optimizer state
and decode state are built by the port's own ``init_params``,
``optimizer.init`` and ``init_decode_state`` under ``FakeTensorMode``,
which records every draw's shape and allocates nothing (JAX's
``jax.eval_shape``), so the full configs (deepseek-67b: 6.66e10
parameters) build in well under a second each.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import optim
from repro_torch.configs import SHAPES, get_config
from repro_torch.models import init_decode_state, init_params
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.parallel import (batch_specs, param_specs, state_specs,
                                  to_named_tree)
from repro_torch.parallel.sharding import NamedSharding, P
from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True, eq=False)
class Abstract:
    """A leaf with no storage (a meta tensor) and its named sharding."""
    tensor: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    def shard_shape(self):
        return self.sharding.shard_shape(self.shape)

    def device_nbytes(self) -> int:
        """Bytes of this leaf on each device of the mesh."""
        return math.prod(self.shard_shape()) * self.tensor.element_size()


def per_device_bytes(tree) -> int:
    """Bytes on each device of a tree of ``Abstract`` leaves."""
    return sum(a.device_nbytes() for a in leaves(tree))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _fake(fn):
    """``fn()``'s tree built under ``FakeTensorMode`` (no storage, no
    draws), its leaves as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn()
    return tree_map(lambda t: _meta(t.shape, t.dtype), tree)


def _param_shapes(cfg):
    return _fake(lambda: init_params(torch.Generator(), cfg, device="cpu"))


def _sds(tree, shardings):
    return tree_map(Abstract, tree, shardings)


def abstract_params(cfg, mesh):
    shapes = _param_shapes(cfg)
    specs = param_specs(cfg, shapes, mesh)
    return _sds(shapes, to_named_tree(mesh, specs))


def abstract_opt_state(cfg, mesh, optimizer):
    oshapes = optimizer.init(_param_shapes(cfg))   # meta in, meta out
    # mirror param specs for master/m/v; scalars replicated
    full = {k: param_specs(cfg, v, mesh) if k in ("master", "m", "v", "mom")
            else tree_map(lambda l: P(), v) for k, v in oshapes.items()}
    return _sds(oshapes, to_named_tree(mesh, full))


def abstract_batch(cfg, mesh, shape_name):
    info = SHAPES[shape_name]
    return batch_at(cfg, mesh, info["kind"], info["global_batch"],
                    info["seq_len"])


def batch_at(cfg, mesh, kind, B, S):
    """``abstract_batch`` for a ``kind`` cell at ``B`` sequences of ``S``
    tokens (the dry run's cells cut from ``SHAPES``)."""
    S_in = 1 if kind == "decode" else S
    batch = {}
    if cfg.embeds_input:
        batch["embeds"] = _meta((B, S_in, cfg.d_model), COMPUTE_DTYPE)
    else:
        batch["tokens"] = _meta((B, S_in), torch.int32)
    if kind == "train":
        batch["labels"] = _meta((B, S_in), torch.int32)
    specs = batch_specs(cfg, batch, mesh)
    return _sds(batch, to_named_tree(mesh, specs))


def abstract_decode_state(cfg, mesh, shape_name):
    info = SHAPES[shape_name]
    return decode_state_at(cfg, mesh, info["global_batch"], info["seq_len"])


def decode_state_at(cfg, mesh, B, S):
    """``abstract_decode_state`` at ``B`` sequences of context ``S``."""
    shapes = _fake(lambda: init_decode_state(cfg, B, S, device="cpu"))
    specs = state_specs(cfg, shapes, mesh, B)
    return _sds(shapes, to_named_tree(mesh, specs))


def input_specs(arch: str, shape_name: str, mesh, optimizer=None):
    """Full abstract input tree for the given cell. Returns (kind, inputs)."""
    cfg = get_config(arch)
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        optimizer = optimizer or optim.adamw()
        return kind, {
            "params": abstract_params(cfg, mesh),
            "opt_state": abstract_opt_state(cfg, mesh, optimizer),
            "batch": abstract_batch(cfg, mesh, shape_name),
        }
    if kind == "prefill":
        return kind, {
            "params": abstract_params(cfg, mesh),
            "batch": abstract_batch(cfg, mesh, shape_name),
        }
    if kind == "decode":
        return kind, {
            "params": abstract_params(cfg, mesh),
            "state": abstract_decode_state(cfg, mesh, shape_name),
            "batch": abstract_batch(cfg, mesh, shape_name),
            "cur_pos": Abstract(_meta((), torch.int32),
                                NamedSharding(mesh, P())),
        }
    raise ValueError(kind)
