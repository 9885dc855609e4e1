"""Aggregation algorithms (thesis §2.1.3, eqs 2.1-2.7; port of
``repro/core/aggregation.py``).

All operate on model-weight dicts.  ``staleness`` of a response is
``i - xi``: current server version minus the server version the worker
fetched before training.  Weighted means pack the updates once into a
``(W, N)`` buffer and merge them in one ``fedavg_agg_flat`` pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from . import flatbuf


@dataclass(frozen=True)
class WorkerUpdate:
    weights: object          # weight dict, packed vector (or
                             # flatbuf.EncodedVec) or window row
    staleness: int = 0       # i - xi
    n_data: int = 1          # batches of training data the worker used


def weighted_mean(trees: Sequence, weights: Sequence[float]):
    """Pack once, one fused weighted sum, unpack."""
    w = flatbuf.normalized_weights(weights)
    bundle = flatbuf.bundle_for(trees[0])
    rows = bundle.pack_many(trees)
    return bundle.unpack(flatbuf.fused_weighted_sum(rows, w))


# --- eq 2.1 / 2.2: federated averaging (sync + async are the same formula;
# async simply admits updates with staleness > 0) -------------------------

def fedavg(updates: List[WorkerUpdate]):
    return weighted_mean([u.weights for u in updates], [1.0] * len(updates))


# --- eqs 2.3-2.7: weighted federated averaging ----------------------------

def linear_weight(staleness: int) -> float:          # eq 2.5
    return 1.0 / (staleness + 1.0)


def polynomial_weight(staleness: int, a: float = 0.5) -> float:   # eq 2.6
    return float((staleness + 1.0) ** (-a))


def exponential_weight(staleness: int, a: float = 0.5) -> float:  # eq 2.7
    return float(np.exp(-a * staleness))


def weighted_fedavg(updates: List[WorkerUpdate],
                    weight_fn: Callable[[int], float] = linear_weight,
                    data_weighted: bool = True):
    """Eqs 2.3/2.4 with WEI_x from a staleness weight function, optionally
    multiplied by each worker's data size."""
    ws = [weight_fn(u.staleness) * (u.n_data if data_weighted else 1.0)
          for u in updates]
    return weighted_mean([u.weights for u in updates], ws)


AGGREGATORS = {
    "fedavg": fedavg,
    "linear": lambda ups: weighted_fedavg(ups, linear_weight),
    "polynomial": lambda ups: weighted_fedavg(ups, polynomial_weight),
    "exponential": lambda ups: weighted_fedavg(ups, exponential_weight),
}

# per-update scalar weights of each named aggregator: the server fuses the
# weighted sum and the alpha-mix into ONE kernel pass over packed buffers
UPDATE_WEIGHT_FNS = {
    "fedavg": lambda u: 1.0,
    "linear": lambda u: linear_weight(u.staleness) * u.n_data,
    "polynomial": lambda u: polynomial_weight(u.staleness) * u.n_data,
    "exponential": lambda u: exponential_weight(u.staleness) * u.n_data,
}


def use_flat_vec(flat, transport, aggregator: str) -> bool:
    """True when decoded payloads can land straight in the flat (W, N)
    row buffer: the merge state exists, the transport resolves to the
    SAME (mesh-aware) bundle (else decoded vectors would not match the
    row buffer's padded width), and the aggregator has a scalar-weight
    form."""
    return (flat is not None and transport.flat_capable
            and transport.bundle is flat.bundle
            and aggregator in UPDATE_WEIGHT_FNS)


def update_weights(aggregator: str, updates: List[WorkerUpdate]):
    """Scalar merge weight per update, or None if ``aggregator`` has no
    scalar-weight form."""
    fn = UPDATE_WEIGHT_FNS.get(aggregator)
    if fn is None:
        return None
    return [fn(u) for u in updates]


def mix_into(server_weights, aggregate, alpha: float = 1.0):
    """Server-side mixing: M_{i+1} = (1-alpha)*M_i + alpha*aggregate.
    alpha=1 is the thesis' replace-on-aggregate."""
    if alpha >= 1.0:
        return aggregate
    return {k: ((1 - alpha) * s.to(torch.float32)
                + alpha * aggregate[k].to(torch.float32)).to(s.dtype)
            for k, s in server_weights.items()}
