"""Synthetic image-classification data standing in for MNIST/CIFAR-10.

The container is offline, so we generate a deterministic dataset with the
property the thesis requires of its model/data pairing (§4.2.4): any single
worker's shard is insufficient to reach the target accuracy, while the union
of all shards is sufficient. Classes are smooth random templates; samples
add per-sample noise and small translations.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _smooth(img: np.ndarray, passes: int = 2) -> np.ndarray:
    for _ in range(passes):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def make_classification_dataset(n: int, *, hw: int = 28, channels: int = 1,
                                n_classes: int = 10, noise: float = 0.35,
                                max_shift: int = 1,
                                seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n,hw,hw,c) float32, y (n,) int32)."""
    rng = np.random.RandomState(seed)
    templates = _smooth(rng.randn(n_classes, hw, hw, channels)
                        .astype(np.float32).reshape(n_classes * channels, hw, hw)
                        ).reshape(n_classes, hw, hw, channels) \
        if channels == 1 else None
    if templates is None:
        t = rng.randn(n_classes, hw, hw, channels).astype(np.float32)
        for i in range(n_classes):
            for c in range(channels):
                t[i, :, :, c] = _smooth(t[i, :, :, c])
        templates = t
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = templates[y]
    # small random translations (keeps the task non-trivial)
    sx = rng.randint(-max_shift, max_shift + 1, size=n)
    sy = rng.randint(-max_shift, max_shift + 1, size=n)
    for i in range(n):
        x[i] = np.roll(np.roll(x[i], sx[i], 0), sy[i], 1)
    x = x + noise * rng.randn(*x.shape).astype(np.float32)
    x = (x - x.min()) / max(x.max() - x.min(), 1e-6)
    return x.astype(np.float32), y


def federated_split(x: np.ndarray, y: np.ndarray,
                    batches_per_worker: Sequence[int], batch_size: int = 64,
                    seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Distribute data as 'batches of data each worker is allocated'
    (thesis tables 4.1/4.2 — even and uneven setups; a zero entry gives that
    worker no data, exactly like W2/W3 in setup 3)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(x))
    shards = []
    ptr = 0
    for nb in batches_per_worker:
        take = nb * batch_size
        idx = order[ptr:ptr + take]
        ptr += take
        shards.append({"x": x[idx], "y": y[idx]})
    return shards


def _largest_remainder(frac: np.ndarray, total: int) -> np.ndarray:
    """Integer targets summing EXACTLY to ``total`` from a fractional
    allocation (floor everything, hand the remainder to the largest
    fractional parts) — the no-drop/no-dup backbone of every partitioner."""
    frac = np.maximum(frac, 0.0)
    s = frac.sum()
    share = frac / s * total if s > 0 else np.full_like(frac, total / len(frac))
    base = np.floor(share).astype(np.int64)
    rem = total - int(base.sum())
    if rem > 0:
        order = np.argsort(-(share - base), kind="stable")
        base[order[:rem]] += 1
    return base


def dirichlet_split(x: np.ndarray, y: np.ndarray,
                    batches_per_worker: Sequence[int], batch_size: int = 64,
                    alpha: float = 0.5,
                    seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Dirichlet label-skew partition (Hsu et al.): worker ``i`` draws a
    class mixture ``p_i ~ Dir(alpha * 1)`` and fills its allocation
    (``batches_per_worker[i] * batch_size`` samples, same contract as
    :func:`federated_split`) according to it.  alpha → ∞ recovers the IID
    mixture; alpha → 0 concentrates each worker on ~1 class.

    Deterministic in ``seed``; conserves samples exactly within the
    allocated total (no sample appears twice, none is dropped while any
    class pool can still supply its target); composes with the thesis'
    uneven ``batches_per_worker`` tables (a zero entry gives that worker
    no data)."""
    rng = np.random.RandomState(seed)
    classes = np.unique(y)
    # per-class index pools, shuffled once — draws pop from the tail
    pools = {int(c): rng.permutation(np.flatnonzero(y == c)).tolist()
             for c in classes}
    shards = []
    for nb in batches_per_worker:
        want = nb * batch_size
        if want == 0:
            shards.append({"x": x[:0], "y": y[:0]})
            continue
        p = rng.dirichlet(np.full(len(classes), alpha))
        target = _largest_remainder(p, want)
        idx: List[int] = []
        for c, t in zip(classes, target):
            pool = pools[int(c)]
            take = min(int(t), len(pool))
            if take:
                idx.extend(pool[-take:])
                del pool[-take:]
        short = want - len(idx)
        while short > 0:
            # the drawn mixture asked for more of some class than remains:
            # steal the shortfall from the best-stocked pools (keeps the
            # conservation property exact without re-drawing the mixture)
            c_rich = max(pools, key=lambda c: len(pools[c]))
            pool = pools[c_rich]
            if not pool:
                break                      # dataset exhausted entirely
            take = min(short, len(pool))
            idx.extend(pool[-take:])
            del pool[-take:]
            short -= take
        order = rng.permutation(len(idx))
        sel = np.asarray(idx, dtype=np.int64)[order]
        shards.append({"x": x[sel], "y": y[sel]})
    return shards


def quantity_skew_split(x: np.ndarray, y: np.ndarray,
                        batches_per_worker: Sequence[int],
                        batch_size: int = 64, alpha: float = 0.5,
                        seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Per-worker quantity skew: keep labels IID (a global shuffle, like
    :func:`federated_split`) but re-apportion the TOTAL allocated sample
    budget across workers by ``q ~ Dir(alpha * 1_W)`` — small alpha gives
    a few data-rich workers and many data-poor ones.  Workers whose table
    entry is zero stay at zero (the thesis' empty-worker setups survive
    the skew); batch totals are conserved exactly via largest-remainder
    rounding on whole batches."""
    rng = np.random.RandomState(seed)
    nbs = np.asarray(list(batches_per_worker), dtype=np.int64)
    total_batches = int(nbs.sum())
    active = np.flatnonzero(nbs > 0)
    new_nbs = np.zeros_like(nbs)
    if len(active) and total_batches:
        q = rng.dirichlet(np.full(len(active), alpha))
        new_nbs[active] = _largest_remainder(q, total_batches)
    return federated_split(x, y, new_nbs.tolist(), batch_size=batch_size,
                           seed=seed)


# run_fl(partition=)/make_setup(partition=) dispatch table; every entry
# shares federated_split's (x, y, batches_per_worker, batch_size, seed)
# contract plus partitioner-specific kwargs (e.g. alpha).
PARTITIONERS = {
    "iid": federated_split,
    "dirichlet": dirichlet_split,
    "quantity": quantity_skew_split,
}


def partition_split(x: np.ndarray, y: np.ndarray,
                    batches_per_worker: Sequence[int], *,
                    partition: str = "iid", batch_size: int = 64,
                    seed: int = 0, **kw) -> List[Dict[str, np.ndarray]]:
    """Name-dispatched federated partition (see :data:`PARTITIONERS`)."""
    fn = PARTITIONERS.get(partition)
    if fn is None:
        raise ValueError(f"unknown partition {partition!r}; "
                         f"have {sorted(PARTITIONERS)}")
    return fn(x, y, batches_per_worker, batch_size=batch_size, seed=seed,
              **kw)
