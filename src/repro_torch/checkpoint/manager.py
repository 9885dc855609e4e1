"""Checkpoint/restart on top of atomic disk storage (port of
``repro/checkpoint/manager.py``).

Fault-tolerance contract: a step-``k`` checkpoint is visible iff it was
written completely (atomic rename); ``restore_latest`` after any crash
resumes from the newest complete step; ``keep`` bounds disk usage
(counting only *readable* snapshots: a corrupt newest file must never
evict the checkpoints a restore actually needs).  Stale ``*.tmp``
staging files from saves that crashed between ``mkstemp`` and the
atomic publish are swept on construction and before every save.

Snapshot contract (:class:`repro_torch.checkpoint.snapshot.FederationSnapshot`)
-------------------------------------------------------------------------------
A federation snapshot **captures**: server flat buffers and row-window
occupancy, per-link transport state (``tx_base``/``acked_base``, uplink
and downlink EF residuals with their revert chains, lossy-channel
RNG/sequence/delivered-set, per-link autotuner state), the shared
``WorkerAckRegistry``, estimator measurements, population lanes,
selection/budget state, warehouse contents and ticket tables, history
counters, the server optimizer's moments, and the event-loop clock plus
every pending timer as ``(time, seq)`` records.

It **re-derives** (never serializes): packed server mirrors and
per-round pack caches (``_server_flat``/``_down_vec``: bitwise-same
repacks of the restored weights), the server optimizer's ``prev``
anchor, population views, tuner bandwidth closures, and link objects
themselves.

Every tensor of a snapshot is a host copy, taken once per live tensor at
capture (so two references stay one object) and moved once to the
restoring federation's device: a snapshot file needs no card to read.

In-flight payloads on *lossy* links are **cancelled-with-credit at
snapshot** rather than serialized: their pending retransmit timers are
closures over live channel state that cannot be carried across a
process boundary, so the capture credits the encode's EF mass back,
unlinks the downlink revert chain, revokes the ticket (all on captured
images, never the live run) and records a re-dispatch instead.  The
audit ledger stays closed because both sides of its inequalities only
grow.  Reliable legs are serialized verbatim and resume bit-identically
(deadlines are replayed as exact absolute floats).

Snapshots must be saved with ``raw=True``: the default host-copy
normalisation maps tensor leaves of dicts, lists and tuples only, and
would not reach the tensors inside the snapshot's objects.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import warnings
from pathlib import Path
from typing import Any, Optional, Tuple

import torch

from .snapshot import FederationSnapshot  # noqa: F401  (re-export)


def _host_leaves(state: Any) -> Any:
    """``state`` with every tensor leaf of its dicts, lists and tuples
    replaced by a host copy (the counterpart of JAX's
    ``tree.map(np.asarray, state)``)."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _host_leaves(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_host_leaves(v) for v in state)
    return state


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._sweep_tmp()

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:012d}.pkl"

    def _sweep_tmp(self):
        """Remove staging files orphaned by a crash between ``mkstemp``
        and the atomic publish: they are invisible to restore (never
        renamed in) but would otherwise accumulate forever."""
        for tmp in self.dir.glob("*.tmp"):
            try:
                tmp.unlink()
            except OSError:
                pass

    def save(self, step: int, state: Any, metadata: Optional[dict] = None,
             *, raw: bool = False):
        """Atomically publish a step-``step`` checkpoint.  ``raw=True``
        pickles ``state`` as it is (required for ``FederationSnapshot``,
        whose tensors are host copies already); the default copies tensor
        leaves to the host first."""
        self._sweep_tmp()
        payload = {
            "step": step,
            "state": state if raw else _host_leaves(state),
            "metadata": metadata or {},
            "wall_time": time.time(),
        }
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                # streamed into the file: no second copy of the state
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))    # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._gc()

    def _readable(self, path: Path) -> bool:
        try:
            with open(path, "rb") as f:
                pickle.load(f)
            return True
        except Exception:
            return False

    def _gc(self):
        """Retain the newest ``keep`` *readable* checkpoints: walk newest
        to oldest counting readable snapshots and delete everything
        strictly older than the ``keep``-th; an unreadable (corrupt,
        truncated) file never counts toward the quota, so it can never
        evict the checkpoints a restore would actually use.
        ``keep <= 0`` disables retention entirely (keep everything)."""
        if self.keep <= 0:
            return
        ckpts = sorted(self.dir.glob("ckpt_*.pkl"))
        readable = 0
        for i in range(len(ckpts) - 1, -1, -1):
            if self._readable(ckpts[i]):
                readable += 1
                if readable >= self.keep:
                    for old in ckpts[:i]:
                        old.unlink()
                    return

    def steps(self):
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("ckpt_*.pkl"))

    def restore(self, step: int) -> Tuple[int, Any, dict]:
        with open(self._path(step), "rb") as f:
            payload = pickle.load(f)
        return payload["step"], payload["state"], payload["metadata"]

    def restore_latest(self) -> Optional[Tuple[int, Any, dict]]:
        """Resume from the newest *readable* step: a corrupt or truncated
        snapshot (a crash on a filesystem without atomic rename, a partial
        copy) is skipped with a warning instead of aborting the restore:
        the contract is "newest COMPLETE step", not "newest file"."""
        for step in reversed(self.steps()):
            try:
                return self.restore(step)
            except Exception as e:
                warnings.warn(f"skipping unreadable checkpoint step {step} "
                              f"({self._path(step).name}): {e!r}")
        return None
