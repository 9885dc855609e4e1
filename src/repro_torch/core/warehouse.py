"""Data-warehouse sub-module (thesis §3.2.1) + Pointer abstraction.

The warehouse stores machine-learning classes, model weights (own and other
participants'), and training data behind getter/setter functions keyed by
unique IDs; storage *types* (RAM / local disk / remote) are pluggable. Model
weights travel out-of-band (the thesis uses an FTP server with one-time
credentials so the control channel never blocks on weight transfer): here
``issue_ticket``/``redeem_ticket`` reproduce the one-time-credential flow,
and the disk storage type writes content-addressed files with atomic rename.

A :class:`Pointer` is (site network address, unique ID) — everything needed
to name a model on a remote site (thesis §2.3.1 / Pysyft pointer idea).
"""
from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import secrets
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class Pointer:
    address: str      # network address of the owning site
    uid: str          # unique ID within that site's warehouse

    def __str__(self):
        return f"{self.address}/{self.uid}"


class StorageType:
    def put(self, uid: str, value: Any) -> None:
        raise NotImplementedError

    def get(self, uid: str) -> Any:
        raise NotImplementedError

    def delete(self, uid: str) -> None:
        raise NotImplementedError


class RamStorage(StorageType):
    def __init__(self):
        self._d: Dict[str, Any] = {}

    def put(self, uid, value):
        self._d[uid] = value

    def get(self, uid):
        return self._d[uid]

    def delete(self, uid):
        self._d.pop(uid, None)


class DiskStorage(StorageType):
    """Content-addressed pickles with atomic rename (crash-safe puts)."""

    def __init__(self, root: Optional[str] = None):
        self.root = Path(root or tempfile.mkdtemp(prefix="warehouse_"))
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, uid: str) -> Path:
        return self.root / f"{uid}.pkl"

    def put(self, uid, value):
        data = pickle.dumps(value)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, self._path(uid))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, uid):
        with open(self._path(uid), "rb") as f:
            return pickle.load(f)

    def delete(self, uid):
        p = self._path(uid)
        if p.exists():
            p.unlink()


class DataWarehouse:
    """Getter/setter over pluggable storage types; returns a fresh unique ID
    on first save (thesis §3.2.1)."""

    def __init__(self, default: str = "ram"):
        self.storages: Dict[str, StorageType] = {"ram": RamStorage()}
        self.default = default
        self._meta: Dict[str, str] = {}       # uid -> storage type
        self._ctr = itertools.count()
        self._tickets: Dict[str, str] = {}    # one-time credential -> uid

    def add_storage(self, name: str, storage: StorageType) -> None:
        self.storages[name] = storage

    def put(self, value: Any, uid: Optional[str] = None,
            storage: Optional[str] = None) -> str:
        storage = storage or self.default
        if storage not in self.storages and storage == "disk":
            self.storages["disk"] = DiskStorage()
        if uid is None:
            uid = f"obj{next(self._ctr)}"
        self.storages[storage].put(uid, value)
        self._meta[uid] = storage
        return uid

    def get(self, uid: str) -> Any:
        return self.storages[self._meta[uid]].get(uid)

    def delete(self, uid: str) -> None:
        st = self._meta.pop(uid, None)
        if st:
            self.storages[st].delete(uid)

    def __contains__(self, uid: str) -> bool:
        return uid in self._meta

    # --- one-time credentials for out-of-band weight transfer (§3.3.2) ---
    def issue_ticket(self, uid: str) -> str:
        assert uid in self._meta, uid
        cred = secrets.token_hex(8)
        self._tickets[cred] = uid
        return cred

    def redeem_ticket(self, cred: str) -> Any:
        """Redeem a one-time credential: returns the value and *deletes* the
        stored object — a ticketed transfer is a hand-off, and keeping the
        source copy alive after redemption leaks a model-sized buffer per
        response. A second redeem of the same credential raises KeyError."""
        uid = self._tickets.pop(cred)    # one-time: second redeem raises
        value = self.get(uid)
        self.delete(uid)
        return value

    def has_ticket(self, cred: str) -> bool:
        return cred in self._tickets

    def revoke_ticket(self, cred: str) -> None:
        """Drop an unredeemed credential and delete its stored object (the
        transfer will never happen — e.g. the sender died mid-transmit)."""
        uid = self._tickets.pop(cred, None)
        if uid is not None and uid in self:
            self.delete(uid)

    def drop_tickets(self) -> None:
        """Revoke every outstanding credential (round closed: responses that
        were never redeemed are dead weight)."""
        for cred in list(self._tickets):
            self.revoke_ticket(cred)
