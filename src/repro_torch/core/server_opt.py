"""Server-side optimizers over the flat-buffer merge substrate (port of
``repro/core/server_opt.py``).

The FedAvg-family merge (``flatbuf.FlatServerState``) ends every round
with the packed aggregate ``merged``.  Plain FedAvg installs it; a server
optimizer instead treats

    d = merged - prev        (prev = the packed server model pre-merge)

as a pseudo-gradient (Reddi et al., "Adaptive Federated Optimization")
and takes a real optimizer step from ``prev``, elementwise over the packed
buffers.  The step runs inside the merge's own kernel pass
(``kernels.fedavg_agg.merge_opt_flat``, fed by :meth:`ServerOpt.
merge_operands`), so ``merged`` never goes to memory; :meth:`ServerOpt.
step_vec` is the same step as a pass of its own
(``kernels.server_opt.server_opt_step_flat``), the oracle the tests hold
the fused merge against.  State lives as packed ``(N,)`` vectors over the
same :class:`~repro_torch.core.flatbuf.ParamBundle` and updates in place;
on a sharded flat state (``mesh=``) ``prev``, ``m`` and ``v`` are
``Sharded`` like the server mirror, and a merge is one ``merge_opt_flat``
launch a device over the pieces it holds.

================  =============================================  ==========================
name              update rule (d = merged - prev)                degenerate == plain FedAvg
================  =============================================  ==========================
``fedavgm``       m' = momentum*m + d; new = prev + lr*m'        momentum=0, lr=1
``fedadam``       m' = b1*m + (1-b1)*d; v' = b2*v + (1-b2)*d^2;  beta1=beta2=0, tau=inf
                  new = prev + lr * m' / (sqrt(v') + tau)        (the FedOpt tau->inf limit)
``feddyn``        h' = h + d; new = merged + gamma*h'            gamma=0
================  =============================================  ==========================

Degenerate parameters short-circuit and return the merge result
*verbatim*: ``prev + 1.0*(merged - prev)`` is not bit-equal to ``merged``
in f32, so the identity is structural, not numeric.

The ``prev`` anchor.  After a step the installed vector is kept as next
round's ``prev``, keyed on the weight dict the server will hand back.
That vector is also the flat state's packed server mirror, which an
alpha < 1 merge or a delta-accumulate overwrites in place; the flat state
then calls :meth:`ServerOpt.release` and the next step re-packs ``prev``
from the server's dict (bitwise the same for f32).  This is the port's
counterpart of JAX's donation check (``_prev_vec.is_deleted()``).  An
alpha < 1 merge whose model is all f32 hands its server buffer over as
``prev`` instead: the fused pass reads both before it writes.

``step_tree`` runs the same recursions per leaf on dicts of tensors: the
parity oracle for the fused pass.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import fedavg_agg
from repro_torch.kernels import server_opt as opt_kernel
from repro_torch.parallel import sharding as psh


class ServerOpt:
    """Base: packed-vector optimizer state bound lazily to the merge's
    ParamBundle at the first step."""

    name = "base"
    adam = False

    def __init__(self):
        self._m = None              # first-moment / drift vector (N,)
        self._v = None              # adam second moment (N,)
        self._prev_vec = None       # packed server model pre-merge
        self._prev_tree = None      # identity key for _prev_vec
        self._m_tree = None         # step_tree state
        self._v_tree = None

    # --- subclass hooks ---
    def _scalars(self) -> np.ndarray:
        raise NotImplementedError

    def _degenerate(self) -> bool:
        """True when the parameters collapse the step to the identity:
        the merge result is returned verbatim."""
        raise NotImplementedError

    def _kwargs(self) -> dict:
        raise NotImplementedError

    # --- flat path ---
    def _anchor(self, flat, server_tree, server=None) -> torch.Tensor:
        """``prev``, the packed pre-merge server model, with the moment
        vectors allocated.  ``server`` (or None) holds its bits already."""
        if self._prev_tree is not server_tree or self._prev_vec is None:
            # first step, external model replacement, or the cached anchor
            # was handed to an in-place merge (release)
            self._prev_vec = (flat.pack(server_tree) if server is None
                              else server)
        prev = self._prev_vec
        if self._m is None:
            self._m = _zeros_like(prev)
        if self.adam and self._v is None:
            self._v = _zeros_like(prev)
        return prev

    def merge_operands(self, flat, server_tree, server=None):
        """What a merge needs to take this step in its own kernel pass
        (``flatbuf.fused_merge_opt``): ``(prev, m, v, scalars)``, the
        moments to be updated in place; None when the parameters are
        degenerate (the merge result is installed verbatim).
        ``server_tree`` is the pre-merge server dict; ``server``, when not
        None, is a packed buffer with the bits ``pack(server_tree)`` gives
        (the one an in-place merge consumes), taken as ``prev`` instead of
        a re-pack."""
        if self._degenerate():
            return None
        return (self._anchor(flat, server_tree, server), self._m, self._v,
                self._scalars())

    def step_vec(self, flat, server_tree, merged: torch.Tensor
                 ) -> torch.Tensor:
        """The same step as a pass of its own over a packed merge result
        (the fused merge's oracle); ``server_tree`` is the pre-merge
        server dict (the anchor when ``prev`` must re-pack)."""
        if self._degenerate():
            return merged
        prev = self._anchor(flat, server_tree)
        if flat.mesh is not None:
            new, _, _ = fedavg_agg.server_opt_step_flat_sharded(
                prev, merged, self._m, self._v, self._scalars(),
                adam=self.adam, mesh=flat.mesh, m_out=self._m,
                v_out=self._v)
            return new
        new, _, _ = opt_kernel.server_opt_step_flat(
            prev, merged, self._m, self._v, self._scalars(), adam=self.adam,
            m_out=self._m, v_out=self._v)
        return new

    def note_result(self, merged_vec: torch.Tensor, out_tree) -> None:
        """Called after the unpack: the installed vector is next round's
        ``prev``, keyed on the dict the server will hand back."""
        self._prev_vec = merged_vec
        self._prev_tree = out_tree

    def release(self, vec: torch.Tensor) -> None:
        """``vec`` was handed to an in-place write: if it is the anchor,
        drop it so the next step re-packs ``prev``."""
        if vec is self._prev_vec:
            self._prev_vec = None

    # --- per-leaf path ---
    def step_tree(self, prev_tree, merged_tree):
        """The same recursions per leaf: the parity oracle for the fused
        pass."""
        if self._degenerate():
            return merged_tree
        sc = [float(s) for s in self._scalars()]
        f32 = torch.float32
        if self._m_tree is None:
            self._m_tree = {k: torch.zeros(p.shape, dtype=f32,
                                           device=p.device)
                            for k, p in prev_tree.items()}
        if self.adam and self._v_tree is None:
            self._v_tree = {k: torch.zeros_like(m)
                            for k, m in self._m_tree.items()}
        d = {k: merged_tree[k].to(f32) - p.to(f32)
             for k, p in prev_tree.items()}
        if self.adam:
            b1, b2, lr, tau = sc[:4]
            self._m_tree = {k: b1 * m + (1.0 - b1) * d[k]
                            for k, m in self._m_tree.items()}
            self._v_tree = {k: b2 * v + (1.0 - b2) * d[k] ** 2
                            for k, v in self._v_tree.items()}
            return {k: (p.to(f32) + lr * self._m_tree[k]
                        / (torch.sqrt(self._v_tree[k]) + tau)).to(p.dtype)
                    for k, p in prev_tree.items()}
        am, bm, cd, lr = sc[:4]
        self._m_tree = {k: am * m + bm * d[k]
                        for k, m in self._m_tree.items()}
        return {k: (p.to(f32) + cd * d[k] + lr * self._m_tree[k]).to(p.dtype)
                for k, p in prev_tree.items()}

    # --- lifecycle ---
    def rebase(self) -> None:
        """The server model was replaced under us: drop the packed anchor
        so the next step re-packs from the new dict.  The moment vectors
        survive: they are the role's state."""
        self._prev_vec = None
        self._prev_tree = None

    def capture(self) -> dict:
        """The optimizer's state as a plain dict of tensor copies (the
        vectors update in place, so an image must not alias them).  The
        ``prev`` anchor is not captured: it re-packs on restore."""
        return {"name": self.name, "kw": self._kwargs(),
                "m": _copy(self._m), "v": _copy(self._v),
                "m_tree": _copy(self._m_tree), "v_tree": _copy(self._v_tree)}

    def restore(self, img: dict) -> None:
        # copies again: the restored vectors update in place from here on
        # (a snapshot's restore placed sharded pieces on their devices)
        self._m, self._v = (_copy(img[k]) for k in ("m", "v"))
        self._m_tree, self._v_tree = _copy(img["m_tree"]), _copy(img["v_tree"])
        self.rebase()


def _zeros_like(x):
    return x.zeros_like() if isinstance(x, psh.Sharded) else \
        torch.zeros_like(x)


def _copy(x):
    """A copy of a state vector (whole or ``Sharded``), a dict of them,
    or None."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: t.clone() for k, t in x.items()}
    return x.clone()


class FedAvgM(ServerOpt):
    """Server momentum: ``m' = momentum*m + d; new = prev + lr*m'``."""

    name = "fedavgm"

    def __init__(self, momentum: float = 0.9, lr: float = 1.0):
        super().__init__()
        self.momentum = float(momentum)
        self.lr = float(lr)

    def _scalars(self):
        return np.asarray([self.momentum, 1.0, 0.0, self.lr], np.float32)

    def _degenerate(self):
        # momentum=0, lr=1: m' = d and new = prev + d == merged.  m' need
        # not be kept: with momentum 0 the next m' is d' whatever came
        # before, so the skipped state is unobservable.
        return self.momentum == 0.0 and self.lr == 1.0

    def _kwargs(self):
        return {"momentum": self.momentum, "lr": self.lr}


class FedAdam(ServerOpt):
    """Per-coordinate adaptive server step (FedOpt's FedAdam, no bias
    correction): ``new = prev + lr * m' / (sqrt(v') + tau)``."""

    name = "fedadam"
    adam = True

    def __init__(self, beta1: float = 0.9, beta2: float = 0.99,
                 lr: float = 0.1, tau: float = 1e-3):
        super().__init__()
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.lr = float(lr)
        self.tau = float(tau)

    def _scalars(self):
        return np.asarray([self.beta1, self.beta2, self.lr, self.tau,
                           0.0, 0.0], np.float32)

    def _degenerate(self):
        return (self.beta1 == 0.0 and self.beta2 == 0.0
                and math.isinf(self.tau))

    def _kwargs(self):
        return {"beta1": self.beta1, "beta2": self.beta2, "lr": self.lr,
                "tau": self.tau}


class FedDyn(ServerOpt):
    """FedDyn-style server drift correction: ``h`` accumulates the average
    client drift and the install overshoots the aggregate by ``gamma*h``
    (the momentum form with am = bm = cd = 1, lr = gamma)."""

    name = "feddyn"

    def __init__(self, gamma: float = 0.1):
        super().__init__()
        self.gamma = float(gamma)

    def _scalars(self):
        return np.asarray([1.0, 1.0, 1.0, self.gamma], np.float32)

    def _degenerate(self):
        return self.gamma == 0.0

    def _kwargs(self):
        return {"gamma": self.gamma}


SERVER_OPTS = {
    "fedavgm": FedAvgM,
    "fedadam": FedAdam,
    "feddyn": FedDyn,
}


def make_server_opt(spec, **kw) -> Optional[ServerOpt]:
    """Resolve ``server_opt=``: None passes through (plain FedAvg), a
    string looks up :data:`SERVER_OPTS`, an instance is used as it is."""
    if spec is None:
        return None
    if isinstance(spec, ServerOpt):
        if kw:
            raise ValueError("server_opt_kw needs a string server_opt")
        return spec
    cls = SERVER_OPTS.get(spec)
    if cls is None:
        raise ValueError(f"unknown server_opt {spec!r}; "
                         f"have {sorted(SERVER_OPTS)}")
    return cls(**kw)
