"""Update compression for pod-level weight exchange (port of
``repro/core/compression.py``): top-k sparsification with error feedback
and int8 linear quantisation (per-tensor scale), applied to deltas.

``ErrorFeedbackCompressor`` packs the delta tree once into a contiguous
f32 vector (padded to ``flatbuf.BLOCK``, as the JAX package's bundle is)
and runs the codec's fused global top-k(+int8) encode over it
(``transport.ef_topk_encode``, i.e. ``kernels.topk_quant.ef_encode``: the
CUDA kernel on a card, its plain version on the CPU).  The per-leaf
reference path (leaf-local thresholds and scales) is kept:
``REPRO_AGG_PATH=tree`` forces it.

Trees are a tensor or (nested) dicts of tensors.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.tree import leaves, unflatten

from . import flatbuf


def topk_compress(x: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the largest-|.| ``frac`` of entries (ties at the k-th value
    kept).  Returns (values, mask), both in x's dtype."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = (x.abs() >= thresh).to(x.dtype)
    return x * mask, mask


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-d): ``scale = max(max|x|, 1e-12) / 127`` (as
    XLA computes it, the product with fl32(1/127)), ``q = clip(round(x /
    scale), -127, 127)``."""
    scale = ref.reference_int8_scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _leaves(tree):
    """(leaves in ``jax.tree.leaves`` order, rebuild(leaves) -> tree)."""
    ls = list(leaves(tree))
    if not ls or not all(isinstance(l, torch.Tensor) for l in ls):
        raise TypeError("expected a tensor or a non-empty dict of tensors")
    return ls, lambda values: unflatten(tree, values)


class _Flat:
    """Packs one tree structure into a flat f32 vector padded to
    ``flatbuf.BLOCK`` (a single f32 leaf of a padded size is viewed, not
    copied) and unpacks it."""

    def __init__(self, tree):
        ls, self.rebuild = _leaves(tree)
        self.shapes = [tuple(l.shape) for l in ls]
        self.dtypes = [l.dtype for l in ls]
        self.sizes = [l.numel() for l in ls]
        self.n_params = sum(self.sizes)
        self.n = flatbuf.padded_size_for(self.n_params)

    def pack(self, tree) -> torch.Tensor:
        ls, _ = _leaves(tree)
        if (len(ls) == 1 and self.n == self.n_params
                and ls[0].dtype == torch.float32 and ls[0].is_contiguous()):
            return ls[0].reshape(-1)
        vec = torch.zeros(self.n, dtype=torch.float32, device=ls[0].device)
        off = 0
        for l in ls:
            vec[off:off + l.numel()].copy_(l.reshape(-1))
            off += l.numel()
        return vec

    def unpack(self, vec: torch.Tensor):
        out, off = [], 0
        for shape, dt, n in zip(self.shapes, self.dtypes, self.sizes):
            out.append(vec[off:off + n].reshape(shape).to(dt))
            off += n
        return self.rebuild(out)


class ErrorFeedbackCompressor:
    """EF-topk(+int8) over trees of deltas.

    State is ONE flat residual vector (global top-k over the packed
    buffer); ``.residual`` exposes it as a tree.  The per-leaf reference
    path keeps a tree residual instead."""

    def __init__(self, frac: float = 0.1, quantize: bool = True,
                 residual: Optional[object] = None):
        self.frac = frac
        self.quantize = quantize
        self._res_tree = residual      # per-leaf reference path state
        self._res_vec = None           # flat path state
        self._bundle = None

    @property
    def residual(self):
        if self._res_vec is not None:
            return self._bundle.unpack(self._res_vec)
        return self._res_tree

    @residual.setter
    def residual(self, tree):
        self._res_tree = tree
        self._res_vec = None     # the flat path re-seeds from the tree

    def compress(self, delta_tree):
        """Returns (reconstructed tree, bytes on the wire); the residual
        updates.  The flat path packs once and runs one fused global
        top-k(+int8) encode of ``delta + residual``; wire bytes follow the
        transport codec table (bitmap, one scale if quantising, ``kept``
        values)."""
        if os.environ.get("REPRO_AGG_PATH") == "tree":
            return self._compress_tree(delta_tree)
        from . import transport   # deferred: transport imports the kernels
        bundle = _Flat(delta_tree)
        self._bundle = bundle
        vec = bundle.pack(delta_tree)
        if self._res_vec is None:
            # seed from a caller-given / tree-path residual if present
            self._res_vec = (bundle.pack(self._res_tree).clone()
                             if self._res_tree is not None
                             else torch.zeros_like(vec))
            self._res_tree = None
        _, recon, self._res_vec, wire_bytes = transport.ef_topk_encode(
            vec + self._res_vec, n_params=bundle.n_params, frac=self.frac,
            quantize=self.quantize)
        return bundle.unpack(recon), wire_bytes

    def _compress_tree(self, delta_tree):
        """Per-leaf reference: leaf-local top-k thresholds and scales.  The
        kept counts sync to the host once per tree."""
        ls, rebuild = _leaves(delta_tree)
        if self._res_tree is None:
            self._res_tree = rebuild([torch.zeros_like(l) for l in ls])
        res_leaves, _ = _leaves(self._res_tree)
        wire_bytes = 0
        kept_counts, recon, new_res = [], [], []
        for d, r in zip(ls, res_leaves):
            x = d + r
            kept, mask = topk_compress(x, self.frac)
            if self.quantize:
                q, scale = int8_quantize(kept)
                kept = int8_dequantize(q, scale).to(d.dtype) * mask
                wire_bytes += 4                           # per-tensor scale
            kept_counts.append(mask.sum().to(torch.int32))
            wire_bytes += (mask.numel() + 7) // 8         # bitmap
            recon.append(kept)
            new_res.append(x - kept)
        payload_itemsize = 1 if self.quantize else 4      # int8 vs f32
        wire_bytes += int(torch.stack(kept_counts).sum()) * payload_itemsize
        self._res_tree = rebuild(new_res)
        return rebuild(recon), wire_bytes

    def uncompressed_bytes(self, delta_tree) -> int:
        ls, _ = _leaves(delta_tree)
        return int(sum(l.numel() * 4 for l in ls))
