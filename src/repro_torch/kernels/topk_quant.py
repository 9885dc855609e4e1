"""Fused top-k threshold + int8 quantise encode, and fused dequantise +
delta-apply decode, over a packed f32 vector.

``topk_quant_encode`` and ``dequant_add`` replace the TPU kernels of
``repro/kernels/topk_quant.py`` one for one.  Their Hopper redesigns take
the launches around them too: ``ef_encode`` is the codec's whole
error-feedback top-k(+int8) encode (the threshold's select, the scale,
the kept count and the quantising sweep) in one thread-block cluster
launch, ``topk_threshold`` that launch's select alone, and
``dequant_add_rows`` decodes all of a merge's updates into the server's
row buffer in one launch.  On a CUDA tensor each launches
``csrc/topk_quant.cu``; on a CPU tensor each runs its plain version in
``ref.py``.  See the CUDA source for the design and its bound.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from . import check_cuda_tensor, check_status, ref, use_kernel
from .ref import SAMPLE_CAP, THRESH_FLOOR, sample_plan  # noqa: F401

# kernel launches by wrapper: a run shows it went through the kernels
LAUNCHES = {"encode": 0, "decode": 0, "ef_encode": 0, "select": 0,
            "decode_rows": 0}

# CTAs of ef_encode's cluster: 16, a non-portable size the H100 schedules
# (7 such clusters at once), faster than the portable 8 at the MLP's width
# (chip_smoke.py times both; PERF.md); and the largest sample one cluster
# holds in shared memory (2^18 f32: 64 KB a CTA at 16, 128 KB at 8).
# GRID_BLOCKS blocks cover a vector above it.
CLUSTER_CTAS = 16
CLUSTER_MAX = 1 << 18
GRID_BLOCKS = 528

Scalar = Union[float, torch.Tensor]


def _scalar_on(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device.  A Python float is filled on
    the card (no host-to-device copy, no sync)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"expected a scalar tensor, got {tuple(v.shape)}")
        if v.device != like.device:
            raise ValueError(f"scalar on {v.device}, data on {like.device}")
        return v.reshape(()).to(torch.float32).contiguous()
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def topk_quant_encode(x: torch.Tensor, thresh: Scalar, scale: Scalar
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over x (N,) f32: ``q`` = int8 of ``round(x / scale)``
    clipped to +-127 where ``|x| >= thresh``, else 0; returns
    ``(q, x - q * scale)``.  ``thresh``/``scale`` are floats or 0-d
    tensors on x's device."""
    if not use_kernel(x):
        return ref.reference_topk_quant_encode(x, thresh, scale)
    from ._build import lib
    n = x.numel()
    check_cuda_tensor(x, "x", torch.float32, n)
    t, s = _scalar_on(thresh, x), _scalar_on(scale, x)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    r = torch.empty(n, dtype=torch.float32, device=x.device)
    status = lib().topk_quant_encode_launch(
        x.data_ptr(), t.data_ptr(), s.data_ptr(), q.data_ptr(), r.data_ptr(),
        n, torch.cuda.current_stream(x.device).cuda_stream)
    check_status(status, "topk_quant_encode")
    LAUNCHES["encode"] += 1
    return q, r


def dequant_add(q: torch.Tensor, scale: Scalar, base: torch.Tensor
                ) -> torch.Tensor:
    """One pass: ``base + q * scale`` with q (N,) int8 and base (N,) f32;
    returns a new vector."""
    if not use_kernel(q, base):
        return ref.reference_dequant_add(q, scale, base)
    from ._build import lib
    n = base.numel()
    check_cuda_tensor(q, "q", torch.int8, n)
    check_cuda_tensor(base, "base", torch.float32, n)
    s = _scalar_on(scale, base)
    out = torch.empty(n, dtype=torch.float32, device=base.device)
    status = lib().dequant_add_launch(
        q.data_ptr(), s.data_ptr(), base.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(base.device).cuda_stream)
    check_status(status, "dequant_add")
    LAUNCHES["decode"] += 1
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _select_cluster(a, b, c, n: int, stride: int, m: int, k: int, sweep,
                    quantize, q, recon, r, stats) -> None:
    from ._build import lib
    status = lib().ef_encode_cluster_launch(
        _ptr(a), _ptr(b), _ptr(c), n, stride, m, k, int(sweep),
        int(quantize), _ptr(q), _ptr(recon), _ptr(r), stats.data_ptr(),
        stats.data_ptr() + 4, stats.data_ptr() + 8, CLUSTER_CTAS,
        torch.cuda.current_stream(a.device).cuda_stream)
    check_status(status, "ef_encode (cluster)")


def ef_encode(a: torch.Tensor, b: Optional[torch.Tensor] = None,
              c: Optional[torch.Tensor] = None, *, k: Optional[int],
              n_params: int, quantize: bool):
    """The codec's error-feedback top-k(+int8) encode of ``x = (a - b) +
    c`` (a missing ``b`` or ``c`` skipped), all (N,) f32.  The threshold
    is the k-th largest |x| (exact up to ``SAMPLE_CAP`` parameters, from a
    strided sample above, ``ref.sample_plan``), floored at
    ``THRESH_FLOOR``; ``k`` None means threshold 0 (the int8 codec).
    Returns ``(q, residual, thresh, scale, kept)`` with ``quantize`` (q
    int8 as ``topk_quant_encode`` writes it, scale ``max(max|x|, 1e-12) /
    127``), else ``(recon, x - recon, thresh, None, kept)`` with recon x
    masked to ``|x| >= thresh``; thresh, scale and kept (int32) are 0-d
    tensors on x's device.  One launch when the sample is x itself and
    fits one cluster (N <= ``CLUSTER_MAX``, the FL paths' widths);
    otherwise a cluster select over the sample, then two passes over x."""
    parts = [t for t in (a, b, c) if t is not None]
    if not use_kernel(*parts):
        return ref.reference_ef_encode(a, b, c, k=k, n_params=n_params,
                                       quantize=quantize)
    n = a.numel()
    for t, name in zip((a, b, c), "abc"):
        if t is not None:
            check_cuda_tensor(t, name, torch.float32, n)
    if k is None:
        stride, m, ks = 1, n, 0
    else:
        stride, m, ks = sample_plan(n, k, n_params)
        if not 1 <= ks <= m:
            raise ValueError(f"k = {k} outside 1..{m}")
    dev = a.device
    out = torch.empty(n, dtype=torch.int8 if quantize else torch.float32,
                      device=dev)
    r = torch.empty(n, dtype=torch.float32, device=dev)
    # thresh, scale (f32) and kept (int32) in one allocation
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    q, recon = (out, None) if quantize else (None, out)
    if stride == 1 and m <= CLUSTER_MAX:
        _select_cluster(a, b, c, n, 1, m, ks, True, quantize, q, recon, r,
                        stats)
        LAUNCHES["ef_encode"] += 1
    else:
        from ._build import lib
        if ks:
            _select_cluster(a, b, c, n, stride, m, ks, False, quantize,
                            None, None, None, stats)
        blocks = min(GRID_BLOCKS, -(-n // 256))
        part = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
        status = lib().ef_encode_grid_launch(
            _ptr(a), _ptr(b), _ptr(c), n,
            stats.data_ptr() if ks else None, part.data_ptr(), blocks,
            int(quantize), _ptr(q), _ptr(recon), r.data_ptr(),
            stats.data_ptr(), stats.data_ptr() + 4, stats.data_ptr() + 8,
            torch.cuda.current_stream(dev).cuda_stream)
        check_status(status, "ef_encode (grid)")
        LAUNCHES["ef_encode"] += 3 if ks else 2
    kept = stats[2:].view(torch.int32)[0]
    return out, r, stats[0], (stats[1] if quantize else None), kept


def topk_threshold(x: torch.Tensor, k: int, n_params: int) -> torch.Tensor:
    """0-d |x| threshold selecting ~the k largest coordinates of x (N,)
    f32: ``ef_encode``'s select alone, one cluster launch."""
    if not use_kernel(x):
        return ref.reference_topk_threshold(x, k, n_params)
    n = x.numel()
    check_cuda_tensor(x, "x", torch.float32, n)
    stride, m, ks = sample_plan(n, k, n_params)
    if not 1 <= ks <= m or m > CLUSTER_MAX:
        raise ValueError(f"k = {k} outside 1..{m}, or {m} > CLUSTER_MAX")
    stats = torch.empty(3, dtype=torch.float32, device=x.device)
    _select_cluster(x, None, None, n, stride, m, ks, False, False, None,
                    None, None, stats)
    LAUNCHES["select"] += 1
    return stats[0]


def _ptrs(ts: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def dequant_add_rows(qs: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor],
                     bases: Sequence[torch.Tensor],
                     rows: torch.Tensor) -> torch.Tensor:
    """One merge's decodes into the row buffer ``rows`` (cap, N) f32, in
    place: ``rows[i] = bases[i] + qs[i] * scales[i]`` (q (N,) int8, scale
    a 0-d f32 tensor, base (N,) f32) for i < n, and rows n.. zeroed.  One
    launch up to 128 decodes (their pointers travel as kernel
    parameters); returns ``rows``."""
    n = len(qs)
    if not (len(scales) == len(bases) == n):
        raise ValueError("qs, scales and bases differ in length")
    if rows.dim() != 2 or rows.shape[0] < n:
        raise ValueError(f"rows {tuple(rows.shape)} cannot take {n} rows")
    if not use_kernel(rows, *qs, *scales, *bases):
        return ref.reference_dequant_add_rows(qs, scales, bases, rows)
    cap, N = rows.shape
    check_cuda_tensor(rows, "rows", torch.float32, cap * N)
    for q, s, b in zip(qs, scales, bases):
        check_cuda_tensor(q, "q", torch.int8, N)
        check_cuda_tensor(b, "base", torch.float32, N)
        check_cuda_tensor(s, "scale", torch.float32, 1)
        if q.data_ptr() % 4 or b.data_ptr() % 16:
            raise ValueError("q must start on 4 bytes and base on 16")
    if N % 4 or rows.data_ptr() % 16:
        raise ValueError(f"rows must start on 16 bytes with N % 4 == 0, "
                         f"got N = {N}")
    if n == 0 and cap == 0:
        return rows
    from ._build import lib
    status = lib().dequant_add_rows_launch(
        _ptrs(qs), _ptrs(scales), _ptrs(bases), n, cap - n,
        rows.data_ptr(), N, torch.cuda.current_stream(rows.device)
        .cuda_stream)
    check_status(status, "dequant_add_rows")
    LAUNCHES["decode_rows"] += max(1, -(-n // 128))
    return rows
