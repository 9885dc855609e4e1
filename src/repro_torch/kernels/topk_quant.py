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

``ef_encode``, ``topk_threshold`` and ``dequant_add`` also take vectors
sharded over a server mesh (``parallel.sharding.Sharded``, a sharded
server's link vectors): each shard's pieces are encoded and decoded by
launches on its own device, and only the select's input and O(blocks)
partials cross devices (``ef_encode``'s docstring).  The cross-device
copies are written for distinct devices, but every mesh tested so far
repeats one device (one card, or the CPU).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.parallel import sharding as psh

from . import check_cuda_tensor, check_status, ref, use_kernel
from .ref import SAMPLE_CAP, THRESH_FLOOR, sample_plan  # noqa: F401

# kernel launches by wrapper: a run shows it went through the kernels
# (ef_encode_sharded: every launch of the sharded encode, the select on
# the home device and each shard's sample, stats and sweep; sample: the
# shards' sample launches of a sharded topk_threshold)
LAUNCHES = {"encode": 0, "decode": 0, "ef_encode": 0, "select": 0,
            "decode_rows": 0, "ef_encode_sharded": 0, "sample": 0}

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
    returns a new vector.  ``Sharded`` q and base (one mesh): one launch
    a shard on its device, the scale copied there; a ``Sharded``
    result."""
    if isinstance(q, psh.Sharded):
        out = []
        for qd, bd, dev in zip(q.shards, _pieces_like(base, q),
                               q.mesh.devices):
            with psh.device_guard(dev):
                out.append(dequant_add(qd, _scalar_to(scale, dev), bd))
        return psh.Sharded(out, q.mesh)
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


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _scalar_to(v: Scalar, dev: torch.device) -> Scalar:
    return v.to(dev) if isinstance(v, torch.Tensor) else v


def _pieces_like(t, like: "psh.Sharded"):
    """The pieces of ``t``, a ``Sharded`` over ``like``'s mesh, or None
    pieces for None."""
    if t is None:
        return (None,) * len(like.shards)
    if not (isinstance(t, psh.Sharded) and t.mesh == like.mesh
            and len(t.shards) == len(like.shards)):
        raise ValueError("sharded operands must share one mesh")
    return t.shards


def _on_kernel(shards) -> bool:
    """Whether every shard's pieces (a tuple each, None entries skipped)
    go to the kernels (True) or every one to the plain version (False)."""
    kinds = {use_kernel(*(t for t in p if t is not None)) for p in shards}
    if len(kinds) != 1:
        raise ValueError("a mesh whose pieces lie on the CPU and the card")
    return kinds.pop()


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
    otherwise a cluster select over the sample, then two passes over x.

    ``Sharded`` a (b and c, where given, on its mesh) takes the sharded
    form: each shard's share of the select's input ``x[::stride]``
    (``ref.shard_samples``) copied out on its device, concatenated on the
    home device and selected there by one cluster launch (stride 1 over
    the m sampled elements; ``sample_plan`` keeps m within
    ``CLUSTER_MAX``); the threshold copied to each device, each shard's
    per-block max and kept count (stats), all shards' partials copied to
    each device, and each shard's sweep reducing all of them, so every
    shard has the same scale and kept count.  q or recon and the residual
    come back ``Sharded``, thresh, scale and kept on the home device
    (written by shard 0's sweep), equal bit for bit to this function on
    the gathered vectors at the same width.  One launch on the home
    device and 3 a shard (2 with ``k`` None), counted under
    ``LAUNCHES["ef_encode_sharded"]``.  A mesh of one device takes the
    unsharded form on its one piece (its launches and counter)."""
    if isinstance(a, psh.Sharded):
        return _ef_encode_sharded(a, b, c, k=k, n_params=n_params,
                                  quantize=quantize)
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
        t_in = stats.data_ptr() if ks else None
        status = lib().ef_encode_stats_launch(
            _ptr(a), _ptr(b), _ptr(c), n, t_in, part.data_ptr(), blocks,
            _stream(dev))
        check_status(status, "ef_encode (grid stats)")
        status = lib().ef_encode_sweep_launch(
            _ptr(a), _ptr(b), _ptr(c), n, t_in, part.data_ptr(), blocks,
            blocks, blocks, int(quantize), _ptr(q), _ptr(recon),
            r.data_ptr(), stats.data_ptr(), stats.data_ptr() + 4,
            stats.data_ptr() + 8, _stream(dev))
        check_status(status, "ef_encode (grid sweep)")
        LAUNCHES["ef_encode"] += 3 if ks else 2
    kept = stats[2:].view(torch.int32)[0]
    return out, r, stats[0], (stats[1] if quantize else None), kept


def _shard_parts(a, b, c):
    """Per shard, its (a, b, c) pieces (None for a missing b or c), and
    the pieces' width."""
    pb, pc = _pieces_like(b, a), _pieces_like(c, a)
    shards = list(zip(a.shards, pb, pc))
    S = a.shards[0].numel()
    for pieces in shards:
        for t, name in zip(pieces, "abc"):
            if t is not None:
                check_cuda_tensor(t, name, torch.float32, S)
    return shards, S


def _sharded_select(shards, S: int, mesh, k: int, n_params: int,
                    stats: torch.Tensor) -> int:
    """The sharded form's select: each shard's share of x[::stride] copied
    out on its device, the shares concatenated on the home device in
    shard order, one cluster launch selecting over them into
    ``stats[0]``.  Returns the launches made."""
    from ._build import lib
    n = S * len(shards)
    stride, m, ks = sample_plan(n, k, n_params)
    if not 1 <= ks <= m or m > CLUSTER_MAX:
        raise ValueError(f"k = {k} outside 1..{m}, or {m} > CLUSTER_MAX")
    pieces = []
    for (a, b, c), dev, (off, md) in zip(shards, mesh.devices,
                                         ref.shard_samples(n, len(shards),
                                                           stride)):
        if not md:
            continue
        with psh.device_guard(dev):
            piece = torch.empty(md, dtype=torch.float32, device=dev)
            status = lib().ef_encode_sample_launch(
                _ptr(a), _ptr(b), _ptr(c), S, off, stride, md,
                piece.data_ptr(), _stream(dev))
            check_status(status, "ef_encode (sharded sample)")
        pieces.append(piece)
    home = mesh.home
    with psh.device_guard(home):
        sample = torch.cat([p.to(home) for p in pieces])
        _select_cluster(sample, None, None, m, 1, m, ks, False, False,
                        None, None, None, stats)
    return len(pieces) + 1


def _ef_encode_sharded(a, b, c, *, k, n_params, quantize):
    mesh, D = a.mesh, len(a.shards)
    shards, S = _shard_parts(a, b, c)
    if D == 1:
        # nothing crosses devices: the unsharded encode on the one piece
        out, r, thresh, scale, kept = ef_encode(*shards[0], k=k,
                                                n_params=n_params,
                                                quantize=quantize)
        return (psh.Sharded([out], mesh), psh.Sharded([r], mesh), thresh,
                scale, kept)
    home = mesh.home
    if not _on_kernel(shards):
        pa, pb, pc = ([p[i] for p in shards] for i in range(3))
        out, r, thresh, scale, kept = ref.reference_ef_encode_sharded(
            pa, None if b is None else pb, None if c is None else pc, k=k,
            n_params=n_params, quantize=quantize, home=home)
        return (psh.Sharded(out, mesh), psh.Sharded(r, mesh), thresh, scale,
                kept)
    if a.shards[0].device != home:
        raise ValueError("shard 0 must lie on the mesh's home device")
    from ._build import lib
    # thresh, scale (f32) and kept (int32) in one allocation
    stats = torch.empty(3, dtype=torch.float32, device=home)
    launches = 0
    if k is not None:
        launches += _sharded_select(shards, S, mesh, k, n_params, stats)
    blocks = min(GRID_BLOCKS, -(-S // 256))
    thr, parts = [], []
    for (pa, pb, pc), dev in zip(shards, mesh.devices):
        with psh.device_guard(dev):
            t_in = None if k is None else stats[:1].to(dev)
            part = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
            status = lib().ef_encode_stats_launch(
                _ptr(pa), _ptr(pb), _ptr(pc), S, _ptr(t_in),
                part.data_ptr(), blocks, _stream(dev))
            check_status(status, "ef_encode (sharded stats)")
        thr.append(t_in)
        parts.append(part)
    with psh.device_guard(home):
        every = torch.cat([p.to(home) for p in parts])
    outs, rs = [], []
    for d, ((pa, pb, pc), dev) in enumerate(zip(shards, mesh.devices)):
        with psh.device_guard(dev):
            part = every.to(dev)
            out = torch.empty(S, dtype=torch.int8 if quantize
                              else torch.float32, device=dev)
            r = torch.empty(S, dtype=torch.float32, device=dev)
            q, recon = (out, None) if quantize else (None, out)
            st = stats if d == 0 else None
            status = lib().ef_encode_sweep_launch(
                _ptr(pa), _ptr(pb), _ptr(pc), S, _ptr(thr[d]),
                part.data_ptr(), D * blocks, blocks, blocks, int(quantize),
                _ptr(q), _ptr(recon), r.data_ptr(), _ptr(st),
                None if st is None else st.data_ptr() + 4,
                None if st is None else st.data_ptr() + 8, _stream(dev))
            check_status(status, "ef_encode (sharded sweep)")
        outs.append(out)
        rs.append(r)
    LAUNCHES["ef_encode_sharded"] += launches + 2 * D
    kept = stats[2:].view(torch.int32)[0]
    return (psh.Sharded(outs, mesh), psh.Sharded(rs, mesh), stats[0],
            stats[1] if quantize else None, kept)


def topk_threshold(x: torch.Tensor, k: int, n_params: int) -> torch.Tensor:
    """0-d |x| threshold selecting ~the k largest coordinates of x (N,)
    f32: ``ef_encode``'s select alone, one cluster launch.  A ``Sharded``
    x over more than one device takes the sharded form's select (each
    shard's share of the sample, counted under ``LAUNCHES["sample"]``,
    then the one cluster launch on the home device) and returns the
    threshold on the home device."""
    if isinstance(x, psh.Sharded):
        shards, S = _shard_parts(x, None, None)
        if len(shards) == 1:
            return topk_threshold(shards[0][0], k, n_params)
        if not _on_kernel(shards):
            return ref.reference_topk_threshold_sharded(
                x.shards, k, n_params, x.mesh.home)
        stats = torch.empty(3, dtype=torch.float32, device=x.mesh.home)
        LAUNCHES["sample"] += _sharded_select(shards, S, x.mesh, k,
                                              n_params, stats) - 1
        LAUNCHES["select"] += 1
        return stats[0]
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
