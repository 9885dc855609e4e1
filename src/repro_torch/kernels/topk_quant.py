"""Fused top-k threshold + int8 quantise encode, and fused dequantise +
delta-apply decode, over a packed f32 vector.

``topk_quant_encode`` and ``dequant_add`` replace the TPU kernels of
``repro/kernels/topk_quant.py`` one for one.  Their Hopper redesigns take
the launches around them too: ``ef_encode`` is the codec's whole
error-feedback top-k(+int8) encode (the threshold's select, the scale,
the kept count and the quantising sweep) in one thread-block cluster
launch, ``topk_threshold`` that launch's select alone, and
``dequant_add_rows`` decodes all of a merge's updates into the server's
row buffer in one launch.  B4 itself (``dequant_add``) is off the paths
where a launch beside it already holds its inputs: ``ef_encode``'s
``decoded`` output writes ``b + q * scale`` from the encode's last pass
(a quantised downlink hands its receiver's model over with no decode
launch), and async_delta's decode rides in its delta merge
(``fedavg_agg.dequant_mix``).  On a CUDA tensor each launches
``csrc/topk_quant.cu``; on a CPU tensor each runs its plain version in
``ref.py``.  See the CUDA source for the design and its bound.

``ef_encode``, ``topk_threshold`` and ``dequant_add`` also take vectors
sharded over a server mesh (``parallel.sharding.Sharded``, a sharded
server's link vectors): each shard's pieces are encoded and decoded by
launches on its own device, and only the select's input and O(blocks)
partials cross devices (``ef_encode``'s docstring).  A decode makes one
launch a device over every piece it holds (``dequant_add`` on ``Sharded``
operands, ``dequant_add_rows_pieces`` for a sharded row buffer).  The
cross-device copies are written for distinct devices, but every mesh
tested so far repeats one device (one card, or the CPU).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.parallel import sharding as psh

from . import (GROUP_PIECES, check_cuda_tensor, check_status,
               group_launches, pointer_table, ref, use_kernel)
from .ref import SAMPLE_CAP, THRESH_FLOOR, sample_plan  # noqa: F401

# kernel launches by wrapper: a run shows it went through the kernels
# (ef_encode: every launch of an unsharded encode, 1 or 3; ef_encode_sharded:
# every launch of the sharded encode, each shard's two passes and the
# select and kept sum on the home device; ef_encode_dec: every launch of an
# encode that also writes the decoded vector, in any of those forms;
# sample: the shards' pass 1 launches of a sharded topk_threshold)
LAUNCHES = {"encode": 0, "decode": 0, "ef_encode": 0, "select": 0,
            "decode_rows": 0, "ef_encode_sharded": 0, "sample": 0,
            "ef_encode_dec": 0}
# the pieces the decodes' launches covered (one a call unsharded; every
# piece a device holds of a sharded vector or row buffer)
PIECES = {"decode": 0, "decode_rows": 0}

# CTAs of ef_encode's cluster: 16, a non-portable size the H100 schedules
# (7 such clusters at once), faster than the portable 8 at the MLP's width
# (chip_smoke.py times both; PERF.md); and the largest sample one cluster
# holds in shared memory (2^18 f32: 64 KB a CTA at 16, 128 KB at 8).
# At most GRID_BLOCKS blocks (four of 256 threads on each of the H100's
# 132 SMs: one wave) run each pass of the grid form above it.
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
    returns a new vector.  ``Sharded`` q and base (one mesh): one launch a
    device over the pieces it holds, the scale copied there once; a
    ``Sharded`` result."""
    if not isinstance(q, psh.Sharded):
        return dequant_add_pieces([q], scale, [base])[0]
    bases, out = _pieces_like(base, q), [None] * len(q.shards)
    for dev, idx in psh.device_groups(q.mesh):
        with psh.device_guard(dev):
            res = dequant_add_pieces([q.shards[i] for i in idx],
                                     _scalar_to(scale, dev),
                                     [bases[i] for i in idx])
        for i, r in zip(idx, res):
            out[i] = r
    return psh.Sharded(out, q.mesh)


def dequant_add_pieces(qs: Sequence[torch.Tensor], scale: Scalar,
                       bases: Sequence[torch.Tensor]) -> list:
    """``b + q * scale`` for each piece pair (q (N,) int8 of ``qs``, b (N,)
    f32 of ``bases``, all on one device, one scale): new vectors, one
    launch for all."""
    if not use_kernel(*qs, *bases):
        return [ref.reference_dequant_add(q, scale, b)
                for q, b in zip(qs, bases)]
    from ._build import lib
    n = bases[0].numel()
    for q, b in zip(qs, bases):
        check_cuda_tensor(q, "q", torch.int8, n)
        check_cuda_tensor(b, "base", torch.float32, n)
    s = _scalar_on(scale, bases[0])
    outs = [torch.empty(n, dtype=torch.float32, device=b.device)
            for b in bases]
    status = lib().dequant_add_launch(pointer_table(qs, bases, outs),
                                      len(qs), s.data_ptr(), n,
                                      _stream(bases[0].device))
    check_status(status, "dequant_add")
    LAUNCHES["decode"] += group_launches(len(qs))
    PIECES["decode"] += len(qs)
    return outs


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
                    quantize, q, recon, r, stats, part=None,
                    dec=None) -> None:
    from ._build import lib
    status = lib().ef_encode_cluster_launch(
        _ptr(a), _ptr(b), _ptr(c), n, stride, m, k, int(sweep),
        int(quantize), _ptr(part), 0 if part is None else part.numel(),
        _ptr(q), _ptr(recon), _ptr(r), _ptr(dec), stats.data_ptr(),
        stats.data_ptr() + 4, stats.data_ptr() + 8, CLUSTER_CTAS,
        torch.cuda.current_stream(a.device).cuda_stream)
    check_status(status, "ef_encode (cluster)")


def kept_word(stats: torch.Tensor) -> torch.Tensor:
    """The kept count inside ``stats`` (thresh, scale, kept): an int32
    view of its third word."""
    return stats[2:].view(torch.int32)


def key_max(part: torch.Tensor) -> torch.Tensor:
    """max |x| from int32 max keys (|x|'s bits: they order as the floats)."""
    return part.max().reshape(1).view(torch.float32)[0]


def _put(part: Optional[torch.Tensor], v: torch.Tensor) -> None:
    """A plain pass's partials: the whole piece's value in block 0, the
    identity (0) in the others."""
    if part is not None:
        part.zero_()
        part[:1] = v.reshape(1).to(torch.int32)


def grid_blocks(n: int) -> int:
    """Blocks of a grid pass over n elements: one 16-byte chunk a thread
    or more, at most GRID_BLOCKS (four blocks of 256 threads an SM)."""
    return max(1, min(GRID_BLOCKS, -(-n // 1024)))


def ef_pass1(a, b=None, c=None, *, blocks: int, off: int = 0,
             stride: int = 1, sample=None, x=None, part_max=None,
             part_kept=None, zero=None) -> None:
    """Pass 1 of the grid form over one piece (all operands on one device),
    one launch: the select's input ``sample[i] = x[off + i * stride]``
    (``sample`` None: none), x stored into ``x``, per-block max keys of
    |x| into ``part_max`` and counts of ``|x| >= 0`` into ``part_kept``
    (int32, ``blocks`` each), ``zero``'s kept word set to 0; each skipped
    where None.  x = ``(a - b) + c`` as ``ef_encode`` forms it.  On CPU
    tensors ``ref.reference_ef_pass1``, its value in block 0's partial."""
    bufs = [t for t in (a, b, c, sample, x, part_max, part_kept, zero)
            if t is not None]
    m = 0 if sample is None else sample.numel()
    if not use_kernel(*bufs):
        xv, smp, mx, k0 = ref.reference_ef_pass1(
            a, b, c, off=off, stride=stride, m=m,
            count=part_kept is not None)
        for dst, v in ((x, xv), (sample, smp)):
            if dst is not None:
                dst.copy_(v)
        _put(part_max, mx.reshape(1).view(torch.int32))
        _put(part_kept, k0)
        if zero is not None:
            kept_word(zero).zero_()
        return
    from ._build import lib
    status = lib().ef_encode_pass1_launch(
        _ptr(a), _ptr(b), _ptr(c), a.numel(), off, stride, m, _ptr(sample),
        _ptr(x), _ptr(part_max), _ptr(part_kept),
        None if zero is None else zero.data_ptr() + 8, blocks,
        _stream(a.device))
    check_status(status, "ef_encode (pass 1)")


def ef_select(sample: torch.Tensor, ks: int, stats: torch.Tensor, *,
              exact: bool, part_max=None) -> None:
    """The grid form's select, one cluster launch over ``sample`` (the
    gathered select's input, stride 1): the ks-th largest |sample| floored
    at THRESH_FLOOR into ``stats[0]`` and, where ``part_max`` is given,
    the scale of their max into ``stats[1]``.  On CPU tensors
    ``ref.reference_ef_select`` (``exact``: its torch.topk, else a
    sort)."""
    m = sample.numel()
    if not 1 <= ks <= m or m > CLUSTER_MAX:
        raise ValueError(f"k = {ks} outside 1..{m}, or {m} > CLUSTER_MAX")
    if not use_kernel(*(t for t in (sample, stats, part_max)
                        if t is not None)):
        t, s = ref.reference_ef_select(
            sample, ks, None if part_max is None else key_max(part_max),
            exact=exact)
        stats[0] = t
        if s is not None:
            stats[1] = s
        return
    _select_cluster(sample, None, None, m, 1, m, ks, False,
                    part_max is not None, None, None, None, stats, part_max)


def ef_reduce(stats: torch.Tensor, *, part_max=None, part_kept=None,
              thresh: bool = False) -> None:
    """One block: the scale from the max keys ``part_max`` into
    ``stats[1]``, the sum of ``part_kept`` into its kept word, the
    threshold 0 into ``stats[0]`` with ``thresh``; each where given."""
    if not use_kernel(*(t for t in (stats, part_max, part_kept)
                        if t is not None)):
        if thresh:
            stats[0] = 0.0
        if part_max is not None:
            stats[1] = ref.reference_int8_scale(key_max(part_max))
        if part_kept is not None:
            kept_word(stats)[0] = part_kept.sum()
        return
    from ._build import lib
    p = stats.data_ptr()
    status = lib().ef_encode_reduce_launch(
        _ptr(part_max), 0 if part_max is None else part_max.numel(),
        _ptr(part_kept), 0 if part_kept is None else part_kept.numel(),
        p if thresh else None, None if part_max is None else p + 4,
        None if part_kept is None else p + 8, _stream(stats.device))
    check_status(status, "ef_encode (reduce)")


def ef_pass2(x: torch.Tensor, ts: torch.Tensor, *, blocks: int,
             quantize: bool, out: torch.Tensor, r: torch.Tensor,
             part_kept=None, kept=None, base=None, dec=None) -> None:
    """Pass 2 of the grid form over one piece, one launch: from x (which
    may be ``r`` itself) at the threshold ``ts[0]`` and, with
    ``quantize``, the scale ``ts[1]``: q (int8) or the masked recon into
    ``out``, the residual into ``r``, with ``quantize`` and ``dec`` the
    decode ``base + q * ts[1]`` (B4's) into ``dec``, and the count of
    ``|x| >= ts[0]`` per block into ``part_kept`` or added to ``kept``'s
    kept word.  On CPU tensors ``ref.reference_ef_pass2`` (and
    ``ref.reference_dequant_add``)."""
    if (dec is None) != (base is None) or (dec is not None and
                                           not quantize):
        raise ValueError("a decoded output needs the base and quantize")
    if not use_kernel(*(t for t in (x, ts, out, r, part_kept, kept, base,
                                    dec) if t is not None)):
        o, rr, kd = ref.reference_ef_pass2(x, ts[0],
                                           ts[1] if quantize else None)
        out.copy_(o)
        r.copy_(rr)
        if dec is not None:
            dec.copy_(ref.reference_dequant_add(o, ts[1], base))
        _put(part_kept, kd)
        if kept is not None:
            kept_word(kept)[0] += kd
        return
    from ._build import lib
    q, recon = (out, None) if quantize else (None, out)
    status = lib().ef_encode_pass2_launch(
        x.data_ptr(), x.numel(), ts.data_ptr(), int(quantize), _ptr(q),
        _ptr(recon), r.data_ptr(), _ptr(base), _ptr(dec), _ptr(part_kept),
        None if kept is None else kept.data_ptr() + 8, blocks,
        _stream(x.device))
    check_status(status, "ef_encode (pass 2)")


def _pass1_home(pieces, home: torch.device, dst, **kw) -> None:
    """``ef_pass1`` over one piece's (a, b, c), its sample share and
    partials ``dst`` (sample, part_max, part_kept; None: not written)
    buffers on ``home``: written there directly where the piece lies on
    ``home``, else on the piece's device and copied over.  ``kw``: the
    rest of ``ef_pass1``'s arguments."""
    dev = pieces[0].device
    with psh.device_guard(dev):
        bufs = dst if dev == home else tuple(
            None if t is None else torch.empty_like(t, device=dev)
            for t in dst)
        ef_pass1(*pieces, sample=bufs[0], part_max=bufs[1],
                 part_kept=bufs[2], **kw)
    if dev != home:
        with psh.device_guard(home):
            for t, u in zip(dst, bufs):
                if t is not None:
                    t.copy_(u)


def _ef_encode_grid(shards, home: torch.device, *, k, n_params, quantize,
                    decs=None):
    """The grid form of ``ef_encode`` over one vector or a sharded one,
    ``shards`` its (a, b, c) pieces in shard order (N/D each), each on its
    own device: a pass 1 a piece, the select (or, for the int8 codec, the
    reduce) on ``home``, a pass 2 a piece (with ``decs``, one output a
    piece, also writing the decode ``b + q * scale``), and for a sharded
    top-k encode the kept partials summed on ``home`` (one vector: pass 2
    adds them into the counter pass 1 zeroed).  Each piece's sample share
    and partials go straight into the home device's buffers where the
    piece lies there.  Returns ``(outs, residuals, stats, launches)``."""
    D = len(shards)
    S = shards[0][0].numel()
    n = S * D
    topk = k is not None
    if topk:
        stride, m, ks = sample_plan(n, k, n_params)
        if not 1 <= ks <= m or m > CLUSTER_MAX:
            raise ValueError(f"k = {k} outside 1..{m}, or {m} > "
                             f"CLUSTER_MAX")
        plan = ref.shard_samples(n, D, stride)
    else:
        stride, m, plan = 1, 0, [(0, 0)] * D
    G = grid_blocks(S)
    # pass 2 reads x back from the residual's buffer (4 bytes an element,
    # not a, b and c again); where x is a itself, from a
    store = shards[0][1] is not None or shards[0][2] is not None
    f32 = torch.float32
    stats = torch.empty(3, dtype=f32, device=home)   # thresh, scale, kept
    home = stats.device          # with its index, as the pieces' devices
    sample = torch.empty(m, dtype=f32, device=home)
    # per-block partials of every piece: max keys, then kept counts
    part = torch.empty(2 * D * G, dtype=torch.int32, device=home)
    pmax, pkept = part[:D * G], part[D * G:]
    one = D == 1 and topk      # pass 2 adds kept into the zeroed counter
    outs, rs, xs, start = [], [], [], 0
    for d, (pa, pb, pc) in enumerate(shards):
        dev, (off, md) = pa.device, plan[d]
        sl = slice(d * G, (d + 1) * G)
        dst = (sample[start:start + md] if md else None,
               pmax[sl] if quantize else None,
               None if topk else pkept[sl])
        start += md
        with psh.device_guard(dev):
            out = torch.empty(S, dtype=torch.int8 if quantize else f32,
                              device=dev)
            r = torch.empty(S, dtype=f32, device=dev)
        _pass1_home((pa, pb, pc), home, dst, blocks=G, off=off,
                    stride=stride, x=r if store else None,
                    zero=stats if one else None)
        outs.append(out)
        rs.append(r)
        xs.append(r if store else pa)
    with psh.device_guard(home):
        if topk:
            ef_select(sample, ks, stats, exact=n_params <= SAMPLE_CAP,
                      part_max=pmax if quantize else None)
        else:
            ef_reduce(stats, part_max=pmax if quantize else None,
                      part_kept=pkept, thresh=True)
    # the last piece first: on a device that holds several, the x that its
    # pass 1 wrote last is still in L2 (pass 2 walks each piece from its end)
    for d in reversed(range(D)):
        x, out, r = xs[d], outs[d], rs[d]
        dev, sl = x.device, slice(d * G, (d + 1) * G)
        with psh.device_guard(dev):
            # only thresh and scale, 8 bytes, travel to another device
            ts = stats if dev == home else stats[:2].to(dev)
            pk = None
            if topk and not one:
                pk = pkept[sl] if dev == home else torch.empty(
                    G, dtype=torch.int32, device=dev)
            ef_pass2(x, ts, blocks=G, quantize=quantize, out=out, r=r,
                     part_kept=pk, kept=stats if one else None,
                     base=None if decs is None else shards[d][1],
                     dec=None if decs is None else decs[d])
        if pk is not None and dev != home:
            with psh.device_guard(home):
                pkept[sl].copy_(pk)
    launches = 2 * D + 1
    if topk and not one:
        with psh.device_guard(home):
            ef_reduce(stats, part_kept=pkept)
        launches += 1
    return outs, rs, stats, launches


def ef_encode(a: torch.Tensor, b: Optional[torch.Tensor] = None,
              c: Optional[torch.Tensor] = None, *, k: Optional[int],
              n_params: int, quantize: bool, decoded=None):
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
    otherwise the grid form, three launches: a pass over x (the sample,
    the max keys, x stored into the residual's buffer where b or c is
    given), the cluster select and scale over the sample (the int8 codec:
    a one-block reduce), a pass writing the outputs and the kept count.

    ``Sharded`` a (b and c, where given, on its mesh) takes the sharded
    form, the grid form's pieces split apart: each shard's pass 1 on its
    device (its share of the select's input ``x[::stride]``,
    ``ref.shard_samples``, and its partials written into the home
    device's buffers, copied there from another device), one select and
    scale on the home device (``sample_plan`` keeps the sample within
    ``CLUSTER_MAX``), the threshold and scale (8 bytes) copied to each
    device, each shard's pass 2 counting its kept partials, and (top-k)
    one sum of all shards' kept partials on the home device.  q or recon
    and the residual come back ``Sharded``, thresh, scale and kept on the
    home device, equal bit for bit to this function on the gathered
    vectors at the same width.  2D + 2 launches (2D + 1 with ``k`` None),
    counted under ``LAUNCHES["ef_encode_sharded"]``.  A mesh of one device
    takes the unsharded form on its one piece (its launches and counter).
    On CPU tensors every form runs the plain versions of its launches
    (the one-launch form ``ref.reference_ef_encode``).

    ``decoded``, an (N,) f32 output (a ``Sharded`` one on a's mesh), with
    ``quantize`` and ``b`` given: the same launches also write ``b + q *
    scale`` there, bit for bit what ``dequant_add(q, scale, b)`` (B4)
    returns, so a downlink's encode hands its receiver's model over
    without a decode launch; the cluster form's sweep and the grid form's
    pass 2 re-read b for it.  Such an encode counts its launches under
    ``LAUNCHES["ef_encode_dec"]`` instead.  On CPU tensors the plain
    encode, then ``ref.reference_dequant_add``."""
    if decoded is not None and (not quantize or b is None):
        raise ValueError("a decoded output needs quantize and b")
    if isinstance(a, psh.Sharded):
        return _ef_encode_sharded(a, b, c, k=k, n_params=n_params,
                                  quantize=quantize, decoded=decoded)
    parts = [t for t in (a, b, c, decoded) if t is not None]
    on_card = use_kernel(*parts)
    n = a.numel()
    if on_card:
        for t, name in zip((a, b, c, decoded), ("a", "b", "c", "decoded")):
            if t is not None:
                check_cuda_tensor(t, name, torch.float32, n)
        if decoded is not None and decoded.data_ptr() % 16:
            raise ValueError("decoded must start on 16 bytes")
    stride, m, ks = (1, n, 0) if k is None else sample_plan(n, k, n_params)
    if stride == 1 and m <= CLUSTER_MAX:
        if not on_card:
            res = ref.reference_ef_encode(a, b, c, k=k, n_params=n_params,
                                          quantize=quantize)
            if decoded is not None:
                decoded.copy_(ref.reference_dequant_add(res[0], res[3], b))
            return res
        if k is not None and not 1 <= ks <= m:
            raise ValueError(f"k = {k} outside 1..{m}")
        dev = a.device
        out = torch.empty(n, dtype=torch.int8 if quantize else torch.float32,
                          device=dev)
        r = torch.empty(n, dtype=torch.float32, device=dev)
        # thresh, scale (f32) and kept (int32) in one allocation
        stats = torch.empty(3, dtype=torch.float32, device=dev)
        q, recon = (out, None) if quantize else (None, out)
        _select_cluster(a, b, c, n, 1, m, ks, True, quantize, q, recon, r,
                        stats, dec=decoded)
        launches = 1
    else:
        (out,), (r,), stats, launches = _ef_encode_grid(
            [(a, b, c)], a.device, k=k, n_params=n_params,
            quantize=quantize, decs=None if decoded is None else [decoded])
    if on_card:
        LAUNCHES["ef_encode" if decoded is None else "ef_encode_dec"] += \
            launches
    return (out, r, stats[0], stats[1] if quantize else None,
            kept_word(stats)[0])


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


def _sharded_select(shards, S: int, mesh, k: int, n_params: int) -> tuple:
    """A sharded vector's select: each shard's share of x[::stride] (one
    pass 1 launch a shard that holds some, sample only) written into one
    buffer on the home device (copied there from another device), one
    cluster launch selecting over it.  Returns the threshold (0-d, on the
    home device) and the launches made."""
    n = S * len(shards)
    stride, m, ks = sample_plan(n, k, n_params)
    if not 1 <= ks <= m or m > CLUSTER_MAX:
        raise ValueError(f"k = {k} outside 1..{m}, or {m} > CLUSTER_MAX")
    stats = torch.empty(3, dtype=torch.float32, device=mesh.home)
    home = stats.device
    sample = torch.empty(m, dtype=torch.float32, device=home)
    start, launches = 0, 1
    for pieces, (off, md) in zip(shards,
                                 ref.shard_samples(n, len(shards), stride)):
        if not md:
            continue
        _pass1_home(pieces, home, (sample[start:start + md], None, None),
                    blocks=grid_blocks(S), off=off, stride=stride)
        start += md
        launches += 1
    with psh.device_guard(home):
        ef_select(sample, ks, stats, exact=n_params <= SAMPLE_CAP)
    return stats[0], launches


def _ef_encode_sharded(a, b, c, *, k, n_params, quantize, decoded=None):
    mesh = a.mesh
    shards, S = _shard_parts(a, b, c)
    decs = None if decoded is None else _pieces_like(decoded, a)
    if decs is not None:
        for t in decs:
            check_cuda_tensor(t, "decoded", torch.float32, S)
    if len(shards) == 1:
        # nothing crosses devices: the unsharded encode on the one piece
        out, r, thresh, scale, kept = ef_encode(
            *shards[0], k=k, n_params=n_params, quantize=quantize,
            decoded=None if decs is None else decs[0])
        return (psh.Sharded([out], mesh), psh.Sharded([r], mesh), thresh,
                scale, kept)
    on_card = _on_kernel(shards)
    outs, rs, stats, launches = _ef_encode_grid(
        shards, mesh.home, k=k, n_params=n_params, quantize=quantize,
        decs=decs)
    if on_card:
        LAUNCHES["ef_encode_sharded" if decs is None else
                 "ef_encode_dec"] += launches
    return (psh.Sharded(outs, mesh), psh.Sharded(rs, mesh), stats[0],
            stats[1] if quantize else None, kept_word(stats)[0])


def topk_threshold(x: torch.Tensor, k: int, n_params: int) -> torch.Tensor:
    """0-d |x| threshold selecting ~the k largest coordinates of x (N,)
    f32: ``ef_encode``'s select alone, one cluster launch.  A ``Sharded``
    x over more than one device takes the sharded form's select (each
    shard's share of the sample written by a pass 1 launch, counted under
    ``LAUNCHES["sample"]``, then the one cluster launch on the home
    device) and returns the threshold on the home device."""
    if isinstance(x, psh.Sharded):
        shards, S = _shard_parts(x, None, None)
        if len(shards) == 1:
            return topk_threshold(shards[0][0], k, n_params)
        on_card = _on_kernel(shards)
        t, launches = _sharded_select(shards, S, x.mesh, k, n_params)
        if on_card:
            LAUNCHES["sample"] += launches - 1
            LAUNCHES["select"] += 1
        return t
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


def dequant_add_rows(qs: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor],
                     bases: Sequence[torch.Tensor],
                     rows: torch.Tensor) -> torch.Tensor:
    """One merge's decodes into the row buffer ``rows`` (cap, N) f32, in
    place: ``rows[i] = bases[i] + qs[i] * scales[i]`` (q (N,) int8, scale
    a 0-d f32 tensor, base (N,) f32) for i < n, and rows n.. zeroed.  One
    launch up to 128 decodes (their pointers travel as kernel
    parameters); returns ``rows``."""
    return dequant_add_rows_pieces([[q] for q in qs], scales,
                                   [[b] for b in bases], [rows])[0]


def rows_launches(n_dec: int, n_zero: int, n_pieces: int) -> int:
    """Launches of ``dequant_add_rows_launch``: one for every 128
    (decode, piece) pairs of up to 32 pieces, at least one that zeroes."""
    launches = 0
    for first in range(0, n_pieces, GROUP_PIECES):
        per = 128 // min(GROUP_PIECES, n_pieces - first)
        launches += max(1, -(-n_dec // per)) if n_dec or n_zero else 0
    return launches


def dequant_add_rows_pieces(qs: Sequence[Sequence[torch.Tensor]],
                            scales: Sequence[torch.Tensor],
                            bases: Sequence[Sequence[torch.Tensor]],
                            rows: Sequence[torch.Tensor]) -> list:
    """``dequant_add_rows`` into the row buffers of pieces on one device
    (a sharded server's rows: the pieces that device holds), in place:
    piece j's ``rows[j][i] = bases[i][j] + qs[i][j] * scales[i]`` for each
    decode i < n, rows n.. of every piece zeroed.  ``qs[i]``/``bases[i]``
    are decode i's pieces, one a row buffer; ``scales[i]`` its 0-d scale
    on the device.  One launch for all the pieces (a launch every 128
    (decode, piece) pairs); returns ``rows``."""
    n, P = len(qs), len(rows)
    if not (len(scales) == len(bases) == n):
        raise ValueError("qs, scales and bases differ in length")
    if any(len(x) != P for x in (*qs, *bases)):
        raise ValueError(f"a decode without one piece for each of the "
                         f"{P} row buffers")
    for r in rows:
        if r.dim() != 2 or r.shape[0] < n or r.shape != rows[0].shape:
            raise ValueError(f"rows {tuple(r.shape)} cannot take {n} rows")
    flat_q = [q for x in qs for q in x]
    flat_b = [b for x in bases for b in x]
    if not use_kernel(*rows, *flat_q, *scales, *flat_b):
        return [ref.reference_dequant_add_rows(
            [x[j] for x in qs], scales, [x[j] for x in bases], r)
            for j, r in enumerate(rows)]
    cap, N = rows[0].shape
    for r in rows:
        check_cuda_tensor(r, "rows", torch.float32, cap * N)
        if N % 4 or r.data_ptr() % 16:
            raise ValueError(f"rows must start on 16 bytes with N % 4 == 0,"
                             f" got N = {N}")
    for q, b in zip(flat_q, flat_b):
        check_cuda_tensor(q, "q", torch.int8, N)
        check_cuda_tensor(b, "base", torch.float32, N)
        if q.data_ptr() % 4 or b.data_ptr() % 16:
            raise ValueError("q must start on 4 bytes and base on 16")
    for s in scales:
        check_cuda_tensor(s, "scale", torch.float32, 1)
    if n == 0 and cap == 0:
        return list(rows)
    from ._build import lib
    status = lib().dequant_add_rows_launch(
        pointer_table(flat_q), pointer_table(scales), pointer_table(flat_b),
        n, cap - n, pointer_table(rows), P, N, _stream(rows[0].device))
    check_status(status, "dequant_add_rows")
    LAUNCHES["decode_rows"] += rows_launches(n, cap - n, P)
    PIECES["decode_rows"] += P
    return list(rows)
