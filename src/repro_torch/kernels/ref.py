"""Plain PyTorch versions of the CUDA kernels (the counterparts of
``repro/kernels/ref.py``).

Each repeats its kernel's arithmetic operation for operation: the fedavg
sums run over the rows in the fixed order 0..W-1, and every multiply and
add is a separate rounded PyTorch op, so on the card the kernels agree
with these bit for bit.  The CPU wrappers run these; ``chip_smoke.py``
holds each kernel against them.  The attention and WKV versions cannot
agree bit for bit (the kernels sum their dot products in another order);
they repeat the kernels' arithmetic in every other respect.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30          # the masked-score sentinel of the attention kernels


def _weighted_rows(stacked: torch.Tensor, weights: torch.Tensor
                   ) -> torch.Tensor:
    """``weights @ stacked`` as ``acc = acc + w[r] * row[r]``, r = 0..W-1.
    Every row is read, zero-weight ones included (0 * inf is NaN, as in
    JAX's contraction)."""
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for r in range(stacked.shape[0]):
        acc = acc + weights[r] * stacked[r]
    return acc


def reference_fedavg(stacked: torch.Tensor, weights: torch.Tensor
                     ) -> torch.Tensor:
    """(W, N) x (W,) -> (N,): ``weights @ stacked``; never reads a server
    buffer."""
    return _weighted_rows(stacked.float(), weights.float())


def reference_fedavg_mix(stacked: torch.Tensor, weights: torch.Tensor,
                         server: torch.Tensor, server_scale
                         ) -> torch.Tensor:
    """``server_scale * server + weights @ stacked``; ``server_scale`` is
    a float or a 0-d tensor."""
    acc = _weighted_rows(stacked.float(), weights.float())
    return server_scale * server.float() + acc


def reference_fedavg_sharded(stacked: torch.Tensor, weights: torch.Tensor,
                             server: torch.Tensor, server_scale,
                             n_shards: int) -> torch.Tensor:
    """The sharded mix's plain version: N sliced into ``n_shards`` equal
    ranges, ``reference_fedavg_mix`` on each, concatenated.  The packed
    (W, N) layout keeps the W-reduce shard-local, so this equals the whole
    ``server_scale * server + weights @ stacked`` bit for bit."""
    W, N = stacked.shape
    if N % n_shards:
        raise ValueError(f"N = {N} not divisible by {n_shards} shards")
    S = N // n_shards
    return torch.cat([
        reference_fedavg_mix(stacked[:, d * S:(d + 1) * S], weights,
                             server[d * S:(d + 1) * S], server_scale)
        for d in range(n_shards)])


def reference_topk_quant_encode(x: torch.Tensor, thresh, scale):
    """Mask ``|x| < thresh``, quantise the rest to int8 (round half to
    even, clipped to +-127), and return ``(q, x - q * scale)``."""
    x = x.float()
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    q = torch.where(x.abs() >= thresh, q, torch.zeros_like(q))
    q = q.to(torch.int8)
    return q, x - q.float() * scale


def reference_dequant_add(q: torch.Tensor, scale, base: torch.Tensor
                          ) -> torch.Tensor:
    """``base + q * scale``: int8 ``q`` dequantised onto ``base``."""
    return base.float() + q.float() * scale


def reference_dequant_mix(q: torch.Tensor, scale, base: torch.Tensor,
                          server: torch.Tensor, wvec: torch.Tensor
                          ) -> torch.Tensor:
    """async_delta's merge of a quantised response, as the chain computes
    it: ``new = reference_dequant_add(q, scale, base)``, then
    ``reference_fedavg_mix`` over the rows ``(new, base)`` with weights
    ``wvec[1:]`` and the server's ``wvec[0]`` (the delta merge's ``[1, 1,
    -1]``: ``server + (new - base)``)."""
    new = reference_dequant_add(q, scale, base)
    return reference_fedavg_mix(torch.stack([new, base.float()]), wvec[1:],
                                server, wvec[0])


def reference_dequant_add_rows(qs, scales, bases, rows: torch.Tensor
                               ) -> torch.Tensor:
    """``rows[i] = bases[i] + qs[i] * scales[i]`` for each of the n
    decodes, then rows n.. zeroed (a stale row's non-finite value would
    turn 0 * inf into NaN in the merge); in place, returns ``rows``."""
    for i, (q, s, b) in enumerate(zip(qs, scales, bases)):
        rows[i] = reference_dequant_add(q, s, b)
    rows[len(qs):].zero_()
    return rows


# The codec's top-k threshold (the JAX package's core/transport.py): exact
# up to SAMPLE_CAP parameters; above, the ks-th largest |x| of a strided
# sample (the DGC trick), floored at THRESH_FLOOR so that an all-zero
# vector selects nothing.
SAMPLE_CAP = 1 << 17
THRESH_FLOOR = 1e-30
# 1/127 rounded to f32 once: ``t / 127.0`` on a CUDA tensor multiplies by
# it (PyTorch divides by a host scalar through its reciprocal), and so does
# XLA; a CPU tensor would divide
INV_127 = float(torch.tensor(1.0) / 127.0)


def sample_plan(size: int, k: int, n_params: int):
    """(stride, m, ks): the threshold of a ``size``-element vector is the
    ks-th largest |x| among the m elements x[::stride]."""
    if n_params <= SAMPLE_CAP:
        return 1, size, k
    stride = max(1, size // SAMPLE_CAP)
    m = (size + stride - 1) // stride
    return stride, m, min(m, max(1, round(m * k / n_params)))


def reference_topk_threshold(x: torch.Tensor, k: int, n_params: int
                             ) -> torch.Tensor:
    """0-d |x| threshold selecting ~the k largest coordinates: exact
    (``torch.topk``) up to SAMPLE_CAP parameters, sampled (``sort``)
    above, floored at THRESH_FLOOR."""
    if n_params <= SAMPLE_CAP:
        t = torch.topk(x.abs(), k).values[-1]
    else:
        stride, _, ks = sample_plan(int(x.shape[0]), k, n_params)
        t = x.abs()[::stride].sort().values[-ks]
    return torch.clamp_min(t, THRESH_FLOOR)


def reference_int8_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-12) / 127`` as a product with INV_127: what the
    chain computes on the card and what XLA computes (a NaN propagates)."""
    return torch.clamp_min(x.abs().max(), 1e-12) * INV_127


def reference_ef_encode(a: torch.Tensor, b: Optional[torch.Tensor] = None,
                        c: Optional[torch.Tensor] = None, *,
                        k: Optional[int], n_params: int, quantize: bool):
    """The error-feedback top-k(+int8) encode as a chain of PyTorch ops:
    ``x = (a - b) + c`` (a missing ``b`` or ``c`` skipped), the threshold
    (``reference_topk_threshold``; 0 when ``k`` is None, the int8 codec),
    the kept count ``sum(|x| >= thresh)``, then with ``quantize`` the
    scale and ``reference_topk_quant_encode``, else the masked recon and
    ``x - recon``.  Returns ``(q or recon, residual, thresh, scale or
    None, kept)``, all on x's device."""
    x = _x_of(a, b, c)
    if k is None:
        thresh = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        thresh = reference_topk_threshold(x, k, n_params)
    kept = torch.sum(x.abs() >= thresh)
    if quantize:
        scale = reference_int8_scale(x)
        q, r = reference_topk_quant_encode(x, thresh, scale)
        return q, r, thresh, scale, kept
    recon = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
    return recon, x - recon, thresh, None, kept


def reference_ef_encode_decoded(a: torch.Tensor, b: torch.Tensor,
                                c: Optional[torch.Tensor] = None, *,
                                k: Optional[int], n_params: int):
    """A quantised encode and its decode against ``b`` as the chain runs
    them: ``reference_ef_encode(a, b, c, quantize=True)``, then
    ``reference_dequant_add(q, scale, b)``, the vector the receiver
    reconstructs (the downlink's ``tx_base``).  Returns ``(q, residual,
    thresh, scale, kept, decoded)``."""
    q, r, thresh, scale, kept = reference_ef_encode(
        a, b, c, k=k, n_params=n_params, quantize=True)
    return q, r, thresh, scale, kept, reference_dequant_add(q, scale, b)


def shard_samples(size: int, n_shards: int, stride: int):
    """Each shard's share of the select's input ``x[::stride]`` of a
    ``size``-element vector split into ``n_shards`` equal pieces: per
    shard ``(off, m)``, its first sampled element at local index ``off``
    (the first global index >= the shard's start that is 0 mod
    ``stride``) and ``m`` sampled elements.  Concatenated in shard order
    the shares are ``x[::stride]``."""
    if size % n_shards:
        raise ValueError(f"N = {size} not divisible by {n_shards} shards")
    s = size // n_shards
    out = []
    for d in range(n_shards):
        off = -(d * s) % stride
        out.append((off, 0 if off >= s else (s - off + stride - 1) // stride))
    return out


def reference_topk_threshold_sharded(xs, k: int, n_params: int,
                                     home: torch.device) -> torch.Tensor:
    """``reference_topk_threshold`` of the vector held as the pieces
    ``xs`` (shard order): each shard's share of the select's input
    (``shard_samples``) concatenated on ``home``, the threshold taken
    there (a 0-d tensor on ``home``)."""
    D = len(xs)
    n = D * int(xs[0].shape[0])
    stride, _, ks = sample_plan(n, k, n_params)
    sample = torch.cat([x[off::stride].to(home) for x, (off, m)
                        in zip(xs, shard_samples(n, D, stride)) if m])
    return reference_ef_select(sample, ks, None,
                               exact=n_params <= SAMPLE_CAP)[0]


def _x_of(a, b, c):
    x = a.float()
    if b is not None:
        x = x - b
    if c is not None:
        x = x + c
    return x


def reference_ef_pass1(a, b=None, c=None, *, off: int = 0, stride: int = 1,
                       m: int = 0, count: bool = False):
    """Pass 1 of the grid form over one piece, as ``ef_pass1`` runs it:
    ``x = (a - b) + c``, the piece's share of the select's input
    ``x[off::stride][:m]``, max |x| (NaN-propagating: what the per-block
    max keys reduce to) and, with ``count`` (the int8 codec, whose
    threshold 0 is known before the pass), the kept count at threshold 0.
    Returns ``(x, sample, max, kept or None)``."""
    x = _x_of(a, b, c)
    xa = x.abs()
    return (x, x[off::stride][:m], xa.max(),
            torch.sum(xa >= 0) if count else None)


def _kth_largest(v: torch.Tensor, ks: int, exact: bool) -> torch.Tensor:
    """The ks-th largest of ``v`` (``torch.topk`` where the threshold is
    exact, a sort on the sampled path, as the reference's select)."""
    if exact:
        return torch.topk(v, ks).values[-1]
    return v.sort().values[-ks]


def reference_ef_select(sample: torch.Tensor, ks: int, maxes, *,
                        exact: bool):
    """The grid form's select, as its cluster launch runs it over the
    gathered sample: the ks-th largest |sample| floored at THRESH_FLOOR,
    and the scale from ``maxes`` (the pieces' max |x|; None: no scale).
    Returns ``(thresh, scale or None)``."""
    t = torch.clamp_min(_kth_largest(sample.abs(), ks, exact), THRESH_FLOOR)
    return t, None if maxes is None else reference_int8_scale(maxes)


def reference_ef_pass2(x: torch.Tensor, thresh, scale=None):
    """Pass 2 over one piece: with ``scale`` ``(q, x - q * scale, kept)``
    (``reference_topk_quant_encode``), else ``(recon, x - recon, kept)``
    with recon x masked to ``|x| >= thresh``; kept ``sum(|x| >=
    thresh)``."""
    kept = torch.sum(x.abs() >= thresh)
    if scale is not None:
        q, r = reference_topk_quant_encode(x, thresh, scale)
        return q, r, kept
    recon = torch.where(x.abs() >= thresh, x, torch.zeros_like(x))
    return recon, x - recon, kept


def reference_ef_encode_sharded(a, b=None, c=None, *, k: Optional[int],
                                n_params: int, quantize: bool,
                                home: torch.device):
    """``reference_ef_encode`` over a vector held as pieces (``a``, ``b``,
    ``c``: sequences of equal (N/D,) pieces in shard order, ``b``/``c``
    None or all present), staged as the grid form's kernels run it: each
    piece's pass 1 (``reference_ef_pass1``: x, its share of the select's
    input ``shard_samples``, its max |x|; for the int8 codec its kept
    count); on ``home`` the shares concatenated and the select and scale
    taken (``reference_ef_select``; threshold 0 for the int8 codec); each
    piece's pass 2 at the threshold and scale copied to its device
    (``reference_ef_pass2``); the kept counts summed on ``home``.  Returns
    ``([q or recon], [residual], thresh, scale or None, kept)``: pieces in
    shard order, the 0-d values on ``home``.  With one piece it is the
    grid form of one vector.  Equals ``reference_ef_encode`` of the whole
    vectors bit for bit: the k-th largest of a multiset, a max and a count
    do not depend on the order they are taken in."""
    D = len(a)
    n = D * int(a[0].shape[0])
    if k is None:
        stride, ks, plan = 1, None, [(0, 0)] * D
    else:
        stride, _, ks = sample_plan(n, k, n_params)
        plan = shard_samples(n, D, stride)
    p1 = [reference_ef_pass1(a[d], None if b is None else b[d],
                             None if c is None else c[d], off=off,
                             stride=stride, m=md, count=k is None)
          for d, (off, md) in enumerate(plan)]
    maxes = (torch.stack([mx.to(home) for _, _, mx, _ in p1]) if quantize
             else None)
    if k is None:
        thresh = torch.zeros((), dtype=torch.float32, device=home)
        scale = None if maxes is None else reference_int8_scale(maxes)
    else:
        sample = torch.cat([s.to(home) for _, s, _, _ in p1])
        thresh, scale = reference_ef_select(sample, ks, maxes,
                                            exact=n_params <= SAMPLE_CAP)
    p2 = [reference_ef_pass2(x, thresh.to(x.device),
                             None if scale is None else scale.to(x.device))
          for x, _, _, _ in p1]
    counts = [k0 for _, _, _, k0 in p1] if k is None else \
        [kd for _, _, kd in p2]
    kept = torch.stack([kd.to(home) for kd in counts]).sum()
    return [o for o, _, _ in p2], [r for _, r, _ in p2], thresh, scale, kept


def reference_server_opt(prev: torch.Tensor, merged: torch.Tensor,
                         m: torch.Tensor, v, scalars, *, adam: bool):
    """The fused server-optimizer step on ``d = merged - prev``.

    momentum form (``adam=False``, scalars ``[am, bm, cd, lr]``):
      ``m' = am*m + bm*d;  new = (prev + cd*d) + lr*m'``
    adam form (``adam=True``, scalars ``[b1, b2, lr, tau, 0, 0]``):
      ``m' = b1*m + (1-b1)*d;  v' = b2*v + ((1-b2)*d)*d;
      new = prev + (lr*m') / (sqrt(v') + tau)``

    Every operation is one rounded f32 op in this order, as in the JAX
    oracle and the CUDA kernel.  Returns ``(new, m', v')`` with ``v'``
    None in the momentum form."""
    f32 = torch.float32
    prev, merged, m = prev.float(), merged.float(), m.float()
    sc = torch.as_tensor(scalars, dtype=f32).to(prev.device)
    d = merged - prev
    if adam:
        mo = sc[0] * m + (1.0 - sc[0]) * d
        vo = sc[1] * v.to(f32) + (1.0 - sc[1]) * d * d
        return prev + sc[2] * mo / (torch.sqrt(vo) + sc[3]), mo, vo
    mo = sc[0] * m + sc[1] * d
    return prev + sc[2] * d + sc[3] * mo, mo, None


def reference_merge_opt(stacked: torch.Tensor, wvec: torch.Tensor,
                        server: Optional[torch.Tensor], prev: torch.Tensor,
                        m: torch.Tensor, v, scalars, *, adam: bool):
    """The merge and the server optimizer's step as one function: the
    plain chain, ``reference_fedavg(stacked, wvec)`` (``server`` None: the
    aggregate) or ``reference_fedavg_mix(stacked, wvec[1:], server,
    wvec[0])`` (the mix), then ``reference_server_opt`` on its result.
    Every result is computed before the caller writes any, so ``prev``
    may be ``server``.  Returns ``(new, m', v')``."""
    if server is None:
        merged = reference_fedavg(stacked, wvec)
    else:
        merged = reference_fedavg_mix(stacked, wvec[1:], server, wvec[0])
    return reference_server_opt(prev, merged, m, v, scalars, adam=adam)


def _slices(n: int, n_shards: int):
    if n % n_shards:
        raise ValueError(f"N = {n} not divisible by {n_shards} shards")
    s = n // n_shards
    return [slice(d * s, (d + 1) * s) for d in range(n_shards)]


def _cat_steps(steps):
    news, mos, vos = zip(*steps)
    return (torch.cat(news), torch.cat(mos),
            None if vos[0] is None else torch.cat(vos))


def reference_server_opt_sharded(prev: torch.Tensor, merged: torch.Tensor,
                                 m: torch.Tensor, v, scalars, *,
                                 adam: bool, n_shards: int):
    """The sharded optimizer step's plain version: ``reference_server_opt``
    on each of ``n_shards`` equal ranges of N, concatenated (the update is
    elementwise, so this is the whole step bit for bit)."""
    return _cat_steps(
        reference_server_opt(prev[sl], merged[sl], m[sl],
                             None if v is None else v[sl], scalars,
                             adam=adam)
        for sl in _slices(prev.shape[-1], n_shards))


def reference_merge_opt_sharded(stacked: torch.Tensor, wvec: torch.Tensor,
                                server: Optional[torch.Tensor],
                                prev: torch.Tensor, m: torch.Tensor, v,
                                scalars, *, adam: bool, n_shards: int):
    """``reference_merge_opt`` on each of ``n_shards`` equal ranges of N,
    concatenated: the sharded fused merge's plain version."""
    return _cat_steps(
        reference_merge_opt(stacked[:, sl], wvec,
                            None if server is None else server[sl],
                            prev[sl], m[sl], None if v is None else v[sl],
                            scalars, adam=adam)
        for sl in _slices(stacked.shape[1], n_shards))


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                   window: int) -> torch.Tensor:
    """(len(qpos), len(kpos)) bool: which keys each query may see."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """O(S^2) attention, the counterpart of the JAX package's
    ``reference_attention``.  q: (B,S,H,D); k, v: (B,T,Kv,D); query head h
    reads KV head ``h // (H // Kv)``.  Computed in f32, returned in q's
    dtype."""
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(max(S, T), device=q.device)
    s = torch.where(attention_mask(pos[:S], pos[:T], causal, window), s,
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def reference_flash_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0
                              ) -> torch.Tensor:
    """The plain version of the flash-attention kernel (B8): online softmax
    over KV tiles of 64 keys, every query row at once.

    The kernel's arithmetic: q cast to f32 and scaled by ``1/sqrt(D)``
    before ``q k^T``; then ``softcap * tanh(s / softcap)``; then the
    causal / window mask with the finite sentinel -1e30; ``(m, l, acc)``
    and P in f32; ``acc / max(l, 1e-30)`` cast to q's dtype.  The kernel
    skips the tiles that lie wholly outside a query tile's band and sizes
    its tiles by head_dim; here every tile is visited, which changes
    nothing: a fully masked tile before the band adds terms that the first
    real key multiplies by ``exp(-1e30 - m) = 0``, and one after it adds
    ``exp(-1e30 - m) = 0``.
    q: (B,S,H,D); k, v: (B,T,Kv,D); head h reads KV head ``h // (H//Kv)``.
    """
    B, S, H, D = q.shape
    T, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    f32 = torch.float32
    qf = (q.to(f32) * (1.0 / math.sqrt(D))).reshape(B, S, Kv, rep, D)
    m = torch.full((B, Kv, rep, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Kv, rep, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, Kv, rep, S, D), dtype=f32, device=q.device)
    pos = torch.arange(max(S, T), device=q.device)
    block_k = 64
    for k0 in range(0, T, block_k):
        kb = k[:, k0:k0 + block_k].to(f32)                  # (B,bk,Kv,D)
        vb = v[:, k0:k0 + block_k].to(f32)
        s = torch.einsum("bsgrd,bkgd->bgrsk", qf, kb)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = attention_mask(pos[:S], pos[k0:k0 + block_k], causal, window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrsk,bkgd->bgrsd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,Kv,rep,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


TRAIN_TILE = 64          # the training pair's tile of queries and keys


def _train_mask(pos: torch.Tensor, kpos: torch.Tensor,
                skip_tile: Optional[int]) -> torch.Tensor:
    """Causal mask of the training pair; ``skip_tile``, a fault for the
    checks, drops the diagonal tile (query tile = key tile = skip_tile)."""
    mask = pos[:, None] >= kpos[None, :]
    if skip_tile is not None:
        mask &= ~((pos[:, None] // TRAIN_TILE == skip_tile)
                  & (kpos[None, :] // TRAIN_TILE == skip_tile))
    return mask


def reference_flash_train_fwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              skip_tile: Optional[int] = None):
    """The plain version of the training pair's forward: causal attention,
    positions from 0, (o, lse).

    The kernel's arithmetic, tile by tile over 64 keys: ``s = (q k^T) *
    1/sqrt(D)`` in f32 from the exactly converted operands (the scale
    after the product, as ``mha_chunked``); the online softmax's (m, l)
    in f32; P rounded to bf16 once, relative to the running max, before
    ``P V`` (as ``mha_chunked`` rounds it relative to its block's); ``o =
    acc / l`` in q's dtype and ``lse = m + log(l)`` f32 (B, H, S).
    q: (B,S,H,D); k, v: (B,S,Kv,D); head h reads KV head ``h // (H//Kv)``.
    """
    B, S, H, D = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(D)
    qf = q.to(f32).reshape(B, S, Kv, rep, D)
    m = torch.full((B, Kv, rep, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Kv, rep, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, Kv, rep, S, D), dtype=f32, device=q.device)
    pos = torch.arange(S, device=q.device)
    for k0 in range(0, S, TRAIN_TILE):
        kb = k[:, k0:k0 + TRAIN_TILE].to(f32)
        vb = v[:, k0:k0 + TRAIN_TILE].to(f32)
        s = torch.einsum("bsgrd,bkgd->bgrsk", qf, kb) * scale
        s = torch.where(_train_mask(pos, pos[k0:k0 + TRAIN_TILE], skip_tile),
                        s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrsk,bkgd->bgrsd", p.to(torch.bfloat16).to(f32), vb)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    o = (acc / den[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return o.to(q.dtype), (m + torch.log(den)).reshape(B, H, S)


def reference_flash_train_bwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              split_ds: bool = True,
                              skip_tile: Optional[int] = None):
    """The plain version of the training pair's backward: (dq, dk, dv).

    The kernels' arithmetic in f32 from the bf16 operands: ``P = exp(s -
    lse)`` (masked: 0), ``dV = bf16(P)^T dO``, ``dP = dO V^T``, ``D =
    rowsum(dO o O)``, ``dS = P (dP - D)`` taken to f32 accuracy as ``hi =
    bf16(dS)`` plus ``lo = bf16(dS - hi)`` (whose sum is exact in f32, so
    one product stands for the kernels' two), ``dQ = scale dS K``, ``dK =
    scale dS^T Q``; GQA sums dK and dV over the query heads of a KV head
    in f32; each cast to its input's dtype once.  ``split_ds=False`` (dS
    as one bf16 term) and ``skip_tile`` are faults for the checks."""
    B, S, H, D = q.shape
    Kv = k.shape[2]
    rep = H // Kv
    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(D)
    qf, dof = q.to(f32), do.to(f32)
    kr = k.to(f32).repeat_interleave(rep, dim=2)
    vr = v.to(f32).repeat_interleave(rep, dim=2)
    pos = torch.arange(S, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    p = torch.where(_train_mask(pos, pos, skip_tile),
                    torch.exp(s - lse[..., None]), 0.0)
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(bf16).to(f32), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    dlt = (dof * o.to(f32)).sum(-1).permute(0, 2, 1)          # (B,H,S)
    ds = p * (dp - dlt[..., None])
    del p, dp
    hi = ds.to(bf16).to(f32)
    if split_ds:
        hi = hi + (ds - hi).to(bf16).to(f32)
    del ds
    dq = torch.einsum("bhqk,bkhd->bqhd", hi, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", hi, qf) * scale

    def per_kv(t):
        return t.reshape(B, S, Kv, rep, D).sum(dim=3)
    return (dq.to(q.dtype), per_kv(dk).to(k.dtype), per_kv(dv).to(v.dtype))


def reference_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The sequential WKV recurrence, the ground truth of the chunked forms
    (the counterpart of the JAX package's ``reference_wkv``): for each t,
    ``y_t = r_t . (state + u k_t v_t^T)``, then ``state = state * w_t +
    k_t v_t^T``, from a zero state, in f32.  r, k, v, w: (B,S,H,K); u:
    (H,K).  Returns y (B,S,H,K) in r's dtype."""
    f32 = torch.float32
    B, S, H, K = r.shape
    r, k, v, w = (t.to(f32) for t in (r, k, v, w))
    uf = u.to(f32)[None, :, :, None]
    state = torch.zeros((B, H, K, K), dtype=f32, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + uf * kv))
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1).to(r.dtype)


def reference_wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          w: torch.Tensor, u: torch.Tensor, chunk: int = 16,
                          *, s0: Optional[torch.Tensor] = None,
                          return_state: bool = False):
    """The plain version of the WKV kernel (B9): the arithmetic of the TPU
    kernel ``_wkv_kernel`` and of the model's ``wkv_chunked``, every
    (batch, head) at once, chunk after chunk from the (K, K) state ``s0``
    (zeros when None).

    Per chunk, in f32: ``lw = log(clip(w, 1e-12, 1))``; the exclusive
    cumsum ``A = cumsum(lw) - lw`` and ``Atot = A[-1] + lw[-1]``; the
    pairwise decays ``exp(A_t - A_i - lw_i)`` kept for ``i < t`` only;
    ``y = scores @ v + (r . u k) v``, then ``y += (r exp(A)) @ state``
    (the state as it was before this chunk); then ``state = state
    exp(Atot) + (k exp(Atot - A - lw))^T @ v``.
    r, k, v, w: (B,S,H,K) with ``S % min(chunk, S) == 0``; u: (H,K); s0:
    (B,H,K,K).  Returns y (B,S,H,K) in r's dtype, and with
    ``return_state`` also the final state (B,H,K,K) f32."""
    f32 = torch.float32
    B, S, H, K = r.shape
    C = min(chunk, S)
    uf = u.to(f32)[None, :, None, :]                            # (1,H,1,K)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, None, :, :, None]       # i < t
    state = (torch.zeros((B, H, K, K), dtype=f32, device=r.device)
             if s0 is None else s0.to(f32))
    ys = []
    for c0 in range(0, S, C):
        rb, kb, vb, wb = (t[:, c0:c0 + C].transpose(1, 2).to(f32)
                          for t in (r, k, v, w))                # (B,H,C,K)
        lw = torch.log(torch.clamp(wb, 1e-12, 1.0))
        A = torch.cumsum(lw, dim=2) - lw
        Atot = A[:, :, -1] + lw[:, :, -1]                       # (B,H,K)
        D = A[:, :, :, None, :] - A[:, :, None, :, :] - lw[:, :, None, :, :]
        E = torch.where(tri, torch.exp(D), 0.0)                 # (B,H,C,C,K)
        scores = torch.einsum("bhtk,bhtik,bhik->bhti", rb, E, kb)
        diag = torch.sum(rb * uf * kb, dim=-1)                  # (B,H,C)
        y = scores @ vb + diag[..., None] * vb
        y = y + (rb * torch.exp(A)) @ state
        kdec = kb * torch.exp(Atot[:, :, None, :] - A - lw)
        state = state * torch.exp(Atot)[..., None] + \
            kdec.transpose(2, 3) @ vb
        ys.append(y.transpose(1, 2))
    y = torch.cat(ys, dim=1).to(r.dtype)
    return (y, state) if return_state else y
