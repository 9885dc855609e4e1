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
