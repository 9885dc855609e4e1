"""Mamba-2 (SSD) block [arXiv:2405.21060] for the zamba2 hybrid backbone
(port of ``repro/models/mamba2.py``).

Scalar-per-head data-dependent decay, outer-product state (head_dim x
state), causal depthwise conv stem; a chunk-parallel scan for train and
prefill (``ssd_chunked``) and an O(1)-state decode step (``ssd_step``).
Projections stay split (z / x / B / C / dt) and the depthwise conv in an
x-conv and a BC-conv, the JAX package's layout.

Plain PyTorch: JAX has no Pallas kernel here.  The scan keeps JAX's f32
and its ``-inf``-masked intra-chunk decay; the intra-chunk products of
every chunk are computed at once, and the state is carried chunk by chunk
as ``lax.scan`` carries it.
"""
from __future__ import annotations

import torch

from .layers import dense_init, silu

CONV_K = 4


def mamba2_init(generator: torch.Generator, d_model: int, *, expand: int = 2,
                head_dim: int = 64, n_state: int = 64, lead=(),
                device=None) -> dict:
    """One block's parameters in bf16 (the JAX package's f32 draws cast as
    its tree is): projections ``normal / sqrt(fan_in)``, conv weights
    ``normal * 0.2``, biases and ``a_log`` 0, ``d_skip`` and ``norm_scale``
    1; ``lead`` prepends stacking axes."""
    lead = tuple(lead)
    d_in = expand * d_model
    nh = d_in // head_dim
    bf16 = torch.bfloat16

    def dense(shape):
        return dense_init(generator, lead + shape, shape[0], device)

    def normal(shape, std):
        w = torch.randn(lead + shape, generator=generator,
                        dtype=torch.float32, device=generator.device) * std
        return w.to(device=device, dtype=bf16)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=bf16, device=device)
    return {
        "wz": dense((d_model, d_in)),
        "wx": dense((d_model, d_in)),
        "wB": dense((d_model, n_state)),
        "wC": dense((d_model, n_state)),
        "wdt": dense((d_model, nh)),
        "conv_x_w": normal((CONV_K, d_in), 0.2),
        "conv_x_b": full((d_in,), 0.0),
        "conv_bc_w": normal((CONV_K, 2 * n_state), 0.2),
        "conv_bc_b": full((2 * n_state,), 0.0),
        "dt_bias": full((nh,), 0.0),
        "a_log": full((nh,), 0.0),
        "d_skip": full((nh,), 1.0),
        "norm_scale": full((d_in,), 1.0),
        "out_proj": dense((d_in, d_model)),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv.  x: (B,S,C); w: (K,C).  Returns (y, the last
    K-1 inputs as the new state), op by op in x's dtype as JAX computes."""
    B, S, C = x.shape
    if conv_state is None:
        conv_state = torch.zeros((B, CONV_K - 1, C), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, CONV_K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = silu(y + b.to(x.dtype))
    return y, xp[:, -(CONV_K - 1):]


def ssd_chunked(xh, Bm, Cm, dt, la, s0=None, chunk: int = 32):
    """SSD scan.  xh: (B,S,nh,hd); Bm, Cm: (B,S,n); dt, la: (B,S,nh) with
    la the log decay; s0: (B,nh,hd,n) f32 or None (zeros).  Returns (y in
    xh's dtype, the final state (B,nh,hd,n) f32)."""
    Bsz, S, nh, hd = xh.shape
    n = Bm.shape[-1]
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"S ({S}) must be a multiple of the chunk ({C})")
    nc = S // C
    f32 = torch.float32
    xc = xh.to(f32).reshape(Bsz, nc, C, nh, hd).permute(0, 1, 3, 2, 4)
    bc = Bm.to(f32).reshape(Bsz, nc, C, n)                 # (B,c,C,n)
    cc = Cm.to(f32).reshape(Bsz, nc, C, n)
    dtc = dt.to(f32).reshape(Bsz, nc, C, nh).transpose(2, 3)   # (B,c,h,C)
    lac = la.to(f32).reshape(Bsz, nc, C, nh).transpose(2, 3)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=xh.device))

    A = torch.cumsum(lac, dim=-1)                           # inclusive
    Atot = A[..., -1]                                       # (B,c,h)
    # intra-chunk, every chunk at once: decay(i -> t) = exp(A_t - A_i)
    G = A[..., :, None] - A[..., None, :]
    G = torch.where(tri, G, -torch.inf)
    cb = torch.einsum("bctn,bcin->bcti", cc, bc)            # (B,c,C,C)
    scores = torch.exp(G) * cb[:, :, None] * dtc[..., None, :]
    y = torch.einsum("bchti,bchid->bchtd", scores, xc)
    # each chunk's own contribution to the state it hands on
    wgt = torch.exp(Atot[..., None] - A) * dtc              # (B,c,h,C)
    own = torch.einsum("bchi,bchid,bcin->bchdn", wgt, xc, bc)
    decay = torch.exp(Atot)[..., None, None]                # (B,c,h,1,1)
    # the carry, chunk by chunk: the state each chunk reads, then the next
    state = (torch.zeros((Bsz, nh, hd, n), dtype=f32, device=xh.device)
             if s0 is None else s0.to(f32))
    reads = []
    for c in range(nc):
        reads.append(state)
        state = state * decay[:, c] + own[:, c]
    reads = torch.stack(reads, dim=1)                       # (B,c,h,hd,n)
    y = y + torch.exp(A)[..., None] * torch.einsum("bchdn,bctn->bchtd",
                                                   reads, cc)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, nh, hd)
    return y.to(xh.dtype), state


def ssd_step(xh, Bm, Cm, dt, la, state):
    """One decode step.  xh: (B,nh,hd); Bm, Cm: (B,n); dt, la: (B,nh);
    state (B,nh,hd,n) f32.  Returns (y (B,nh,hd) f32, new state)."""
    f32 = torch.float32
    xh, Bm, Cm, dt, la = (t.to(f32) for t in (xh, Bm, Cm, dt, la))
    decay = torch.exp(la)
    state = state * decay[..., None, None] + \
        torch.einsum("bh,bhd,bn->bhdn", dt, xh, Bm)
    y = torch.einsum("bhdn,bn->bhd", state, Cm)
    return y, state


def mamba2_apply(params, x, *, expand: int = 2, head_dim: int = 64,
                 n_state: int = 64, state=None, chunk: int = 32):
    """x: (B,S,D); state: None or dict(conv_x, conv_bc, ssm).  Returns
    (out (B,S,D) in x's dtype, the new state dict)."""
    dt_ = x.dtype
    B, S, D = x.shape
    d_in = expand * D
    nh = d_in // head_dim
    z = x @ params["wz"].to(dt_)
    xr = x @ params["wx"].to(dt_)
    Bm = x @ params["wB"].to(dt_)
    Cm = x @ params["wC"].to(dt_)
    dt_raw = x @ params["wdt"].to(dt_)

    cx = state["conv_x"] if state is not None else None
    cbc = state["conv_bc"] if state is not None else None
    xr, new_cx = _causal_conv(xr, params["conv_x_w"], params["conv_x_b"], cx)
    bc = torch.cat([Bm, Cm], dim=-1)
    bc, new_cbc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"],
                               cbc)
    Bm, Cm = torch.chunk(bc, 2, dim=-1)

    f32 = torch.float32
    # jax.nn.softplus is logaddexp(x, 0)
    pre = dt_raw.to(f32) + params["dt_bias"].to(f32)
    dt_v = torch.logaddexp(pre, torch.zeros((), dtype=f32, device=x.device))
    la = -dt_v * torch.exp(params["a_log"].to(f32))          # log decay
    xh = xr.reshape(B, S, nh, head_dim)

    if state is not None and S == 1:
        y, ssm = ssd_step(xh[:, 0], Bm[:, 0], Cm[:, 0], dt_v[:, 0], la[:, 0],
                          state["ssm"])
        y = y[:, None]
    else:
        s0 = state["ssm"] if state is not None else None
        y, ssm = ssd_chunked(xh, Bm, Cm, dt_v, la, s0, chunk=chunk)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * \
        xh.to(y.dtype)
    y = y.reshape(B, S, d_in)

    # gated RMSNorm, then the out-projection
    y = y.to(f32) * silu(z.to(f32))
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * params["norm_scale"].to(f32)
    out = y.to(dt_) @ params["out_proj"].to(dt_)
    return out, {"conv_x": new_cx, "conv_bc": new_cbc, "ssm": ssm}
