"""Plain reference of pod-level FedAvg over a pre-norm decoder LM trained by
AdamW (musicgen-medium's block stack: RMSNorm, rotary multi-head causal
attention, a SiLU-gated MLP, a tied output head over precomputed frame
embeddings).

The parameter tree is ``{"embed": {"embedding": (V, d)}, "final_norm":
{"scale": (d,)}, "blocks": {"ln1", "ln2": {"scale": (L, d)}, "attn":
{"wq", "wk", "wv": (L, d, H, hd), "wo": (L, H, hd, d)}, "mlp": {"wi_gate",
"wi_up": (L, d, f), "wo": (L, f, d)}}}`` in bfloat16, the precision the
configuration states for the forward and backward passes; norms, rotary
angles, attention scores and the loss are float32, and the optimizer keeps
float32 master weights and moments.

``precision="fp8"`` is the control: every bfloat16 matrix product takes its
operands through float8 e4m3 (one scale a tensor, amax / 448) first.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
F32 = torch.float32
E4M3_MAX = 448.0


def flat(tree, prefix=""):
    """[(path, tensor)] of a nested dict, keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(flat(v, p + "."))
        else:
            out.append((p, v))
    return out


def rebuild(tree, values: Dict[str, torch.Tensor], prefix=""):
    return {k: (rebuild(v, values, f"{prefix}{k}.") if isinstance(v, dict)
                else values[f"{prefix}{k}"]) for k, v in tree.items()}


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(t.detach().abs().amax().float(), 1e-30) / E4M3_MAX
    q = (t.float() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q.to(t.dtype) - t).detach()      # straight-through gradient


def _mm(precision: str) -> Callable:
    if precision == "bf16":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: torch.matmul(_fp8(a), _fp8(b))
    raise ValueError(precision)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """(B, S, H, hd): the two halves of each head rotated by position."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device, dtype=F32) / hd)
    ang = torch.arange(S, device=x.device, dtype=F32)[:, None] * inv
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x.float().chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1).to(x.dtype)


def block(p: dict, x: torch.Tensor, mm: Callable) -> torch.Tensor:
    B, S, d = x.shape
    H, hd = p["attn"]["wq"].shape[-2:]
    h = rmsnorm(p["ln1"]["scale"], x)
    q, k, v = (mm(h, p["attn"][n].reshape(d, -1)).reshape(B, S, -1, hd)
               for n in ("wq", "wk", "wv"))
    q, k = rope(q), rope(k)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", att.to(v.dtype).float(), v.float())
    x = x + mm(o.to(x.dtype).reshape(B, S, H * hd),
               p["attn"]["wo"].reshape(H * hd, d))
    h = rmsnorm(p["ln2"]["scale"], x)
    g = mm(h, p["mlp"]["wi_gate"])
    u = mm(h, p["mlp"]["wi_up"])
    return x + mm(g * torch.sigmoid(g) * u, p["mlp"]["wo"])


def loss(params: dict, embeds: torch.Tensor, labels: torch.Tensor,
         precision: str = "bf16") -> torch.Tensor:
    """Mean next-frame cross-entropy over every position."""
    mm = _mm(precision)
    x = embeds.to(BF16)
    blocks = params["blocks"]
    L = blocks["ln1"]["scale"].shape[0]
    for i in range(L):
        p = {g: {n: t[i] for n, t in sub.items()} for g, sub in blocks.items()}
        x = torch.utils.checkpoint.checkpoint(block, p, x, mm,
                                              use_reentrant=False)
    x = rmsnorm(params["final_norm"]["scale"], x)
    logit = mm(x, params["embed"]["embedding"].t()).float()
    return F.cross_entropy(logit.reshape(-1, logit.shape[-1]),
                           labels.reshape(-1).long())


def grads(params: dict, embeds: torch.Tensor, labels: torch.Tensor, *,
          precision: str = "bf16", rows: int = 8):
    """(loss, {path: f32 gradient}) over the batch, ``rows`` sequences at a
    time (each block's share weighted by its rows)."""
    named = flat(params)
    live = {n: t.detach().requires_grad_(True) for n, t in named}
    tree = rebuild(params, live)
    acc = {n: torch.zeros(t.shape, dtype=F32, device=t.device)
           for n, t in named}
    total, B = 0.0, embeds.shape[0]
    for r in range(0, B, rows):
        w = min(rows, B - r) / B
        with torch.enable_grad():
            l = loss(tree, embeds[r:r + rows], labels[r:r + rows], precision)
            gs = torch.autograd.grad(l, [live[n] for n, _ in named])
        for (n, _), g in zip(named, gs):
            acc[n].add_(g.float(), alpha=w)
        total += float(l.detach()) * w
    return total, acc


class AdamW:
    """AdamW with global-norm clipping and float32 master weights; the live
    parameters are the masters cast to bfloat16."""

    def __init__(self, params: dict, *, lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, clip_norm: float):
        self.hp = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=weight_decay,
                       clip=clip_norm)
        self.master = {n: t.float().clone() for n, t in flat(params)}
        self.m = {n: torch.zeros_like(t) for n, t in self.master.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.master.items()}
        self.t = 0

    def step(self, g: Dict[str, torch.Tensor]) -> None:
        hp = self.hp
        self.t += 1
        gn = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        clip = torch.clamp(hp["clip"] / torch.clamp_min(gn, 1e-9), max=1.0)
        c1 = 1 - hp["b1"] ** self.t
        c2 = 1 - hp["b2"] ** self.t
        for n, mast in self.master.items():
            gc = g[n] * clip
            self.m[n].mul_(hp["b1"]).add_(gc, alpha=1 - hp["b1"])
            self.v[n].mul_(hp["b2"]).addcmul_(gc, gc, value=1 - hp["b2"])
            u = (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + hp["eps"])
            mast.sub_(hp["lr"] * (u + hp["wd"] * mast))

    def live(self, like: dict) -> dict:
        return rebuild(like, {n: t.to(BF16) for n, t in self.master.items()})


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def run_pods(w0: dict, batches: List[tuple], *, n_pods: int,
             merge_after: List[int], compress: Optional[Callable],
             opt_kw: dict, precision: str = "bf16", rows: int = 8
             ) -> dict:
    """Pod FedAvg from the shared initial parameters ``w0``.

    ``batches[s]`` is the step's (embeds, labels) over all pods' rows; pod
    i trains on its consecutive share.  After the steps listed in
    ``merge_after`` (1-based), the pods' live parameters are averaged with
    equal weights and every pod's live parameters become the merge; the
    optimizer's masters are left as they are.  With ``compress`` (a
    function of the (n_pods, N) f32 deltas from the last merge, returning
    their reconstructions), the merge is the anchor plus the mean of the
    compressed deltas; the anchor starts at ``w0`` and is then the last
    merge.

    Returns the step losses of each pod (``losses[pod][step]``), and norms
    leaf by leaf: of each pod's first clipped gradient as the optimizer
    takes it (``first_grad``), of each pod's masters minus ``w0`` after the
    last step (``change``), and of each merge minus ``w0`` (``merges``)."""
    base = dict(flat(w0))
    opts = [AdamW(w0, **opt_kw) for _ in range(n_pods)]
    live = [w0 for _ in range(n_pods)]
    anchor = torch.cat([t.float().reshape(-1) for t in base.values()])
    losses = [[] for _ in range(n_pods)]
    first_grad, merges = [], []
    for s, (emb, lab) in enumerate(batches, start=1):
        per = emb.shape[0] // n_pods
        for i in range(n_pods):
            l, g = grads(live[i], emb[i * per:(i + 1) * per],
                         lab[i * per:(i + 1) * per], precision=precision,
                         rows=rows)
            opts[i].step(g)
            del g
            losses[i].append(l)
            if s == 1:
                b1 = opts[i].hp["b1"]
                first_grad.append({n: _norm(m / (1 - b1))
                                   for n, m in opts[i].m.items()})
            live[i] = opts[i].live(w0)
        if s in merge_after:
            stacked = torch.stack([
                torch.cat([t.float().reshape(-1) for _, t in flat(p)])
                for p in live])
            if compress is None:
                merged = stacked.mean(0)
            else:
                merged = anchor + compress(stacked - anchor).mean(0)
            del stacked
            merged = merged.to(BF16)
            anchor = merged.float()
            out, off = {}, 0
            for n, t in base.items():
                out[n] = merged[off:off + t.numel()].reshape(t.shape)
                off += t.numel()
            merges.append({n: _norm(out[n].float() - base[n].float())
                           for n in base})
            live = [rebuild(w0, out) for _ in range(n_pods)]
    change = [{n: _norm(o.master[n] - base[n].float()) for n in base}
              for o in opts]
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "merges": merges}
