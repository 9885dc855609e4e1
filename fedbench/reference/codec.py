"""Plain reference of the error-feedback top-k + int8 codec over one flat
f32 vector, as the codec documents it.

The vector is zero-padded to a multiple of 512.  The threshold is the k-th
largest |x| (k = max(1, floor(n * frac)) of the n unpadded entries): exact
up to 2**17 entries; above, the ks-th largest |x| among x[::stride] with
stride = padded // 2**17 and ks = round(m k / n) of the m sampled entries;
floored at 1e-30.  Kept entries (|x| >= threshold) are quantised with
one scale, max(max|x|, 1e-12) times float32(1/127), rounded half to even
and clipped to +-127.  The reconstruction is q * scale; the residual,
x - reconstruction, is the next call's error feedback.
"""
from __future__ import annotations

import torch

PAD = 512
SAMPLE_CAP = 1 << 17
FLOOR = 1e-30
INV_127 = float(torch.tensor(1.0, dtype=torch.float32) / 127.0)


def threshold(x: torch.Tensor, k: int, n: int) -> torch.Tensor:
    a = x.abs()
    if n <= SAMPLE_CAP:
        t = torch.topk(a[:n], k).values[-1]
    else:
        stride = max(1, x.numel() // SAMPLE_CAP)
        s = a[::stride]
        m = s.numel()
        ks = min(m, max(1, round(m * k / n)))
        t = torch.sort(s).values[-ks]
    return torch.clamp_min(t, FLOOR)


class ErrorFeedbackTopkInt8:
    """The codec's state (the residual) and one encode a call."""

    def __init__(self, frac: float):
        self.frac = frac
        self.residual = None

    def __call__(self, delta: torch.Tensor) -> torch.Tensor:
        """The reconstruction of ``delta + residual`` (same shape as
        ``delta``); the residual updates."""
        n = delta.numel()
        size = -(-n // PAD) * PAD
        x = torch.zeros(size, dtype=torch.float32, device=delta.device)
        x[:n] = delta.reshape(-1)
        if self.residual is not None:
            x += self.residual
        t = threshold(x, max(1, int(n * self.frac)), n)
        scale = torch.clamp_min(x.abs().max(), 1e-12) * INV_127
        q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
        q = torch.where(x.abs() >= t, q, torch.zeros_like(q))
        recon = q * scale
        self.residual = x - recon
        return recon[:n].reshape(delta.shape)
