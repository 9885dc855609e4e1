"""Fused server-optimizer step over packed f32 vectors.

``server_opt_step_flat`` replaces the TPU kernels of
``repro/kernels/fedavg_agg.py::server_opt_step_flat``: the momentum form
(FedAvgM, FedDyn) and the adam form (FedAdam), one elementwise pass on
``d = merged - prev``.  On a CUDA tensor it launches
``csrc/server_opt.cu``; on a CPU tensor it runs the plain version in
``ref.py``.  See the CUDA source for the design and its bound.  The FL
paths take the same step inside the merge's own launch
(``fedavg_agg.merge_opt_flat``); this pass of its own is
``ServerOpt.step_vec``, the oracle of the tests.  ``server_opt_step_pieces``
is the step over equal-width pieces on one device, one launch for all (the
sharded step, ``fedavg_agg.server_opt_step_flat_sharded``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import (check_cuda_tensor, check_status, group_launches,
               output_tensor, pointer_table, ref, use_kernel)

# kernel launches by form, and the pieces those launches covered: a run
# shows it went through the kernels
LAUNCHES = {"mom": 0, "adam": 0}
PIECES = dict(LAUNCHES)


def server_opt_step_pieces(prevs: Sequence[torch.Tensor],
                           mergeds: Sequence[torch.Tensor],
                           ms: Sequence[torch.Tensor],
                           vs: Optional[Sequence[torch.Tensor]], scalars, *,
                           adam: bool, m_outs: Optional[Sequence] = None,
                           v_outs: Optional[Sequence] = None):
    """``server_opt_step_flat`` for each piece (every operand a sequence
    of equal-width pieces on one device, ``vs`` None unless ``adam``), one
    launch for all.  Returns ``(news, m's, v's)``, lists of the pieces'
    results (``v's`` Nones unless ``adam``); ``m_outs``/``v_outs`` are
    None or one entry a piece, as ``server_opt_step_flat``'s."""
    sc = np.asarray(scalars, np.float32).reshape(-1)
    if sc.size != (6 if adam else 4):
        raise ValueError(f"expected {6 if adam else 4} scalars, got {sc.size}")
    n = len(prevs)
    vs = list(vs) if adam else [None] * n
    m_outs = [None] * n if m_outs is None else list(m_outs)
    v_outs = [None] * n if v_outs is None or not adam else list(v_outs)
    tensors = [t for t in (*prevs, *mergeds, *ms, *vs) if t is not None]
    if not use_kernel(*tensors):
        news, mos, vos = [], [], []
        for p, g, m, v, mo, vo in zip(prevs, mergeds, ms, vs, m_outs,
                                      v_outs):
            new, m1, v1 = ref.reference_server_opt(p, g, m, v, sc, adam=adam)
            news.append(new)
            mos.append(m1 if mo is None else mo.copy_(m1))
            vos.append(v1 if not adam or vo is None else vo.copy_(v1))
        return news, mos, vos
    from ._build import lib
    N = prevs[0].numel()
    news = []
    for i, (p, g, m, v) in enumerate(zip(prevs, mergeds, ms, vs)):
        for t, name in ((p, "prev"), (g, "merged"), (m, "m"), (v, "v")):
            if t is not None:
                check_cuda_tensor(t, name, torch.float32, N)
        news.append(torch.empty_like(p))
        # m_out may be m itself, v_out v, and no other input
        m_outs[i] = output_tensor(m_outs[i], m, "m_out", (p, g, v))
        if adam:
            v_outs[i] = output_tensor(v_outs[i], v, "v_out", (p, g, m))
    table = pointer_table(prevs, mergeds, ms, vs if adam else None, news,
                          m_outs, v_outs if adam else None)
    stream = torch.cuda.current_stream(prevs[0].device).cuda_stream
    form = "adam" if adam else "mom"
    status = getattr(lib(), f"server_opt_{form}_launch")(
        table, n, *(float(x) for x in sc[:4]), N, stream)
    check_status(status, f"server_opt_step_flat"
                         f"({'adam' if adam else 'momentum'})")
    LAUNCHES[form] += group_launches(n)
    PIECES[form] += n
    return news, m_outs, v_outs


def server_opt_step_flat(prev: torch.Tensor, merged: torch.Tensor,
                         m: torch.Tensor, v: Optional[torch.Tensor],
                         scalars, *, adam: bool,
                         m_out: Optional[torch.Tensor] = None,
                         v_out: Optional[torch.Tensor] = None):
    """One optimizer step over ``(N,)`` f32 vectors; returns ``(new, m',
    v')`` with ``v'`` None when ``adam`` is False.

    ``scalars`` (host values, f32): ``[am, bm, cd, lr]`` for the momentum
    form, ``[b1, b2, lr, tau, 0, 0]`` for the adam form.  ``m_out`` /
    ``v_out`` may be ``m`` / ``v`` themselves (the state updates in place)
    or None for new vectors; ``new`` is always a new vector.  On the CPU
    the results are computed out of place and copied into the outputs
    that were given."""
    news, mos, vos = server_opt_step_pieces(
        [prev], [merged], [m], [v] if adam else None, scalars, adam=adam,
        m_outs=[m_out], v_outs=[v_out])
    return news[0], mos[0], vos[0]
