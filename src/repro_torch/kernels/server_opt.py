"""Fused server-optimizer step over packed f32 vectors.

``server_opt_step_flat`` replaces the TPU kernels of
``repro/kernels/fedavg_agg.py::server_opt_step_flat``: the momentum form
(FedAvgM, FedDyn) and the adam form (FedAdam), one elementwise pass on
``d = merged - prev``.  On a CUDA tensor it launches
``csrc/server_opt.cu``; on a CPU tensor it runs the plain version in
``ref.py``.  See the CUDA source for the design and its bound.  The FL
paths take the same step inside the merge's own launch
(``fedavg_agg.merge_opt_flat``); this pass of its own is
``ServerOpt.step_vec``, the oracle of the tests.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import (check_cuda_tensor, check_status, output_tensor, ref,
               use_kernel)

# kernel launches by form: a run shows it went through the kernels
LAUNCHES = {"mom": 0, "adam": 0}


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
    sc = np.asarray(scalars, np.float32).reshape(-1)
    if sc.size != (6 if adam else 4):
        raise ValueError(f"expected {6 if adam else 4} scalars, got {sc.size}")
    tensors = (prev, merged, m) + ((v,) if adam else ())
    if not use_kernel(*tensors):
        new, mo, vo = ref.reference_server_opt(prev, merged, m, v, sc,
                                               adam=adam)
        if m_out is not None:
            mo = m_out.copy_(mo)
        if adam and v_out is not None:
            vo = v_out.copy_(vo)
        return new, mo, vo
    from ._build import lib
    N = prev.numel()
    for t, name in zip(tensors, ("prev", "merged", "m", "v")):
        check_cuda_tensor(t, name, torch.float32, N)
    new = torch.empty_like(prev)
    # m_out may be m itself, v_out v, and no other input
    mo = output_tensor(m_out, m, "m_out", (prev, merged) + tensors[3:])
    stream = torch.cuda.current_stream(prev.device).cuda_stream
    if adam:
        vo = output_tensor(v_out, v, "v_out", (prev, merged, m))
        status = lib().server_opt_adam_launch(
            prev.data_ptr(), merged.data_ptr(), m.data_ptr(), v.data_ptr(),
            new.data_ptr(), mo.data_ptr(), vo.data_ptr(),
            *(float(x) for x in sc[:4]), N, stream)
        check_status(status, "server_opt_step_flat(adam)")
        LAUNCHES["adam"] += 1
        return new, mo, vo
    status = lib().server_opt_mom_launch(
        prev.data_ptr(), merged.data_ptr(), m.data_ptr(), new.data_ptr(),
        mo.data_ptr(), *(float(x) for x in sc), N, stream)
    check_status(status, "server_opt_step_flat(momentum)")
    LAUNCHES["mom"] += 1
    return new, mo, None
