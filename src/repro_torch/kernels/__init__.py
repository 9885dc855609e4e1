"""Hand-written Hopper kernels and their plain PyTorch versions.

Dispatch rule, one for every wrapper in this package:

* a CPU tensor runs the plain version (``ref.py``);
* a CUDA tensor on a compute-capability (9, 0) card launches the kernel;
* anything else raises.

There is no override: a CUDA tensor never reaches the plain version, and
a kernel that fails to build or launch raises.

The merge, step and decode kernels take *pieces*: equal-width operands on
one device, one launch over all of them (``csrc/fedavg_agg.cu``).  One
piece is an unsharded call; a sharded wrapper passes every piece a device
holds.  Their counters count launches (``LAUNCHES``) and the pieces those
launches cover (``PIECES``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

# pieces one launch of a grouped entry covers (kMax in csrc/pieces.cuh)
GROUP_PIECES = 32


def group_launches(n: int) -> int:
    """Launches a grouped entry makes for n pieces."""
    return -(-n // GROUP_PIECES)


def pointer_table(*operands: Optional[Sequence[torch.Tensor]]):
    """The host array a grouped entry reads: piece by piece, each
    operand's data pointer in the given order; an operand that is None
    (or a None piece) is a null pointer."""
    n = max(len(op) for op in operands if op is not None)
    ptrs = [None if op is None or op[i] is None else op[i].data_ptr()
            for i in range(n) for op in operands]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when ``tensors`` (all on one device) go to the CUDA kernel,
    False when they go to the plain version; raises otherwise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        cap = torch.cuda.get_device_capability(dev)
        if cap == (9, 0):
            return True
        raise RuntimeError(f"the kernels are built for sm_90a; device "
                           f"{dev} has compute capability {cap}")
    raise RuntimeError(f"no kernel and no plain version for device {dev}")


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      numel: int) -> None:
    """Validate one kernel operand before its pointer is passed on."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() != numel:
        raise ValueError(f"{name}: expected {numel} elements, got "
                         f"{t.numel()}")


def output_tensor(t: Optional[torch.Tensor], like: torch.Tensor, name: str,
                  forbidden) -> torch.Tensor:
    """The tensor a kernel writes ``name`` to: a new one shaped like
    ``like``, or ``t``, which must not share its storage with any tensor of
    ``forbidden`` (None entries are skipped)."""
    if t is None:
        return torch.empty_like(like)
    check_cuda_tensor(t, name, torch.float32, like.numel())
    if t.device != like.device:
        raise ValueError(f"{name} must be on the operands' device")
    if any(x is not None and x.data_ptr() == t.data_ptr()
           for x in forbidden):
        raise ValueError(f"{name} aliases an operand it may not")
    return t


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd is recording and one of ``tensors`` (None
    entries skipped) requires grad: a call would be part of a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_grad_inputs(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when ``records_grad(*tensors)``.  B8 and B9 are forward only
    (the JAX package has no backward for its Pallas kernels either), and
    an output written by such a kernel carries no gradient path: a
    ``backward()`` through it would silently drop the inputs' gradients.
    Run under ``torch.no_grad()``, or take the model's training route
    (attention's training kernel pair, ``flash_attention_train``, or the
    plain ops)."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{what} is forward only: an input requires grad while autograd "
            f"records, and the kernel has no backward; call it under "
            f"torch.no_grad() (the training paths take "
            f"flash_attention_train or the plain routes)")


def check_status(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
