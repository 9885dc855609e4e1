"""Plain PyTorch references of what the benchmark's cells compute.

They import neither JAX nor anything of the program under test, and take
nothing the program made: the benchmark hands them the same seeded inputs
it handed the program.
"""
import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """float32 matrix products and convolutions in TF32 (``enabled``) or in
    full float32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
