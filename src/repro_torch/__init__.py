"""PyTorch/CUDA port of the ``repro`` FL framework.

Same layout and public names as ``repro`` (``core.make_setup``,
``core.run_fl``, ``core.flatbuf.FlatServerState``, ...), written in
PyTorch's idiom: plain functions on tensors, dicts of tensors for model
parameters, explicit ``torch.Generator``s.  The merge and codec hot spots
run hand-written CUDA kernels for Hopper (``repro_torch.kernels``).

Entry points take ``device=``.  The default is the CUDA card; with no
card and no explicit device they raise rather than drop to the CPU.  The
CPU runs each kernel's plain PyTorch version (the parity tests use it).

This package imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA card.  Raises when no device was given and CUDA is absent.

    Float32 matmuls stay full float32 on the card: TF32 is switched off
    explicitly, not left to PyTorch's defaults."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run the plain versions")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def device_or_exit(name: Optional[str] = "cuda") -> torch.device:
    """A script's ``--device``: ``"cuda"`` (or None) is the first card,
    and a missing card ends the script (SystemExit) rather than run the
    CPU in its place; any other name is taken as given."""
    if name in (None, "cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: run on the card, or ask for "
                             "the CPU with --device cpu")
        name = torch.device("cuda", 0)
    return resolve_device(name)


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; "no card" where
    nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True,
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no card"
