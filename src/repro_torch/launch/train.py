"""Production training script (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train [--full] [--mode fl] [--device cpu]

Modes:
  * ``--mode single`` -- ``train_step`` on one device;
  * ``--mode fl``     -- federated local SGD across ``--pods`` pod workers
                         stacked on one device (``federated.fl_local_step``),
                         merged every ``--fl-every`` steps by
                         ``federated.fl_round`` (kernel B2 on the card).

Checkpoints (atomic, keep-N) land in ``--ckpt-dir``; ``--resume`` restarts
from the latest complete step (kill the process mid-run to exercise it).
The loop is the reference's, with two facts of it kept: a resumed run's
data iterator starts again from its first batch, and an ``embeds_input``
arch draws its embeds from a generator seeded with the step
(``step_embeds``; torch cannot replay JAX's draws).

The run is on the CUDA card unless ``--device`` names another device;
without a card it exits.  ``--layers`` cuts the config's depth.  After
the reference's lines it prints one ``[train] summary`` JSON line: every
step's loss and seconds, each round's seconds and whether it left every
pod equal, the kernels' launches and the peak device memory (allocated
and reserved).
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path

import torch

from repro_torch import device_or_exit, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import federated
from repro_torch.data import synthetic_token_batches
from repro_torch.kernels import (fedavg_agg, flash_attention, rwkv6_kernel,
                                 server_opt, topk_quant)
from repro_torch.models import init_params, train_step
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.tree import leaves, tree_map

CKPT_DIR = Path(__file__).resolve().parents[3] / "benchmarks" / "results" / \
    "torch" / "train_ckpt"
KERNEL_MODULES = (fedavg_agg, flash_attention, rwkv6_kernel, server_opt,
                  topk_quant)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen-medium")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mode", choices=["single", "fl"], default="single")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--fl-every", type=int, default=10,
                    help="local steps between federated aggregation rounds")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    return ap.parse_args(argv)


def step_embeds(step: int, shape, device) -> torch.Tensor:
    """The step's input embeddings (bf16 normals), drawn on ``device`` from
    a generator seeded with the step (the reference's ``PRNGKey(step)``)."""
    g = torch.Generator(device=device).manual_seed(step)
    return torch.randn(shape, generator=g, dtype=COMPUTE_DTYPE,
                       device=device)


def to_device(tree, device):
    """A restored tree's host tensors moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def pods_equal(stacked) -> bool:
    """Every pod's slice of every leaf equal to pod 0's."""
    return all(torch.equal(t[0], t[i]) for t in leaves(stacked)
               for i in range(1, t.shape[0]))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_or_exit(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    optimizer = optim.adamw(args.lr)
    data = synthetic_token_batches(vocab=cfg.vocab_size, batch=args.batch,
                                   seq_len=args.seq)
    mgr = CheckpointManager(args.ckpt_dir)

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    opt_state = optimizer.init(params)
    start_step = 0

    if args.mode == "fl":
        params = federated.stack_for_pods(params, args.pods)
        opt_state = federated.stack_for_pods(opt_state, args.pods)
        step_fn = functools.partial(
            federated.fl_local_step, cfg=cfg, optimizer=optimizer,
            n_pods=args.pods)
        round_fn = federated.fl_round
    else:
        step_fn = functools.partial(train_step, cfg=cfg,
                                    optimizer=optimizer)

    if args.resume:
        restored = mgr.restore_latest()
        if restored:
            start_step, state, _ = restored
            params = opt_state = None      # room for the restored state
            params = to_device(state["params"], dev)
            opt_state = to_device(state["opt_state"], dev)
            del state
            print(f"[train] resumed from step {start_step}")

    summary = {"arch": cfg.name, "mode": args.mode, "n_layers": cfg.n_layers,
               "n_params": n_params, "device": str(dev),
               "start_step": start_step, "losses": [], "step_s": [],
               "rounds": []}
    t0 = time.time()
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = next(data)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if cfg.embeds_input:
            emb = step_embeds(step, (args.batch, args.seq, cfg.d_model), dev)
            batch = {"embeds": emb, "labels": batch["labels"]}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(torch.mean(metrics["loss"].float()))      # a sync
        summary["losses"].append(loss)
        summary["step_s"].append(time.perf_counter() - t_step)
        if args.mode == "fl" and (step + 1) % args.fl_every == 0:
            t_round = time.perf_counter()
            weights = torch.ones((args.pods,), dtype=torch.float32,
                                 device=dev)           # selection mask
            params = round_fn(params, weights)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            summary["rounds"].append({
                "step": step + 1, "s": time.perf_counter() - t_round,
                "pods_equal": pods_equal(params)})
            print(f"[fl] round at step {step + 1}: cross-pod aggregate")
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({(time.time() - t0):.1f}s)")
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt_state": opt_state},
                     {"loss": loss})
            print(f"[ckpt] saved step {step + 1}")
    summary["launches"] = {m.__name__.rsplit(".", 1)[1]: dict(m.LAUNCHES)
                           for m in KERNEL_MODULES}
    cuda = dev.type == "cuda"
    summary["peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if cuda else None
    summary["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(dev) \
        if cuda else None
    print("[train] summary " + json.dumps(summary))
    print("done")
    summary["params"], summary["opt_state"] = params, opt_state
    return summary


if __name__ == "__main__":
    main()
