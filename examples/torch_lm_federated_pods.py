"""Pod-level federated LM pretraining on the port: local SGD on each
(simulated) pod, worker-selection-weighted cross-pod aggregation every H
steps, checkpoints.

The twin of ``examples/lm_federated_pods.py`` through ``repro_torch``: the
same yi-mini (yi-9b's family at 4 layers, d_model 128, vocab 2048), AdamW
at 1e-3, ``fl_local_step`` on every pod and ``fl_round`` (one launch of
the B2 merge on the card) every ``--fl-every`` steps, and a
``CheckpointManager`` save every 50 steps.  It runs on the CUDA card, and
on the CPU when asked (``--device cpu``).

    PYTHONPATH=src python examples/torch_lm_federated_pods.py --steps 120

Checkpoints go to ``benchmarks/results/torch/lm_federated_pods_ckpt/``
(git-ignored) unless ``--ckpt-dir`` says otherwise, and a summary (per-pod
losses, seconds, the card) to
``benchmarks/results/torch/lm_federated_pods.json``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import card_name, device_or_exit, optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import federated  # noqa: E402
from repro_torch.data import synthetic_token_batches  # noqa: E402
from repro_torch.kernels import fedavg_agg  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results" / \
    "torch"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--fl-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=str(RESULTS / "lm_federated_pods_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="the CUDA card (default; exits without one) or "
                         "cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = device_or_exit(args.device)
    cfg = get_config("yi-9b", reduced=True).replace(
        name="yi-mini", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
        d_ff=384, vocab_size=2048, loss_chunk=32)
    optimizer = optim.adamw(1e-3)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    n = sum(x.numel() for x in leaves(params))
    print(f"model: {n/1e6:.1f}M params x {args.pods} pod workers on "
          f"{device}, aggregating every {args.fl_every} steps")

    sp = federated.stack_for_pods(params, args.pods)
    so = federated.stack_for_pods(optimizer.init(params), args.pods)
    mgr = CheckpointManager(args.ckpt_dir)
    data = synthetic_token_batches(vocab=cfg.vocab_size,
                                   batch=args.batch * args.pods,
                                   seq_len=args.seq, seed=0)
    weights = torch.ones((args.pods,), dtype=torch.float32, device=device)
    log, merges0 = [], fedavg_agg.LAUNCHES["agg"]
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        sp, so, m = federated.fl_local_step(sp, so, batch, cfg=cfg,
                                            optimizer=optimizer,
                                            n_pods=args.pods)
        if (step + 1) % args.fl_every == 0:
            # simple selection: all pods healthy -> equal weights
            sp = federated.fl_round(sp, weights)
        if step % 10 == 0 or step == args.steps - 1:
            losses = [float(l) for l in m["loss"]]
            log.append({"step": step, "losses": losses,
                        "seconds": time.time() - t0})
            print(f"step {step:4d} per-pod loss "
                  f"{[f'{l:.3f}' for l in losses]} ({time.time()-t0:.0f}s)")
        if (step + 1) % 50 == 0:
            mgr.save(step + 1, {"params": sp, "opt": so})
    seconds = time.time() - t0
    print(f"done in {seconds:.0f}s; checkpoints: {mgr.steps()}")
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "lm_federated_pods.json").write_text(json.dumps({
        "card": card_name() if device.type == "cuda" else "cpu",
        "device": str(device), "torch": torch.__version__,
        "config": {"arch": cfg.name, "n_params": n, "pods": args.pods,
                   "fl_every": args.fl_every, "batch_per_pod": args.batch,
                   "seq": args.seq, "steps": args.steps},
        "seconds": seconds, "s_per_step": seconds / max(args.steps, 1),
        "b2_launches": fedavg_agg.LAUNCHES["agg"] - merges0,
        "log": log, "checkpoints": mgr.steps()}, indent=1))


if __name__ == "__main__":
    main()
