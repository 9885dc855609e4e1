"""Time one checkout's B8 (flash attention) at ``chip_smoke.FLASH_SHAPES``,
or with ``--train`` its training kernel pair.

    PYTHONPATH=src python tools/torch_flash_times.py --out FILE [--tree DIR]
        [--shapes LABEL,...] [--train]

For each bf16 shape of ``chip_smoke.FLASH_SHAPES`` (or the labels given),
draws q, k, v as ``chip_smoke.check_flash`` does, holds the kernel against
its plain version (``chip_smoke.flash_ratio``, which passes at <= 1) and
times it with ``chip_smoke.Timer`` (median of CUDA events over
``N_TIMED_FLASH`` launches, L2 flushed before each).  ``chip_smoke`` is
this checkout's; ``repro_torch`` is DIR's (default: this checkout), built
from DIR's sources, so another body unpacked into a git-ignored directory
is timed on the same inputs: run A, B, B, A in one call to compare two on
one card.  Writes FILE with the card's name and power limit; exits
non-zero if a shape misses the limit.

With ``--train``: at each ``chip_smoke.TRAIN_FLASH_SHAPES`` shape
(musicgen-medium's pods, and yi-9b's pods at head dim 128 with GQA), a
forward and a backward
through ``flash_attention_train`` (the training pair) against the same
through ``mha_chunked`` under autograd, in turns (chunked, pair, pair,
chunked; medians of CUDA events, L2 flushed), beside the bound
(``chip_smoke.train_pair_bound``: 2 forward and 5 backward causal
products at 989 TFLOP/s, or the bytes),
the plain versions (``ref.reference_flash_train_fwd`` and ``_bwd``) and
``scaled_dot_product_attention``'s forward and backward, a yardstick the
port never calls; also the pair's forward and backward alone.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_train(timer, chip_smoke, fa, ref, dev, label):
    """The training pair at TRAIN_FLASH_SHAPES[label]: see the module's
    docstring.  Returns its record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention
    B, S, H, Kv, D = chip_smoke.TRAIN_FLASH_SHAPES[label]
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(B, S, n, D, device=dev, generator=g)
                   .to(torch.bfloat16) for n in (H, Kv, Kv, H))

    def grad_of(fn):
        def run():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            fn(*ins).backward(do)
        return run
    pair = grad_of(fa.flash_attention_train)
    chunked = grad_of(attention.mha_chunked)

    def sdpa(qq, kk, vv):
        out = F.scaled_dot_product_attention(
            qq.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            is_causal=True, enable_gqa=Kv != H)
        return out.transpose(1, 2)

    def plain():
        o, lse = ref.reference_flash_train_fwd(q, k, v)
        ref.reference_flash_train_bwd(q, k, v, o, lse, do)
    o, lse = fa._train_fwd(q, k, v)
    n = chip_smoke.N_TIMED_FLASH
    k_ms, c_ms, turns = timer.turns(pair, chunked, n)
    rec = {"shape": [B, S, H, Kv, D], "pair_ms": k_ms, "chunked_ms": c_ms,
           "turns": turns,
           "fwd_ms": timer(lambda: fa._train_fwd(q, k, v), n),
           "bwd_ms": timer(lambda: fa._train_bwd(q, k, v, o, lse, do), n),
           "bound_ms": chip_smoke.train_pair_bound(B, S, H, Kv, D)[0],
           "plain_ms": timer(plain, 3, warm=1),
           "sdpa_ms": timer(grad_of(sdpa), n)}
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--shapes", default="",
                    help="comma-separated FLASH_SHAPES labels (default: "
                         "every bf16 one)")
    ap.add_argument("--train", action="store_true",
                    help="time the training pair at chip_smoke's "
                         "TRAIN_FLASH_SHAPES instead")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))   # ahead of chip_smoke's own
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_times: needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(dev)
    if args.train:
        train = {}
        for label in ([s for s in args.shapes.split(",") if s] or
                      list(chip_smoke.TRAIN_FLASH_SHAPES)):
            train[label] = time_train(timer, chip_smoke, fa, ref, dev, label)
            print(f"{label}: {json.dumps(train[label])} ({tree})",
                  flush=True)
        import repro_torch
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card.stdout.strip(), "tree": str(tree),
             "repro_torch": repro_torch.__file__, "train": train},
            indent=1))
        return
    labels = ([s for s in args.shapes.split(",") if s] or
              [k for k, v in chip_smoke.FLASH_SHAPES.items()
               if v[5] == torch.bfloat16])
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = {}
    for label in labels:
        B, S, H, Kv, D, dt, window, cap = chip_smoke.FLASH_SHAPES[label]
        q, k, v = (torch.randn(B, S, n, D, device=dev, generator=g)
                   for n in (H, Kv, Kv))
        q, k, v = (q * chip_smoke.FLASH_Q_SCALE).to(dt), k.to(dt), v.to(dt)
        kw = dict(window=window, softcap=cap)
        ratio = chip_smoke.flash_ratio(
            fa.flash_attention(q, k, v, **kw),
            ref.reference_flash_attention(q, k, v, **kw))
        ms = timer(lambda: fa.flash_attention(q, k, v, **kw),
                   chip_smoke.N_TIMED_FLASH)
        shapes[label] = {"ratio": ratio, "ms": ms}
        print(f"{label}: {ms:.4f} ms, ratio {ratio:.4f} ({tree})",
              flush=True)
        del q, k, v
    import repro_torch
    rec = {"card": card.stdout.strip(), "tree": str(tree),
           "repro_torch": repro_torch.__file__, "shapes": shapes}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    if not all(r["ratio"] <= 1.0 for r in shapes.values()):
        raise SystemExit("torch_flash_times: a shape misses the limit")


if __name__ == "__main__":
    main()
