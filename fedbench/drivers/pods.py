"""Window loop of the ``pods`` kind: cross-silo FedAvg of an LM whose pods
are stacked on one card (``core.federated``): ``fl_local_step`` (AdamW's
``train_step`` on every pod's rows), and after every ``merge_every``-th
step either ``fl_round`` (kernel B2 over the packed pods) or
``fl_round_delta_compressed`` (the error-feedback top-k + int8 codec over
the pods' deltas from the last merge, then B6).

Set-up makes the weights and the batches on the card from the seed,
stacks them for the pods with AdamW's state, and runs the checked steps
(``checked_steps``, with merges after the steps in ``checked_merges``);
the first step and merge warm every shape.  The window continues the same
pods step after step.  The unit of work is a trained token.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from fedbench import compare
from fedbench.reference import codec as ref_codec
from fedbench.reference import lm as ref_lm

RATE = "train_tokens_per_s"
BF16 = torch.bfloat16


def init_weights(model: dict, seed: int, device) -> dict:
    """The pods' shared initial parameters, bf16, drawn on ``device`` from
    one generator seeded with ``seed``, leaf after leaf in path order:
    matrices ``normal / sqrt(fan_in)``, the embedding ``normal * 0.02``,
    norm scales 0 (the ``1 + scale`` form)."""
    L, d, H = model["n_layers"], model["d_model"], model["n_heads"]
    Kv, f, V = model["n_kv_heads"], model["d_ff"], model["vocab_size"]
    hd = d // H
    shapes = {
        "blocks.attn.wk": ((L, d, Kv, hd), d),
        "blocks.attn.wo": ((L, H, hd, d), H * hd),
        "blocks.attn.wq": ((L, d, H, hd), d),
        "blocks.attn.wv": ((L, d, Kv, hd), d),
        "blocks.ln1.scale": ((L, d), 0),
        "blocks.ln2.scale": ((L, d), 0),
        "blocks.mlp.wi_gate": ((L, d, f), d),
        "blocks.mlp.wi_up": ((L, d, f), d),
        "blocks.mlp.wo": ((L, f, d), f),
        "embed.embedding": ((V, d), -1),
        "final_norm.scale": ((d,), 0),
    }
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path in sorted(shapes):
        shape, fan = shapes[path]
        if fan == 0:
            t = torch.zeros(shape, dtype=BF16, device=device)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            t = (t * (0.02 if fan < 0 else 1.0 / math.sqrt(fan))).to(BF16)
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def batch(model: dict, traffic: dict, seed: int, step: int, device) -> tuple:
    """Step ``step``'s frame embeddings (rows, S, d) bf16 and next-frame
    labels (rows, S), every pod's rows together, drawn from a generator
    seeded with the seed and the step."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (1 << 62))
    rows = traffic["n_pods"] * traffic["rows_per_pod"]
    S, d = traffic["seq_len"], model["d_model"]
    emb = torch.randn((rows, S, d), generator=gen, device=device,
                      dtype=torch.float32).to(BF16)
    lab = torch.randint(0, model["vocab_size"], (rows, S), generator=gen,
                        device=device)
    return emb, lab


# faults planted under the window's own calls (tests and calibration): a
# step that returns its state unchanged, half of each pod's rows left out
# (the mean over the rest), the merge's answer altered (pod 0's alone)
FAULTS = ("unchanged", "half_batch", "drop_pod")


def named(tree) -> Dict[str, torch.Tensor]:
    return dict(ref_lm.flat(tree))


class Driver:
    """One run of a ``pods`` cell: ``setup``, ``window``, ``release``,
    ``check``."""

    def __init__(self, cell, *, fault=None):
        self.cell = cell
        self.model = cell.config
        self.opt_kw = cell.config["optimizer"]
        self.tr = cell.traffic
        self.fault = fault            # tests and calibration only
        self.step = 0
        self.spans: Dict[str, List[float]] = {"local_step_s": [],
                                              "merge_round_s": []}

    def _cfg(self):
        from repro_torch.configs.base import ModelConfig
        m, p = self.model, self.cell.config["program"]
        return ModelConfig(
            name=self.cell.config["name"], family="audio",
            n_layers=m["n_layers"], d_model=m["d_model"],
            n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
            d_ff=m["d_ff"], vocab_size=m["vocab_size"],
            rope_theta=m["rope_theta"], embeds_input=True,
            loss_chunk=p["loss_chunk"], remat=p["remat"],
            attn_impl=p["attn_impl"])

    def _sync(self) -> None:
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def setup(self) -> None:
        from repro_torch import optim
        from repro_torch.core import federated
        from repro_torch.core.compression import ErrorFeedbackCompressor
        from repro_torch.tree import tree_map
        dev, tr = self.cell.device, self.tr
        n = tr["n_pods"]
        self.fed, self.tree_map = federated, tree_map
        self.cfg = self._cfg()
        w0 = init_weights(self.model, self.cell.seed, dev)
        self.optimizer = optim.adamw(
            lr=self.opt_kw["lr"], b1=self.opt_kw["b1"], b2=self.opt_kw["b2"],
            eps=self.opt_kw["eps"], weight_decay=self.opt_kw["weight_decay"],
            clip_norm=self.opt_kw["clip_norm"])
        opt = self.optimizer.init(w0)
        self.params = federated.stack_for_pods(w0, n)
        self.opt = federated.stack_for_pods(opt, n)
        del opt
        self.merge_weights = torch.ones((n,), dtype=torch.float32, device=dev)
        if tr["merge"] == "topk_int8":
            self.comp = ErrorFeedbackCompressor(frac=tr["frac"],
                                                quantize=True)
            self.anchor = tree_map(lambda p: p[0].clone(), self.params)
        elif tr["merge"] != "raw":
            raise ValueError(f"unknown merge {tr['merge']!r}")
        self.tokens_per_step = n * tr["rows_per_pod"] * tr["seq_len"]
        w0n = named(w0)
        self.prog = {"losses": [], "first_grad": [], "merges": [],
                     "masters": []}
        b1 = self.opt_kw["b1"]
        for s in range(1, tr["checked_steps"] + 1):
            mets = self._step()
            self.prog["losses"].append([float(x) for x in mets["loss"]])
            if s == 1:
                m = named(self.opt["m"])
                self.prog["first_grad"] = [
                    compare.norms({k: v[i] / (1 - b1) for k, v in m.items()})
                    for i in range(n)]
            if s in tr["checked_merges"]:
                self._merge()
                cur = named(self.params)
                self.prog["merges"].append(compare.norms(
                    {k: cur[k][0].float() - w0n[k].float() for k in w0n}))
        mast = named(self.opt["master"])
        self.prog["masters"] = [compare.norms(
            {k: mast[k][i] - w0n[k].float() for k in w0n}) for i in range(n)]
        del w0, w0n, mast
        self._sync()

    def _step(self):
        self.step += 1
        if self.fault == "unchanged":
            return {"loss": torch.zeros(self.tr["n_pods"])}
        emb, lab = batch(self.model, self.tr, self.cell.seed, self.step,
                         self.cell.device)
        if self.fault == "half_batch":
            per = emb.shape[0] // self.tr["n_pods"]
            # each pod's first half of its rows, twice
            idx = torch.cat([torch.arange(i * per, i * per + per // 2)
                             .repeat(2) for i in range(self.tr["n_pods"])])
            emb, lab = emb[idx.to(emb.device)], lab[idx.to(emb.device)]
        self.params, self.opt, mets = self.fed.fl_local_step(
            self.params, self.opt, {"embeds": emb, "labels": lab},
            cfg=self.cfg, optimizer=self.optimizer,
            n_pods=self.tr["n_pods"])
        return mets

    def _merge(self) -> None:
        w = self.merge_weights
        if self.fault == "drop_pod":
            w = torch.zeros_like(w)
            w[0] = 1.0
        if self.tr["merge"] == "raw":
            self.params = self.fed.fl_round(self.params, w)
            return
        self.params = self.fed.fl_round_delta_compressed(
            self.params, self.anchor, w,
            compressor=lambda d: self.comp.compress(d)[0])
        self.anchor = self.tree_map(lambda p: p[0].clone(), self.params)

    def window(self, seconds: float, span: bool = False,
               until_merge: bool = False) -> dict:
        """Steps (and their merges) until ``seconds`` are up, then a
        synchronisation; with ``until_merge``, on until the next merge is
        done."""
        every = self.tr["merge_every"]
        self._sync()
        s0, merges = self.step, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if span:
                self._sync()
                t = time.perf_counter()
            self._step()
            if span:
                self._sync()
                self.spans["local_step_s"].append(time.perf_counter() - t)
            merged = self.step % every == 0
            if merged:
                if span:
                    t = time.perf_counter()
                self._merge()
                merges += 1
                if span:
                    self._sync()
                    self.spans["merge_round_s"].append(
                        time.perf_counter() - t)
            if time.perf_counter() >= deadline and (merged or
                                                    not until_merge):
                break
        self._sync()
        return {"units": (self.step - s0) * self.tokens_per_step,
                "seconds": time.perf_counter() - t0,
                "steps": self.step - s0, "merges": merges}

    def span_window(self) -> dict:
        return self.window(self.tr["span_seconds"], span=True,
                           until_merge=True)

    def trace_window(self) -> dict:
        return self.window(self.tr["trace_seconds"], until_merge=True)

    def rate(self, win: dict) -> Dict[str, float]:
        return {RATE: win["units"] / win["seconds"]}

    def failed(self) -> int:
        return 0

    def facts(self) -> dict:
        from fedbench import yardstick
        m, tr = self.model, self.tr
        n_params = yardstick.lm_params(m["n_layers"], m["d_model"],
                                       m["n_heads"], m["n_kv_heads"],
                                       m["d_ff"], m["vocab_size"])
        return {"n_params": n_params,
                "flops_per_token": yardstick.lm_train_flops_per_token(
                    n_params, m["n_layers"], tr["seq_len"], m["d_model"]),
                "tokens_per_step": self.tokens_per_step,
                "b2_rows": tr["n_pods"], "b2_n": n_params,
                "encode_n": -(-tr["n_pods"] * n_params // 512) * 512}

    def release(self) -> None:
        for name in ("params", "opt", "comp", "anchor"):
            if hasattr(self, name):
                delattr(self, name)

    def reference(self, lower: bool = False) -> dict:
        """The reference's pods from the same weights and batches
        (``lower``: every bf16 matrix product through fp8, the control)."""
        dev, tr = self.cell.device, self.tr
        w0 = init_weights(self.model, self.cell.seed, dev)
        batches = [batch(self.model, tr, self.cell.seed, s, dev)
                   for s in range(1, tr["checked_steps"] + 1)]
        comp = (ref_codec.ErrorFeedbackTopkInt8(tr["frac"])
                if tr["merge"] == "topk_int8" else None)
        return ref_lm.run_pods(
            w0, batches, n_pods=tr["n_pods"],
            merge_after=tr["checked_merges"], compress=comp,
            opt_kw=self.opt_kw, precision="fp8" if lower else "bf16",
            rows=tr["reference_rows"])

    def as_program(self, ref: dict) -> dict:
        return {"losses": [list(s) for s in zip(*ref["losses"])],
                "first_grad": ref["first_grad"], "merges": ref["merges"],
                "masters": ref["change"]}

    def compare(self, prog: dict, ref: dict) -> List[dict]:
        return readings(prog, ref, self.cell.limits)

    def check(self) -> List[dict]:
        """The program's checked steps against the reference's."""
        return self.compare(self.prog, self.reference())


def readings(prog: dict, ref: dict, limits: dict) -> List[dict]:
    """The numbers compared: the largest relative gap of a pod's step loss,
    and the worst leaf's gap of norms of the first gradient, of each
    merge's change from the initial weights, and of the masters' change
    after the checked steps (quiet leaves left out)."""
    n = len(prog["first_grad"])
    vals = {"loss_gap": max(
        compare.rel_gap(prog["losses"][s][i], ref["losses"][i][s])
        for i in range(n) for s in range(len(prog["losses"])))}
    vals["grad1_gap"] = max(compare.gap_of_norms(prog["first_grad"][i],
                                                 ref["first_grad"][i])
                            for i in range(n))
    if prog["merges"]:
        vals["merge_gap"] = max(compare.gap_of_norms(p, r) for p, r in
                                zip(prog["merges"], ref["merges"]))
    vals["change3_gap"] = max(
        compare.gap_of_norms(prog["masters"][i], ref["change"][i],
                             compare.moving(ref["first_grad"][i]))
        for i in range(n))
    return compare.against(vals, limits)
