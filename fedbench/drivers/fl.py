"""Window loop of the ``fl`` kind: the program's event-driven federation
(``core.experiment.build_experiment`` and its event loop, as ``run_fl``
takes it) over the thesis' CNN on seeded synthetic images.

Set-up makes the images and the initial weights on the card from the
seed, builds the federation, and drives it through its first rounds: the
first warms every shape, and the first ``checked_rounds`` are the ones the
reference follows.  The window then continues the same federation round
after round until its time is up.  The unit of work is one worker's local
training (its ``train_fn`` call), delivered to the server in the same
event.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Dict, List

import torch

from fedbench import compare
from fedbench.reference import cnn as ref_cnn

RATE = "client_updates_per_s"


def images(gen: torch.Generator, n: int, protos: torch.Tensor,
           noise: float) -> tuple:
    """``n`` images (n, h, w, c) in [0, 1]: a class prototype plus noise,
    and their labels."""
    y = torch.randint(0, protos.shape[0], (n,), generator=gen,
                      device=protos.device)
    x = protos[y] + noise * torch.randn((n,) + protos.shape[1:],
                                        generator=gen, device=protos.device)
    return x.clamp_(0.0, 1.0), y


def make_inputs(model: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's images, shards and initial weights, drawn on ``device``
    from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hw, c = model["image_hw"], model["channels"]
    k, c1, c2, nc = (model["kernel"], model["conv1"], model["conv2"],
                     model["n_classes"])
    protos = torch.rand((nc, hw, hw, c), generator=gen, device=device)
    W, per = traffic["workers"], traffic["images_per_worker"]
    x, y = images(gen, W * per, protos, traffic["noise"])
    tx, ty = images(gen, traffic["n_test"], protos, traffic["noise"])
    flat = (hw // 4) * (hw // 4) * c2

    def he(shape, fan):
        return torch.randn(shape, generator=gen, device=device) \
            * math.sqrt(2.0 / fan)
    w0 = {"c1w": he((k, k, c, c1), k * k * c),
          "c1b": torch.zeros(c1, device=device),
          "c2w": he((k, k, c1, c2), k * k * c1),
          "c2b": torch.zeros(c2, device=device),
          "fw": he((flat, nc), flat),
          "fb": torch.zeros(nc, device=device)}
    shards = [(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per])
              for i in range(W)]
    return {"w0": w0, "shards": shards, "test": (tx, ty)}


class Driver:
    """One run of an ``fl`` cell: ``setup``, ``window``, ``release``,
    ``check``."""

    def __init__(self, cell, *, fault=None):
        self.cell = cell
        self.model = cell.config
        self.tr = cell.traffic
        self.fault = fault            # tests and calibration only
        self.updates = 0
        self.spans: Dict[str, List[float]] = {"worker_sgd_s": []}
        self.span = False

    # -- set-up -----------------------------------------------------------
    def _train_fn(self):
        from repro_torch.core.experiment import cnn_train_wrapper
        base = functools.partial(cnn_train_wrapper, lr=self.model["lr"],
                                 device=self.cell.device)
        if self.fault is not None:
            base = FAULTS[self.fault](base, self.tr["workers"])
        sync = torch.cuda.synchronize if self.cell.device.type == "cuda" \
            else (lambda: None)

        def train_fn(params, x, y, epochs):
            if self.span:
                sync()
                t0 = time.perf_counter()
                out = base(params, x, y, epochs)
                sync()
                self.spans["worker_sgd_s"].append(time.perf_counter() - t0)
            else:
                out = base(params, x, y, epochs)
            self.updates += 1
            return out
        return train_fn

    def setup(self) -> None:
        from repro_torch.configs.paper_cnn import CNNConfig
        from repro_torch.core import experiment as exp
        from repro_torch.models import cnn as cnn_mod
        dev = self.cell.device
        m, tr = self.model, self.tr
        self.inputs = make_inputs(m, tr, self.cell.seed, dev)
        w0 = self.inputs["w0"]
        tx, ty = self.inputs["test"]
        cfg = CNNConfig(name="fedbench-cnn", image_hw=m["image_hw"],
                        channels=m["channels"], conv1=m["conv1"],
                        conv2=m["conv2"], n_classes=m["n_classes"],
                        lr=m["lr"])
        W = tr["workers"]
        profiles = exp.heterogeneous_profiles(
            W, tr["het"], [tr["batches_per_worker"]] * W, self.cell.seed)
        shards = [{"x": x, "y": y} for x, y in self.inputs["shards"]]
        setup = exp.FLSetup(
            cfg=cfg, weights0={k: v.clone() for k, v in w0.items()},
            shards=shards, profiles=profiles, test_x=tx, test_y=ty,
            model_bytes=int(sum(v.numel() * v.element_size()
                                for v in w0.values())),
            train_fn=self._train_fn(),
            eval_fn=lambda w: float(cnn_mod.cnn_accuracy(w, tx, ty)),
            per_batch_server=tr["per_batch_server"], device=dev,
            device_shards=shards)
        self.loop, self.server = exp.build_experiment(
            setup, mode=tr["mode"], selector=tr["selector"],
            aggregator=tr["aggregator"], epochs_per_round=tr["epochs"],
            max_rounds=10 ** 9, transport=tr["transport"])
        self.server.start()
        self.prog = []
        for _ in range(tr["checked_rounds"]):
            self._one_round()
            self.prog.append({
                "params": {k: v.detach().clone()
                           for k, v in self.server.weights.items()},
                "accuracy": self.server.history[-1].accuracy,
                "n_updates": self.server.history[-1].n_updates})
        self._sync()

    def _sync(self) -> None:
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize(self.cell.device)

    def _one_round(self) -> None:
        v = self.server.version
        self.loop.run(break_when=lambda: self.server.version > v)
        if self.server.version == v:
            raise RuntimeError("the federation stopped before its round "
                               "closed")

    # -- the window -------------------------------------------------------
    def window(self, seconds: float, span: bool = False) -> dict:
        self.span = span
        self._sync()
        u0, r0 = self.updates, self.server.version
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.loop.run(break_when=lambda: time.perf_counter() >= deadline)
        self._sync()
        dt = time.perf_counter() - t0
        self.span = False
        if self.server.done:
            raise RuntimeError("the federation ran out of work in the window")
        return {"units": self.updates - u0, "seconds": dt,
                "rounds": self.server.version - r0}

    def span_window(self) -> dict:
        return self.window(self.tr["span_seconds"], span=True)

    def trace_window(self) -> dict:
        return self.window(self.tr["trace_seconds"])

    def rate(self, win: dict) -> Dict[str, float]:
        return {RATE: win["units"] / win["seconds"]}

    def failed(self) -> int:
        return sum(1 for w in self.server.workers.values()
                   if w.profile.failed)

    def facts(self) -> dict:
        from fedbench import yardstick
        m = self.model
        rows = self.server._flat._rows
        per_image = yardstick.cnn_train_flops_per_image(
            m["image_hw"], m["channels"], m["conv1"], m["conv2"],
            m["n_classes"], m["kernel"])
        return {"flops_per_update": per_image * self.tr["images_per_worker"]
                * self.tr["epochs"],
                "b2_rows": int(rows.shape[0]), "b2_n": int(rows.shape[1])}

    # -- after the window -------------------------------------------------
    def release(self) -> None:
        del self.loop, self.server

    def reference(self, lower: bool = False) -> List[dict]:
        """The reference's rounds from the same inputs (``lower``: in TF32,
        the control)."""
        return ref_cnn.run_rounds(
            self.inputs["w0"], self.inputs["shards"], self.inputs["test"],
            lr=self.model["lr"], epochs=self.tr["epochs"],
            rounds=self.tr["checked_rounds"], use_tf32=lower)

    def as_program(self, ref: List[dict]) -> List[dict]:
        return [dict(r, n_updates=self.tr["workers"]) for r in ref]

    def compare(self, prog: List[dict], ref: List[dict]) -> List[dict]:
        return readings(self.inputs["w0"], prog, ref, self.tr["workers"],
                        self.cell.limits)

    def check(self) -> List[dict]:
        """The program's first ``checked_rounds`` against the reference's."""
        return self.compare(self.prog, self.reference())


def _unchanged(base, workers):
    return lambda p, x, y, e: {k: v.clone() for k, v in p.items()}


def _half_batch(base, workers):
    return lambda p, x, y, e: base(p, x[:len(x) // 2], y[:len(y) // 2], e)


def _altered(base, workers):
    """The first worker of every round answers with its update reversed."""
    calls = [0]

    def fn(p, x, y, e):
        out = base(p, x, y, e)
        calls[0] += 1
        if calls[0] % workers == 1:
            out = {k: 2 * p[k] - v for k, v in out.items()}
        return out
    return fn


# faults planted under the window's own call (tests and calibration): a
# step that returns its state unchanged, half of each shard left out, one
# answer altered where it is produced
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}


def readings(w0, prog: List[dict], ref: List[dict], workers: int,
             limits: dict) -> List[dict]:
    """The numbers compared: the first round's update and the change after
    the last checked round, each as the worst leaf's gap of norms and as
    the worst leaf's norm of the difference, the largest gap of test
    accuracy over the rounds, and the updates a round left out of its
    merge (the reference merges every worker)."""
    d1p = compare.diff(prog[0]["params"], w0)
    d1r = compare.diff(ref[0]["params"], w0)
    d3p = compare.diff(prog[-1]["params"], w0)
    d3r = compare.diff(ref[-1]["params"], w0)
    keep = compare.moving(compare.norms(d1r))
    vals = {
        "update1_gap": compare.gap_of_norms(compare.norms(d1p),
                                            compare.norms(d1r)),
        "change3_gap": compare.gap_of_norms(compare.norms(d3p),
                                            compare.norms(d3r), keep),
        "update1_diff": compare.diff_by_leaf(d1p, d1r),
        "change3_diff": compare.diff_by_leaf(d3p, d3r, keep),
        "acc_gap": max(abs(p["accuracy"] - r["accuracy"])
                       for p, r in zip(prog, ref)),
        "missing_updates": sum(workers - p["n_updates"] for p in prog),
    }
    return compare.against(vals, limits)
