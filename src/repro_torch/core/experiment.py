"""End-to-end FL experiment harness reproducing the thesis §4 setups (port
of ``repro/core/experiment.py``): synthetic MNIST/CIFAR-class data, N
workers with heterogeneous profiles, sequential / sync-FL / async-FL runs,
accuracy-over-(simulated)-time histories.

Every entry point runs on the setup's device: ``make_setup(device=None)``
means the CUDA card, and raises when there is none.  Each worker's shard
and the test set move to the device once, at setup.

Not ported yet, and raising ``NotImplementedError``: ``topology``
(ROADMAP A9), checkpoints and ``resume`` (A10), ``server_mesh`` (A11) and
``cohort`` (A6).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.paper_cnn import CNNConfig, FAST_MNIST_CNN
from repro_torch.data.synth import make_classification_dataset, partition_split
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import mlp as mlp_mod

from .estimator import TimeEstimator, WorkerProfile
from .events import EventLoop
from .population import WorkerPopulation
from .selection import make_selector
from .server import AggregationServer, HistoryPoint, run_sequential
from .transport import Transport
from .worker import FLWorker

# thesis tables 4.1 (10 workers): batches allocated per worker
TABLE_4_1 = {
    "mnist_sequential": [10] + [0] * 9,
    "mnist_even": [1] * 10,
    "mnist_uneven": [1, 0, 0, 3, 0, 0, 0, 2, 2, 2],
}
# thesis table 4.2 (30 workers)
TABLE_4_2 = {
    "mnist_sequential": [30] + [0] * 29,
    "mnist_even": [1] * 30,
    "mnist_uneven": [4] + [0] * 9 + [8] + [0] * 9 + [0, 2, 2, 2, 2, 2, 2, 2, 2, 2],
}


def heterogeneous_profiles(n: int, kind: str = "mixed",
                           batches: Optional[Sequence[int]] = None,
                           seed: int = 0) -> List[WorkerProfile]:
    """Profiles mimicking the thesis' three VMs with contended CPUs:
    a third fast, a third medium, a third slow."""
    rng = np.random.RandomState(seed)
    profiles = []
    for i in range(n):
        if kind == "uniform":
            freq, prop, bw = 2.0, 1.0, 100e6
        elif kind == "extreme":
            tier = i % 3
            freq = [3.0, 1.6, 0.8][tier]
            prop = [1.0, 0.9, 0.7][tier]
            bw = [200e6, 80e6, 20e6][tier]
        elif kind == "strong":   # ~3.8x spread: sync tail waits on stragglers
            tier = i % 3
            freq = [3.0, 2.0, 1.0][tier]
            prop = [1.0, 0.9, 0.8][tier]
            bw = [200e6, 80e6, 30e6][tier]
        else:  # "mixed": the thesis' same-laptop VM contention (~2.2x spread)
            tier = i % 3
            freq = [3.0, 2.4, 1.6][tier]
            prop = [1.0, 0.95, 0.85][tier]
            bw = [200e6, 100e6, 30e6][tier]
        nb = batches[i] if batches is not None else 1
        profiles.append(WorkerProfile(worker_id=f"w{i}", cpu_freq=freq,
                                      cpu_prop=prop, bandwidth=bw,
                                      n_batches=nb))
    return profiles


@dataclass
class FLSetup:
    cfg: CNNConfig
    weights0: Dict[str, torch.Tensor]
    shards: List[Dict]                  # numpy, as the data module made them
    profiles: List[WorkerProfile]
    test_x: np.ndarray
    test_y: np.ndarray
    model_bytes: int
    train_fn: object
    eval_fn: object
    per_batch_server: float
    device: torch.device
    device_shards: List[Dict]           # the shards as tensors on `device`


def _on_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def make_setup(batches_per_worker: Sequence[int], *,
               cfg: CNNConfig = FAST_MNIST_CNN, model: str = "mlp",
               het: str = "mixed", batch_size: int = 32, n_test: int = 512,
               seed: int = 0, per_batch_server: float = 0.05,
               noise: float = 0.35, mlp_lr: float = 0.1,
               partition: str = "iid",
               partition_kw: Optional[dict] = None,
               fedprox_mu: float = 0.0, weights0=None,
               device=None) -> FLSetup:
    """The data, profiles and initial weights of one experiment.

    ``model`` is ``"mlp"`` or ``"cnn"`` (the thesis' Listing 4.1 at
    ``cfg``'s widths, trained by full-batch SGD at ``cfg.lr``).
    ``weights0`` injects the initial weights (a dict of numpy arrays or
    tensors, e.g. the JAX package's ``init_mlp``/``init_cnn`` exported as
    numpy); without it they are drawn from a ``torch.Generator`` seeded
    with ``seed``.  ``device=None`` means the CUDA card and raises without
    one.  ``partition`` and ``fedprox_mu`` (MLP only) are as in the JAX
    package."""
    if model not in ("mlp", "cnn"):
        raise ValueError(f"unknown model {model!r}; have 'mlp', 'cnn'")
    if model == "cnn" and fedprox_mu:
        raise ValueError("fedprox_mu is only wired for model='mlp'")
    device = resolve_device(device)
    total_batches = sum(batches_per_worker)
    x, y = make_classification_dataset(
        total_batches * batch_size + n_test, hw=cfg.image_hw,
        channels=cfg.channels, noise=noise, seed=seed)
    test_x, test_y = x[-n_test:], y[-n_test:]
    shards = partition_split(x[:-n_test], y[:-n_test], batches_per_worker,
                             partition=partition, batch_size=batch_size,
                             seed=seed, **(partition_kw or {}))
    if weights0 is not None:
        weights0 = {k: (v.detach().cpu().numpy()
                        if isinstance(v, torch.Tensor) else v)
                    for k, v in weights0.items()}
    if model == "cnn":
        weights0 = (cnn_mod.init_cnn(torch.Generator().manual_seed(seed),
                                     cfg, device=device)
                    if weights0 is None
                    else cnn_mod.params_from_numpy(weights0, device))
        train_fn = functools.partial(cnn_train_wrapper, lr=cfg.lr,
                                     device=device)
        acc_fn = cnn_mod.cnn_accuracy
    else:
        in_dim = cfg.image_hw * cfg.image_hw * cfg.channels
        weights0 = (mlp_mod.init_mlp(torch.Generator().manual_seed(seed),
                                     in_dim=in_dim, device=device)
                    if weights0 is None
                    else mlp_mod.params_from_numpy(weights0, device))
        train_fn = functools.partial(mlp_train_wrapper, lr=mlp_lr,
                                     mu=fedprox_mu, device=device)
        acc_fn = mlp_mod.mlp_accuracy
    tx = _on_device(test_x, device)
    ty = _on_device(test_y, device, torch.int64)
    eval_fn = lambda w: float(acc_fn(w, tx, ty))
    return FLSetup(cfg=cfg, weights0=weights0, shards=shards,
                   profiles=heterogeneous_profiles(len(batches_per_worker),
                                                   het, batches_per_worker,
                                                   seed),
                   test_x=test_x, test_y=test_y,
                   model_bytes=int(sum(p.numel() * p.element_size()
                                       for p in weights0.values())),
                   train_fn=train_fn, eval_fn=eval_fn,
                   per_batch_server=per_batch_server, device=device,
                   device_shards=_device_shards(shards, device))


def _device_shards(shards: Sequence[Dict], device: torch.device
                   ) -> List[Dict]:
    return [{"x": _on_device(s["x"], device),
             "y": _on_device(s["y"], device, torch.int64)} for s in shards]


def cnn_train_wrapper(params, x, y, epochs, lr=0.01, device=None):
    """Local training of one worker on the CNN: ``epochs`` full-batch SGD
    steps.  Tensors already on ``device`` are used as they are."""
    return cnn_mod.cnn_sgd_train(params, _on_device(x, device),
                                 _on_device(y, device, torch.int64),
                                 lr=lr, epochs=int(epochs))


def mlp_train_wrapper(params, x, y, epochs, lr=0.1, mu=0.0, device=None):
    """Local training of one worker: FedProx when ``mu > 0`` (anchored at
    the weights the worker decoded), plain minibatch SGD otherwise.
    Tensors already on ``device`` are used as they are."""
    return mlp_mod.mlp_prox_train(params, _on_device(x, device),
                                  _on_device(y, device, torch.int64),
                                  lr=lr, epochs=int(epochs), mu=mu)


def mlp_prox_train_wrapper(params, x, y, epochs, lr=0.1, mu=0.0,
                           device=None):
    """FedProx local training: ``mlp_train_wrapper`` under the JAX
    package's name for it."""
    return mlp_train_wrapper(params, x, y, epochs, lr=lr, mu=mu,
                             device=device)


def _not_ported(name: str, step: str):
    raise NotImplementedError(f"{name} is not ported yet (ROADMAP {step})")


def run_fl(setup: FLSetup, *, mode: str = "sync", selector: str = "all",
           aggregator: str = "fedavg", epochs_per_round: int = 10,
           max_rounds: int = 60, target_accuracy: Optional[float] = None,
           selector_kw: Optional[dict] = None, server_freq: float = 3.0,
           async_alpha: float = 1.0, async_stale_pow: float = 0.0,
           async_min_updates: int = 1, async_delta: bool = False,
           async_latest_table: bool = True, transport: str = "raw",
           transport_down: Optional[str] = None,
           transport_frac: float = 0.1,
           server_mesh: Optional[int] = None,
           cohort: Optional[int] = None, server_opt=None,
           server_opt_kw: Optional[dict] = None,
           partition: Optional[str] = None,
           partition_kw: Optional[dict] = None,
           topology=None, max_events: int = 200_000,
           checkpoint_every: Optional[int] = None,
           checkpoint_dir: Optional[str] = None,
           resume: bool = False) -> List[HistoryPoint]:
    """One end-to-end FL run on the setup's device; returns the server's
    HistoryPoint sequence.

    ``mode``/``selector``/``aggregator`` pick the thesis §2-3 machinery;
    ``transport``/``transport_down``/``transport_frac`` the wire codecs
    (see ``core.transport``).  ``server_opt`` names a server-side
    optimizer (``"fedavgm"``, ``"fedadam"``, ``"feddyn"``; see
    ``core.server_opt``) with ``server_opt_kw`` its constructor kwargs;
    None keeps the plain FedAvg install.  ``partition`` re-splits the
    setup's pooled samples across its workers (``"dirichlet"`` with
    ``partition_kw={"alpha": ..., "seed": ...}``, ``"quantity"``,
    ``"iid"``; see :func:`repartition_setup`); None leaves the shards as
    they are.  ``max_events`` caps the event loop (the run raises rather
    than silently truncate the history)."""
    if partition is not None:
        setup = repartition_setup(setup, partition=partition,
                                  **(partition_kw or {}))
    if topology is not None:
        _not_ported("topology", "A9")
    if checkpoint_every is not None or checkpoint_dir is not None or resume:
        _not_ported("checkpointing and resume", "A10")
    loop, server = build_experiment(
        setup, mode=mode, selector=selector, aggregator=aggregator,
        epochs_per_round=epochs_per_round, max_rounds=max_rounds,
        target_accuracy=target_accuracy, selector_kw=selector_kw,
        server_freq=server_freq, async_alpha=async_alpha,
        async_stale_pow=async_stale_pow,
        async_min_updates=async_min_updates, async_delta=async_delta,
        async_latest_table=async_latest_table, transport=transport,
        transport_down=transport_down, transport_frac=transport_frac,
        server_mesh=server_mesh, cohort=cohort, server_opt=server_opt,
        server_opt_kw=server_opt_kw)
    server.start()
    loop.run(max_events=max_events)
    if loop.exhausted:
        raise RuntimeError(
            f"event loop exhausted max_events={max_events} with work "
            "still queued — the run did not complete and the history "
            "would be silently truncated; shrink the run or raise "
            "max_events")
    return server.history


def build_experiment(setup: FLSetup, *, mode: str = "sync",
                     selector: str = "all", aggregator: str = "fedavg",
                     epochs_per_round: int = 10, max_rounds: int = 60,
                     target_accuracy: Optional[float] = None,
                     selector_kw: Optional[dict] = None,
                     server_freq: float = 3.0, async_alpha: float = 1.0,
                     async_stale_pow: float = 0.0,
                     async_min_updates: int = 1, async_delta: bool = False,
                     async_latest_table: bool = True,
                     transport: str = "raw",
                     transport_down: Optional[str] = None,
                     transport_frac: float = 0.1,
                     server_mesh: Optional[int] = None,
                     cohort: Optional[int] = None, server_opt=None,
                     server_opt_kw: Optional[dict] = None):
    """Build one single-server federation, wired but NOT started; returns
    ``(loop, server)``."""
    if server_mesh is not None:
        _not_ported("server_mesh", "A11")
    loop = EventLoop()
    est = TimeEstimator(server_freq=server_freq,
                        t_onebatch_server=setup.per_batch_server)
    pop = WorkerPopulation()
    est.bind_population(pop)
    tr = Transport(setup.weights0, codec=transport,
                   down_codec=transport_down, frac=transport_frac,
                   raw_bytes=setup.model_bytes)
    sel = make_selector(selector, est, tr.expected_oneway_bytes,
                        **(selector_kw or {}))
    server = AggregationServer(
        weights=setup.weights0, loop=loop, estimator=est, selector=sel,
        eval_fn=setup.eval_fn, model_bytes=setup.model_bytes,
        aggregator=aggregator, mode=mode, epochs_per_round=epochs_per_round,
        max_rounds=max_rounds, target_accuracy=target_accuracy,
        async_alpha=async_alpha, async_stale_pow=async_stale_pow,
        async_min_updates=async_min_updates, async_delta=async_delta,
        async_latest_table=async_latest_table, transport=tr,
        population=pop, cohort=cohort, server_opt=server_opt,
        server_opt_kw=server_opt_kw)
    for prof, shard in zip(setup.profiles, setup.device_shards):
        w = FLWorker(prof.worker_id, profile=prof, data=shard,
                     train_fn=setup.train_fn, loop=loop,
                     per_batch_time=setup.per_batch_server * server_freq /
                     max(prof.cpu_freq * prof.cpu_prop, 1e-9))
        server.add_worker(w)
    return loop, server


def repartition_setup(setup: FLSetup, *, partition: str, seed: int = 0,
                      **kw) -> FLSetup:
    """Re-split an existing setup's pooled training samples across the
    same workers with a named partitioner (``data.synth.PARTITIONERS``):
    pool every shard back together, re-partition, and return a copy of the
    setup with only ``shards`` and ``device_shards`` replaced (weights,
    profiles, test set and train_fn untouched, so two runs differing only
    in ``partition=`` isolate the statistical-heterogeneity effect)."""
    xs = [s["x"] for s in setup.shards]
    ys = [s["y"] for s in setup.shards]
    nonempty = [a for a in xs if len(a)]
    if not nonempty:
        return setup
    all_x = np.concatenate(nonempty)
    all_y = np.concatenate([a for a in ys if len(a)])
    batches = [p.n_batches if len(s["x"]) else 0
               for p, s in zip(setup.profiles, setup.shards)]
    total = sum(batches)
    batch_size = len(all_x) // max(total, 1)
    shards = partition_split(all_x, all_y, batches, partition=partition,
                             batch_size=batch_size, seed=seed, **kw)
    return dataclasses.replace(
        setup, shards=shards,
        device_shards=_device_shards(shards, setup.device))


def run_sequential_baseline(setup: FLSetup, *, epochs_per_round: int = 10,
                            max_rounds: int = 60,
                            target_accuracy: Optional[float] = None
                            ) -> List[HistoryPoint]:
    all_x = np.concatenate([s["x"] for s in setup.shards if len(s["x"])])
    all_y = np.concatenate([s["y"] for s in setup.shards if len(s["x"])])
    n_batches = sum(p.n_batches for p in setup.profiles)
    return run_sequential(
        weights=setup.weights0, train_fn=setup.train_fn, eval_fn=setup.eval_fn,
        data={"x": all_x, "y": all_y},
        per_batch_time=setup.per_batch_server, n_batches=n_batches,
        epochs_per_round=epochs_per_round, max_rounds=max_rounds,
        target_accuracy=target_accuracy)


def time_to_accuracy(history: List[HistoryPoint], target: float) -> Optional[float]:
    """First (linearly interpolated) simulated time at which accuracy crosses
    ``target``."""
    for prev, h in zip(history, history[1:]):
        if h.accuracy >= target:
            if h.accuracy == prev.accuracy or prev.accuracy >= target:
                return prev.time if prev.accuracy >= target else h.time
            f = (target - prev.accuracy) / (h.accuracy - prev.accuracy)
            return prev.time + f * (h.time - prev.time)
    if history and history[0].accuracy >= target:
        return history[0].time
    return None
