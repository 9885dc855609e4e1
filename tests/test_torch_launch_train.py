"""The production training script ``repro_torch.launch.train`` at REDUCED
sizes on the CPU against the JAX package's ``launch/train.py`` ``main``,
run in this process on the same initial parameters: JAX's
``init_params(PRNGKey(0))`` carried across through ``params_from_numpy``,
and for musicgen-medium (an ``embeds_input`` arch) JAX's per-step embeds
``jax.random.normal(PRNGKey(step))`` in place of the port's draws.  JAX's
per-step outputs are read by wrapping ``jax.jit`` while its ``main`` runs.

Tolerances (relative, of the loss): the first step within 1e-3; every
later step within ``LOSS_TOL`` = 5e-4 (measured at most 5.5e-5 over six
steps of yi-9b and musicgen-medium, single and fl mode: bf16 forward and
backward in two frameworks, then AdamW); a data iterator one batch ahead
must exceed it.  Parameters after the run and after each round: every
element within ``PARAM_TOL`` = 0.025 (about 8 steps of the learning
rate 3e-3; measured at most 0.0122 after six steps) and at most
``SHARE_TOL`` = 5% of them beyond ``NEAR`` = 1e-3 (measured at most
1.8%): two AdamW runs on bf16 parameters part where a gradient is near
zero, while the pre-round parameters against the merged ones differ in
85% of the elements.

Resume: both trainers restart their data iterator on ``--resume`` (the
resumed steps train on the first batches again) and draw embeds by the
step; the port's resumed steps equal a same-process continuation from
the checkpoint bit for bit, and differ from the uninterrupted run as
JAX's do.

``chip_smoke.py``'s phase 15 is rehearsed in ``test_torch_launch_phase.py``.
torch runs on one thread here: beside other test processes its thread
pool spins (the port's fl run took 8.1 s on eight threads, 1.3 s on
one).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import synthetic_token_batches
from repro_torch.launch import train
from repro_torch.models import params_from_numpy, train_step
from repro_torch.tree import leaves

FIRST_TOL = 1e-3
LOSS_TOL = 5e-4
PARAM_TOL = 0.025
NEAR = 1e-3
SHARE_TOL = 0.05


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jax(monkeypatch, argv):
    """JAX's ``main`` on ``argv``; returns the output of every jitted call
    (steps and rounds) in order."""
    calls = []
    real = jax.jit

    def jit(fn, *a, **kw):
        jfn = real(fn, *a, **kw)

        def call(*args):
            out = jfn(*args)
            calls.append(out)
            return out
        return call
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", jit)
        m.setattr(sys, "argv", ["train"] + argv)
        jtrain.main()
    return calls


def jax_embeds(step, shape, device):
    emb = jax.random.normal(jax.random.PRNGKey(step), shape, jnp.bfloat16)
    return torch.from_numpy(np.asarray(emb, np.float32)).to(
        device=device, dtype=torch.bfloat16)


def run_port(monkeypatch, argv, jparams, rounds=None):
    """The port's ``main`` on ``argv`` from JAX's parameters (and JAX's
    embeds); ``rounds`` collects each ``fl_round``'s output."""
    with monkeypatch.context() as m:
        m.setattr(train, "init_params",
                  lambda g, cfg, device=None: params_from_numpy(jparams,
                                                                device))
        m.setattr(train, "step_embeds", jax_embeds)
        if rounds is not None:
            real = train.federated.fl_round

            def fl_round(*a):
                out = real(*a)
                rounds.append([t.clone() for t in leaves(out)])
                return out
            m.setattr(train.federated, "fl_round", fl_round)
        return train.main(argv + ["--device", "cpu"])


def jparams_of(arch):
    cfg = jget_config(arch, reduced=True)
    return jax.tree.map(np.asarray, jmodels.init_params(
        jax.random.PRNGKey(0), cfg))


def step_outputs(calls):
    return [c for c in calls if isinstance(c, tuple) and len(c) == 3]


def jloss(out):
    return float(jnp.mean(out[2]["loss"]))


def rel(a, b):
    return abs(a - b) / abs(b)


def param_gap(jtree, ttensors):
    """(largest |difference|, share of elements differing by more than
    ``NEAR``) over every leaf (the port's leaf order is JAX's)."""
    jl = [np.asarray(x, np.float32) for x in jax.tree.leaves(jtree)]
    assert len(jl) == len(ttensors)
    diffs = [np.abs(a - b.float().numpy()).ravel()
             for a, b in zip(jl, ttensors)]
    d = np.concatenate(diffs)
    return float(d.max()), float((d > NEAR).mean())


def params_close(jtree, ttensors):
    big, share = param_gap(jtree, ttensors)
    return big <= PARAM_TOL and share <= SHARE_TOL


CLI_CASES = [("yi-9b", "single"), ("musicgen-medium", "single"),
             ("musicgen-medium", "fl")]


@pytest.mark.parametrize("arch,mode", CLI_CASES,
                         ids=[f"{a}-{m}" for a, m in CLI_CASES])
def test_cli_matches_jax(arch, mode, monkeypatch, tmp_path, capsys):
    """Six steps (fl: two pods, a round every 2 steps) of both trainers
    from the same parameters: every step's loss, the rounds' merged
    parameters and the final parameters."""
    argv = ["--arch", arch, "--mode", mode, "--steps", "6", "--batch", "4",
            "--seq", "32", "--fl-every", "2", "--ckpt-every", "100"]
    jp = jparams_of(arch)
    calls = run_jax(monkeypatch, argv + ["--ckpt-dir", str(tmp_path / "j")])
    rounds = []
    out = run_port(monkeypatch, argv + ["--ckpt-dir", str(tmp_path / "t")],
                   jp, rounds)
    steps = step_outputs(calls)
    want = [jloss(s) for s in steps]
    got = out["losses"]
    assert len(got) == len(want) == 6
    assert rel(got[0], want[0]) <= FIRST_TOL
    assert max(rel(a, b) for a, b in zip(got[1:], want[1:])) <= LOSS_TOL, \
        (got, want)
    final = calls[-1] if mode == "fl" else steps[-1][0]   # fl: a round
    assert params_close(final, list(leaves(out["params"]))), \
        param_gap(final, list(leaves(out["params"])))
    printed = capsys.readouterr().out
    assert "[train] summary" in printed and printed.rstrip().endswith("done")
    if mode == "fl":
        jrounds = [c for c in calls if not isinstance(c, tuple)]
        assert len(rounds) == len(jrounds) == 3
        assert [r["step"] for r in out["rounds"]] == [2, 4, 6]
        assert all(r["pods_equal"] for r in out["rounds"])
        for jr, tr in zip(jrounds, rounds):
            assert params_close(jr, tr), param_gap(jr, tr)
            assert all(torch.equal(t[0], t[1]) for t in tr)
        assert out["launches"]["fedavg_agg"]["agg"] == 0     # the CPU
    else:
        assert out["rounds"] == []
    if (arch, mode) == ("yi-9b", "single"):
        # control: the data iterator one batch ahead
        def ahead(**kw):
            it = synthetic_token_batches(**kw)
            next(it)
            return it
        monkeypatch.setattr(train, "synthetic_token_batches", ahead)
        moved = run_port(monkeypatch, argv + ["--ckpt-dir",
                                              str(tmp_path / "c")], jp)
        assert max(rel(a, b) for a, b in zip(moved["losses"], want)) > \
            LOSS_TOL


def test_resume_matches_jax(monkeypatch, tmp_path):
    """Four steps saved every 2, then ``--resume`` to step 6, on both
    sides: the resumed run starts at the newest checkpoint, trains on the
    first batches again (the iterator restarts) with the steps' own
    embeds, and is not the uninterrupted run."""
    arch = "musicgen-medium"
    base = ["--arch", arch, "--batch", "4", "--seq", "32", "--ckpt-every",
            "2"]
    jp = jparams_of(arch)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    run_jax(monkeypatch, base + ["--steps", "4", "--ckpt-dir", jdir])
    jres = step_outputs(run_jax(monkeypatch, base + [
        "--steps", "6", "--ckpt-dir", jdir, "--resume"]))
    jfull = step_outputs(run_jax(monkeypatch, base + [
        "--steps", "6", "--ckpt-dir", str(tmp_path / "jf")]))
    first = run_port(monkeypatch, base + ["--steps", "4", "--ckpt-dir",
                                          tdir], jp)
    assert CheckpointManager(tdir).steps() == [2, 4]
    res = run_port(monkeypatch, base + ["--steps", "6", "--ckpt-dir", tdir,
                                        "--resume"], jp)
    assert res["start_step"] == 4 and len(res["losses"]) == len(jres) == 2
    want = [jloss(s) for s in jres]
    assert max(rel(a, b) for a, b in zip(res["losses"], want)) <= LOSS_TOL
    # the iterator restarts on both sides: not the uninterrupted run
    full = [jloss(s) for s in jfull[4:]]
    assert max(rel(a, b) for a, b in zip(want, full)) > LOSS_TOL
    assert max(rel(a, b) for a, b in zip(res["losses"], full)) > LOSS_TOL
    # a same-process continuation from the step-4 checkpoint, on the first
    # batches: bit for bit
    _, state, _ = CheckpointManager(tdir).restore(4)
    p = train.to_device(state["params"], "cpu")
    st = train.to_device(state["opt_state"], "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(p), leaves(first["params"])))
    cfg = train.get_config(arch, reduced=True)
    opt = optim.adamw(3e-3)
    data = synthetic_token_batches(vocab=cfg.vocab_size, batch=4, seq_len=32)
    cont = []
    for step in (4, 5):
        b = next(data)
        batch = {"embeds": jax_embeds(step, (4, 32, cfg.d_model), "cpu"),
                 "labels": torch.from_numpy(b["labels"])}
        p, st, met = train_step(p, st, batch, cfg=cfg, optimizer=opt)
        cont.append(float(met["loss"]))
    assert cont == res["losses"]
    assert all(torch.equal(a, b) for a, b in
               zip(leaves(p), leaves(res["params"])))
    # --resume with no checkpoint starts at step 0, as the reference's
    fresh = run_port(monkeypatch, base + ["--steps", "1", "--ckpt-dir",
                                          str(tmp_path / "e"), "--resume"],
                     jp)
    assert fresh["start_step"] == 0 and len(fresh["losses"]) == 1


def test_trainer_needs_the_card_or_the_cpu_asked_for():
    """``--device`` defaults to the card; without one the trainer exits
    before any work rather than train on the CPU."""
    assert train.parse_args([]).device == "cuda"
    assert train.parse_args([]).arch == "musicgen-medium"
    assert train.parse_args([]).reduced and \
        not train.parse_args(["--full"]).reduced
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train.main(["--steps", "1"])
