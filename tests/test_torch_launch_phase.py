"""``chip_smoke.py``'s phase 15 rehearsed at REDUCED size on the CPU (the
production training script ``repro_torch.launch.train`` in subprocesses):
the trainer killed after its first checkpoint and resumed in a fresh
process, held against a continuation in this process; every abstract
cell; the depth rule of the fl run; the fl round's B2 check in the
trainer's own process and its controls; a train step freeing its
gradients without the garbage collector.

The kill is keyed to the first checkpoint's appearance, so the writer
needs only enough steps after it that the kill lands before its end
(``RESUME_STEPS``); the reader and this process's continuation each run
the steps after the checkpoint.  torch runs on one thread here and in
the trainers (``OMP_NUM_THREADS=1``): beside other test processes its
thread pool spins.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# the writer's steps: a checkpoint every 2, killed after the first, six
# steps of margin for the kill to land mid-run on a loaded CPU
RESUME_STEPS = 8


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_launch_phase_rehearsed_on_cpu(monkeypatch, tmp_path):
    cpu = torch.device("cpu")
    monkeypatch.setattr(chip_smoke, "LAUNCH_SIZE", ())
    monkeypatch.setattr(chip_smoke, "LAUNCH_RESUME", [
        "--steps", str(RESUME_STEPS), "--ckpt-every", "2", "--batch", "4",
        "--seq", "32"])
    rec = {}
    chip_smoke.launch_kill_resume(cpu, tmp_path, rec)
    assert rec["restored_equal"] and rec["resumed_checkpoints_equal"]
    assert all(rec["resumed_checkpoints_equal"].values())
    assert rec["resumed_at"] == rec["killed_after"][-1] < RESUME_STEPS
    assert rec["continuation_losses"] == rec["resumed_losses"]
    rec = {}
    chip_smoke.launch_abstract(cpu, rec)
    assert len(rec["cells"]) == 80
    assert rec["cells"]["2x16x16/musicgen-medium/train_4k"] == 573_731_844
    # the fl cut at full width: the deepest whose estimate leaves
    # LAUNCH_FREE free, monotone in the free bytes
    monkeypatch.setattr(chip_smoke, "LAUNCH_SIZE", ("--full",))
    room = chip_smoke.LAUNCH_FREE + chip_smoke.LAUNCH_RESERVE
    n48 = chip_smoke.fl_peak_estimate(48)
    assert chip_smoke.fl_depth(n48 + room) == 48
    assert chip_smoke.fl_depth(n48 + room - 1) == 47
    d = chip_smoke.fl_depth(80e9)
    assert chip_smoke.fl_peak_estimate(d) + room <= 80e9 \
        < chip_smoke.fl_peak_estimate(d + 1) + room


def test_chip_smoke_fl_round_check_rehearsed_on_cpu(monkeypatch, tmp_path):
    """Phase 15's fl run at REDUCED: the trainer's round checked in its own
    process, and the check rejects a wrong merge."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(chip_smoke, "LAUNCH_SIZE", ())
    fl = chip_smoke.run_train(cpu, tmp_path, "fl", "--mode", "fl", "--pods",
                              "2", "--steps", "3", "--fl-every", "2",
                              "--batch", "4", "--seq", "32", check="b2")
    (b2,) = fl["checked"]
    assert [r["step"] for r in fl["rounds"]] == [2]
    assert b2["W"] == 2 and b2["N"] == fl["n_params"]
    assert b2["equal"] and b2["max_abs_err"] == 0.0
    assert b2["columns_where_pods_differ"] > 0
    assert not any(b2["controls_pass"].values())
    # chunk edges that cut the rows mid-way, and a merge one ulp off
    monkeypatch.setattr(chip_smoke, "B2_CHUNK", 7)
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.randn(3, 50).astype(np.float32))
    w = torch.tensor([0.5, 0.25, 0.25])
    good = ref.reference_fedavg(rows, w)
    ok = chip_smoke.b2_round_check(rows, w, good)
    assert ok["equal"] and not any(ok["controls_pass"].values())
    bad = good.clone()
    bad[45] = torch.nextafter(bad[45], torch.tensor(np.inf))
    assert not chip_smoke.b2_round_check(rows, w, bad)["equal"]


LEAK_CHECK = """
import gc, sys, weakref
gc.disable()
import torch
from repro_torch import configs, optim
from repro_torch.core import federated
from repro_torch.models import init_params
from repro_torch.tree import leaves
cfg = configs.get_config("musicgen-medium", reduced=True)
params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
opt = optim.adamw()
refs = []
def update(p, g, s):
    refs.extend(weakref.ref(t) for t in leaves(g))
    return opt.update(p, g, s)
traced = optim.Optimizer(init=opt.init, update=update)
sp = federated.stack_for_pods(params, 2)
so = federated.stack_for_pods(opt.init(params), 2)
batch = {"embeds": torch.randn(4, 32, cfg.d_model, dtype=torch.bfloat16),
         "labels": torch.zeros((4, 32), dtype=torch.int32)}
alive = []
for _ in range(2):
    refs.clear()
    federated.fl_local_step(sp, so, batch, cfg=cfg, optimizer=traced,
                            n_pods=2)
    alive.append(sum(r() is not None for r in refs))
print(len(refs), alive)
"""


def test_train_steps_free_their_gradients_without_gc():
    """With the cyclic garbage collector off, no pod's gradients outlive
    its ``train_step`` (first step and later: the first one runs torch's
    lazy imports), so a round's peak holds none (tools/torch_train_memory.py
    saw 2 B a parameter held when they did)."""
    import subprocess
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", LEAK_CHECK],
                          env={"PYTHONPATH": str(root / "src"),
                               "PATH": "/usr/bin:/bin",
                               "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, alive = proc.stdout.split(maxsplit=1)
    assert int(n) > 0 and alive.strip() == "[0, 0]", proc.stdout
