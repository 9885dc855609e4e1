"""The port stands alone: no module of ``src/repro_torch``, no
``tools/torch_*.py``, ``benchmarks/torch_*.py`` or ``examples/torch_*.py``
script and not ``chip_smoke.py`` imports ``jax`` or the JAX package
``repro``; the port imports with both blocked; and its entry points
(``make_setup``, ``agg_mesh``, the bench twins) do not fall back to the
CPU when no device was asked for."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "tools").glob("torch_*.py")) + \
    sorted((ROOT / "benchmarks").glob("torch_*.py")) + \
    sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_neither_jax_nor_repro(path):
    assert path.exists()
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.core, repro_torch.kernels.fedavg_agg, "
            "repro_torch.kernels.topk_quant, repro_torch.kernels.server_opt, "
            "repro_torch.models.cnn, repro_torch.kernels._build, "
            "repro_torch.kernels.flash_attention, repro_torch.models, "
            "repro_torch.models.attention, repro_torch.models.layers, "
            "repro_torch.configs, repro_torch.data.lm, "
            "repro_torch.launch.analytics, repro_torch.kernels.ops, "
            "repro_torch.kernels.rwkv6_kernel, repro_torch.models.rwkv6, "
            "repro_torch.core.autotune, repro_torch.core.topology, "
            "repro_torch.runtime.faults, repro_torch.checkpoint, "
            "repro_torch.parallel.sharding, repro_torch.models.moe, "
            "repro_torch.models.mamba2, repro_torch.optim, "
            "repro_torch.core.compression, repro_torch.core.federated, "
            "repro_torch.parallel, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.train\n"
            "assert 'repro_torch.core.experiment' in sys.modules\n"
            "assert 'repro_torch.models.transformer' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_make_setup_without_device_needs_the_card():
    from repro_torch.core import TABLE_4_1, make_setup
    if torch.cuda.is_available():
        setup = make_setup(TABLE_4_1["mnist_even"])
        assert setup.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_setup(TABLE_4_1["mnist_even"])


def test_agg_mesh_without_platform_needs_the_card():
    """``agg_mesh`` with no platform is on the card, as ``make_setup``
    is, and raises without one rather than build a CPU mesh."""
    from repro_torch.parallel import sharding as psh
    if torch.cuda.is_available():
        assert psh.agg_mesh(1).devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            psh.agg_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            psh.agg_mesh(1)
    assert psh.agg_mesh(1, platform="cpu").devices == (torch.device("cpu"),)


def _bench(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmarks" / f"{name}.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.mark.parametrize("name", ["torch_fl_figures", "torch_agg_bench",
                                  "torch_scale_bench"])
def test_bench_twin_without_device_needs_the_card(name, monkeypatch):
    """The experiment and bench twins run on the card: without one they
    exit unless the CPU is asked for, and never run the CPU in the card's
    place."""
    bench = _bench(name)
    assert bench.device_or_exit("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert bench.device_or_exit("cuda").type == "cuda"
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.device_or_exit("cuda")
    if name == "torch_fl_figures":
        assert bench.parse_args([]).device == "cuda"
        ran = []
        monkeypatch.setitem(bench.ALL, "table5_1_time_to_accuracy",
                            lambda **kw: ran.append(kw))
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main(["--only", "table5_1_time_to_accuracy"])
        assert not ran
    elif name == "torch_agg_bench":
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main([])
    else:
        # main() as torch_fl_figures --smoke-scale calls it: the card
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(smoke=True)


def test_device_or_exit_is_the_card_or_the_cpu_asked_for():
    """The scripts' one device policy (``repro_torch.device_or_exit``):
    the first card for "cuda" or None, the CPU only by name, TF32 off."""
    from repro_torch import device_or_exit
    assert device_or_exit("cpu") == torch.device("cpu")
    for name in ("cuda", None):
        if torch.cuda.is_available():
            assert device_or_exit(name) == torch.device("cuda", 0)
            assert not torch.backends.cuda.matmul.allow_tf32
        else:
            with pytest.raises(SystemExit, match="no CUDA device"):
                device_or_exit(name)


def test_card_name_without_nvidia_smi(monkeypatch):
    """``card_name`` says "no card" where nvidia-smi cannot be run."""
    import repro_torch
    monkeypatch.setenv("PATH", "/nonexistent")
    assert repro_torch.card_name() == "no card"


def test_agg_shard_bench_without_device_needs_the_card():
    """The sharded-aggregation bench measures on the card: without one it
    exits unless the CPU is asked for, and never times the CPU in the
    card's place."""
    import importlib.util
    path = ROOT / "benchmarks" / "torch_agg_shard_bench.py"
    spec = importlib.util.spec_from_file_location("torch_agg_shard_bench",
                                                  path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.parse_args([]).device == "cuda"
    assert bench.parse_args(["--smoke"]).device == "cpu"
    assert bench.parse_args(["--smoke", "--device", "cuda"]).device == "cuda"
    assert bench.device_or_exit("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert bench.device_or_exit("cuda").type == "cuda"
    else:
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.device_or_exit(bench.parse_args([]).device)


# topology, cohorts, checkpoints and the sharded server are ported; the
# checkpoint options raise as the JAX package's do without a directory,
# and a server mesh larger than the devices there are as agg_mesh does
UNPORTED = [
    (dict(topology="1x2", checkpoint_every=2), ValueError,
     "checkpointing needs checkpoint_dir"),
    (dict(checkpoint_every=2), ValueError,
     "checkpointing needs checkpoint_dir"),
    (dict(resume=True), ValueError, "checkpointing needs checkpoint_dir"),
    (dict(server_mesh=64), ValueError, "server mesh of 64 devices"),
    (dict(cohort=4, server_mesh=64), ValueError,
     "server mesh of 64 devices"),
    # the three server optimizers are ported; any other name raises
    (dict(server_opt="fedyogi"), ValueError, "unknown server_opt")]


@pytest.mark.parametrize("kw,exc,match", UNPORTED,
                         ids=[next(iter(kw)) for kw, _, _ in UNPORTED])
def test_unported_run_fl_options_raise(kw, exc, match):
    from repro_torch.core import TABLE_4_1, make_setup, run_fl
    setup = make_setup(TABLE_4_1["mnist_even"], device="cpu")
    with pytest.raises(exc, match=match):
        run_fl(setup, max_rounds=1, epochs_per_round=1, **kw)


def test_cnn_model_is_not_ported():
    """The CNN itself is ported; what the JAX package does not wire for it
    (worker-side FedProx) raises as it does there."""
    from repro_torch.core import TABLE_4_1, make_setup
    with pytest.raises(ValueError, match="fedprox_mu"):
        make_setup(TABLE_4_1["mnist_even"], model="cnn", fedprox_mu=0.01,
                   device="cpu")


def test_pod_and_wire_twins_without_device_need_the_card():
    """``examples/torch_lm_federated_pods.py`` and
    ``benchmarks/torch_wire_bench.py`` run on the card: without one they
    exit unless the CPU is asked for (``--smoke`` asks for it)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_lm_federated_pods",
        ROOT / "examples" / "torch_lm_federated_pods.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    assert ex.parse_args([]).device == "cuda"
    assert "benchmarks/results/torch" in ex.parse_args([]).ckpt_dir
    bench = _bench("torch_wire_bench")
    assert bench.parse_args([]).device == "cuda"
    assert bench.parse_args(["--smoke"]).device == "cpu"
    assert bench.RESULTS == ROOT / "benchmarks" / "results" / "torch"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            ex.main(["--steps", "1"])
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main([])
