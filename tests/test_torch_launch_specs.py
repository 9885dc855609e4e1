"""The launch path's sharding rules, meshes and abstract inputs (ROADMAP
A8, first half) against the JAX package, on the CPU.

* ``param_specs``, ``batch_specs`` and ``state_specs``: equal to JAX's,
  path for path, for every arch's FULL config on 16 x 16, 2 x 16 x 16
  and 1 x 1 meshes built like tests/test_substrate.py's ``FakeMesh`` (the
  same object goes to both packages); JAX's trees come from
  ``jax.eval_shape``, the port's from its abstract inputs, whose shapes
  and dtypes equal JAX's.
* ``input_specs``: every cell of ``SHAPES`` x ``list_archs()`` on both
  production meshes, every leaf's per-device shard shape and the cell's
  per-device bytes equal to those of JAX's own ``input_specs`` on an
  abstract mesh of the same axes; every leaf a meta tensor (no storage).
* ``NamedSharding.shard_shape`` equal to JAX's, and raising where JAX's
  does; the dims sharded only where divisible (the counterpart of
  ``test_param_specs_divisibility``).
* ``constrain_qkv``/``constrain_act`` return their inputs, as JAX's do
  with no mesh active.
* ``train_step(grad_specs=...)`` equals ``grad_specs=None`` bit for bit
  (parameters, optimizer state, metrics), with specs or named shardings;
  a tree that does not match the parameters raises.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.parallel import sharding as jsh
from repro_torch import configs, models, optim
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.parallel import sharding as psh
from repro_torch.tree import leaves, tree_map_with_path

ARCHS = configs.list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
PRODUCTION = {"16x16": False, "2x16x16": True}


def fake_mesh(name):
    shape, axes = MESHES[name]

    class FakeMesh:
        axis_names = axes
        devices = np.empty(shape)
    return FakeMesh()


class JAbstractMesh(AbstractMesh):
    """JAX's abstract mesh with the ``devices`` its ``_sizes`` reads."""

    @property
    def devices(self):
        return np.empty(tuple(self.axis_sizes))


def _jflat(tree):
    """JAX tree -> {dict-key path: leaf}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP))[0]:
        out[tuple(p.key for p in path)] = leaf
    return out


def _tflat(tree):
    """Port tree -> {dict-key path: leaf}."""
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _same_specs(jtree, ttree):
    j, t = _jflat(jtree), _tflat(ttree)
    assert sorted(j) == sorted(t)
    bad = {p: (tuple(j[p]), tuple(t[p])) for p in j
           if tuple(j[p]) != tuple(t[p])}
    assert not bad, bad
    return len(j)


def _same_shapes(jtree, ttree):
    j, t = _jflat(jtree), _tflat(ttree)
    assert sorted(j) == sorted(t)
    for p in j:
        assert tuple(j[p].shape) == tuple(t[p].shape), p
        assert str(j[p].dtype) == str(t[p].dtype).replace("torch.", ""), p


@functools.lru_cache(maxsize=None)
def _jparam_shapes(arch):
    return jax.eval_shape(functools.partial(jinit_params,
                                            cfg=jget_config(arch)),
                          jax.random.PRNGKey(0))


def _jbatch(cfg, shape_name):
    """JAX's abstract batch tree of a cell (specs.abstract_batch's)."""
    info = JSHAPES[shape_name]
    B = info["global_batch"]
    S = 1 if info["kind"] == "decode" else info["seq_len"]
    batch = {}
    if cfg.embeds_input:
        batch["embeds"] = jax.ShapeDtypeStruct((B, S, cfg.d_model),
                                               jnp.bfloat16)
    else:
        batch["tokens"] = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if info["kind"] == "train":
        batch["labels"] = jax.ShapeDtypeStruct((B, S), jnp.int32)
    return batch


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_path_for_path(arch, mesh_name):
    """Parameters, every cell's batch and every decode cell's state: the
    same paths, shapes, dtypes and specs as JAX's."""
    mesh = fake_mesh(mesh_name)
    jcfg, cfg = jget_config(arch), configs.get_config(arch)
    jshapes = _jparam_shapes(arch)
    tshapes = specs._param_shapes(cfg)
    _same_shapes(jshapes, tshapes)
    assert all(t.is_meta for t in leaves(tshapes))
    n = _same_specs(jsh.param_specs(jcfg, jshapes, mesh),
                    psh.param_specs(cfg, tshapes, mesh))
    assert n == len(list(leaves(tshapes)))
    for shape_name, info in JSHAPES.items():
        jb = _jbatch(jcfg, shape_name)
        tb = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)),
                             device="meta") for k, v in jb.items()}
        _same_specs(jsh.batch_specs(jcfg, jb, mesh),
                    psh.batch_specs(cfg, tb, mesh))
        if info["kind"] != "decode":
            continue
        B, S = info["global_batch"], info["seq_len"]
        jst = jax.eval_shape(functools.partial(jinit_decode_state, jcfg,
                                               B, S))
        tst = specs._fake(lambda: models.init_decode_state(cfg, B, S,
                                                           device="cpu"))
        _same_shapes(jst, tst)
        _same_specs(jsh.state_specs(jcfg, jst, mesh, B),
                    psh.state_specs(cfg, tst, mesh, B))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_name", list(PRODUCTION))
def test_input_specs_per_device_bytes_match_jax(mesh_name, arch):
    """Every cell of the arch on a production mesh: each leaf's shard shape
    and the cell's per-device bytes equal those of JAX's ``input_specs``."""
    shape, axes = MESHES[mesh_name]
    jmesh = JAbstractMesh(shape, axes)
    mesh = tmesh.make_production_mesh(multi_pod=PRODUCTION[mesh_name])
    for shape_name in JSHAPES:
        jkind, jin = jspecs.input_specs(arch, shape_name, jmesh)
        kind, tin = specs.input_specs(arch, shape_name, mesh)
        assert kind == jkind
        j, t = _jflat(jin), _tflat(tin)
        assert sorted(j) == sorted(t)
        jbytes = 0
        for p, leaf in j.items():
            js = tuple(leaf.sharding.shard_shape(leaf.shape))
            assert t[p].shard_shape() == js, (shape_name, p)
            assert t[p].shape == tuple(leaf.shape), (shape_name, p)
            assert t[p].tensor.is_meta
            jbytes += int(np.prod(js)) * leaf.dtype.itemsize
            assert tuple(t[p].sharding.spec) == tuple(leaf.sharding.spec)
        assert specs.per_device_bytes(tin) == jbytes, shape_name


def test_production_and_host_meshes(monkeypatch):
    """The production meshes have the reference's axes and shapes and hold
    no device; the host mesh is (1, n) over this host's devices, the CPU
    only when asked for."""
    for name, multi in PRODUCTION.items():
        m = tmesh.make_production_mesh(multi_pod=multi)
        shape, axes = MESHES[name]
        assert m.axis_names == axes and m.devices.shape == shape
        assert dict(m.shape) == dict(zip(axes, shape))
        assert all(d is None for d in m.devices.flat)
        assert psh.dp_axes(m) == jsh.dp_axes(fake_mesh(name))
        assert psh._dp_total(m) == jsh._dp_total(fake_mesh(name))
    m = tmesh.make_host_mesh("cpu")
    assert m.axis_names == ("data", "model") and m.devices.shape == (1, 1)
    assert m.devices[0, 0] == torch.device("cpu")
    monkeypatch.setenv("REPRO_HOST_DEVICES", "4")
    assert tmesh.make_host_mesh("cpu").devices.shape == (1, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh()


SHARD_CASES = [((64, 32, 5), (("pod", "data"), "model")),
               ((64, 32, 5), ("data", None, None)),
               ((64, 32), ()),
               ((32, 48), ("model",)),
               ((6, 32), ("data", None)),        # 6 % 16: raises
               ((2, 32), (None, ("pod", "data", "model")))]


@pytest.mark.parametrize("shape,spec", SHARD_CASES,
                         ids=[str(i) for i in range(len(SHARD_CASES))])
def test_named_sharding_shard_shape_matches_jax(shape, spec):
    jmesh = JAbstractMesh((2, 16, 16), ("pod", "data", "model"))
    mesh = tmesh.make_production_mesh(multi_pod=True)
    js = JNamedSharding(jmesh, JP(*spec))
    ts = psh.named(mesh, psh.P(*spec))
    assert tuple(ts.spec) == tuple(js.spec)
    try:
        want = js.shard_shape(shape)
    except ValueError:
        with pytest.raises(ValueError, match="divisible"):
            ts.shard_shape(shape)
        return
    assert ts.shard_shape(shape) == tuple(want)


@pytest.mark.parametrize("mesh_name", list(PRODUCTION))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisibility(arch, mesh_name):
    """Dims are sharded only when divisible by the mesh axis size."""
    mesh = tmesh.make_production_mesh(multi_pod=PRODUCTION[mesh_name])
    sizes = dict(mesh.shape)
    cfg = configs.get_config(arch)
    shapes = specs._param_shapes(cfg)
    flat_shapes = _tflat(shapes)
    flat_specs = _tflat(psh.param_specs(cfg, shapes, mesh))
    sharded = 0
    for path, leaf in flat_shapes.items():
        for dim, ax in zip(leaf.shape, tuple(flat_specs[path])):
            if ax is not None:
                sharded += 1
                axes = (ax,) if isinstance(ax, str) else ax
                assert dim % int(np.prod([sizes[a] for a in axes])) == 0, \
                    (path, leaf.shape, flat_specs[path])
    assert sharded > 0


def test_constrain_leaves_inputs_unchanged():
    """With no mesh active JAX's constraints return their inputs; the port
    has no trace-time mesh at all, under the pod-vmap flag or not."""
    rng = np.random.RandomState(0)
    arrs = [rng.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3)]
    q, k, v = (torch.from_numpy(a) for a in arrs)
    x = torch.from_numpy(rng.randn(2, 16, 32).astype(np.float32))
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    for ctx in (psh.pod_axis_is_vmapped, lambda: torch.no_grad()):
        with ctx():
            out = psh.constrain_qkv(q, k, v)
            assert all(a is b for a, b in zip(out, (q, k, v)))
            assert psh.constrain_act(x) is x
            assert psh.current_mesh_axes() == {} == jsh.current_mesh_axes()
    jout = jsh.constrain_qkv(jq, jk, jv)
    assert all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(jout, (q, k, v)))
    assert np.array_equal(np.asarray(jsh.constrain_act(jnp.asarray(
        x.numpy()))), x.numpy())


def _step(cfg, params, grad_specs, n_microbatch, seed=0):
    """One AdamW train_step from copies of ``params``: (params, opt state,
    metrics) as flat lists of tensors."""
    p = models.params_from_numpy(params, "cpu")
    opt = optim.adamw(3e-3)
    st = opt.init(p)
    rng = np.random.RandomState(seed)
    batch = {"labels": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))}
    if cfg.embeds_input:
        batch["embeds"] = torch.from_numpy(
            rng.randn(4, 16, cfg.d_model).astype(np.float32))
    else:
        batch["tokens"] = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (4, 16)).astype(np.int32))
    p, st, met = models.train_step(p, st, batch, cfg=cfg, optimizer=opt,
                                   n_microbatch=n_microbatch,
                                   grad_specs=grad_specs(p))
    return list(leaves(p)) + list(leaves(st)) + [met[k] for k in sorted(met)]


@pytest.mark.parametrize("n_microbatch", [1, 2])
@pytest.mark.parametrize("arch", ["yi-9b", "zamba2-7b", "musicgen-medium"])
def test_train_step_grad_specs_equal_none_bit_for_bit(arch, n_microbatch):
    cfg = configs.get_config(arch, reduced=True)
    params = jax.tree.map(np.asarray, jinit_params(
        jax.random.PRNGKey(0), jget_config(arch, reduced=True)))
    mesh = tmesh.make_production_mesh()
    want = _step(cfg, params, lambda p: None, n_microbatch)
    for specs_of in (lambda p: psh.param_specs(cfg, p, mesh),
                     lambda p: psh.to_named_tree(
                         mesh, psh.param_specs(cfg, p, mesh))):
        got = _step(cfg, params, specs_of, n_microbatch)
        assert len(got) == len(want)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))


def test_train_step_grad_specs_mismatch_raises():
    cfg = configs.get_config("yi-9b", reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    opt = optim.adamw(3e-3)
    st = opt.init(params)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    good = psh.param_specs(cfg, params, tmesh.make_production_mesh())
    missing = dict(good, blocks={k: v for k, v in good["blocks"].items()
                                 if k != "ln1"})
    extra = dict(good, extra=psh.P())
    leaf_for_dict = dict(good, final_norm=psh.P())
    not_a_spec = dict(good, final_norm={"scale": ("data",)})
    before = [t.clone() for t in leaves(params)]
    for bad in (missing, extra, leaf_for_dict, not_a_spec, {}):
        with pytest.raises(ValueError, match="grad_specs"):
            models.train_step(params, st, batch, cfg=cfg, optimizer=opt,
                              grad_specs=bad)
    # a refused tree leaves the parameters as they were
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), before))
    assert int(st["step"]) == 0
