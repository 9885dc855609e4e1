"""Shared inputs of the LM parity tests (tests/test_torch_moe.py,
test_torch_mamba2.py, test_torch_train.py, test_torch_federated.py): the
JAX package's parameter tree for a config, filled from a numpy seed, and
the relative gap the tests measure."""
import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import init_params as jinit
from repro_torch import configs, models

# mamba2 leaves that are not projections: (mean, std) of their draws
_MAMBA_FILL = {"conv_x_w": (0.0, 0.2), "conv_bc_w": (0.0, 0.2),
               "conv_x_b": (0.0, 0.1), "conv_bc_b": (0.0, 0.1),
               "dt_bias": (0.0, 0.3), "a_log": (0.0, 0.3),
               "d_skip": (1.0, 0.1), "norm_scale": (1.0, 0.1)}


def np_params(cfg, seed=0):
    """The JAX package's parameter tree for ``cfg``, filled with numpy
    draws: dense weights normal / sqrt(fan_in), the embedding normal *
    0.02, the norm scales 0.1 * normal (so the (1 + scale) form is live),
    mamba2's conv, bias, decay and skip leaves near their initial values."""
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in _MAMBA_FILL:
            mean, std = _MAMBA_FILL[name]
            return (mean + std * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "scale":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "embedding":
            return (0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        fan = leaf.shape[-3] if name in ("wq", "wk", "wv") else leaf.shape[-2]
        return (rng.randn(*leaf.shape) / np.sqrt(fan)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def both(arch, jimpl="xla", timpl="xla", seed=0, **replace):
    """(JAX config, port config, JAX bf16 params, port params on the CPU)
    for ``arch``'s REDUCED config with ``replace`` applied to both."""
    jcfg = jconfigs.get_config(arch, reduced=True).replace(attn_impl=jimpl,
                                                            **replace)
    tcfg = configs.get_config(arch, reduced=True).replace(attn_impl=timpl,
                                                          **replace)
    P = np_params(jcfg, seed)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), P)
    return jcfg, tcfg, jp, models.params_from_numpy(P, device="cpu")


def rel(got, want):
    """max |got - want| / max |want| (floored at 1e-3), in f32."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-3))


def tree_rel(got, want):
    """The largest ``rel`` over matching leaves of two trees."""
    gl = [t for _, t in sorted(_flat(got))]
    wl = [t for _, t in sorted(_flat(want))]
    assert len(gl) == len(wl)
    return max(rel(g, w) for g, w in zip(gl, wl))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v
