"""The port's kernel entry points (repro_torch.kernels.ops) against the JAX
package's ``kernels/ops.py`` on the same numpy inputs; JAX's kernels run
in interpret mode (its default off the TPU), the port's as their plain
versions (CPU tensors).

Tolerances (tests/test_kernels.py's): flash attention 2e-5 in f32 and
3e-2 in bf16; fedavg 1e-6; WKV 1e-4 in f32, one bf16 ulp of JAX's output
plus 1e-4 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fedavg_agg, ops, rwkv6_kernel


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("S,H,Kv,D", [(128, 4, 2, 32), (256, 2, 1, 64),
                                      (64, 8, 8, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax_ops(S, H, Kv, D, dtype):
    rng = np.random.RandomState(S + D)
    q, k, v = (rng.randn(2, S, n, D).astype(np.float32) for n in (H, Kv, Kv))
    jdt, tdt, tol = ((jnp.float32, torch.float32, 2e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 3e-2))
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)))
    assert got.dtype == tdt
    assert np.abs(_np(got) - _np(want)).max() < tol


@pytest.mark.parametrize("window,cap", [(32, 0.0), (0, 30.0), (64, 50.0)])
def test_flash_attention_window_softcap_matches_jax_ops(window, cap):
    rng = np.random.RandomState(window + int(cap))
    q, k, v = (rng.randn(1, 128, n, 32).astype(np.float32) for n in (4, 2, 2))
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                window=window, softcap=cap)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window, softcap=cap)
    assert np.abs(_np(got) - _np(want)).max() < 2e-5


def test_fedavg_aggregate_matches_jax_ops():
    """Three parameter dicts of mixed shapes, unnormalised weights: one
    packed buffer, one B2 pass, the dict back at the leaves' dtypes."""
    rng = np.random.RandomState(11)
    shapes = {"w1": (784, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}
    trees = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    weights = np.array([2.0, 1.0, 0.5], np.float32)
    want = jops.fedavg_aggregate(
        [{n: jnp.asarray(a) for n, a in t.items()} for t in trees],
        jnp.asarray(weights))
    n0 = dict(fedavg_agg.LAUNCHES)
    got = ops.fedavg_aggregate(
        [{n: torch.from_numpy(a) for n, a in t.items()} for t in trees],
        weights)
    assert fedavg_agg.LAUNCHES == n0          # CPU tensors: the plain version
    assert sorted(got) == sorted(shapes)
    for n in shapes:
        assert got[n].shape == shapes[n] and got[n].dtype == torch.float32
        assert np.abs(_np(got[n]) - _np(want[n])).max() < 1e-6


@pytest.mark.parametrize("S,H,K,chunk", [(64, 2, 16, 16), (128, 3, 32, 32),
                                         (64, 1, 8, 8), (48, 2, 16, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wkv_matches_jax_ops(S, H, K, chunk, dtype):
    """Including a chunk longer than S (taken as S, as JAX takes it)."""
    rng = np.random.RandomState(S + K)
    r, k, v = (rng.randn(2, S, H, K).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.randn(2, S, H, K) * 0.5 - 1.0)).astype(np.float32)
    u = (rng.randn(H, K) * 0.3).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = _np(jops.wkv(*(jnp.asarray(a, jdt) for a in (r, k, v)),
                        jnp.asarray(w), jnp.asarray(u), chunk=chunk))
    n0 = rwkv6_kernel.LAUNCHES["wkv"]
    got = ops.wkv(*(torch.from_numpy(a).to(tdt) for a in (r, k, v)),
                  torch.from_numpy(w), torch.from_numpy(u), chunk=chunk)
    assert rwkv6_kernel.LAUNCHES["wkv"] == n0
    assert got.dtype == tdt and got.shape == (2, S, H, K)
    if dtype == "f32":
        assert np.abs(_np(got) - want).max() < 1e-4
    else:
        assert (np.abs(_np(got) - want) <= 2 ** -7 * np.abs(want) + 1e-4
                ).all()


def test_entry_points_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA card has no kernel and no
    plain version: every entry point raises."""
    q = torch.zeros(1, 16, 2, 16, device="meta")
    with pytest.raises(RuntimeError):
        ops.flash_attention(q, q, q)
    with pytest.raises(RuntimeError):
        ops.fedavg_aggregate([{"w": torch.zeros(4, device="meta")}] * 2,
                             [1.0, 1.0])
    with pytest.raises(RuntimeError):
        ops.wkv(q, q, q, q, torch.zeros(2, 16, device="meta"))
