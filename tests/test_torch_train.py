"""The port's LM training path (``layers.chunked_ce_loss``,
``transformer.loss_fn`` / ``train_step``, ``optim``) against the JAX
package on the same numpy inputs, at the REDUCED configs; and the rules
that keep the forward-only kernels off it.

Tolerances:
* ``chunked_ce_loss``: within ``CE_TOL`` = 3e-4 of JAX's, relative (bf16
  logits, where the frameworks' matmul and tanh round a few entries to
  the other neighbour; measured at most 9.4e-5); against the port's
  unchunked NLL within 1e-5; a loss without the mask must fail.
* ``loss_fn``: the loss within 1e-4 relative (its f32 tail over bf16
  hidden states; measured at most 6e-6) for one arch of each family; its
  gradients, leaf by leaf, within ``GRAD_TOL`` = 0.06 of the leaf's
  largest |value| (bf16 gradients through bf16 activations: measured at
  most 0.038); the MoE aux loss within 0.02 relative (a token near a
  routing tie may pick another first choice).
* ``adamw`` / ``sgd``: f32 masters, moments and the bf16 parameters
  within 2e-6 (the same f32 ops; XLA may contract some into FMAs).
* ``n_microbatch`` 2: the gradients given to the optimizer equal the f32
  mean of the two halves' gradients bit for bit, and are within
  ``MB_TOL`` = 2^-6 (four bf16 ulps at the leaf's largest |value|) of
  the whole batch's, leaf by leaf; the first microbatch alone and the
  sum not divided must fail that.  Remat off against on: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro_torch import configs, models, optim
from repro_torch.kernels import flash_attention, records_grad, rwkv6_kernel
from repro_torch.models import layers, rwkv6
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves
from torch_lm_common import both, rel

GRAD_TOL = 0.06
MB_TOL = 2.0 ** -6
CE_TOL = 3e-4
TRAIN_ARCHS = ["yi-9b", "gemma2-2b", "mixtral-8x22b", "zamba2-7b",
               "rwkv6-3b", "musicgen-medium"]


def _batch(cfg, B=2, S=32, seed=2, mask=True):
    rng = np.random.RandomState(seed)
    batch = {"labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if mask:
        batch["mask"] = (rng.rand(B, S) > 0.2).astype(np.float32)
    if cfg.embeds_input:
        batch["embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    else:
        batch["tokens"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("cap", [0.0, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_chunked_ce_loss_matches_jax(cap, with_mask):
    rng = np.random.RandomState(0)
    B, S, D, V = 2, 48, 16, 40
    h = rng.randn(B, S, D).astype(np.float32)
    emb = rng.randn(V, D).astype(np.float32)
    lab = rng.randint(0, V, (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.3).astype(np.float32) if with_mask else None
    jbf = lambda a: jnp.asarray(a, jnp.bfloat16)   # noqa: E731
    want = jl.chunked_ce_loss({"embedding": jbf(emb)}, jbf(h),
                              jnp.asarray(lab), chunk=16, final_softcap=cap,
                              mask=None if mask is None else
                              jnp.asarray(mask))
    tbf = lambda a: torch.from_numpy(a).to(torch.bfloat16)   # noqa: E731
    got = layers.chunked_ce_loss({"embedding": tbf(emb)}, tbf(h),
                                 torch.from_numpy(lab), chunk=16,
                                 final_softcap=cap,
                                 mask=None if mask is None else
                                 torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(want)) <= CE_TOL * abs(float(want))
    # the same loss unchunked
    logits = tbf(h) @ tbf(emb).T
    if cap:
        logits = layers.softcap(logits, cap)
    nll = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, V), torch.from_numpy(lab).long().reshape(
            -1), reduction="none")
    m = torch.ones(B * S) if mask is None else torch.from_numpy(mask)
    whole = (nll * m.reshape(-1)).sum() / m.sum()
    assert abs(float(got) - float(whole)) <= 1e-5 * float(whole)
    if with_mask:
        # control: the mask dropped
        nomask = layers.chunked_ce_loss({"embedding": tbf(emb)}, tbf(h),
                                        torch.from_numpy(lab), chunk=16,
                                        final_softcap=cap)
        assert abs(float(nomask) - float(want)) > CE_TOL * float(want)
    with pytest.raises(ValueError, match="loss chunk"):
        layers.chunked_ce_loss({"embedding": tbf(emb)}, tbf(h),
                               torch.from_numpy(lab), chunk=20)


def test_chunked_ce_loss_gradient_through_checkpointed_chunks():
    """Gradients through the recomputed chunks equal the unchunked
    loss's, within one bf16 ulp (the bf16 head's backward is blocked by
    the chunk)."""
    rng = np.random.RandomState(1)
    h = torch.from_numpy(rng.randn(2, 32, 8).astype(np.float32))
    emb = torch.from_numpy(rng.randn(24, 8).astype(np.float32))
    lab = torch.from_numpy(rng.randint(0, 24, (2, 32)))
    grads = []
    for chunk in (8, 32):
        hh = h.clone().requires_grad_()
        ee = emb.clone().requires_grad_()
        loss = layers.chunked_ce_loss({"embedding": ee}, hh.to(
            torch.bfloat16), lab, chunk=chunk)
        loss.backward()
        grads.append((hh.grad, ee.grad))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-4, rtol=2.0 ** -7)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    """``loss_fn``'s value and ``jax.value_and_grad``'s gradients, with a
    mask, for one arch of each family (musicgen through ``embeds``)."""
    jcfg, tcfg, jp, tp = both(arch)
    batch = _batch(jcfg)
    (jloss, jmet), jg = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jp, jcfg, _j(batch))
    tloss, tmet, tg = ttr._value_and_grad(tp, tcfg, _t(batch), 0.01)
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert abs(float(tmet["ce"]) - float(jmet["ce"])) <= \
        1e-4 * abs(float(jmet["ce"]))
    if tcfg.is_moe:
        assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= \
            0.02 * abs(float(jmet["aux"]))
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    for path, want in jleaves:
        got = tg
        for p in path:
            got = got[p.key]
        assert got.dtype == torch.bfloat16
        assert rel(got, want) < GRAD_TOL, (arch, jax.tree_util.keystr(path))


def _opt_inputs(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": {"w": rng.randn(6, 5)}, "b": rng.randn(7)}
    grads = {"a": {"w": rng.randn(6, 5)}, "b": rng.randn(7) * 30}
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                      params)
    jgr = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)
    tgr = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                       grads)
    return jp, tp, jgr, tgr


def _assert_tree_close(got, want, atol):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(jnp.asarray(w, jnp.float32)),
            rtol=0, atol=atol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"clip_norm": None, "weight_decay": 0.0}),
    ("adamw", {"schedule": lambda s: 1.0 / s}),
    ("sgd", {"lr": 0.1}), ("sgd", {"lr": 0.1, "momentum": 0.9,
                                   "clip_norm": 1.0})],
    ids=["adamw", "adamw-noclip", "adamw-schedule", "sgd", "sgd-momentum"])
def test_optimizers_match_jax(name, kw):
    """Three updates: parameters and every state tensor against JAX's
    (the port updates in place and returns the trees it was given)."""
    jp, tp, jgr, tgr = _opt_inputs()
    jopt, topt = getattr(joptim, name)(**kw), getattr(optim, name)(**kw)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(3):
        jp, jst = jopt.update(jp, jgr, jst)
        tp2, tst2 = topt.update(tp, tgr, tst)
        assert tp2 is tp and tst2 is tst
        _assert_tree_close(tp, jp, 2e-6 + 2.0 ** -8)
        for k in jst:
            if k == "step":
                assert int(tst[k]) == int(jst[k]) == step + 1
            else:
                _assert_tree_close(tst[k], jst[k], 2e-6)
    assert float(optim.global_norm(tgr)) == pytest.approx(
        float(joptim.global_norm(jgr)), rel=1e-6)


def _grads_seen(params, cfg, batch, aux_weight, **kw):
    """The gradients ``train_step`` hands its optimizer (an optimizer
    that returns them in the parameters' place)."""
    opt = optim.Optimizer(init=lambda p: {}, update=lambda p, g, s: (g, s))
    grads, _, met = models.train_step(params, {}, batch, cfg=cfg,
                                      optimizer=opt, aux_weight=aux_weight,
                                      **kw)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    return list(leaves(grads))


def _worst_gap(got, want):
    """max over leaves of max |got - want| / max |want|."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp(min=1e-30))
               for g, w in zip(got, want))


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b", "zamba2-7b"])
def test_microbatches_and_remat_match(arch):
    """The gradients ``train_step`` gives its optimizer: with
    ``n_microbatch`` 2, f32 and bit for bit the mean of the two halves'
    bf16 gradients (JAX's scan body), and within ``MB_TOL`` of each leaf's
    largest |value| of the whole batch's gradients (the mean of the halves
    is the whole batch's mean; bf16 rounding of the weight gradients,
    measured at most 0.0067); remat off equals remat on bit for bit.
    Controls that must fail the MB_TOL check: only the first microbatch
    used, the sum not divided.  mixtral runs at capacity 4.0 with no aux
    loss, so that neither drops nor the per-group aux loss depend on how
    the batch is split."""
    moe = configs.get_config(arch, reduced=True).is_moe
    _, cfg, _, params = both(arch, **({"capacity_factor": 4.0} if moe
                                      else {}))
    aux_weight = 0.0 if moe else 0.01
    batch = _t(_batch(cfg, B=4, mask=False))
    whole = _grads_seen(params, cfg, batch, aux_weight)
    two = _grads_seen(params, cfg, batch, aux_weight, n_microbatch=2)
    halves = [list(leaves(ttr._value_and_grad(
        params, cfg, {k: v[2 * i:2 * i + 2] for k, v in batch.items()},
        aux_weight)[2])) for i in range(2)]
    assert all(t.dtype == torch.float32 for t in two)
    mean = [(a.float() + b.float()) / 2 for a, b in zip(*halves)]
    assert all(torch.equal(a, b) for a, b in zip(two, mean))
    assert _worst_gap(two, whole) <= MB_TOL
    # controls: the first microbatch alone, the sum not divided
    assert _worst_gap([a.float() for a in halves[0]], whole) > MB_TOL
    assert _worst_gap([2 * a for a in mean], whole) > MB_TOL
    other = _grads_seen(params, cfg.replace(remat=not cfg.remat), batch,
                        aux_weight)
    assert all(torch.equal(a, b) for a, b in zip(other, whole))


def test_train_step_decreases_the_loss_and_grad_specs_raises():
    cfg = configs.get_config("zamba2-7b", reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    opt = optim.adamw(3e-3)
    st = opt.init(params)
    batch = _t(_batch(cfg, mask=False))
    losses = []
    for _ in range(3):
        params, st, met = models.train_step(params, st, batch, cfg=cfg,
                                            optimizer=opt)
        losses.append(float(met["loss"]))
    assert losses[2] < losses[0]
    # grad_specs that do not match the parameters raise, as JAX's tree.map
    # does (a matching tree: tests/test_torch_launch_specs.py)
    with pytest.raises(ValueError, match="grad_specs"):
        models.train_step(params, st, batch, cfg=cfg, optimizer=opt,
                          grad_specs={})


def test_forward_only_kernels_raise_under_autograd():
    """B8's and B9's wrappers raise on an input that requires grad while
    autograd records (their outputs would carry no gradient); under
    torch.no_grad() the same call runs."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 16).astype(np.float32))
               for _ in range(3))
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention.flash_attention(qg, k, v)
    with torch.no_grad():
        flash_attention.flash_attention(qg, k, v)
    r, kk, vv = (torch.from_numpy(rng.randn(1, 16, 2, 8).astype(np.float32))
                 for _ in range(3))
    w = torch.full((1, 16, 2, 8), 0.9)
    u = torch.full((2, 8), 0.5, requires_grad=True)
    for fn in (rwkv6_kernel.wkv, rwkv6_kernel.wkv_state):
        with pytest.raises(RuntimeError, match="forward only"):
            fn(r, kk, vv, w, u, chunk=8)
        with torch.no_grad():
            fn(r, kk, vv, w, u, chunk=8)
    assert not records_grad(r, None) and records_grad(None, u)


def test_rwkv6_trains_through_wkv_chunked():
    """The prefill recurrence goes to B9 for tensors off the CPU only when
    autograd does not record through them (meta tensors stand in for the
    card); and the model's loss runs and differentiates on the CPU."""
    x = torch.empty((1, 4, 2, 8), device="meta")
    assert rwkv6.kernel_recurrence(x, x, None)
    assert not rwkv6.kernel_recurrence(x, x.requires_grad_(), None)
    with torch.no_grad():
        assert rwkv6.kernel_recurrence(x, x, None)
    assert not rwkv6.kernel_recurrence(torch.zeros(1), None)
    cfg = configs.get_config("rwkv6-3b", reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    _, _, grads = ttr._value_and_grad(params, cfg,
                                      _t(_batch(cfg, mask=False)), 0.01)
    tm = grads["blocks"]["rwkv"]["tm"]
    assert float(tm["bonus"].float().abs().sum()) > 0
    assert float(tm["decay_base"].float().abs().sum()) > 0
