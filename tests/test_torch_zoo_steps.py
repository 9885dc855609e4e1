"""Every config of the LM zoo runs every step of the port on the CPU at its
REDUCED size: ``init_params``, ``train_step`` (through ``loss_fn``; the
MoE archs' aux loss in it), ``prefill_step`` and two ``serve_step``s,
with finite outputs of the right shapes.  Parity with the JAX package is
held per family in tests/test_torch_{transformer,moe,mamba2,rwkv6,train}.py;
this file pins that no arch is left out (ROADMAP A5)."""
import numpy as np
import pytest
import torch

from repro_torch import configs, models, optim


@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_arch_runs_every_step(arch):
    cfg = configs.get_config(arch, reduced=True)
    params = models.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    rng = np.random.RandomState(0)
    B, S = 2, 16
    inputs = ({"embeds": torch.from_numpy(rng.randn(
        B, S + 2, cfg.d_model).astype(np.float32))} if cfg.embeds_input
        else {"tokens": torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (B, S + 2)))})
    batch = {k: v[:, :S] for k, v in inputs.items()}
    batch["labels"] = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                   (B, S)))
    loss, met = models.loss_fn(params, cfg, batch)
    assert torch.isfinite(loss) and (float(met["aux"]) > 0) == cfg.is_moe
    opt = optim.sgd(0.1)
    params, _, met = models.train_step(params, opt.init(params), batch,
                                       cfg=cfg, optimizer=opt)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    logits, state = models.prefill_step(
        params, {k: v[:, :S] for k, v in inputs.items()}, cfg=cfg,
        max_len=S + 2)
    for t in range(2):
        step = {k: v[:, S + t:S + t + 1] for k, v in inputs.items()}
        logits, state = models.serve_step(
            params, state, step.get("tokens"), S + t, cfg=cfg,
            embeds=step.get("embeds"))
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert torch.isfinite(logits.float()).all()
