"""Pod-level federated training (port of ``repro/core/federated.py``): the
paper's FedAvg with worker selection, applied to LMs.

Each pod is an FL worker holding its own copy of the parameters and the
optimizer state, stacked on a leading ``n_pods`` dim.  ``fl_local_step``
runs the ordinary ``train_step`` on every pod's slice of the batch (a
loop over the pods, writing each pod's step into the stacked tensors, in
place of JAX's ``vmap``); ``fl_round`` is the aggregation server: a
selection-weighted average over the pod dim, re-broadcast to every pod.

On one device the merge packs the pods into one ``(n_pods, N)`` f32 buffer
and runs one fused pass: kernel B2 (``fedavg_agg_flat``) on a CUDA
tensor, its plain version on a CPU tensor (the counterpart of the JAX
package's ``_use_agg_kernel()`` path).  ``fl_round_delta_compressed``
merges compressed deltas from an anchor through B6 (``fedavg_delta_flat``,
B1 at server scale 1).

With tracing on (``repro_torch.tracing``) a local step is a ``pods.step``
span over one ``pods.pod_step`` a pod, and a merge a ``pods.merge`` span
over ``merge.pack``, ``merge.encode`` (the compressed form),
``merge.combine`` and ``merge.unpack``; both carry the caching
allocator's device frees, retries and allocations as counter deltas.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels import fedavg_agg
from repro_torch.models import train_step
from repro_torch.tree import leaves, tree_map, unflatten


def stack_for_pods(tree, n_pods: int):
    """Each leaf copied ``n_pods`` times along a new leading pod dim: real
    copies, since the pods' parameters diverge as they train."""
    return tree_map(lambda p: p[None].repeat((n_pods,) + (1,) * p.dim()),
                    tree)


def unstack_pod(tree, idx: int = 0):
    """Pod ``idx``'s slice of every leaf (views into the stacked tensors)."""
    return tree_map(lambda p: p[idx], tree)


def fl_local_step(stacked_params, stacked_opt, batch, *, cfg, optimizer,
                  n_pods: int, n_microbatch: int = 1):
    """One local-SGD step on every pod worker independently.

    ``batch``'s leaves are (B_global, ...): pod i trains on rows ``[i *
    B/n_pods, (i + 1) * B/n_pods)``, as JAX's reshape to (n_pods,
    B/n_pods, ...) gives them.  Each pod's ``train_step`` is written into
    the stacked tensors (in place where the optimizer updates in place,
    else copied back), which are returned with the metrics stacked along
    the pod dim."""
    mets = []
    with tracing.span("pods.step", counters=tracing.alloc_counters,
                      step=tracing.NEXT):
        for i in range(n_pods):
            def part(x):
                x = torch.as_tensor(x)
                n = x.shape[0] // n_pods
                return x[i * n:(i + 1) * n]
            with tracing.span("pods.pod_step", pod=i):
                p_i = unstack_pod(stacked_params, i)
                o_i = unstack_pod(stacked_opt, i)
                new_p, new_o, met = train_step(
                    p_i, o_i, {k: part(v) for k, v in batch.items()},
                    cfg=cfg, optimizer=optimizer, n_microbatch=n_microbatch)
                for tree, new in ((p_i, new_p), (o_i, new_o)):
                    for view, t in zip(leaves(tree), leaves(new)):
                        if t is not view:
                            view.copy_(t)
            mets.append(met)
        metrics = {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
    return stacked_params, stacked_opt, metrics


def _pack_pods(stacked_params) -> torch.Tensor:
    """Every (n_pods, ...) leaf, in leaf order, as one contiguous
    (n_pods, N) f32 buffer."""
    ls = list(leaves(stacked_params))
    n_pods = ls[0].shape[0]
    N = sum(l[0].numel() for l in ls)
    flat = torch.empty((n_pods, N), dtype=torch.float32, device=ls[0].device)
    off = 0
    for l in ls:
        n = l[0].numel()
        flat[:, off:off + n].copy_(l.reshape(n_pods, n))
        off += n
    return flat


def _unpack_pods(merged: torch.Tensor, stacked_params):
    """The merged (N,) vector as new stacked leaves at their dtypes, every
    pod holding the merge."""
    out, off = [], 0
    for l in leaves(stacked_params):
        n = l[0].numel()
        lm = merged[off:off + n].reshape(l.shape[1:]).to(l.dtype)
        out.append(lm[None].expand(l.shape).clone())
        off += n
    return unflatten(stacked_params, out)


def _norm(weights: torch.Tensor, device) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32).to(device)
    return w / torch.clamp(w.sum(), min=1e-9)


def fl_round(stacked_params, weights):
    """Aggregation server: the weighted average over the pod dim,
    re-broadcast to every pod (new tensors).

    ``weights``: (n_pods,) selection mask x aggregation weight (FedAvg:
    1/|selected|), normalised here; weight 0 removes a pod's contribution,
    and every pod, selected or not, continues from the merge.  One launch
    of B2 over the packed (n_pods, N) f32 buffer on a card."""
    with tracing.span("pods.merge", counters=tracing.alloc_counters,
                      step=tracing.LAST):
        with tracing.span("merge.pack"):
            flat = _pack_pods(stacked_params)
        with tracing.span("merge.combine"):
            merged = fedavg_agg.fedavg_agg_flat(flat,
                                                _norm(weights, flat.device))
        del flat
        with tracing.span("merge.unpack"):
            return _unpack_pods(merged, stacked_params)


def fl_round_delta_compressed(stacked_params, anchor_params, weights, *,
                              compressor):
    """Beyond-paper variant: aggregate *compressed deltas* from the anchor
    (the last merged model) instead of raw weights.

    ``compressor`` maps the packed (n_pods, N) f32 deltas to their
    reconstructions (e.g. ``lambda d: ErrorFeedbackCompressor(...)
    .compress(d)[0]``), so a top-k compressor ranks the whole model's
    coordinates globally.  The merge ``anchor + weights @ deltas`` is one
    launch of B6 on a card."""
    with tracing.span("pods.merge", counters=tracing.alloc_counters,
                      step=tracing.LAST):
        with tracing.span("merge.pack"):
            delta = _pack_pods(stacked_params)
            aflat = torch.cat([l.reshape(-1).to(torch.float32)
                               for l in leaves(anchor_params)])
            delta.sub_(aflat[None])        # flat - anchor, in place
        with tracing.span("merge.encode"):
            cdelta = compressor(delta)
        del delta
        with tracing.span("merge.combine"):
            merged = fedavg_agg.fedavg_delta_flat(
                aflat, cdelta, _norm(weights, aflat.device))
        del cdelta
        with tracing.span("merge.unpack"):
            return _unpack_pods(merged, stacked_params)
