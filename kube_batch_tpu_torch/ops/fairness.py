"""Fairness tensors — DRF shares and proportion max-min queue capacity.

Mirrors ``kube_batch_tpu/ops/fairness.py`` (drf.go:161-171,
proportion.go:101-154).  Every comparison masks out the capacity-only pods
dimension (``PODS_INDEX``).
"""

from __future__ import annotations

import torch

from kube_batch_tpu_torch.api.resources import PODS_INDEX


def semantic_mask(R: int, device) -> torch.Tensor:
    """[R] bool on ``device``: the semantic dimensions (all but pods).
    Indexing a device tensor with a Python list uploads the list first, a
    blocking copy each time; the masked forms below upload nothing."""
    return torch.arange(R, device=device) != PODS_INDEX


def _semantic_amax(ratios: torch.Tensor) -> torch.Tensor:
    """Max over the semantic dims of the last axis (the pods dim reads as
    -inf, so it never wins)."""
    sem = semantic_mask(ratios.shape[-1], ratios.device)
    return torch.where(sem, ratios, float("-inf")).amax(dim=-1)


def dominant_share(alloc: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """[., R], [R] → [.] max over semantic dims of alloc/total, 0 where the
    cluster has none of a resource (drf.go:161-171)."""
    ratios = torch.where(total > 0, alloc / total.clamp(min=1e-9), 0.0)
    return _semantic_amax(ratios)


def proportion_deserved(
    total: torch.Tensor,      # [R]
    weight: torch.Tensor,     # [Q]
    request: torch.Tensor,    # [Q, R]
    valid: torch.Tensor,      # [Q] bool
    max_iters: int | None = None,
) -> torch.Tensor:
    """Weighted max-min fair deserved [Q, R] (proportion.go:101-154).

    The JAX package's ``while_loop`` runs until the pool is empty or every
    queue is met, at most Q+1 iterations.  Here all ``max_iters``
    iterations run and an iteration whose loop condition is false leaves
    the state as it was: the same result, with no host sync."""
    Q, R = request.shape
    if max_iters is None:
        max_iters = Q + 1
    deserved = torch.zeros((Q, R), dtype=total.dtype, device=total.device)
    met = ~valid
    remaining = total
    # kbt: allow[KBT005] the JAX while_loop's at most Q+1 water-filling passes,
    # dispatched without a host sync (a pass whose condition is false leaves
    # the state); once per solve, not a round
    for _ in range(max_iters):
        active = (remaining > 1e-6).any() & (valid & ~met).any()
        w = torch.where(valid & ~met, weight, 0.0)
        tw = w.sum()
        frac = torch.where(tw > 0, w / tw.clamp(min=1e-9), 0.0)
        new = deserved + remaining[None, :] * frac[:, None]
        now_met = (request <= new + 1e-6).all(dim=-1) & valid
        capped = torch.where(now_met[:, None], torch.minimum(new, request), new)
        granted = capped - deserved
        rem_new = (remaining - granted.sum(dim=0)).clamp(min=0.0)
        deserved = torch.where(active, capped, deserved)
        met = torch.where(active, met | now_met, met)
        remaining = torch.where(active, rem_new, remaining)
    return deserved


def overused(deserved: torch.Tensor, alloc: torch.Tensor,
             quanta: torch.Tensor) -> torch.Tensor:
    """[Q] bool — allocation already covers the deserved share
    (proportion.go:198-209), over the semantic dims."""
    sem = semantic_mask(quanta.shape[-1], quanta.device)
    return ((deserved <= alloc + quanta) | ~sem).all(dim=-1)


def queue_share(alloc: torch.Tensor, deserved: torch.Tensor) -> torch.Tensor:
    """[Q] — dominant allocated/deserved ratio (proportion.go:156-169);
    lower share schedules first."""
    ratios = torch.where(deserved > 0, alloc / deserved.clamp(min=1e-9), 0.0)
    return _semantic_amax(ratios)
