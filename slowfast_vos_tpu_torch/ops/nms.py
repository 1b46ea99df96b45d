"""Fixed-shape NMS on torch tensors, batched over leading dimensions.

Port of `slowfast_vos_tpu/ops/nms.py` (the fixpoint form, `nms.py:27-55`).
Like the JAX package it returns a keep *mask* over the original indices plus
the score order, and callers take a static top-k afterwards, so no output
shape depends on the data.

Ties: `jnp.argsort` is stable and `jax.lax.top_k` puts the lower index
first among equal values. `torch.topk` on CUDA promises no order among ties,
so every ordering here is a stable `torch.sort` and a slice.

Batching: the fixpoint runs on boxes of shape [..., N, 4] with any leading
dimensions (frames, FPN levels), one [..., N, N] suppression matrix for the
whole batch. The greedy result is the unique fixpoint of each problem, so
batching changes no answer; the loop runs until every problem has converged.
A hand NMS kernel is later work.
"""
from __future__ import annotations

import torch

from slowfast_vos_tpu_torch.ops.boxes import box_iou

NEG_INF = -1e10


def sort_desc(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Descending sort along the last axis, lower index first among ties
    (`jax.lax.top_k` order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _nms_fixpoint(sboxes: torch.Tensor, svalid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS on score-sorted boxes [..., N, 4] by fixpoint iteration:
    keep_{t+1}[i] = valid[i] & !any_{j<i}(keep_t[j] & iou[j,i] > thr)."""
    n = sboxes.shape[-2]
    iou = box_iou(sboxes, sboxes)
    # m[j, i] = (j < i) & overlap: candidate i is suppressed by a kept earlier j.
    earlier = torch.ones((n, n), dtype=torch.bool, device=sboxes.device).triu(1)
    m = (iou > iou_threshold) & earlier & svalid[..., :, None] & svalid[..., None, :]
    keep = svalid
    while True:
        suppressed = (m & keep[..., :, None]).any(dim=-2)
        new_keep = svalid & ~suppressed
        if torch.equal(new_keep, keep):
            return keep
        keep = new_keep


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    iou_threshold: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-maximum suppression with static shapes.

    boxes [..., N, 4] XYXY, scores [..., N], valid optional [..., N] bool
    (invalid entries are never kept). Returns (keep [..., N] bool over the
    ORIGINAL indices, order [..., N] the score-descending permutation)."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    eff = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    # jnp.argsort(-eff): ascending and stable.
    order = torch.sort(-eff, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    svalid = torch.gather(eff, -1, order) > NEG_INF / 2
    alive = _nms_fixpoint(sboxes, svalid, iou_threshold)
    keep = torch.zeros_like(alive).scatter(-1, order, alive)
    return keep, order


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    valid: torch.Tensor | None = None,
    *,
    iou_threshold: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS via the coordinate-offset trick (torchvision
    `batched_nms`). As in `nms.py:151`, the offset is the maximum over ALL
    boxes of each problem, invalid ones included."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.amax(dim=(-2, -1)) + 1.0
    offsets = idxs.to(boxes.dtype) * max_coord[..., None]
    return nms_mask(boxes + offsets[..., None], scores, valid, iou_threshold=iou_threshold)


def top_k_after_nms(keep: torch.Tensor, scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Static top-k of kept entries along the last axis, score-descending.
    Returns (indices [..., k], valid [..., k]) into the original index space;
    if fewer than k candidates exist, trailing slots are invalid and point at
    index 0."""
    eff = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    n = eff.shape[-1]
    kk = min(k, n)
    top_scores, top_idx = sort_desc(eff)
    top_scores, top_idx = top_scores[..., :kk], top_idx[..., :kk]
    if kk < k:
        pad = (*eff.shape[:-1], k - kk)
        top_idx = torch.cat([top_idx, top_idx.new_zeros(pad)], dim=-1)
        top_scores = torch.cat([top_scores, top_scores.new_full(pad, NEG_INF)], dim=-1)
    return top_idx, top_scores > NEG_INF / 2
