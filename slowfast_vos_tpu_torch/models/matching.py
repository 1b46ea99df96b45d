"""Candidate-to-ground-truth matching and balanced sampling, fixed-shape.

Port of `slowfast_vos_tpu/models/matching.py` (torchvision's `Matcher` and
`BalancedPositiveNegativeSampler`), batched over any leading dimensions
(frames) where the JAX functions are vmapped.

Randomness: the samplers take their uniform draws as tensors instead of a
`jax.random` key. The train step makes them from a `torch.Generator`; the
parity tests hand over the draws the JAX functions make from their key
(`kp, kn = split(key)`, then `uniform(kp, (n,))` and `uniform(kn, (n,))`),
and selection is then index-exact. `jax.lax.top_k` and `jnp.argsort` put
the lower index first among ties; so does `sort_desc`, a stable sort.
"""
from __future__ import annotations

import torch

from slowfast_vos_tpu_torch.ops.nms import sort_desc

BELOW_LOW = -1
BETWEEN = -2


def match_to_gt(
    iou: torch.Tensor,
    gt_valid: torch.Tensor,
    *,
    high_threshold: float,
    low_threshold: float,
    allow_low_quality: bool,
) -> torch.Tensor:
    """Match each candidate to a gt index, or BELOW_LOW / BETWEEN
    (`matching.py:21-56`).

    iou: [..., num_candidates, num_gt]; gt_valid: [..., num_gt] bool.
    Returns [..., num_candidates] int64 matches. With `allow_low_quality`,
    every candidate reaching some valid gt's best IoU (ties included) gets
    its argmax match back, including torchvision's quirk that a gt whose
    best IoU is 0 restores every zero-overlap candidate."""
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    matched_vals = iou.amax(dim=-1)
    matches = iou.argmax(dim=-1)  # the first index among ties, as jnp.argmax
    below = torch.full_like(matches, BELOW_LOW)
    out = torch.where(matched_vals < low_threshold, below, matches)
    between = (matched_vals >= low_threshold) & (matched_vals < high_threshold)
    out = torch.where(between, torch.full_like(matches, BETWEEN), out)
    if allow_low_quality:
        best_per_gt = iou.amax(dim=-2, keepdim=True)  # [..., 1, num_gt]
        is_best = (iou == best_per_gt) & gt_valid[..., None, :]
        out = torch.where(is_best.any(dim=-1), matches, out)
    return out


def _rank(priority: torch.Tensor) -> torch.Tensor:
    """Position of each entry in the stable descending order of `priority`
    (`jnp.argsort(-priority)` inverted)."""
    order = sort_desc(priority).indices
    ar = torch.arange(priority.shape[-1], device=priority.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def sample_balanced(
    positive: torch.Tensor,
    negative: torch.Tensor,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
    *,
    batch_size: int,
    positive_fraction: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to `batch_size * positive_fraction` random positives, the rest of
    `batch_size` filled with random negatives (`matching.py:59-87`).

    positive, negative: [..., n] bool; u_pos, u_neg: [..., n] uniform draws
    in [0, 1). Returns (pos_mask, neg_mask) [..., n]: each class keeps its
    entries of largest draw."""
    max_pos = int(batch_size * positive_fraction)
    num_pos = positive.sum(-1).clamp(max=max_pos)
    num_neg = torch.minimum(negative.sum(-1), batch_size - num_pos)

    def pick(u, mask, count):
        rank = _rank(torch.where(mask, u, torch.full_like(u, -1.0)))
        return mask & (rank < count[..., None])

    return pick(u_pos, positive, num_pos), pick(u_neg, negative, num_neg)


def sample_balanced_indices(
    positive: torch.Tensor,
    negative: torch.Tensor,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
    *,
    batch_size: int,
    positive_fraction: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`sample_balanced` as a compact index set (`matching.py:90-133`).

    Returns (idx [..., P + B], is_pos [..., P + B], valid [..., P + B]) with
    P = min(max_pos, n), B = min(batch_size, n): the P positives and the B
    negatives of largest draw, each class in descending draw order. Rows
    where `valid` is False point at arbitrary entries."""
    n = positive.shape[-1]
    max_pos = min(int(batch_size * positive_fraction), n)
    bsz = min(batch_size, n)
    num_pos = positive.sum(-1).clamp(max=max_pos)
    num_neg = torch.minimum(negative.sum(-1), batch_size - num_pos)
    minus_one = torch.full_like(u_pos, -1.0)
    pos_idx = sort_desc(torch.where(positive, u_pos, minus_one)).indices[..., :max_pos]
    neg_idx = sort_desc(torch.where(negative, u_neg, minus_one)).indices[..., :bsz]
    idx = torch.cat([pos_idx, neg_idx], dim=-1)
    dev = positive.device
    valid = torch.cat([
        torch.arange(max_pos, device=dev) < num_pos[..., None],
        torch.arange(bsz, device=dev) < num_neg[..., None],
    ], dim=-1)
    is_pos = torch.cat([torch.ones(max_pos, dtype=torch.bool, device=dev),
                        torch.zeros(bsz, dtype=torch.bool, device=dev)]).expand_as(valid)
    return idx, is_pos, valid
