"""The numbers that decide `correct`, from what the program produced and
what the reference computes. Each is a gap: 0 where the two agree.

Inference, over the sampled sequences' frames:

* `mask_gap`: the program's union masks against the reference's masks at
  the program's own boxes and labels, pasted as the program pastes them:
  the widest logit, |logit(p)| of the reference's probability p, at a
  pixel where the two unions differ. Like a served token's logit below
  the reference's best: a pixel that rounding flips sits at the threshold
  (logit near 0); one that a lower precision or a fault flips lies as far
  from it as the error. The pasted probability is continuous, so every
  mask's boundary has pixels at every margin near 0.5. The program's
  choice of boxes does not enter it: it judges the features, SlowFast with
  its carry, the 14x14 pool, the mask head, the paste and the union.
* `score_gap`, `score_rel_gap`: each program detection against the
  reference's foreground candidate of its frame (every proposal's decoded,
  clipped box and its score, before the threshold and NMS) whose box is
  nearest, by the largest coordinate difference over the candidate's
  larger side (at least 16 px): the median over the detections of the
  difference of the scores' logits (a score near 1 hides a logit's error),
  and the median of that difference over the larger of 1 and the
  reference's |logit| (bf16 rounds a class logit in proportion to its
  size, so confident detections read larger absolute gaps). They judge the
  RPN and K3, the 7x7 pool, the box head and the decode. Medians, because
  a proposal at the edge of the top-k or of an NMS suppression leaves the
  reference's set under rounding, and gives a far candidate.
* `box_gap`: the median of that box distance itself.

Training, over the first steps:

* `loss_gap`: the largest relative difference of a step's loss;
* `grad_gap`, `step_gap`: by trainable leaf, the gap between the norms of
  the program's and the reference's first gradient (as the optimizer got
  it) and of the parameters' change over the steps, over the larger of the
  reference's norm of that leaf and of the median leaf; the mean over the
  leaves. The worst leaf is most often SlowFast's first fast convolution,
  whose gradient comes through three train-mode BatchNorm backwards that
  each take two projections off it, so bf16 rounding dominates it and it
  swings from seed to seed; the mean over the leaves is steady. Leaves
  whose reference gradient is under a thousandth of the median leaf's
  (biases ahead of a train-mode BatchNorm) move by round-off alone and are
  left out.
* `slowfast_grad_gap`: `grad_gap`'s mean over SlowFast's leaves alone.
  SlowFast is the one trainable block that sees each centre frame through
  a window of its own, so the gradient that one centre frame gives differs
  from the other's there, and a step that leaves a centre frame out shows
  there; the RoI heads see two near-identical frames and dilute it.
* `buffer_gap`: SlowFast's running means and variances, by buffer, the gap
  between the norms of their change over the steps, as above; the worst
  buffer. A step that leaves the statistics as they were reads 1.
"""
from __future__ import annotations

import numpy as np
import torch

EXCLUDE_BELOW = 1e-3
TEMPORAL = "slow_fast."  # SlowFast's leaves, for `slowfast_grad_gap`
BOX_FLOOR_PX = 16.0  # a box's size for `box_gap` is at least this, so that slivers at the border count as 16 px


def logit(p):
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def inference_gaps(program: list, reference: list) -> tuple[dict[str, float], dict[str, float]]:
    """program: per sequence, the per-frame dicts of `infer_sequence`;
    reference: per sequence, `reference.run.infer_sequence`'s dict (numpy).
    Returns (the gaps, and `union_share`, the share of pixels in the
    program's unions, for the record). A cell's limits file names the gaps
    that it compares."""
    mask_gap = 0.0
    box, score, relative, union = [], [], [], []
    for dets, ref in zip(program, reference):
        if len(dets) != ref["teacher_margin"].shape[0]:
            inf = float("inf")
            return ({"mask_gap": inf, "score_gap": inf, "score_rel_gap": inf, "box_gap": inf},
                    {"union_share": 0.0})
        for g, d in enumerate(dets):
            m = ref["teacher_margin"][g]
            union.append(float(d["union_mask"].mean()))
            flipped = d["union_mask"] ^ (m >= 0)
            if flipped.any():
                mask_gap = max(mask_gap, float(np.abs(logit(0.5 + m[flipped])).max()))
            valid = d["valid"].astype(bool)
            if valid.any():
                cand = ref["cand_boxes"][g].astype(np.float64)
                size = np.maximum(np.maximum(cand[:, 2] - cand[:, 0], cand[:, 3] - cand[:, 1]), BOX_FLOOR_PX)
                dist = np.abs(d["boxes"][valid][:, None, :].astype(np.float64) - cand[None]).max(-1) / size[None]
                j = dist.argmin(axis=1)
                box.extend(dist[np.arange(j.size), j])
                reference_logit = logit(ref["cand_scores"][g][j])
                gap = np.abs(logit(d["scores"][valid]) - reference_logit)
                score.extend(gap)
                relative.extend(gap / np.maximum(np.abs(reference_logit), 1.0))
    return ({"mask_gap": mask_gap, "score_gap": float(np.median(score)) if score else 0.0,
             "score_rel_gap": float(np.median(relative)) if relative else 0.0,
             "box_gap": float(np.median(box)) if box else 0.0},
            {"union_share": float(np.mean(union)) if union else 0.0})


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict, keep) -> dict[str, float]:
    """By leaf: |norm_p - norm_r| / max(norm_r, median norm_r)."""
    p, r = leaf_norms({k: program[k] for k in keep}), leaf_norms({k: reference[k] for k in keep})
    median = float(np.median(list(r.values())))
    return {k: abs(p[k] - r[k]) / max(r[k], median) for k in keep}


def leaf_gap(program: dict, reference: dict, keep) -> tuple[float, str]:
    """(worst gap, its leaf) of `leaf_gaps`."""
    gaps = leaf_gaps(program, reference, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def kept_leaves(reference_grad: dict) -> list[str]:
    norms = leaf_norms(reference_grad)
    median = float(np.median(list(norms.values())))
    return sorted(k for k, v in norms.items() if v >= EXCLUDE_BELOW * median)


def training_gaps(program: dict, reference: dict) -> tuple[dict[str, float], dict]:
    """program, reference: {"losses": [...], "grad": {leaf: tensor},
    "change": {leaf: tensor}, "buffers": {buffer: its change}}. Returns
    (gaps, details): the mean leaf's gaps, and the worst leaf's in the
    details."""
    keep = kept_leaves(reference["grad"])
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(program["losses"], reference["losses"]))
    grad = leaf_gaps(program["grad"], reference["grad"], keep)
    change = leaf_gaps(program["change"], reference["change"], keep)
    buffers = leaf_gaps(program["buffers"], reference["buffers"], sorted(reference["buffers"]))
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    worst_buffer = max(buffers, key=buffers.get)
    details = {"leaves": len(keep), "left_out": sorted(set(reference["grad"]) - set(keep)),
               "worst_grad": [worst_grad, grad[worst_grad]], "worst_step": [worst_change, change[worst_change]],
               "worst_buffer": worst_buffer, "median_grad": float(np.median(list(grad.values()))),
               "losses": program["losses"], "reference_losses": reference["losses"]}
    return {"loss_gap": loss_gap, "grad_gap": float(np.mean(list(grad.values()))),
            "step_gap": float(np.mean(list(change.values()))),
            "slowfast_grad_gap": float(np.mean([v for k, v in grad.items() if k.startswith(TEMPORAL)])),
            "buffer_gap": buffers[worst_buffer]}, details
