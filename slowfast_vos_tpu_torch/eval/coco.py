"""Minimal COCO-style mAP evaluation (bbox + segm), numpy only.

The port's copy of `slowfast_vos_tpu/eval/coco.py`, a low-fidelity
equivalent of the reference's vendored COCO eval path
(`code/maskrcnn/coco_utils.py` / `coco_eval.py`): enough to track detection
quality of the Mask R-CNN fine-tune stage without pycocotools (the DAVIS J&F
protocol in `eval/scorer.py` is the project's real metric).

Implements the standard protocol: greedy score-ordered matching at each IoU
threshold in 0.5:0.95:0.05, 101-point interpolated AP, mean over classes.
`merge_across_processes` gathers per-process shards of images before
scoring, as the reference's distributed COCO evaluation does.
"""
from __future__ import annotations

import numpy as np

from slowfast_vos_tpu_torch.parallel.distributed import all_gather_host

# pycocotools grid, bit-for-bit: np.linspace rounds 0.6 DOWN
# (0.5999999999999999778) where np.arange(0.5, 1.0, 0.05) rounds it UP
# (0.6000000000000000888) — an exact-0.6 IoU match is a TP under the real
# protocol and would be a FP under arange.
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def _box_iou_np(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _mask_iou_np(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    a = a.reshape(len(a), -1).astype(bool)
    b = b.reshape(len(b), -1).astype(bool)
    inter = (a[:, None] & b[None]).sum(-1)
    union = (a[:, None] | b[None]).sum(-1)
    return np.where(union > 0, inter / union, 0.0)


def _ap_from_matches(scores, matched, num_gt):
    """101-point interpolated AP from per-detection (score, is_tp)."""
    if num_gt == 0:
        return np.nan
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = matched[order]
    fp = ~tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    recall_points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, recall_points, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(prec_at.mean())


def coco_map(predictions, ground_truths, *, kind: str = "bbox", classes=None):
    """predictions/ground_truths: parallel per-image lists of dicts with
    'boxes' [N,4], 'labels' [N], 'scores' (preds), 'valid' [N] and — for
    kind='segm' — 'masks' [N,H,W].

    Returns {'mAP': float, 'AP50': float, 'per_class': {label: ap}}.
    """
    if classes is None:
        classes = sorted(
            {
                int(l)
                for gt in ground_truths
                for l, v in zip(gt["labels"], gt["valid"])
                if v
            }
        )
    ap_table = np.full((len(classes), len(IOU_THRESHOLDS)), np.nan)

    for ci, cls in enumerate(classes):
        for ti, thresh in enumerate(IOU_THRESHOLDS):
            all_scores, all_matched, total_gt = [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                gsel = (gt["labels"] == cls) & gt["valid"]
                psel = (pred["labels"] == cls) & pred["valid"]
                gboxes = gt["boxes"][gsel]
                pboxes = pred["boxes"][psel]
                scores = pred["scores"][psel]
                total_gt += len(gboxes)
                if kind == "segm":
                    iou = _mask_iou_np(pred["masks"][psel] >= 0.5, gt["masks"][gsel])
                else:
                    iou = _box_iou_np(pboxes, gboxes)
                order = np.argsort(-scores, kind="stable")
                taken = np.zeros(len(gboxes), bool)
                matched = np.zeros(len(pboxes), bool)
                for di in order:
                    if len(gboxes) == 0:
                        break
                    cand = np.where(~taken & (iou[di] >= thresh))[0]
                    if len(cand):
                        best = cand[np.argmax(iou[di][cand])]
                        taken[best] = True
                        matched[di] = True
                all_scores.append(scores)
                all_matched.append(matched)
            ap_table[ci, ti] = _ap_from_matches(
                np.concatenate(all_scores) if all_scores else np.zeros(0),
                np.concatenate(all_matched) if all_matched else np.zeros(0, bool),
                total_gt,
            )

    with np.errstate(invalid="ignore"):
        per_class = {cls: float(np.nanmean(ap_table[ci])) for ci, cls in enumerate(classes)}
        return {
            "mAP": float(np.nanmean(ap_table)),
            "AP50": float(np.nanmean(ap_table[:, 0])),
            "per_class": per_class,
        }


def merge_across_processes(image_ids, predictions, ground_truths):
    """Merge per-image detection shards from all processes before scoring.

    The reference evaluates COCO metrics distributed: every process
    accumulates predictions for its shard of images, then the shards are
    pickled, all-gathered and deduplicated by image id before the final
    numbers are computed (`code/maskrcnn/coco_eval.py:163-201`,
    `utils.py:79-119`). Here the shards travel the same way, over the host
    group (`parallel/distributed.py::all_gather_host`). Duplicate image ids
    keep their first occurrence in rank order (the lowest rank), in the
    order of the gathered shards, like the reference's np.unique merge.
    Single-process: identity.

    image_ids: [B] ints; predictions/ground_truths: parallel length-B lists
    of per-image dicts of arrays. Returns the merged (image_ids,
    predictions, ground_truths) lists."""
    shards = all_gather_host((list(image_ids), list(predictions), list(ground_truths)))
    if len(shards) == 1:
        return image_ids, predictions, ground_truths
    ids = [int(i) for shard in shards for i in shard[0]]
    preds = [p for shard in shards for p in shard[1]]
    gts = [g for shard in shards for g in shard[2]]
    _, first = np.unique(np.asarray(ids, np.int64), return_index=True)
    keep = np.sort(first)
    return [ids[i] for i in keep], [preds[i] for i in keep], [gts[i] for i in keep]
