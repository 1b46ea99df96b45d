"""Qualitative evaluation: per-frame IoU and overlay image dumps.

The port's copy of `slowfast_vos_tpu/eval/visualize.py`, a rebuild of the
reference's simple evaluation/visualization path:
`code/helpers/evaluation.py:16-84` (per-frame IoU against the gt union,
overlay PNG dumps), `code/helpers/utils.py:7-88` (mask/box overlay helpers,
`intersection_over_union`) and the `prediction.py` driver
(`code/prediction.py:8-18`). It runs `pipe` with its model as it stands,
like the port's other drivers.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence

_COLORS = np.array(
    [[255, 64, 64], [64, 160, 255], [64, 255, 96], [255, 200, 64],
     [200, 64, 255], [64, 255, 255], [255, 128, 200], [160, 160, 160]],
    np.uint8,
)


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Binary mask IoU (`helpers/utils.py` intersection_over_union)."""
    pred = pred.astype(bool)
    gt = gt.astype(bool)
    union = (pred | gt).sum()
    if union == 0:
        return 1.0
    return float((pred & gt).sum() / union)


def overlay(image: np.ndarray, masks: np.ndarray, boxes=None, alpha=0.45) -> np.ndarray:
    """Blend instance masks (and optional boxes) over an RGB uint8 image."""
    out = image.copy()
    for i, m in enumerate(masks):
        color = _COLORS[i % len(_COLORS)]
        sel = m.astype(bool)
        out[sel] = (out[sel] * (1 - alpha) + color * alpha).astype(np.uint8)
    if boxes is not None:
        for i, b in enumerate(boxes):
            color = _COLORS[i % len(_COLORS)].tolist()
            x1, y1, x2, y2 = [int(round(v)) for v in b]
            x1, x2 = np.clip([x1, x2], 0, out.shape[1] - 1)
            y1, y2 = np.clip([y1, y2], 0, out.shape[0] - 1)
            out[y1 : y2 + 1, [x1, x2]] = color
            out[[y1, y2], x1 : x2 + 1] = color
    return out


def evaluate_with_visualization(
    pipe,
    *,
    davis_root: str,
    out_dir: str,
    subset: str = "val",
    year: str = "2016",
    sequences="all",
    save_all_imgs: bool = False,
    iou_threshold_to_save: float = 0.8,
):
    """Run `pipe` over sequences, compute per-frame union-mask IoU, and
    save overlays (all frames, or only low-IoU ones, like the reference's
    evaluate()). Returns mean IoU."""
    os.makedirs(out_dir, exist_ok=True)
    index = DavisIndex(davis_root, subset, year=year, sequences=sequences)
    ious = []
    for info in index:
        seq = load_sequence(info, max_gt=pipe.cfg.max_gt)
        dets = pipe.infer_sequence(seq["images"], instance_masks=True)
        for f, det in enumerate(dets):
            gt_union = (seq["masks"][f] & seq["gt_valid"][f, :, None, None]).any(axis=0)
            pred_union = det["union_mask"].astype(bool)
            iou = mask_iou(pred_union, gt_union)
            ious.append(iou)
            if save_all_imgs or iou < iou_threshold_to_save:
                inst = (det["masks"] >= 0.5) & det["valid"][:, None, None]
                img = overlay(seq["images"][f], inst, det["boxes"][det["valid"]])
                Image.fromarray(img).save(
                    os.path.join(out_dir, f"{info.name}_{f:05d}_iou{iou:.2f}.png")
                )
    return float(np.mean(ious)) if ious else 0.0
