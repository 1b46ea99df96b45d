"""DAVIS J&F metrics, host numpy and OpenCV.

The port's copy of `slowfast_vos_tpu/eval/metrics.py`, a vectorized
implementation of the official protocol (reference
`code/davis2017_evaluation/davis2017/metrics.py`):

* J  — Jaccard index with void-pixel exclusion and the empty-union = 1 rule;
* F  — boundary F-measure: 1-pixel boundary maps (Martin seg2bmap semantics:
  a pixel is boundary if it differs from its east/south/south-east neighbor,
  with special handling of the last row/column), dilated by a disk of radius
  ceil(0.008 * image diagonal), matched boundary precision/recall;
* db_statistics — mean / recall@0.5 / decay over the frame axis.

All per-frame loops are vectorized over leading axes where the protocol
allows; boundary maps are computed with array shifts, and dilation uses cv2
with an explicit skimage-`disk`-equivalent kernel (x^2 + y^2 <= r^2).
"""
from __future__ import annotations

import warnings

import cv2
import numpy as np


def jaccard(annotation: np.ndarray, segmentation: np.ndarray, void: np.ndarray | None = None):
    """IoU over the trailing two axes; leading axes broadcast. Empty-union
    frames score 1 (protocol rule for frames where the object is absent)."""
    a = annotation.astype(bool)
    s = segmentation.astype(bool)
    not_void = True if void is None else ~void.astype(bool)
    inters = np.sum(a & s & not_void, axis=(-2, -1))
    union = np.sum((a | s) & not_void, axis=(-2, -1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = inters / union
    j = np.where(np.isclose(union, 0), 1.0, j)
    return j


def seg_to_boundary(seg: np.ndarray) -> np.ndarray:
    """Binary 1-pixel-wide boundary map, offset half a pixel toward the origin
    (David Martin's seg2bmap rule).

    Incremental form of the shifted-copies formulation: the union of the
    east/south/south-east membership differences, with the frame's last
    row/column comparing only along itself and the corner always false —
    algebraically identical to the original full-frame xors + overrides
    (each border region receives exactly one contribution), at less than
    half the temporaries."""
    seg = seg.astype(bool)
    b = np.zeros_like(seg)
    b[:, :-1] = seg[:, :-1] ^ seg[:, 1:]  # east (also Martin's last-row rule)
    b[:-1, :] |= seg[:-1, :] ^ seg[1:, :]  # south (also last-column rule)
    b[:-1, :-1] |= seg[:-1, :-1] ^ seg[1:, 1:]  # south-east
    b[-1, -1] = False
    return b


def disk_kernel(radius: int) -> np.ndarray:
    """skimage.morphology.disk equivalent: (2r+1)^2 grid, x^2+y^2 <= r^2."""
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def dilate_in_bbox(b: np.ndarray, kernel: np.ndarray, r: int) -> np.ndarray:
    """Disk dilation confined to the boundary's bounding box + radius —
    exact: a radius-r dilation cannot reach farther, and cv2's dilate border
    contributes nothing, matching the all-zero surroundings. The full-frame
    arbitrary-shape dilate was the scorer's top cost."""
    rows = b.any(axis=1)
    if not rows.any():
        return np.zeros_like(b)
    cols = b.any(axis=0)
    h, w = b.shape
    y0 = max(int(rows.argmax()) - r, 0)
    y1 = min(h - int(rows[::-1].argmax()) + r, h)
    x0 = max(int(cols.argmax()) - r, 0)
    x1 = min(w - int(cols[::-1].argmax()) + r, w)
    out = np.zeros_like(b)
    crop = np.ascontiguousarray(b[y0:y1, x0:x1]).view(np.uint8)
    out[y0:y1, x0:x1] = cv2.dilate(crop, kernel).view(bool)
    return out


def boundary_f_measure(
    annotation: np.ndarray,
    segmentation: np.ndarray,
    void: np.ndarray | None = None,
    bound_th: float = 0.008,
):
    """Boundary F per frame. annotation/segmentation: [H,W] or [T,H,W]."""
    if annotation.ndim == 3:
        return np.array(
            [
                boundary_f_measure(
                    annotation[i], segmentation[i], None if void is None else void[i], bound_th
                )
                for i in range(annotation.shape[0])
            ]
        )

    gt = annotation.astype(bool)
    fg = segmentation.astype(bool)
    if void is not None:
        nv = ~void.astype(bool)
        gt = gt & nv
        fg = fg & nv

    radius = bound_th if bound_th >= 1 else np.ceil(bound_th * np.linalg.norm(fg.shape))
    kernel = disk_kernel(radius)

    fg_b = seg_to_boundary(fg)
    gt_b = seg_to_boundary(gt)
    fg_dil = dilate_in_bbox(fg_b, kernel, int(radius))
    gt_dil = dilate_in_bbox(gt_b, kernel, int(radius))

    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt > 0:
        return 0.0
    if n_fg > 0 and n_gt == 0:
        return 0.0
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = (fg_b & gt_dil).sum() / n_fg
    recall = (gt_b & fg_dil).sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def db_statistics(per_frame_values: np.ndarray):
    """(mean, recall@0.5, decay) over the frame axis — protocol statistics."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = np.nanmean(per_frame_values)
        r = np.nanmean(per_frame_values > 0.5)
    n = len(per_frame_values)
    ids = np.round(np.linspace(1, n, 5) + 1e-10) - 1
    ids = ids.astype(int)
    bins = [per_frame_values[ids[i] : ids[i + 1] + 1] for i in range(4)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = np.nanmean(bins[0]) - np.nanmean(bins[3])
    return m, r, d
