"""Synthetic sequences with moving blobs, host numpy.

The port's copy of the JAX package's generator
(`slowfast_vos_tpu/data/synthetic.py::_draw_sequence`) and of its per-frame
annotation decode (`data/davis.py::decode_frame_annotation`, boxes from
mask extents), without the DAVIS file tree: `sequence_arrays` gives the
fixed-shape sequence dict that `train_windows` slices.
"""
from __future__ import annotations

import numpy as np


def draw_sequence(rng: np.random.Generator, t: int, h: int, w: int, num_objects: int):
    """Moving blobs on a textured background: (images [t, h, w, 3] uint8,
    id_masks [t, h, w] uint8, 0 = background, object o is o + 1)."""
    yy, xx = np.mgrid[0:h, 0:w]
    images = np.zeros((t, h, w, 3), np.uint8)
    id_masks = np.zeros((t, h, w), np.uint8)
    bg = (rng.uniform(0, 80, (h, w, 3))).astype(np.uint8)

    centers = rng.uniform([0.25 * w, 0.25 * h], [0.75 * w, 0.75 * h], (num_objects, 2))
    vels = rng.uniform(-3, 3, (num_objects, 2))
    radii = rng.uniform(min(h, w) * 0.08, min(h, w) * 0.2, num_objects)
    colors = rng.integers(120, 255, (num_objects, 3))

    for f in range(t):
        frame = bg.copy()
        ids = np.zeros((h, w), np.uint8)
        for o in range(num_objects):
            cx, cy = centers[o] + vels[o] * f
            r = radii[o]
            blob = ((xx - cx) ** 2 / (1.3 * r) ** 2 + (yy - cy) ** 2 / r**2) <= 1.0
            frame[blob] = colors[o]
            ids[blob] = o + 1
        images[f] = frame
        id_masks[f] = ids
    return images, id_masks


def frame_annotation(id_mask: np.ndarray, max_gt: int):
    """One frame's id mask -> (boxes [max_gt, 4] f32 XYXY from mask extents,
    masks [max_gt, h, w] uint8, valid [max_gt]); objects in id order,
    degenerate extents dropped."""
    h, w = id_mask.shape
    boxes = np.zeros((max_gt, 4), np.float32)
    masks = np.zeros((max_gt, h, w), np.uint8)
    valid = np.zeros((max_gt,), bool)
    slot = 0
    for oid in np.unique(id_mask):
        if oid == 0:
            continue
        if slot >= max_gt:
            break
        bin_mask = id_mask == oid
        ys, xs = np.where(bin_mask)
        x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
        if x1 < x2 and y1 < y2:
            boxes[slot] = [x1, y1, x2, y2]
            masks[slot] = bin_mask
            valid[slot] = True
            slot += 1
    return boxes, masks, valid


def sequence_arrays(images: np.ndarray, id_masks: np.ndarray, max_gt: int = 8) -> dict:
    """Fixed-shape sequence dict (`data/davis.py::load_sequence`): images,
    boxes [T, G, 4], masks [T, G, H, W], gt_valid [T, G], frame_valid [T]."""
    ann = [frame_annotation(m, max_gt) for m in id_masks]
    valid = np.stack([a[2] for a in ann])
    return {
        "images": images,
        "boxes": np.stack([a[0] for a in ann]),
        "masks": np.stack([a[1] for a in ann]),
        "gt_valid": valid,
        "frame_valid": valid.any(axis=1),
    }
