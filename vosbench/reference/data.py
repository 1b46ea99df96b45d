"""The reference's DAVIS decode and training windows: Pillow and numpy.

A frozen copy of the reference loaders' semantics (`code/helpers/dataset.py`
of the reference, as the port rebuilds them): a 2017 tree lists its
sequences in `ImageSets/2017/<subset>.txt`; a palette PNG splits into one
binary mask a nonzero id, in ascending id order, each with the tight box of
its extent, degenerate extents dropped, padded to `max_gt`; a training
window is `n_center` consecutive frames with the temporal halo, frames
outside the sequence zero.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np
from PIL import Image


def sequence_names(root: str, subset: str = "train") -> list[str]:
    with open(os.path.join(root, "ImageSets", "2017", f"{subset}.txt")) as f:
        return [ln.strip() for ln in f if ln.strip()]


def annotation(ids: np.ndarray, max_gt: int):
    h, w = ids.shape
    boxes = np.zeros((max_gt, 4), np.float32)
    masks = np.zeros((max_gt, h, w), np.uint8)
    valid = np.zeros((max_gt,), bool)
    slot = 0
    for oid in [v for v in np.unique(ids) if v != 0]:
        if slot >= max_gt:
            break
        m = ids == oid
        ys, xs = np.where(m)
        if xs.min() < xs.max() and ys.min() < ys.max():
            boxes[slot] = [xs.min(), ys.min(), xs.max(), ys.max()]
            masks[slot] = m
            valid[slot] = True
            slot += 1
    return boxes, masks, valid


def decode_sequence(root: str, name: str, max_gt: int) -> dict:
    images = sorted(glob(os.path.join(root, "JPEGImages", "480p", name, "*.jpg")))
    pngs = sorted(glob(os.path.join(root, "Annotations", "480p", name, "*.png")))
    ann = [annotation(np.array(Image.open(p)), max_gt) for p in pngs]
    valid = np.stack([a[2] for a in ann])
    return {
        "images": np.stack([np.array(Image.open(p).convert("RGB")) for p in images]),
        "boxes": np.stack([a[0] for a in ann]),
        "masks": np.stack([a[1] for a in ann]),
        "gt_valid": valid,
        "frame_valid": valid.any(axis=1),
    }


def windows(seq: dict, fast: int, n_center: int):
    t = seq["images"].shape[0]
    left, right = fast // 2, -(-fast // 2) - 1
    for start in range(0, t, n_center):
        idxs = np.arange(start - left, start + n_center + right)
        feat_valid = (idxs >= 0) & (idxs < t)
        images = seq["images"][np.clip(idxs, 0, t - 1)].copy()
        images[~feat_valid] = 0
        centers = np.arange(start, start + n_center)
        cvalid = centers < t
        c = np.clip(centers, 0, t - 1)
        yield {
            "images": images,
            "feat_valid": feat_valid,
            "frame_valid": seq["frame_valid"][c] & cvalid,
            "boxes": seq["boxes"][c],
            "labels": np.ones(seq["gt_valid"][c].shape, np.int64),
            "gt_valid": seq["gt_valid"][c] & cvalid[:, None],
            "masks": seq["masks"][c],
        }


def first_windows(root: str, count: int, fast: int, n_center: int, max_gt: int) -> list[dict]:
    """The first `count` training windows of an epoch over the tree, in its
    index order."""
    out = []
    for name in sequence_names(root):
        for w in windows(decode_sequence(root, name, max_gt), fast, n_center):
            out.append(w)
            if len(out) == count:
                return out
    return out
