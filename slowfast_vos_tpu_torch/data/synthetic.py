"""Synthetic DAVIS data: moving blobs on a textured background, host numpy.

The port's copy of `slowfast_vos_tpu/data/synthetic.py`. Real DAVIS data is
not shipped with the repo; `make_synthetic_davis` writes small but
structurally faithful DAVIS trees (JPEGImages, palette-PNG Annotations,
ImageSets in the 2016 and 2017 layouts), and `sequence_arrays` gives the
fixed-shape sequence dict of `data/davis.py::load_sequence` without a file
tree, through the same per-frame annotation decode.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image

from slowfast_vos_tpu_torch.data.davis import annotation_from_ids, save_palette_mask


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


def sequence_arrays(images: np.ndarray, id_masks: np.ndarray, max_gt: int = 8) -> dict:
    """Fixed-shape sequence dict (`data/davis.py::load_sequence`): images,
    boxes [T, G, 4], masks [T, G, H, W], gt_valid [T, G], frame_valid [T]."""
    ann = [annotation_from_ids(m, max_gt) for m in id_masks]
    valid = np.stack([a[2] for a in ann])
    return {
        "images": images,
        "boxes": np.stack([a[0] for a in ann]),
        "masks": np.stack([a[1] for a in ann]),
        "gt_valid": valid,
        "frame_valid": valid.any(axis=1),
    }


def make_synthetic_davis(
    root: str,
    *,
    num_sequences: int = 2,
    frames: int = 12,
    hw: tuple[int, int] | list[tuple[int, int]] = (60, 100),
    num_objects: int = 2,
    year: str = "2017",
    subset: str | None = "train",
    seed: int = 63,
    resolution: str = "480p",
    start: int = 0,
) -> list[str]:
    """Create a synthetic DAVIS tree under `root`. Returns sequence names.

    `hw` may be one (h, w) for a uniform-resolution tree, or a list of
    per-sequence (h, w) pairs (cycled) for a mixed-resolution tree. Call
    again with `start` past the existing count (and another `subset`, or
    None for sequences in no ImageSet) to extend a tree with more subsets:
    the frame-level dataset splits by ImageSet membership like the reference
    (`maskrcnn_src.py:30-52`)."""
    rng = np.random.default_rng(seed)
    hws = hw if isinstance(hw, list) else [hw]
    names = []
    img_lines = []
    for s in range(num_sequences):
        h, w = hws[s % len(hws)]
        name = f"synth{start + s:02d}"
        names.append(name)
        img_dir = os.path.join(root, "JPEGImages", resolution, name)
        msk_dir = os.path.join(root, "Annotations", resolution, name)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(msk_dir, exist_ok=True)
        images, id_masks = draw_sequence(rng, frames, h, w, num_objects)
        for f in range(frames):
            Image.fromarray(images[f]).save(os.path.join(img_dir, f"{f:05d}.jpg"))
            save_palette_mask(id_masks[f], os.path.join(msk_dir, f"{f:05d}.png"))
            img_lines.append(
                f"/JPEGImages/{resolution}/{name}/{f:05d}.jpg "
                f"/Annotations/{resolution}/{name}/{f:05d}.png"
            )

    if subset is not None:
        sets_dir = os.path.join(root, "ImageSets", year if year == "2017" else resolution)
        os.makedirs(sets_dir, exist_ok=True)
        with open(os.path.join(sets_dir, f"{subset}.txt"), "w") as f:
            f.write("\n".join(names if year == "2017" else img_lines) + "\n")
    return names
