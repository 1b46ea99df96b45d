"""DAVIS dataset indexing and sequence decoding, host numpy and Pillow.

The port's copy of `slowfast_vos_tpu/data/davis.py`, the capabilities of the
reference loaders (`code/helpers/dataset.py:15-139`):

* palette-PNG masks split into per-object binary masks, tight boxes from
  mask extents, degenerate (empty) boxes dropped;
* the 2017 layout (`ImageSets/2017/<subset>.txt`, one sequence name per
  line) and the 2016 layout (`ImageSets/480p/<subset>.txt`, per-frame paths)
  (`dataset.py:21-30`).

`load_sequence` returns fixed-shape numpy arrays padded to `max_gt` with
validity masks, the batch contract of `train/train_step.py::Trainer`. Its
tracer spans (`utils/profiling.py::TRACER`): `data.load_sequence` (a unit
of work) > `data.decode_images`, `data.decode_masks` (the PNGs and the
per-object mask array); counter `data.frames`.
"""
from __future__ import annotations

import dataclasses
import os
from glob import glob

import numpy as np
from PIL import Image

from slowfast_vos_tpu_torch.utils.profiling import TRACER


@dataclasses.dataclass
class SequenceInfo:
    name: str
    images: list[str]
    masks: list[str]


def imageset_sequences(root: str, subset: str, year: str = "2017", resolution: str = "480p") -> list[str]:
    """Sequence names of `ImageSets/<2017 | resolution>/<subset>.txt`. 2017
    lists one name per line; 2016 lists '<img> <mask>' per frame, and the
    sequence is the image's parent directory (sorted, distinct)."""
    sets_dir = os.path.join(root, "ImageSets", year if year == "2017" else resolution)
    with open(os.path.join(sets_dir, f"{subset}.txt")) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if year == "2017":
        return lines
    return sorted({ln.split()[0].split("/")[-2] for ln in lines})


class DavisIndex:
    """Index of DAVIS sequences for a subset/year."""

    def __init__(
        self,
        root: str,
        subset: str = "train",
        resolution: str = "480p",
        year: str = "2017",
        sequences="all",
    ):
        self.root = root
        self.subset = subset
        self.img_path = os.path.join(root, "JPEGImages", resolution)
        self.mask_path = os.path.join(root, "Annotations", resolution)
        if sequences == "all":
            names = imageset_sequences(root, subset, year, resolution)
        else:
            names = sequences if isinstance(sequences, list) else [sequences]

        self.sequences = [
            SequenceInfo(
                name=n,
                images=sorted(glob(os.path.join(self.img_path, n, "*.jpg"))),
                masks=sorted(glob(os.path.join(self.mask_path, n, "*.png"))),
            )
            for n in names
        ]

    def __len__(self):
        return len(self.sequences)

    def __iter__(self):
        return iter(self.sequences)


def annotation_from_ids(mask: np.ndarray, max_gt: int, single_object: bool = False):
    """An object-id mask [H, W] -> (boxes [max_gt, 4] f32 XYXY, masks
    [max_gt, H, W] uint8, valid [max_gt] bool).

    Mirrors the reference's box derivation (`dataset.py:89-107`): object ids
    are the nonzero values present in THIS frame, in ascending order; boxes
    are [xmin, ymin, xmax, ymax] from mask extents; objects with a degenerate
    extent are dropped."""
    h, w = mask.shape[:2]
    obj_ids = np.unique(mask)
    obj_ids = obj_ids[obj_ids != 0]
    if single_object:
        obj_ids = obj_ids[:1]

    boxes = np.zeros((max_gt, 4), np.float32)
    masks = np.zeros((max_gt, h, w), np.uint8)
    valid = np.zeros((max_gt,), bool)
    slot = 0
    for oid in obj_ids:
        if slot >= max_gt:
            break
        bin_mask = mask == oid
        ys, xs = np.where(bin_mask)
        if len(xs) == 0:
            continue
        x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
        if x1 < x2 and y1 < y2:
            boxes[slot] = [x1, y1, x2, y2]
            masks[slot] = bin_mask
            valid[slot] = True
            slot += 1
    return boxes, masks, valid


def decode_frame_annotation(mask_path: str, max_gt: int, single_object: bool = False):
    """Palette PNG -> per-object binary masks and tight boxes, padded to
    max_gt (`annotation_from_ids`)."""
    return annotation_from_ids(np.array(Image.open(mask_path)), max_gt, single_object)


def load_sequence(info: SequenceInfo, max_gt: int = 8, single_object: bool = False):
    """Decode a whole sequence into fixed-shape arrays.

    Returns dict:
      images [T,H,W,3] uint8; boxes [T,G,4] f32; masks [T,G,H,W] uint8;
      gt_valid [T,G] bool; frame_valid [T] bool (any gt present);
      name: sequence name.
    """
    with TRACER.span("data.load_sequence", unit=True):
        with TRACER.span("data.decode_images"):
            images = np.stack([np.array(Image.open(p).convert("RGB")) for p in info.images])
        t = len(info.images)
        h, w = images.shape[1:3]
        with TRACER.span("data.decode_masks"):
            boxes = np.zeros((t, max_gt, 4), np.float32)
            masks = np.zeros((t, max_gt, h, w), np.uint8)
            valid = np.zeros((t, max_gt), bool)
            for i, mp in enumerate(info.masks):
                boxes[i], masks[i], valid[i] = decode_frame_annotation(mp, max_gt, single_object)
        TRACER.count("data.frames", t)
    return {
        "name": info.name,
        "images": images,
        "boxes": boxes,
        "masks": masks,
        "gt_valid": valid,
        "frame_valid": valid.any(axis=1),
    }


DAVIS_PALETTE = np.concatenate(
    [
        np.array(
            [
                [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0],
                [0, 0, 128], [128, 0, 128], [0, 128, 128], [128, 128, 128],
                [64, 0, 0], [191, 0, 0], [64, 128, 0], [191, 128, 0],
                [64, 0, 128], [191, 0, 128], [64, 128, 128], [191, 128, 128],
            ],
            np.uint8,
        ),
        np.zeros((240, 3), np.uint8),
    ]
)


def save_palette_mask(mask: np.ndarray, path: str):
    """Write an object-id mask as a DAVIS palette PNG (the on-disk contract
    with the scorer, reference `davis2017/utils.py:127-132`)."""
    img = Image.fromarray(mask.astype(np.uint8), mode="P")
    img.putpalette(DAVIS_PALETTE.ravel().tolist())
    img.save(path)
