"""DAVIS dataset indexing and sequence decoding, host numpy and Pillow.

The port's copy of `slowfast_vos_tpu/data/davis.py`, the capabilities of the
reference loaders (`code/helpers/dataset.py:15-139`):

* palette-PNG masks split into per-object binary masks, tight boxes from
  mask extents, degenerate (empty) boxes dropped;
* the 2017 layout (`ImageSets/2017/<subset>.txt`, one sequence name per
  line) and the 2016 layout (`ImageSets/480p/<subset>.txt`, per-frame paths)
  (`dataset.py:21-30`).

`load_sequence` returns a `LazySequence`: fixed-shape numpy arrays padded
to `max_gt` with validity masks, the batch contract of
`train/train_step.py::Trainer`, decoded a frame at a time when first asked
for. Tracer spans (`utils/profiling.py::TRACER`): `data.load_sequence` (a
unit of work: opening a sequence); per decoded frame `data.decode_images`
(the JPEG) and `data.decode_masks` (the PNG and its per-object masks),
wherever the frame is first asked for; counter `data.frames`, frames
decoded.
"""
from __future__ import annotations

import dataclasses
import os
from collections.abc import Mapping
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
    extent are dropped. Each object costs a comparison written into its
    slot and two `any` reductions; the ids of an unsigned mask come from a
    count of its values, without `np.unique`'s sort."""
    h, w = mask.shape[:2]
    obj_ids = np.flatnonzero(np.bincount(mask.ravel())) if mask.dtype.kind == "u" else np.unique(mask)
    obj_ids = obj_ids[obj_ids != 0]
    if single_object:
        obj_ids = obj_ids[:1]

    boxes = np.zeros((max_gt, 4), np.float32)
    masks = np.zeros((max_gt, h, w), np.uint8)
    valid = np.zeros((max_gt,), bool)
    slot = 0
    for oid in obj_ids.tolist():
        if slot >= max_gt:
            break
        bin_mask = np.equal(mask, oid, out=masks[slot].view(bool))
        ys, xs = np.flatnonzero(bin_mask.any(axis=1)), np.flatnonzero(bin_mask.any(axis=0))
        x1, x2, y1, y2 = xs[0], xs[-1], ys[0], ys[-1]
        if x1 < x2 and y1 < y2:
            boxes[slot] = [x1, y1, x2, y2]
            valid[slot] = True
            slot += 1
        else:
            masks[slot] = 0
    return boxes, masks, valid


def decode_frame_annotation(mask_path: str, max_gt: int, single_object: bool = False):
    """Palette PNG -> per-object binary masks and tight boxes, padded to
    max_gt (`annotation_from_ids`)."""
    return annotation_from_ids(np.array(Image.open(mask_path)), max_gt, single_object)


FRAME_FIELDS = ("images", "boxes", "masks", "gt_valid", "frame_valid")


class LazySequence(Mapping):
    """A sequence of `load_sequence`, decoded a frame at a time.

    A mapping of `name` and the fields of `FRAME_FIELDS`: images [T,H,W,3]
    uint8; boxes [T,G,4] f32; masks [T,G,H,W] uint8; gt_valid [T,G] bool;
    frame_valid [T] bool (any gt present). `frame(i)` decodes frame i the
    first time it is asked for (JPEG, PNG, `annotation_from_ids`) and holds
    it until `forget` drops it; frames past the last mask (OSVOS clips)
    have no objects. Reading a field decodes every frame not held, once,
    and returns the whole sequence's arrays. `data/windows.py::train_windows`
    asks for a window's frames only and forgets those behind it."""

    def __init__(self, info: SequenceInfo, max_gt: int, single_object: bool):
        self.info, self.max_gt, self.single_object = info, max_gt, single_object
        self.length = len(info.images)
        self._frames: dict[int, dict] = {}
        self._arrays: dict | None = None

    def __getitem__(self, key):
        if key == "name":
            return self.info.name
        if key not in FRAME_FIELDS:
            raise KeyError(key)
        return self._read()[key]

    def __iter__(self):
        return iter(("name", *FRAME_FIELDS))

    def __len__(self):
        return 1 + len(FRAME_FIELDS)

    def frame(self, i: int) -> dict:
        """Frame i's fields (`FRAME_FIELDS`, without the leading T)."""
        if self._arrays is not None:
            return {k: self._arrays[k][i] for k in FRAME_FIELDS}
        if i not in self._frames:
            self._frames[i] = self._decode(i)
        return self._frames[i]

    def forget(self, below: int) -> None:
        """Drop the held frames before frame `below`."""
        for i in [i for i in self._frames if i < below]:
            del self._frames[i]

    def _decode(self, i: int) -> dict:
        with TRACER.span("data.decode_images"):
            # a view of the decoded bytes; `convert` only where the JPEG is not RGB (it would copy them)
            im = Image.open(self.info.images[i])
            image = np.asarray(im if im.mode == "RGB" else im.convert("RGB"))
        with TRACER.span("data.decode_masks"):
            if i < len(self.info.masks):
                boxes, masks, valid = decode_frame_annotation(self.info.masks[i], self.max_gt, self.single_object)
            else:
                boxes = np.zeros((self.max_gt, 4), np.float32)
                masks = np.zeros((self.max_gt, *image.shape[:2]), np.uint8)
                valid = np.zeros((self.max_gt,), bool)
        TRACER.count("data.frames")
        return {"images": image, "boxes": boxes, "masks": masks, "gt_valid": valid, "frame_valid": valid.any()}

    def _read(self) -> dict:
        """The whole sequence's arrays, each frame written in as it is
        decoded (or taken from those held)."""
        if self._arrays is None:
            arrays = {}
            for i in range(self.length):
                f = self._frames.pop(i, None) or self._decode(i)
                for k, v in f.items():
                    if k not in arrays:
                        arrays[k] = np.empty((self.length, *np.shape(v)), np.asarray(v).dtype)
                    arrays[k][i] = v
            self._arrays = arrays
        return self._arrays


def load_sequence(info: SequenceInfo, max_gt: int = 8, single_object: bool = False) -> LazySequence:
    """Open a sequence: a `LazySequence`, which decodes nothing yet. Its
    fields are the arrays of the whole sequence; `dict(seq)` reads them
    all."""
    with TRACER.span("data.load_sequence", unit=True):
        return LazySequence(info, max_gt, single_object)


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
