"""Frame-level DAVIS dataset for the Mask R-CNN fine-tune path.

The port's copy of `slowfast_vos_tpu/data/frames.py`, a rebuild of the
reference `DavisDataset` (`code/maskrcnn/maskrcnn_src.py:21-161`): a flat
sorted index over ALL frames of ALL sequence directories
(`maskrcnn_src.py:27-28`), split train/val/test by sequence membership in the
ImageSets train/val lists — frames of sequences in `train.txt` are train,
in `val.txt` val, and everything else test (`maskrcnn_src.py:30-52`), so the
splits are reference-exact. Batching packs frames into Trainer windows with
fast=1, so each batch is just independent frames.

Mixed-resolution datasets batch through `data/grouping.py` (the reference's
`GroupedBatchSampler`, `code/maskrcnn/group_by_aspect_ratio.py:23-196`): each
batch draws from one quantized aspect bucket and is zero-padded bottom/right
to a shared canvas rounded up to `size_divisor` (torchvision's
`batch_images(size_divisible=32)` convention), so the number of canvases
(one `Pipeline` each) is bounded by the bucket count, not the image count.
Single-resolution data (DAVIS) batches in one shuffled sequential order.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np
from PIL import Image

from slowfast_vos_tpu_torch.data.augment import RandomFlip
from slowfast_vos_tpu_torch.data.davis import decode_frame_annotation, imageset_sequences
from slowfast_vos_tpu_torch.data.grouping import group_by_aspect_ratio


def _imageset_sequences(root, year, resolution, subset) -> set[str]:
    """Sequence names listed in an ImageSets file; empty set if absent.

    The reference requires both train.txt and val.txt to exist
    (`maskrcnn_src.py:29-40`); a missing file gives the empty set here, so
    partial synthetic trees still load."""
    try:
        return set(imageset_sequences(root, subset, year, resolution))
    except FileNotFoundError:
        return set()


class DavisFrameDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        *,
        year: str = "2017",
        max_gt: int = 8,
        resolution: str = "480p",
    ):
        imgs = sorted(glob(os.path.join(root, "JPEGImages", resolution, "*", "*.jpg")))
        msks = sorted(glob(os.path.join(root, "Annotations", resolution, "*", "*.png")))
        # Pair by shared <seq>/<frame> stem and fail loudly on a mismatch: a
        # tree with partial annotations (e.g. test-dev's first-frame-only
        # masks) would otherwise silently misalign every subsequent pair.
        mask_by_stem = {
            (os.path.basename(os.path.dirname(mp)), os.path.splitext(os.path.basename(mp))[0]): mp
            for mp in msks
        }
        if len(imgs) != len(msks):
            raise ValueError(
                f"DAVIS tree at {root}: {len(imgs)} images but {len(msks)} masks; "
                "the frame-level dataset requires one annotation per frame"
            )
        train_names = _imageset_sequences(root, year, resolution, "train")
        val_names = _imageset_sequences(root, year, resolution, "val")
        self.frames = []
        for ip in imgs:
            seq = os.path.basename(os.path.dirname(ip))
            stem = os.path.splitext(os.path.basename(ip))[0]
            mp = mask_by_stem.get((seq, stem))
            if mp is None:
                raise ValueError(f"no annotation PNG for frame {seq}/{stem}")
            which = "train" if seq in train_names else "val" if seq in val_names else "test"
            if which == split:
                self.frames.append((ip, mp))
        self.max_gt = max_gt
        self._sizes: list[tuple[int, int]] | None = None

    def __len__(self):
        return len(self.frames)

    def sizes(self) -> list[tuple[int, int]]:
        """(h, w) per frame from the image headers (no pixel decode)."""
        if self._sizes is None:
            sizes = []
            for img_path, _ in self.frames:
                with Image.open(img_path) as im:
                    w, h = im.size
                sizes.append((h, w))
            self._sizes = sizes
        return self._sizes

    def __getitem__(self, idx):
        img_path, mask_path = self.frames[idx]
        image = np.array(Image.open(img_path).convert("RGB"))
        boxes, masks, valid = decode_frame_annotation(mask_path, self.max_gt)
        return {"image": image, "boxes": boxes, "masks": masks, "gt_valid": valid}


def _assemble(items, batch_size, canvas_hw=None):
    """Stack items into one Trainer window batch, zero-padding images/masks
    bottom/right to `canvas_hw` when given (boxes are top-left anchored, so
    they need no shift — torchvision's batch_images convention)."""
    if canvas_hw is None:
        images = np.stack([it["image"] for it in items])
        masks = np.stack([it["masks"] for it in items])
    else:
        ch, cw = canvas_hw
        images = np.zeros((batch_size, ch, cw, 3), items[0]["image"].dtype)
        masks = np.zeros(
            (batch_size, items[0]["masks"].shape[0], ch, cw), items[0]["masks"].dtype
        )
        for j, it in enumerate(items):
            h, w = it["image"].shape[:2]
            images[j, :h, :w] = it["image"]
            masks[j, :, :h, :w] = it["masks"]
    gt_valid = np.stack([it["gt_valid"] for it in items])
    return {
        "images": images,
        "feat_valid": np.ones((batch_size,), bool),
        "frame_valid": gt_valid.any(axis=1),
        "boxes": np.stack([it["boxes"] for it in items]),
        "labels": np.ones(gt_valid.shape, np.int32),
        "gt_valid": gt_valid,
        "masks": masks,
    }


def _maybe_flip(item, sampler: RandomFlip, rng):
    """Per-frame horizontal flip, boxes+masks co-transformed — the reference's
    `RandomHorizontalFlip(0.5)` train transform in the Mask R-CNN fine-tune
    (`code/maskrcnn/maskrcnn_src.py:207-212`, wired via `get_transform(True)`
    at :222-233). Invalid gt slots are re-zeroed so padding rows stay inert."""
    t = sampler.sample(rng)
    if not t.flipped:
        return item
    img, masks, boxes, _ = t.apply(item["image"], item["masks"], item["boxes"])
    boxes = np.where(item["gt_valid"][:, None], boxes, 0.0).astype(boxes.dtype)
    return {"image": img, "boxes": boxes, "masks": masks, "gt_valid": item["gt_valid"]}


def frame_batches(
    dataset: DavisFrameDataset,
    batch_size: int = 2,
    *,
    shuffle=True,
    seed=0,
    size_divisor: int = 32,
    train_flip: bool = False,
):
    """Yield Trainer-compatible batches of independent frames (fast=1 =>
    window == the frames themselves, no halo).

    Uniform-resolution datasets keep the original shuffled-sequential order;
    mixed-resolution datasets batch per aspect bucket on a shared padded
    canvas (see module docstring). Tail batches smaller than `batch_size`
    are dropped in both paths (static shapes). `train_flip=True` samples a
    p=0.5 horizontal flip per frame (the reference's only train-time
    augmentation on this path); flip draws come from a dedicated RNG in yield
    order, so `utils.prefetch` (which preserves iteration order) leaves the
    augmentation stream deterministic."""
    flip = RandomFlip(0.5) if train_flip else None
    flip_rng = np.random.default_rng(seed + 0x5F11) if train_flip else None

    def fetch(i):
        item = dataset[int(i)]
        return _maybe_flip(item, flip, flip_rng) if flip is not None else item

    sizes = dataset.sizes() if hasattr(dataset, "sizes") else None
    if sizes is None or len(set(sizes)) <= 1:
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [fetch(i) for i in order[start : start + batch_size]]
            yield _assemble(items, batch_size)
        return

    # One canvas per aspect BUCKET (not per batch): the canvas count is
    # bounded by the bucket count regardless of how sizes interleave.
    # Batches from all buckets are then interleaved in shuffled global order,
    # matching the reference GroupedBatchSampler's training-order distribution
    # (`group_by_aspect_ratio.py:23-196` draws batches as the shuffled sampler
    # stream fills each bucket, not bucket-by-bucket).
    rup = lambda v: -(-v // size_divisor) * size_divisor
    groups = group_by_aspect_ratio(sizes)
    rng = np.random.default_rng(seed)
    planned = []  # (canvas, [item indices]) across every bucket
    for _gid, idxs in sorted(groups.items()):
        canvas = (
            rup(max(sizes[i][0] for i in idxs)),
            rup(max(sizes[i][1] for i in idxs)),
        )
        idxs = list(idxs)
        if shuffle:
            rng.shuffle(idxs)
        for s in range(0, len(idxs) - batch_size + 1, batch_size):
            planned.append((canvas, idxs[s : s + batch_size]))
    if shuffle:
        rng.shuffle(planned)
    for canvas, batch_idxs in planned:
        items = [fetch(i) for i in batch_idxs]
        yield _assemble(items, batch_size, canvas)
