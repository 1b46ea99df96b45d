"""OSVOS first-frame dataset: augmented copies of the first annotated frame.

The port's copy of `slowfast_vos_tpu/data/osvos_dataset.py`, a rebuild of
the reference `DAVISSequenceDataset` (`code/osvos/dataset_osvos.py`):
* 200 synthetic items per epoch, each an independently augmented copy of
  frame 0 with its ceil(F/2)-1 following neighbors (`:40-41,77`);
* ONE object only (the first palette id, `:100`);
* RandomHorizontalFlip + RandomScale(cfg.scale or 0.25) + RandomRotate(30),
  one parameter draw applied consistently to the whole window (`:43-68`);
* the scale draw is retried until the box survives the crop (`:59-63`);
* the window is reflect-padded at the front with the reversed neighbor frames
  (`:129-135`), so the fast pathway always sees F frames.

Output is the same fixed-shape batch dict the Trainer consumes (n_center=1).
"""
from __future__ import annotations

import numpy as np

from slowfast_vos_tpu_torch.data import augment
from slowfast_vos_tpu_torch.data.davis import SequenceInfo, load_sequence


class OsvosFirstFrameDataset:
    def __init__(
        self,
        info: SequenceInfo,
        fast_pathway_size: int,
        *,
        scale: float = 0.25,
        rotate: float = 30.0,
        items_per_epoch: int = 200,
        max_gt: int = 8,
        seed: int = 63,
    ):
        self.fast = fast_pathway_size
        self.items_per_epoch = items_per_epoch
        self.max_gt = max_gt
        n_frames = -(-fast_pathway_size // 2)  # ceil(F/2): frame 0 + neighbors
        clipped = SequenceInfo(
            name=info.name,
            images=info.images[:n_frames],
            masks=info.masks[:1],
        )
        self.seq = dict(load_sequence(clipped, max_gt=max_gt, single_object=True))
        self.flip = augment.RandomFlip()
        self.scale = augment.RandomScale(scale)
        self.rotate = augment.RandomRotate(rotate)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.items_per_epoch

    def __getitem__(self, idx) -> dict:
        rng = self.rng
        flip = self.flip.sample(rng)
        rotate = self.rotate.sample(rng)

        images = self.seq["images"]
        n_avail = images.shape[0]
        boxes0 = self.seq["boxes"][0][self.seq["gt_valid"][0]][:1]
        masks0 = self.seq["masks"][0][self.seq["gt_valid"][0]][:1]

        # First frame with targets: flip -> scale (retry until box survives)
        # -> rotate, reference dataset_osvos.py:43-68.
        img0, m0, b0, _ = flip.apply(images[0], masks0, boxes0.astype(np.float64))
        while True:
            scale = self.scale.sample(rng)
            img_s, m_s, b_s, keep = scale.apply(img0, m0, b0)
            if keep is not None and keep.any():
                break
        img0, m0, b0, keep_r = rotate.apply(img_s, m_s[keep], b_s[keep])
        if b0 is not None and keep_r is not None:
            b0, m0 = b0[keep_r], m0[keep_r]

        # Neighbor frames: same draw, images only.
        neighbors = []
        for f in range(1, n_avail):
            im, _, _, _ = flip.apply(images[f])
            im, _, _, _ = scale.apply(im)
            im, _, _, _ = rotate.apply(im)
            neighbors.append(im)

        # Reflect-pad at the front with reversed neighbors; right halo uses the
        # neighbors themselves. Window length = 1 + F - 1 frames centered on 0.
        halo_left = self.fast // 2
        halo_right = -(-self.fast // 2) - 1
        front = list(reversed(neighbors))[:halo_left]
        front_valid = [True] * len(front)
        while len(front) < halo_left:
            front.insert(0, np.zeros_like(images[0]))
            front_valid.insert(0, False)
        back = neighbors[:halo_right]
        back_valid = [True] * len(back)
        while len(back) < halo_right:
            back.append(np.zeros_like(images[0]))
            back_valid.append(False)
        window = np.stack(front + [img0] + back)  # uint8; normalized on the device
        # Zero-filled halo slots (even F, or sequences shorter than ceil(F/2))
        # are marked invalid so the pipeline substitutes zero FEATURES for
        # them, matching the reference's compute_maskrcnn_features padding
        # (model.py:215-225) instead of computing features of a black frame.
        feat_valid = np.array(front_valid + [True] + back_valid, bool)

        g = self.max_gt
        h, w = images.shape[1:3]
        boxes = np.zeros((1, g, 4), np.float32)
        masks = np.zeros((1, g, h, w), np.uint8)
        gt_valid = np.zeros((1, g), bool)
        n_obj = 0 if b0 is None else len(b0)
        if n_obj:
            boxes[0, :n_obj] = b0[:g]
            masks[0, :n_obj] = m0[:g]
            gt_valid[0, :n_obj] = True

        return {
            "images": window,
            "feat_valid": feat_valid,
            "frame_valid": np.array([n_obj > 0]),
            "boxes": boxes,
            "labels": np.ones((1, g), np.int32),
            "gt_valid": gt_valid,
            "masks": masks,
        }
