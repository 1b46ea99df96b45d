"""Training-window extraction from decoded sequences, host numpy.

The port's copy of `slowfast_vos_tpu/data/windows.py` (`train_windows`,
`windows.py:14-45`). The reference trains per frame with a gradient
accumulation of 2 (`code/helpers/model.py:318-374`); the train step
consumes windows of `n_center` consecutive frames plus the F-1 temporal
halo (`train/train_step.py`). This slices those windows out of fixed-shape
sequence arrays (tracer span `data.window` a window).
"""
from __future__ import annotations

import numpy as np

from slowfast_vos_tpu_torch.utils.profiling import TRACER


def train_windows(seq: dict, fast: int, n_center: int = 2):
    """Yield training batches covering all frames of a sequence in order.

    seq: images [T, H, W, 3] uint8, frame_valid [T] bool, boxes [T, G, 4]
    float32, gt_valid [T, G] bool, masks [T, G, H, W] uint8. Each batch
    matches the `Trainer` contract: images [W, H, W0, 3] uint8 (normalized
    on the device), feat_valid [W], frame_valid [n], boxes [n, G, 4], labels
    [n, G] (all 1), gt_valid [n, G], masks [n, G, H, W0]."""
    t = seq["images"].shape[0]
    halo_left = fast // 2
    halo_right = -(-fast // 2) - 1
    w = n_center + fast - 1
    for start in range(0, t, n_center):
        with TRACER.span("data.window"):
            # window frame indices (may run off both ends)
            idxs = np.arange(start - halo_left, start + n_center + halo_right)
            feat_valid = (idxs >= 0) & (idxs < t)
            clipped = np.clip(idxs, 0, t - 1)
            images = seq["images"][clipped].copy()
            images[~feat_valid] = 0

            centers = np.arange(start, start + n_center)
            cvalid = centers < t
            cclip = np.clip(centers, 0, t - 1)
            window = {
                "images": images,
                "feat_valid": feat_valid,
                "frame_valid": seq["frame_valid"][cclip] & cvalid,
                "boxes": seq["boxes"][cclip],
                "labels": np.ones(seq["gt_valid"][cclip].shape, np.int32),
                "gt_valid": seq["gt_valid"][cclip] & cvalid[:, None],
                "masks": seq["masks"][cclip],
            }
        yield window
        assert images.shape[0] == w
