"""Training-window extraction from decoded sequences, host numpy.

The port's copy of `slowfast_vos_tpu/data/windows.py` (`train_windows`,
`windows.py:14-45`). The reference trains per frame with a gradient
accumulation of 2 (`code/helpers/model.py:318-374`); the train step
consumes windows of `n_center` consecutive frames plus the F-1 temporal
halo (`train/train_step.py`). This cuts those windows out of a sequence
(tracer span `data.window` a window): frame by frame out of a
`data/davis.py::LazySequence`, so that each window decodes only the frames
it is the first to touch, or out of fixed-shape sequence arrays.
"""
from __future__ import annotations

import numpy as np

from slowfast_vos_tpu_torch.data.davis import FRAME_FIELDS, LazySequence
from slowfast_vos_tpu_torch.utils.profiling import TRACER


def train_windows(seq, fast: int, n_center: int = 2, wanted=None):
    """Yield training batches covering all frames of a sequence in order.

    seq: a `LazySequence`, or a dict of images [T, H, W, 3] uint8,
    frame_valid [T] bool, boxes [T, G, 4] float32, gt_valid [T, G] bool,
    masks [T, G, H, W] uint8. Each batch matches the `Trainer` contract:
    images [W, H, W0, 3] uint8 (normalized on the device), feat_valid [W],
    frame_valid [n], boxes [n, G, 4], labels [n, G] (all 1), gt_valid
    [n, G], masks [n, G, H, W0].

    A `LazySequence` is read a frame at a time: the first window decodes
    its halo and centres, each later one its `n_center` new frames, and
    the frames behind the next window's left halo are forgotten, so the
    sequence holds at most one window of decoded frames. The windows are
    the same either way.

    `wanted(k)`, where given, says whether this caller uses the sequence's
    k-th window: one it does not use is yielded as None and reads no frame
    (a data-parallel rank cuts only its own windows)."""
    if isinstance(seq, LazySequence):
        t, frame, forget = seq.length, seq.frame, seq.forget
    else:
        t = seq["images"].shape[0]

        def frame(i):
            return {k: seq[k][i] for k in FRAME_FIELDS}

        def forget(below):
            pass

    halo_left = fast // 2
    halo_right = -(-fast // 2) - 1
    w = n_center + fast - 1
    for k, start in enumerate(range(0, t, n_center)):
        if wanted is not None and not wanted(k):
            forget(start + n_center - halo_left)
            yield None
            continue
        with TRACER.span("data.window"):
            # window frame indices (may run off both ends)
            idxs = np.arange(start - halo_left, start + n_center + halo_right)
            feat_valid = (idxs >= 0) & (idxs < t)
            frames = {i: frame(i) for i in idxs[feat_valid].tolist()}
            blank = np.zeros_like(frames[start]["images"])
            images = np.stack([frames[i]["images"] if ok else blank for i, ok in zip(idxs, feat_valid)])

            centers = np.arange(start, start + n_center)
            cvalid = centers < t
            centre = [frames[i] for i in np.clip(centers, 0, t - 1)]
            gt_valid = np.stack([f["gt_valid"] for f in centre])
            window = {
                "images": images,
                "feat_valid": feat_valid,
                "frame_valid": np.stack([f["frame_valid"] for f in centre]) & cvalid,
                "boxes": np.stack([f["boxes"] for f in centre]),
                "labels": np.ones(gt_valid.shape, np.int32),
                "gt_valid": gt_valid & cvalid[:, None],
                "masks": np.stack([f["masks"] for f in centre]),
            }
            forget(start + n_center - halo_left)
        yield window
        assert images.shape[0] == w
