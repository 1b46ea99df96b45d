"""Aspect-ratio grouping for mixed-resolution frame batching.

The port's copy of `slowfast_vos_tpu/data/grouping.py`, the equivalent of
the vendored `GroupedBatchSampler`
(`code/maskrcnn/group_by_aspect_ratio.py:23-196`): images are bucketed by
quantized aspect ratio so each batch shares a canvas, and each group maps to
one `Pipeline` (one static canvas).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np


def quantize_ratios(ratios, bins):
    bins = sorted(bins)
    return [bisect.bisect_right(bins, r) for r in ratios]


def group_by_aspect_ratio(sizes, k: int = 3):
    """sizes: list of (h, w). Returns {group_id: [indices]} with 2k+1 log-
    spaced ratio buckets in [1/2, 2], like the reference's _quantize."""
    ratios = [w / h for h, w in sizes]
    bins = (2 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    groups = quantize_ratios(ratios, bins)
    out = defaultdict(list)
    for i, g in enumerate(groups):
        out[g].append(i)
    return dict(out)


def grouped_batches(sizes, batch_size: int, *, k: int = 3, shuffle=True, seed=0):
    """Yield index batches where every batch comes from one aspect group; the
    remainder of each group forms a final smaller batch (the reference keeps
    them, `group_by_aspect_ratio.py:62-84`)."""
    groups = group_by_aspect_ratio(sizes, k)
    rng = np.random.default_rng(seed)
    for _gid, idxs in sorted(groups.items()):
        idxs = list(idxs)
        if shuffle:
            rng.shuffle(idxs)
        for s in range(0, len(idxs), batch_size):
            yield idxs[s : s + batch_size]
