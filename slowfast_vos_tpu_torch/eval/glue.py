"""Evaluation glue: run the model over DAVIS sequences, write the PNG results
layout, score it. The equivalent of the reference's `davis_evaluation`
(`code/helpers/davis_evaluate.py:20-79`) and `extract_for_davis_eval.py`.

The port's copy of the serial path of `slowfast_vos_tpu/eval/glue.py`. The
on-disk contract is the reference's: the per-frame UNION of all detection
masks thresholded at 0.5 (`davis_evaluate.py:36-44`), written as
`<results_root>/<task>/<model_name>/<seq>/00000.png...`, scoreable by this
package's scorer, the JAX package's and the reference's vendored one.
"""
from __future__ import annotations

import os
import time

import numpy as np
from PIL import Image

from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence, save_palette_mask
from slowfast_vos_tpu_torch.eval.scorer import DavisScorer, summarize
from slowfast_vos_tpu_torch.utils.prefetch import prefetch


def union_mask(det: dict, threshold: float = 0.5) -> np.ndarray:
    """Union of valid detection masks >= threshold -> bool [H, W].

    At the default threshold this is the union the pipeline computes on the
    device; another threshold reads the per-instance masks
    (`infer_sequence(instance_masks=True)`)."""
    if threshold == 0.5 and "union_mask" in det:
        return det["union_mask"].astype(bool)
    masks = det["masks"] >= threshold
    masks = masks & det["valid"][:, None, None]
    return masks.any(axis=0)


def _write_sequence_masks(out_dir, name, dets, year, threshold, progress):
    seq_dir = os.path.join(out_dir, name)
    os.makedirs(seq_dir, exist_ok=True)
    for i, det in enumerate(dets):
        mask = union_mask(det, threshold)
        path = os.path.join(seq_dir, f"{i:05d}.png")
        if year == "2016":
            Image.fromarray((mask * 255).astype(np.uint8)).save(path)
        else:
            save_palette_mask(mask.astype(np.uint8), path)
    if progress is not None:
        progress(name)


def extract_masks(
    pipe,
    davis_root: str,
    out_dir: str,
    *,
    sequences="all",
    subset: str = "val",
    year: str = "2016",
    threshold: float = 0.5,
    progress=None,
):
    """Run inference with `pipe` and write per-frame union masks as PNGs.

    Year 2016 writes 0/255 binary PNGs, byte-compatible with the reference's
    on-disk contract (`davis_evaluate.py:36-44` saves union*255, the scorer
    divides by 255 only for 2016, `results.py:30-35`). Year 2017 writes the
    union as palette id 1: the 2017 reader treats pixel values as object ids
    (`max()` = object count), so a 255-valued mask would read as 255
    proposals there.

    The next sequence's frames are decoded on a background thread while the
    current one runs inference (`utils/prefetch.py`); depth 1 bounds host
    memory to about three decoded sequences."""
    index = DavisIndex(davis_root, subset, year=year, sequences=sequences)
    instance_masks = threshold != 0.5
    with prefetch(
        ((info, load_sequence(info, max_gt=pipe.cfg.max_gt)) for info in index), depth=1
    ) as decoded:
        for info, seq in decoded:
            dets = pipe.infer_sequence(seq["images"], instance_masks=instance_masks)
            _write_sequence_masks(out_dir, info.name, dets, year, threshold, progress)


def davis_evaluation(
    pipe,
    *,
    davis_root: str,
    results_root: str,
    model_name: str,
    sequences=None,
    subset: str = "val",
    year: str = "2016",
):
    """Inference with `pipe` (its model as it stands) and the official
    scoring. `sequences=None` evaluates the full set; naming sequences (the
    OSVOS flow) writes under the 'semi-supervised' results path, mirroring
    `davis_evaluate.py:27`.

    The task name ONLY picks the results directory: scoring ALWAYS uses the
    unsupervised evaluator (all frames, Hungarian matching), exactly like the
    reference, whose `davis_evaluate.py:49` hardcodes task='unsupervised' for
    `DAVISEvaluation` regardless of the output path.

    Returns (jf_mean, global_summary dict, per_object dict, wall_time_s).
    """
    t0 = time.time()
    task = "unsupervised" if sequences is None else "semi-supervised"
    seqs = "all" if sequences is None else sequences
    out_dir = os.path.join(results_root, task, model_name)
    extract_masks(pipe, davis_root, out_dir, sequences=seqs, subset=subset, year=year)
    scorer = DavisScorer(davis_root, task="unsupervised", gt_set=subset, sequences=seqs, year=year)
    metrics = scorer.evaluate(out_dir)
    summary = summarize(metrics)
    per_object = {
        name: {"J-Mean": metrics["J"]["M_per_object"][name], "F-Mean": metrics["F"]["M_per_object"][name]}
        for name in metrics["J"]["M_per_object"]
    }
    return summary["J&F-Mean"], summary, per_object, time.time() - t0
