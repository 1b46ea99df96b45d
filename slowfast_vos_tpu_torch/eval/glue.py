"""Evaluation glue: run the model over DAVIS sequences, write the PNG results
layout, score it. The equivalent of the reference's `davis_evaluation`
(`code/helpers/davis_evaluate.py:20-79`) and `extract_for_davis_eval.py`.

The port of `slowfast_vos_tpu/eval/glue.py`. The on-disk contract is the
reference's: the per-frame UNION of all detection masks thresholded at 0.5
(`davis_evaluate.py:36-44`), written as
`<results_root>/<task>/<model_name>/<seq>/00000.png...`, scoreable by this
package's scorer, the JAX package's and the reference's vendored one. A
multi-process launch splits the sequences over the ranks and merges the
scores; one process may also spread its sequences over several devices
(`parallel/dp_infer.py`).
"""
from __future__ import annotations

import os
import time

import numpy as np
from PIL import Image

from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence, save_palette_mask
from slowfast_vos_tpu_torch.eval.scorer import DavisScorer, summarize
from slowfast_vos_tpu_torch.parallel.distributed import all_gather_host, get_rank, get_world_size, host_barrier
from slowfast_vos_tpu_torch.parallel.dp_infer import DeviceParallelInference
from slowfast_vos_tpu_torch.parallel.mesh import parallel_devices
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


def decode_sequence(info, max_gt: int) -> dict:
    """A sequence's arrays, decoded whole on the calling thread (the
    prefetch thread of `extract_masks`): `load_sequence` decodes frames only
    when they are read."""
    return dict(load_sequence(info, max_gt=max_gt))


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
    shard_by_process: bool = True,
    device_parallel: bool | None = None,
    devices=None,
):
    """Run inference with `pipe` and write per-frame union masks as PNGs.

    Year 2016 writes 0/255 binary PNGs, byte-compatible with the reference's
    on-disk contract (`davis_evaluate.py:36-44` saves union*255, the scorer
    divides by 255 only for 2016, `results.py:30-35`). Year 2017 writes the
    union as palette id 1: the 2017 reader treats pixel values as object ids
    (`max()` = object count), so a 255-valued mask would read as 255
    proposals there.

    Multi-process launches split the sequence list round-robin by rank
    (`shard_by_process=True`, the analogue of the reference's
    DistributedSampler over images, `code/maskrcnn/train.py:73-74`); each
    process writes its shard of the shared tree, then all processes meet at
    a barrier so the tree is complete before anyone scores it.

    Within one process, `device_parallel=True` additionally maps this
    process's sequences onto a device list (`devices`, else every visible
    GPU: `parallel/mesh.py::parallel_devices`), in groups of len(devices),
    one member thread per sequence (`parallel/dp_infer.py`), bit-identical
    to the serial loop on the same device. The list is cut to the number of
    sequences, and one sequence runs the serial loop. None (the default)
    keeps the serial loop unless the caller names `devices`: on four H100s
    the device list lost to it (`scripts/torch_parallel_scaling.py`,
    PERF.md), since the decode and the PNG writing on the host, not the
    device, bound the extraction. False always keeps the serial loop.

    The next sequence (or group) is decoded on a background thread while
    the current one runs inference (`utils/prefetch.py`); depth 1 bounds
    host memory to about three decoded sequences (groups)."""
    infos = list(DavisIndex(davis_root, subset, year=year, sequences=sequences))
    sharded = shard_by_process and get_world_size() > 1
    if sharded:
        infos = infos[get_rank() :: get_world_size()]
    if device_parallel is None:
        device_parallel = devices is not None
    devices = parallel_devices(pipe, device_parallel, devices)
    if devices is not None:
        devices = devices[: len(infos)] if len(infos) > 1 else None
    instance_masks = threshold != 0.5

    def decode(info):
        return info, decode_sequence(info, pipe.cfg.max_gt)

    if devices is not None:
        dp = DeviceParallelInference(pipe, devices, instance_masks=instance_masks)
        groups = (infos[s : s + dp.n] for s in range(0, len(infos), dp.n))
        with prefetch(([decode(info) for info in grp] for grp in groups), depth=1) as decoded_groups:
            for grp in decoded_groups:
                results = dp.infer_group([seq["images"] for _, seq in grp])
                for (info, _), dets in zip(grp, results):
                    _write_sequence_masks(out_dir, info.name, dets, year, threshold, progress)
    else:
        with prefetch((decode(info) for info in infos), depth=1) as decoded:
            for info, seq in decoded:
                dets = pipe.infer_sequence(seq["images"], instance_masks=instance_masks)
                _write_sequence_masks(out_dir, info.name, dets, year, threshold, progress)
    if sharded:
        host_barrier("extract_masks_done")


def merge_scorer_metrics(local: dict, global_sequences: list[str]) -> dict:
    """Gather the per-(sequence, object) J/F statistics that each process
    scored over its sequence shard, and rebuild the full metrics dict in
    global sequence order (the JAX `merge_scorer_metrics`, the analogue of
    the reference's gathered COCO-eval merge, `code/maskrcnn/utils.py:79-119`).

    Each process contributes a float64 row table [seq_idx, obj_id, JM, JR,
    JD, FM, FR, FD], gathered over the host group (pickled: bit for bit).
    The host group's timeout outlasts the skew of per-shard scoring, so no
    barrier precedes the gather. Single-process: identity."""
    if get_world_size() == 1:
        return local
    seq_idx = {s: i for i, s in enumerate(global_sequences)}
    rows = []
    for row, name in enumerate(local["J"]["M_per_object"]):
        seq, obj = name.rsplit("_", 1)
        rows.append([seq_idx[seq], float(obj), *(local[m][k][row] for m in ("J", "F") for k in ("M", "R", "D"))])
    table = np.concatenate([np.asarray(r, np.float64).reshape(-1, 8) for r in all_gather_host(rows)])
    table = table[np.lexsort((table[:, 1], table[:, 0]))]
    out = {
        "J": {"M": [], "R": [], "D": [], "M_per_object": {}},
        "F": {"M": [], "R": [], "D": [], "M_per_object": {}},
    }
    for r in table:
        name = f"{global_sequences[int(r[0])]}_{int(r[1])}"
        for metric, vals in (("J", r[2:5]), ("F", r[5:8])):
            out[metric]["M"].append(float(vals[0]))
            out[metric]["R"].append(float(vals[1]))
            out[metric]["D"].append(float(vals[2]))
            out[metric]["M_per_object"][name] = float(vals[0])
    return out


def davis_evaluation(
    pipe,
    *,
    davis_root: str,
    results_root: str,
    model_name: str,
    sequences=None,
    subset: str = "val",
    year: str = "2016",
    shard_by_process: bool = True,
):
    """Inference with `pipe` (its model as it stands) and the official
    scoring. `sequences=None` evaluates the full set; naming sequences (the
    OSVOS flow) writes under the 'semi-supervised' results path, mirroring
    `davis_evaluate.py:27`. A multi-process launch (`shard_by_process`)
    infers and scores each rank's shard of the sequences and merges the
    per-object statistics (`merge_scorer_metrics`): every process returns
    the full table.

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
    extract_masks(
        pipe, davis_root, out_dir, sequences=seqs, subset=subset, year=year, shard_by_process=shard_by_process,
    )
    scorer = DavisScorer(davis_root, task="unsupervised", gt_set=subset, sequences=seqs, year=year)
    if shard_by_process and get_world_size() > 1:
        all_seqs = list(scorer.sequences)
        scorer.sequences = all_seqs[get_rank() :: get_world_size()]
        metrics = merge_scorer_metrics(scorer.evaluate(out_dir), all_seqs)
    else:
        metrics = scorer.evaluate(out_dir)
    summary = summarize(metrics)
    per_object = {
        name: {"J-Mean": metrics["J"]["M_per_object"][name], "F-Mean": metrics["F"]["M_per_object"][name]}
        for name in metrics["J"]["M_per_object"]
    }
    return summary["J&F-Mean"], summary, per_object, time.time() - t0
