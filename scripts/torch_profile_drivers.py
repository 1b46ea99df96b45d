#!/usr/bin/env python3
"""Where the time of one OSVOS sequence goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_drivers.py [--frames 48] [--items 20]

Writes a synthetic 2016 val tree (two sequences of `--frames` frames at
DAVIS 480x854, one object) into a temporary directory under `build/`,
builds the full-width pipeline (SlowFast 3-3, bf16, default
DetectionConfig, seeded random weights) and runs `train_osvos_sequence`
on each sequence in turn, as `run_osvos_for_all_sequences` does, under the
default freeze SF for one epoch of `--items` items (items / 2 updates)
with its two evaluations. The first sequence pays the process's one-time
costs (the optimizer's first construction imports `torch._dynamo`, cuDNN
picks its algorithms); the second is a sequence of a full-val run. Each
part is timed on the host clock:

  steps      `Trainer.step` (loss, backward, optimizer), synchronized
  inference  `Pipeline.infer_sequence` (ends in a fetch), synchronized
  png        writing the results tree
  scoring    `DavisScorer.evaluate`
  decode     `decode_sequence` in the evaluation's prefetch thread (overlapped)
  augment    the OSVOS items in the training's prefetch thread (overlapped)
  evaluation `davis_evaluation` as a whole, to split the rest of the time

Then one train step under `torch.profiler` for the device's busy share.
Prints each part's share of each sequence's wall time, the second
sequence's shares extrapolated to the reference's schedule (200 items x 10
epochs, 11 evaluations), the card's name and power limit, and one JSON
line. Needs CUDA.
"""
import argparse
import collections
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_profile_pipeline import device_profile  # noqa: E402

from slowfast_vos_tpu_torch.data import osvos_dataset  # noqa: E402
from slowfast_vos_tpu_torch.data.synthetic import make_synthetic_davis  # noqa: E402
from slowfast_vos_tpu_torch.eval import glue, scorer  # noqa: E402
from slowfast_vos_tpu_torch.models import pipeline as pipeline_mod  # noqa: E402
from slowfast_vos_tpu_torch.ops.cuda_build import BUILD_DIR  # noqa: E402
from slowfast_vos_tpu_torch.train import osvos  # noqa: E402
from slowfast_vos_tpu_torch.train.train_step import Trainer  # noqa: E402

REFERENCE_ITEMS, REFERENCE_EPOCHS = 200, 10  # train_osvos.py:39-93
MAIN_PARTS = ("steps", "inference", "png", "scoring")


def patch(owner, name, part, calls, sync):
    """Time every call of `owner.name` into calls[part]; returns the undo."""
    fn = getattr(owner, name)

    def wrapper(*args, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        calls[part].append(time.perf_counter() - t0)
        return out

    setattr(owner, name, wrapper)
    return lambda: setattr(owner, name, fn)


def profile_sequence(pipe, start, root, name, items) -> dict:
    """One `train_osvos_sequence` with every part timed."""
    calls = collections.defaultdict(list)
    undo = [
        patch(Trainer, "step", "steps", calls, sync=True),
        patch(pipeline_mod.Pipeline, "infer_sequence", "inference", calls, sync=True),
        patch(glue, "_write_sequence_masks", "png", calls, sync=False),
        patch(scorer.DavisScorer, "evaluate", "scoring", calls, sync=False),
        patch(glue, "decode_sequence", "decode", calls, sync=False),
        patch(osvos_dataset.OsvosFirstFrameDataset, "__getitem__", "augment", calls, sync=False),
        patch(osvos, "davis_evaluation", "evaluation", calls, sync=True),
    ]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = osvos.train_osvos_sequence(
            pipe, start, davis_root=root, sequence_name=name, results_root=str(pathlib.Path(root) / "res"),
            cfg=osvos.ExperimentConfig(freeze="SF", epochs=1), items_per_epoch=items,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for u in undo:
            u()
    parts = {k: {"calls": len(v), "total_s": sum(v), "median_ms": statistics.median(v) * 1e3} for k, v in calls.items()}
    shares = {k: parts[k]["total_s"] / wall for k in MAIN_PARTS}
    shares["other"] = 1.0 - sum(shares.values())
    return {"sequence": name, "wall_s": wall, "parts": parts, "shares": shares,
            "jf": [results[-1]["jfmean"], results[0]["jfmean"]]}


def report(run: dict, frames: int, items: int) -> None:
    parts, shares = run["parts"], run["shares"]
    print(f"OSVOS sequence {run['sequence']} of {frames} frames at 480x854, SF, {items} items ({items // 2} updates), "
          f"2 evaluations: {run['wall_s']:.3f} s wall; J&F {run['jf'][0]:.4f} -> {run['jf'][1]:.4f}")
    for k in (*MAIN_PARTS, "decode", "augment"):
        p = parts[k]
        note = f", {shares[k]:.1%} of the wall time" if k in MAIN_PARTS else " (prefetch thread, overlapped)"
        print(f"  {k:9s} {p['calls']:4d} calls, {p['total_s']:.3f} s, median {p['median_ms']:.1f} ms{note}")
    evaluation = parts["evaluation"]["total_s"]
    in_eval = evaluation - sum(parts[k]["total_s"] for k in ("inference", "png", "scoring"))
    outside = run["wall_s"] - evaluation - parts["steps"]["total_s"]
    print(f"  other     {shares['other'] * run['wall_s']:.3f} s ({shares['other']:.1%}): {in_eval:.3f} s inside the "
          f"evaluations (waiting on the decode, results-tree set-up), {outside:.3f} s outside them and the steps "
          f"(weights load, dataset and trainer set-up, waiting on the augmented items)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--items", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_drivers: CUDA is not available; this script measures on an NVIDIA GPU", file=sys.stderr)
        return 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pipe, model = pipeline_mod.build_pipeline(3, 3, (480, 854), dtype=torch.bfloat16, device="cuda", superchunk=8)
    pipeline_mod.init_weights(model, seed=0)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory(prefix="profile_drivers_", dir=BUILD_DIR) as tmp:
        root = str(pathlib.Path(tmp) / "davis16")
        make_synthetic_davis(root, num_sequences=2, frames=args.frames, hw=(480, 854), num_objects=1,
                             year="2016", subset="val", seed=7)
        runs = [profile_sequence(pipe, start, root, name, args.items) for name in ("synth00", "synth01")]
        item = osvos_dataset.OsvosFirstFrameDataset(
            glue.DavisIndex(root, "val", year="2016").sequences[0], 3, items_per_epoch=1)[0]
        trainer = Trainer(pipe, n_center=1, accumulate=2, train_backbone=True, train_slow_fast=False)
        trainer.step(item)
        profile = device_profile(lambda: trainer.step(item), top=10)

    for run in runs:
        report(run, args.frames, args.items)
    warm = runs[1]["parts"]
    evals = warm["inference"]["calls"]
    ref = {"steps": REFERENCE_ITEMS * REFERENCE_EPOCHS * warm["steps"]["median_ms"] / 1e3}
    ref.update({k: (REFERENCE_EPOCHS + 1) * warm[k]["total_s"] / evals for k in ("inference", "png", "scoring")})
    ref_total = sum(ref.values())
    print(f"reference schedule ({REFERENCE_ITEMS} items x {REFERENCE_EPOCHS} epochs, {REFERENCE_EPOCHS + 1} evaluations), "
          f"from the second sequence: {ref_total:.1f} s; " + ", ".join(f"{k} {v / ref_total:.1%}" for k, v in ref.items()))
    print(f"one SF train step under torch.profiler: device busy share {profile.get('busy_share')}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card, "frames": args.frames, "items": args.items,
                      "runs": runs, "reference_extrapolation_s": ref, "step_profile": profile}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
