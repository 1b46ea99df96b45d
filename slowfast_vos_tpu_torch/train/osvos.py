"""OSVOS-style semi-supervised workload: per-sequence online fine-tuning on
the first annotated frame, plus the sweep and aggregation drivers.

The port's copy of the serial path of `slowfast_vos_tpu/train/osvos.py`, a
rebuild of `code/osvos/{train_osvos,run_osvos_for_all_seq,
run_osvos_experiments,summarize_osvos_results}.py`:

* fine-tune from the best unsupervised weights on 200 augmented copies of
  frame 0 (`train_osvos.py:39-93`), grad-accum 2, SGD(cfg.lr, 0.9, 1e-4);
* freeze policies none / SF / BB_SF (`osvos_model.py:12-29`);
* per-epoch semi-supervised evaluation of the full sequence;
* sweep over freeze x scale x lr with JSON resume-by-skipping
  (`run_osvos_experiments.py:26-30`), full-val runs with incremental JSON
  (`run_osvos_for_all_seq.py:20-22`), per-epoch mean aggregation
  (`summarize_osvos_results.py:4-28`).

Every fine-tune starts from the weights it is given and trains
`pipe.model` in place.
"""
from __future__ import annotations

import dataclasses
import json
import os
from statistics import mean

from slowfast_vos_tpu_torch.data.davis import DavisIndex
from slowfast_vos_tpu_torch.data.osvos_dataset import OsvosFirstFrameDataset
from slowfast_vos_tpu_torch.eval.glue import davis_evaluation
from slowfast_vos_tpu_torch.models.pipeline import Pipeline
from slowfast_vos_tpu_torch.train.train_step import Trainer
from slowfast_vos_tpu_torch.utils.prefetch import prefetch


@dataclasses.dataclass
class ExperimentConfig:
    """Reference `osvos/experiment_config.py`."""

    freeze: str = "SF"  # 'none' | 'SF' | 'BB_SF'
    lr: float = 1e-3
    scale: float = 0.25
    epochs: int = 10

    def __str__(self):
        return f"Freeze: {self.freeze} Lr: {self.lr} Scale: {self.scale}"


def _freeze_flags(freeze: str) -> dict:
    return {
        "none": dict(train_backbone=True, train_slow_fast=True),
        "SF": dict(train_backbone=True, train_slow_fast=False),
        "BB_SF": dict(train_backbone=False, train_slow_fast=False),
    }[freeze]


def _snapshot(state_dict: dict) -> dict:
    """A copy of the starting weights that training in place cannot touch."""
    return {k: v.detach().clone() for k, v in state_dict.items()}


def _dump(path: str, results: dict) -> None:
    with open(path, "w") as f:
        json.dump({k: {str(e): v for e, v in r.items()} for k, r in results.items()}, f)


def train_osvos_sequence(
    pipe: Pipeline,
    state_dict: dict,
    *,
    davis_root: str,
    sequence_name: str,
    results_root: str,
    cfg: ExperimentConfig | None = None,
    items_per_epoch: int = 200,
    seed: int = 63,
    eval_year: str = "2016",
) -> dict:
    """Fine-tune on one sequence, starting from `state_dict` (copied into
    `pipe.model`, which then trains in place; pass weights the training
    cannot alias, not `pipe.model.state_dict()` itself). Returns {epoch:
    {jfmean, jmean, fmean, eval_time}} with epoch -1 being the pre-training
    sanity eval, mirroring `train_osvos.py:69-80`."""
    cfg = cfg or ExperimentConfig()
    pipe.model.load_state_dict(state_dict, strict=True)
    index = DavisIndex(davis_root, "val", year=eval_year, sequences=sequence_name)
    dataset = OsvosFirstFrameDataset(
        index.sequences[0],
        pipe.sf.fast,
        scale=cfg.scale,
        items_per_epoch=items_per_epoch,
        max_gt=pipe.cfg.max_gt,
        seed=seed,
    )
    trainer = Trainer(
        pipe, lr=cfg.lr, n_center=1, accumulate=2, seed=seed, **_freeze_flags(cfg.freeze)
    )
    model_name = f"osvos_{pipe.sf.slow}-{pipe.sf.fast}_{sequence_name}"

    def evaluate():
        jf, _summary, per_obj, wall = davis_evaluation(
            pipe,
            davis_root=davis_root,
            results_root=results_root,
            model_name=model_name,
            sequences=sequence_name,
            year=eval_year,
        )
        first = next(iter(per_obj.values()))
        return {
            "jfmean": jf,
            "jmean": first["J-Mean"],
            "fmean": first["F-Mean"],
            "eval_time": wall,
        }

    results = {-1: evaluate()}
    for epoch in range(cfg.epochs):
        # Augment item i+1 (cv2 warps on the host) while the device steps on
        # item i; one producer thread keeps the dataset's shared RNG draw
        # order, and so every augmented item, identical to the serial loop.
        with prefetch((dataset[i] for i in range(len(dataset))), depth=2) as items:
            for batch in items:
                trainer.step(batch)
        results[epoch] = evaluate()
    return results


def run_osvos_for_all_sequences(pipe, state_dict, *, davis_root, results_root, output_json, cfg=None, **kw):
    """Full-val OSVOS run, every sequence from the same `state_dict`, with
    an incremental JSON dump after each sequence (a crash loses at most one
    sequence, like the reference `run_osvos_for_all_seq.py:20-22`)."""
    start = _snapshot(state_dict)
    all_results = {}
    for info in DavisIndex(davis_root, "val", year="2016"):
        all_results[info.name] = train_osvos_sequence(
            pipe, start,
            davis_root=davis_root, sequence_name=info.name,
            results_root=results_root, cfg=cfg, **kw,
        )
        _dump(output_json, all_results)
    return all_results


def run_osvos_experiments(
    pipe, state_dict, *, davis_root, results_root, experiments_dir,
    freeze_options=("none", "SF", "BB_SF"), scales=(0.25, 0.4),
    lrs=(1e-3, 5e-4, 1e-4, 5e-3), sequences=("breakdance", "bmx-trees"),
    epochs=5, **kw,
):
    """Grid sweep with resume-by-skipping completed JSON configs."""
    os.makedirs(experiments_dir, exist_ok=True)
    start = _snapshot(state_dict)
    for freeze in freeze_options:
        for scale in scales:
            for lr in lrs:
                cfg = ExperimentConfig(freeze=freeze, lr=lr, scale=scale, epochs=epochs)
                name = (
                    f"osvos_sp_{pipe.sf.slow}fp_{pipe.sf.fast}"
                    f"_freeze_{freeze}_scale_{scale}_lr_{lr}"
                )
                out_json = os.path.join(experiments_dir, f"{name}.json")
                if os.path.exists(out_json):
                    continue
                results = {}
                for seq in sequences:
                    results[seq] = train_osvos_sequence(
                        pipe, start,
                        davis_root=davis_root, sequence_name=seq,
                        results_root=results_root, cfg=cfg, **kw,
                    )
                    _dump(out_json, results)


def summarize_osvos_results(json_path: str, epochs: int = 10):
    """Per-epoch mean over sequences (`summarize_osvos_results.py:4-28`)."""
    with open(json_path) as f:
        all_results = json.load(f)
    rows = []
    for epoch in range(epochs):
        key = str(epoch)
        vals = [r[key] for r in all_results.values() if key in r]
        if not vals:
            break
        rows.append(
            {
                "epoch": epoch,
                "jf": mean(v["jfmean"] for v in vals),
                "j": mean(v["jmean"] for v in vals),
                "f": mean(v["fmean"] for v in vals),
                "time": mean(v["eval_time"] for v in vals),
            }
        )
    return rows
