"""OSVOS-style semi-supervised workload: per-sequence online fine-tuning on
the first annotated frame, plus the sweep and aggregation drivers.

The port of `slowfast_vos_tpu/train/osvos.py`, a rebuild of
`code/osvos/{train_osvos,run_osvos_for_all_seq,
run_osvos_experiments,summarize_osvos_results}.py`:

* fine-tune from the best unsupervised weights on 200 augmented copies of
  frame 0 (`train_osvos.py:39-93`), grad-accum 2, SGD(cfg.lr, 0.9, 1e-4);
* freeze policies none / SF / BB_SF (`osvos_model.py:12-29`);
* per-epoch semi-supervised evaluation of the full sequence;
* sweep over freeze x scale x lr with JSON resume-by-skipping
  (`run_osvos_experiments.py:26-30`), full-val runs with incremental JSON
  (`run_osvos_for_all_seq.py:20-22`), per-epoch mean aggregation
  (`summarize_osvos_results.py:4-28`);
* the full-val run split over processes, and within a process over a
  device list in lockstep groups (`parallel/lockstep.py`).

Every serial fine-tune starts from the weights it is given and trains
`pipe.model` in place; a lockstep member trains its own replica.
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
from slowfast_vos_tpu_torch.parallel.distributed import all_gather_host, get_rank, get_world_size, save_on_master
from slowfast_vos_tpu_torch.parallel.lockstep import make_lockstep_train_step, member_pipelines
from slowfast_vos_tpu_torch.parallel.mesh import on_members, parallel_devices
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


def _evaluate_sequence(pipe: Pipeline, *, davis_root: str, sequence_name: str, results_root: str, year: str) -> dict:
    """One epoch's semi-supervised evaluation of a fine-tune: `pipe.model`
    on its sequence through `davis_evaluation`, whose scoring always uses
    the unsupervised evaluator, like the reference (`davis_evaluate.py:49`).
    Returns {jfmean, jmean, fmean, eval_time}, the J and F means of the
    sequence's first object (`train_osvos.py:69-80`)."""
    # shard_by_process=False: this process owns the sequence
    # (run_osvos_for_all_sequences makes the process split).
    jf, _summary, per_obj, wall = davis_evaluation(
        pipe,
        davis_root=davis_root,
        results_root=results_root,
        model_name=f"osvos_{pipe.sf.slow}-{pipe.sf.fast}_{sequence_name}",
        sequences=sequence_name,
        year=year,
        shard_by_process=False,
    )
    first = next(iter(per_obj.values()))
    return {"jfmean": jf, "jmean": first["J-Mean"], "fmean": first["F-Mean"], "eval_time": wall}


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

    def evaluate():
        return _evaluate_sequence(
            pipe, davis_root=davis_root, sequence_name=sequence_name, results_root=results_root, year=eval_year,
        )

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


def train_osvos_sequences_lockstep(
    pipe: Pipeline,
    state_dict: dict,
    *,
    davis_root: str,
    sequence_names: list[str],
    results_root: str,
    cfg: ExperimentConfig | None = None,
    items_per_epoch: int = 200,
    seed: int = 63,
    eval_year: str = "2016",
    devices=None,
) -> dict:
    """Device-parallel OSVOS: up to len(devices) per-sequence fine-tunes
    advance in lockstep, one per member (`parallel/lockstep.py`; default
    devices: every visible GPU). The reference runs them serially on one GPU
    (`run_osvos_for_all_seq.py`).

    Per-member semantics are the serial `train_osvos_sequence`'s: the same
    seed-63 per-sequence augmentation stream, the same sampler seed, the
    same per-epoch semi-supervised evaluation and scoring
    (`_evaluate_sequence` on the member's replica, on its own thread). A
    member's results are exactly those of its serial run on the same device
    and do not depend on the other members: no collective crosses members. A
    trailing group smaller than the device list wrap-fills with duplicates
    of member 0, whose outputs are dropped. `pipe.model` is left as it was.

    Returns {sequence_name: {epoch: {jfmean, jmean, fmean, eval_time}}}."""
    cfg = cfg or ExperimentConfig()
    devices = parallel_devices(pipe, None, devices)
    if devices is None:
        raise ValueError("lockstep OSVOS needs a device list (one visible GPU: use train_osvos_sequence)")
    n = len(devices)
    real = list(sequence_names)
    if not 1 <= len(real) <= n:
        raise ValueError(f"a lockstep group holds 1 to {n} sequences, got {len(real)}")
    names = real + [real[0]] * (n - len(real))

    infos = {name: DavisIndex(davis_root, "val", year=eval_year, sequences=name).sequences[0] for name in set(names)}
    datasets = [
        OsvosFirstFrameDataset(
            infos[name], pipe.sf.fast, scale=cfg.scale,
            items_per_epoch=items_per_epoch, max_gt=pipe.cfg.max_gt, seed=seed,
        )
        for name in names
    ]
    members = member_pipelines(pipe, devices, state_dict)
    trainers = [
        Trainer(m, lr=cfg.lr, n_center=1, accumulate=2, seed=seed, **_freeze_flags(cfg.freeze)) for m in members
    ]
    step = make_lockstep_train_step(trainers)

    def evaluate():
        # Each real member evaluates its own weights on its own sequence, on
        # its own thread; the wrap-filled members' results would be dropped.
        return on_members(lambda k: _evaluate_sequence(
            members[k], davis_root=davis_root, sequence_name=real[k], results_root=results_root, year=eval_year,
        ), devices[: len(real)])

    results = {name: {} for name in real}
    for name, r in zip(real, evaluate()):
        results[name][-1] = r
    for epoch in range(cfg.epochs):
        # Augment item i+1 for all members (host cv2 work) while the devices
        # step on item i; the single producer keeps each dataset's RNG draw
        # order, so every member's stream matches its serial run.
        with prefetch(([ds[i] for ds in datasets] for i in range(items_per_epoch)), depth=2) as items:
            for batches in items:
                step(batches)
        for name, r in zip(real, evaluate()):
            results[name][epoch] = r
    return results


def run_osvos_for_all_sequences(
    pipe, state_dict, *, davis_root, results_root, output_json, cfg=None,
    shard_by_process: bool = True, device_parallel: bool | None = None, devices=None, **kw,
):
    """Full-val OSVOS run, every sequence from the same `state_dict`, with
    an incremental JSON dump after each sequence (a crash loses at most one
    sequence, like the reference `run_osvos_for_all_seq.py:20-22`).

    The per-sequence fine-tunes are independent, so a multi-process launch
    splits them round-robin by rank (`shard_by_process`). Each process dumps
    its shard incrementally to `<output_json>.rank<r>`; at the end the
    shards are gathered, every process returns the full merged results in
    the global sequence order, and rank 0 writes the merged `output_json`.

    Within one process, `device_parallel` additionally runs this process's
    sequences in lockstep groups of len(devices), one independent
    fine-tune per member (`train_osvos_sequences_lockstep`; a crash then
    loses at most one group). Default (None): on where a single process
    sees more than one GPU (`parallel/mesh.py::parallel_devices`), where it
    beat the serial loop on four H100s (`scripts/torch_parallel_scaling.py`,
    PERF.md); False runs the reference's serial loop
    (`scripts/torch_train_osvos.py --parity-exact`)."""
    start = _snapshot(state_dict)
    infos = list(DavisIndex(davis_root, "val", year="2016"))
    world = get_world_size() if shard_by_process else 1
    my_infos = infos[get_rank() :: world]
    my_json = f"{output_json}.rank{get_rank()}" if world > 1 else output_json
    devices = parallel_devices(pipe, device_parallel, devices)

    all_results = {}
    if devices is not None:
        n = len(devices)
        for s in range(0, len(my_infos), n):
            all_results.update(train_osvos_sequences_lockstep(
                pipe, start,
                davis_root=davis_root, sequence_names=[i.name for i in my_infos[s : s + n]],
                results_root=results_root, cfg=cfg, devices=devices, **kw,
            ))
            _dump(my_json, all_results)
    else:
        for info in my_infos:
            all_results[info.name] = train_osvos_sequence(
                pipe, start,
                davis_root=davis_root, sequence_name=info.name,
                results_root=results_root, cfg=cfg, **kw,
            )
            _dump(my_json, all_results)

    if world > 1:
        all_results = _merge_osvos_results(all_results, [i.name for i in infos])
        save_on_master(_dump, output_json, all_results)
    return all_results


def _merge_osvos_results(local: dict, all_names: list[str]) -> dict:
    """Gather every process's per-sequence OSVOS results over the host
    group and rebuild the full dict in global sequence order; a sequence
    that two processes hold keeps the lowest rank's results. Values travel
    pickled, so they arrive bit for bit."""
    merged = {}
    for shard in all_gather_host(local):
        for name, res in shard.items():
            merged.setdefault(name, res)
    return {name: merged[name] for name in all_names if name in merged}


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
