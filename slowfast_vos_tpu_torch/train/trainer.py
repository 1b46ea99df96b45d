"""Unsupervised VOS training driver.

The port of `slowfast_vos_tpu/train/trainer.py`, a rebuild of the
reference `code/train.py:49-121`: train on DAVIS-2017 train sequences,
SGD(1e-3, momentum 0.9, wd 1e-4) with effective 2-frame steps, a DAVIS-2016
val evaluation before training and after every epoch, best/last/resumable
checkpoints and scalar metrics logging; serially in one process, or data
parallel over the ranks of a process group (`parallel/sharded.py`).

The `Trainer` trains `pipe.model` in place and leaves it in eval mode, so
the evaluation runs the same `Pipeline`. The samplers' draws come from the
trainer's generator, seeded from `seed` at the start of every call (a
resumed run included), as the JAX driver rebuilds `PRNGKey(seed)`.
"""
from __future__ import annotations

import os

import numpy as np

from slowfast_vos_tpu_torch.data.davis import DavisIndex, load_sequence
from slowfast_vos_tpu_torch.data.windows import train_windows
from slowfast_vos_tpu_torch.eval.glue import davis_evaluation
from slowfast_vos_tpu_torch.models.pipeline import Pipeline, init_weights
from slowfast_vos_tpu_torch.parallel.distributed import (
    get_rank,
    get_world_size,
    is_main_process,
    local_batch_slice,
    save_on_master,
)
from slowfast_vos_tpu_torch.parallel.sharded import make_sharded_train_step, replicate_state
from slowfast_vos_tpu_torch.train.train_step import Trainer
from slowfast_vos_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from slowfast_vos_tpu_torch.utils.metrics import MetricsLogger
from slowfast_vos_tpu_torch.utils.prefetch import prefetch
from slowfast_vos_tpu_torch.utils.profiling import TRACER


def start_weights(model, state_dict: dict | None, seed: int) -> None:
    """Load `state_dict` into `model`, or, when it is None, seeded random
    weights (the JAX drivers' `init_variables(model, PRNGKey(seed))`)."""
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)


def finite_loss(metrics: dict) -> float:
    """The step's loss as a number; a non-finite loss aborts training, as
    the vendored engine does (`engine.py:48-51`). Tracer span
    `train.loss_fetch`: the wait for the step's device work."""
    with TRACER.span("train.loss_fetch"):
        loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"Loss is {loss}, stopping training")
    return loss


def wrap_filled_groups(windows, size: int):
    """Yield (group, n_real): consecutive groups of `size` windows, the last
    one wrap-filled with the first windows of the stream when it falls
    short (DistributedSampler's even padding); n_real counts the windows
    that are not fill."""
    group, fill = [], []
    for w in windows:
        group.append(w)
        if len(fill) < size - 1:
            fill.append(w)
        if len(group) == size:
            yield group, size
            group = []
    if group:
        n_real = len(group)
        yield group + [fill[i % len(fill)] for i in range(size - n_real)], n_real


def epoch_windows(index, *, max_gt: int, fast: int, n_center: int, group_size: int = 1, rank: int = 0,
                  limit: int | None = None):
    """One epoch's training windows over `index` in its order, at most
    `limit`. With a group of `group_size` ranks, a window that `rank` does
    not take from `wrap_filled_groups(..., group_size)` (its position in
    every group of `group_size`, and the first `group_size - 1` windows,
    which fill a short last group) is yielded as None and not decoded."""
    def ours(j):
        return group_size == 1 or j < group_size - 1 or j % group_size == rank

    count = 0
    for info in index:
        seq = load_sequence(info, max_gt=max_gt)
        first = count
        for batch in train_windows(seq, fast=fast, n_center=n_center, wanted=lambda k: ours(first + k)):
            yield batch
            count += 1
            if limit and count >= limit:
                return


def train_unsupervised(
    pipe: Pipeline,
    *,
    train_root: str,
    eval_root: str | None = None,
    output_dir: str = "output",
    epochs: int = 20,
    lr: float = 1e-3,
    seed: int = 63,
    train_year: str = "2017",
    eval_year: str = "2016",
    continue_training: bool = False,
    eval_every_epoch: bool = True,
    max_windows_per_epoch: int | None = None,
    state_dict: dict | None = None,
    tensorboard: bool = False,
    data_parallel: bool | None = None,
):
    """Train `pipe.model` in place. Returns (the `Trainer`, the history list
    of per-epoch dicts {epoch, loss, eval}).

    `data_parallel` (default: on when the process group has more than one
    rank) drives the data-parallel step (`parallel/sharded.py`): each
    optimizer step consumes one window per rank, with gradients, metrics
    and SlowFast's running statistics averaged, the production analogue of
    the reference's DDP wrap (`code/maskrcnn/train.py:102`). Every rank
    reads the epoch's windows in the same order and takes its own window of
    each group of world-size windows (`local_batch_slice`), and decodes only
    the windows it may take (`epoch_windows`). A trailing
    group smaller than the world is wrap-filled with windows from the start
    of the epoch, torch DistributedSampler's padding convention
    (`train.py:73-74`); the epoch loss sums each group's mean loss times
    its real windows. Only rank 0 writes checkpoints and logs; the
    evaluation is sharded over the ranks (`eval/glue.py`).

    `state_dict` holds the starting weights (None: seeded random weights).
    `continue_training` restores `<output_dir>/ckpt_last.pt` (weights,
    momentum buffers, meta) and resumes at its epoch + 1. `tensorboard=True`
    mirrors every scalar to TensorBoard event files like the reference's
    SummaryWriter (`code/train.py:82,103,109-111`)."""
    os.makedirs(output_dir, exist_ok=True)
    start_weights(pipe.model, state_dict, seed)
    trainer = Trainer(pipe, lr=lr, seed=seed)
    start_epoch = 0
    if data_parallel is None:
        data_parallel = get_world_size() > 1
    group_size = get_world_size() if data_parallel else 1

    last_path = os.path.join(output_dir, "ckpt_last.pt")
    best_path = os.path.join(output_dir, "ckpt_best.pt")
    if continue_training and os.path.exists(last_path):
        start_epoch = restore_checkpoint(last_path, trainer).get("epoch", 0) + 1
    if data_parallel:
        replicate_state(pipe.model)
    step = make_sharded_train_step(trainer) if data_parallel else trainer.step

    index = DavisIndex(train_root, "train", year=train_year)
    model_name = f"slowfast_{pipe.sf.slow}-{pipe.sf.fast}"

    def run_eval():
        if not eval_every_epoch or eval_root is None:
            return None
        jf, summary, _, wall = davis_evaluation(
            pipe,
            davis_root=eval_root,
            results_root=os.path.join(output_dir, "results"),
            model_name=model_name,
            year=eval_year,
        )
        return {"jf": jf, "wall": wall, **summary}


    history = []
    best_jf = -1.0
    with MetricsLogger(os.path.join(output_dir, "logs"), "train", tensorboard=tensorboard,
                       enabled=is_main_process()) as logger:
        # Sanity eval before training, as the reference does (train.py:95-96).
        pre = run_eval()
        if pre is not None:
            logger.scalar("eval/jf", pre["jf"], step=-1)

        global_step = 0
        for epoch in range(start_epoch, epochs):
            epoch_loss = 0.0
            # One optimizer step per group: a window per rank, or one window
            # when serial. The next windows are decoded and packed on a
            # background thread while the device steps; the order, and so
            # the trajectory, is unchanged.
            windows = epoch_windows(index, max_gt=pipe.cfg.max_gt, fast=pipe.sf.fast, n_center=trainer.n_center,
                                    group_size=group_size, rank=get_rank(), limit=max_windows_per_epoch)
            with prefetch(windows, depth=group_size + 1) as batches:
                for group, n_real in wrap_filled_groups(batches, group_size):
                    (batch,) = group[local_batch_slice(group_size)] if data_parallel else group
                    loss = finite_loss(step(batch))  # the mean over the group
                    epoch_loss += loss * n_real  # the sum over windows
                    logger.scalar("train/batch_loss", loss, global_step)
                    global_step += 1

            logger.scalar("train/epoch_loss", epoch_loss, epoch)
            ev = run_eval()
            history.append({"epoch": epoch, "loss": epoch_loss, "eval": ev})
            save_on_master(save_checkpoint, last_path, trainer, meta={"epoch": epoch})
            if ev is not None:
                logger.scalars({"jf": ev["jf"], "time": ev["wall"]}, epoch, prefix="eval/")
                if ev["jf"] > best_jf:
                    best_jf = ev["jf"]
                    save_on_master(save_checkpoint, best_path, trainer, meta={"epoch": epoch, "jf": ev["jf"]})
            else:
                save_on_master(save_checkpoint, best_path, trainer, meta={"epoch": epoch})
    return trainer, history
