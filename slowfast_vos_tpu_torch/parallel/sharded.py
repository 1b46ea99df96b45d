"""Data-parallel training step over the ranks of a `torch.distributed` group.

The port's counterpart of `slowfast_vos_tpu/parallel/sharded.py:65`
(`make_sharded_train_step`), which replaces the reference's DDP gradient sync
(`code/maskrcnn/train.py:102`, `utils.py:122-146`). Each rank consumes one
training window with its own sampler draws, and after the backward

* the gradients are averaged over the ranks (one `all_reduce` of all of them
  together), so the update is the optimizer applied to the mean of the
  per-window gradients, as DDP's and the JAX step's;
* the metrics are averaged;
* SlowFast's running BatchNorm statistics are averaged. As in the JAX step
  (`sharded.py:70-78`), each rank's forward normalizes with its own window's
  batch statistics (`models/slowfast.py::batch_norm_train`; no
  `nn.SyncBatchNorm`), and only the updated running buffers are averaged.
  Every rank starts from the same buffers, so the mean of the per-rank
  updates `m * old + (1 - m) * batch_r` is the JAX package's pmean-ed
  `new_bn`.

On the card the step's two halves are CUDA graph replays
(`train/graphs.py`), and the all-reduce of the gradients runs between them:
the gradients lie at fixed addresses, which the update graph reads.

The reductions sum and then divide on every rank alike, so after a step
every rank holds bit-identical parameters. A process without a process
group trains serially: the step is then `Trainer.step` (a group of one
still runs the collectives, which then change nothing).

The JAX helpers that place a global batch on a mesh (`stack_windows`,
`shard_windows`) have no counterpart: each rank reads its own window.
`replicate_state` broadcasts rank 0's weights, as DDP does when it wraps a
model.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from slowfast_vos_tpu_torch.parallel.distributed import get_rank, get_world_size
from slowfast_vos_tpu_torch.train.train_step import Trainer


def fold_in(seed: int, rank: int) -> int:
    """A seed for `rank`'s sampler draws, derived from `seed` (the role of
    JAX's `fold_in(key, axis_index)`, `sharded.py:72`). Rank 0 keeps `seed`,
    so a group of one draws as the serial trainer does."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, dtype=np.uint64)[0] >> 1)


def _all_mean_(tensors: list[torch.Tensor]) -> None:
    """Average `tensors` (one dtype and device) over the ranks in place,
    with one all_reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= get_world_size()
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def running_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    """SlowFast's train-mode BatchNorm running statistics."""
    return [b for name, b in model.named_buffers()
            if name.startswith("slow_fast.") and name.endswith(("running_mean", "running_var"))]


def replicate_state(model: torch.nn.Module) -> None:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (the JAX `replicate_state`; what DDP does when it wraps a model).
    Single-process: no-op."""
    if get_world_size() == 1:
        return
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src=0)


def make_sharded_train_step(trainer: Trainer):
    """Returns step(batch, draws=None) -> metrics, the data-parallel
    `Trainer.step`: `batch` is this rank's window, `draws` its sampler draws
    (default: from the trainer's generator, which this call reseeds with the
    rank folded into its seed, so each rank draws its own). The returned
    metrics are the means over the ranks, identical on every rank. The
    trainer's `accumulate` holds: the optimizer steps every k-th call on the
    mean of the ranks' accumulated gradients."""
    trainer.generator.manual_seed(fold_in(trainer.generator.initial_seed(), get_rank()))
    params = list(trainer.params.values())
    buffers = running_buffers(trainer.model)

    def step(batch: dict, draws: dict | None = None) -> dict[str, torch.Tensor]:
        if not dist.is_initialized():
            return trainer.step(batch, draws)
        metrics = trainer.accumulate_gradient(batch, draws)
        names = sorted(metrics)
        values = torch.stack([metrics[k].to(torch.float32) for k in names])
        with torch.no_grad():
            _all_mean_([values, *buffers])
        if trainer.calls % trainer.accumulate == 0:
            with torch.no_grad():
                _all_mean_([p.grad for p in params if p.grad is not None])
            trainer.apply_update()
        return dict(zip(names, values.unbind()))

    return step
