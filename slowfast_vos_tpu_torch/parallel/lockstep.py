"""Lockstep ensemble training: N independent fine-tunes, one per member.

The port's counterpart of `slowfast_vos_tpu/parallel/lockstep.py`. The OSVOS
workload (`code/osvos/run_osvos_for_all_seq.py:10-44`) is 20 independent
per-sequence fine-tunes, which the reference runs one after another on one
GPU. Here each member of a device list holds its own model replica and its
own unmodified single-sequence `Trainer`, and every call advances all
members by one step, each on its own host thread (`mesh.on_members`). There
is no gradient averaging (unlike `parallel/sharded.py`, these are separate
optimization problems), so a member's trajectory is that of its serial
fine-tune on the same device, whatever the other members run.

Every member's `Trainer` is seeded alike, so all members draw the same
sampler numbers at each step, as the JAX lockstep step hands one key to
every member (and the serial driver seeds every sequence's fine-tune
alike, `train/osvos.py`). The JAX helpers that stack state and batches on
a leading device axis (`stack_replicate`, `stack_batches`,
`unstack_member`) become a list of replicas, a list of batches and a
member's `model.state_dict()`.
"""
from __future__ import annotations

import torch

from slowfast_vos_tpu_torch.models.pipeline import Pipeline
from slowfast_vos_tpu_torch.parallel.dp_infer import replica, resolve_device
from slowfast_vos_tpu_torch.parallel.mesh import on_members
from slowfast_vos_tpu_torch.train.train_step import Trainer


def member_pipelines(pipe: Pipeline, devices, state_dict: dict) -> list[Pipeline]:
    """One `Pipeline` per member of `devices`, each over its own replica of
    `pipe.model` on its device, loaded with `state_dict`: the starting
    state of N identical fine-tunes that then diverge."""
    members = [replica(pipe, resolve_device(d)) for d in devices]
    for m in members:
        m.model.load_state_dict(state_dict, strict=True)
    return members


def make_lockstep_train_step(trainers: list[Trainer]):
    """step(batches, draws=None) -> [metrics per member]: member k's
    `Trainer.step` on `batches[k]` (with `draws[k]` where given), every
    member on its own thread."""
    devices = [tr.pipe.device for tr in trainers]

    def step(batches: list[dict], draws: list[dict] | None = None) -> list[dict[str, torch.Tensor]]:
        if len(batches) != len(trainers):
            raise ValueError(f"{len(trainers)} members, {len(batches)} batches")
        draws = draws or [None] * len(trainers)
        return on_members(lambda k: trainers[k].step(batches[k], draws[k]), devices)

    return step
