"""Device-level data-parallel inference: N sequence streams side by side.

The port's counterpart of `slowfast_vos_tpu/parallel/dp_infer.py:44`. The
reference shards evaluation only across processes (DistributedSampler,
`code/maskrcnn/train.py:73-74`); here one process maps its sequences onto
an explicit list of devices, one model replica and one sequence per member.
Each member runs exactly the serial `Pipeline.infer_sequence` chunk steps
on its own device, so its detections are bit-identical to the serial loop
on that device.

* Every member of a group runs the group's `ceil(max_t / SC)` chunk steps,
  as the JAX group does in lockstep: a shorter sequence pads with zero
  frames and feat_valid=False (the serial tail-padding semantics), and its
  excess outputs are dropped.
* Each member's F-1 backbone-feature carry stays on its device between
  steps.
* A trailing group smaller than the device list wrap-fills with repeats of
  its first sequence, whose duplicate outputs are dropped.

Each member runs on its own host thread (`mesh.on_members`), so members on
distinct GPUs overlap wherever a member's thread waits on its device (the
upload of each chunk's frames, the fetch of the results).
"""
from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from slowfast_vos_tpu_torch.models.pipeline import Pipeline, frame_detections
from slowfast_vos_tpu_torch.parallel.mesh import on_members


def resolve_device(device) -> torch.device:
    """`device` with its index made explicit ("cuda" -> the current GPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def replica(pipe: Pipeline, device: torch.device) -> Pipeline:
    """A `Pipeline` over a copy of `pipe.model` on `device`, with `pipe`'s
    geometry and superchunk; on a CUDA device it captures CUDA graphs of
    its own unless `pipe` runs eagerly on the card."""
    model = copy.deepcopy(pipe.model).to(device)
    eager = pipe.device.type == "cuda" and pipe.graphs is None  # `pipe` was asked to run eagerly on the card
    return Pipeline(model, pipe.transform, superchunk=pipe.superchunk, graphs=False if eager else None)


class DeviceParallelInference:
    """Runs `pipe.infer_sequence` semantics over groups of sequences, one
    sequence per member of `devices` (a list that may repeat a device).

    Members on `pipe`'s device run `pipe` itself; each other device gets one
    replica of `pipe.model` as it stands at construction (build a new
    instance after training the model further)."""

    def __init__(self, pipe: Pipeline, devices, *, instance_masks: bool = False):
        self.pipe = pipe
        self.devices = [resolve_device(d) for d in devices]
        self.n = len(self.devices)
        if self.n < 1:
            raise ValueError("DeviceParallelInference needs at least one device")
        self.instance_masks = instance_masks
        by_device = {pipe.device: pipe}
        for d in self.devices:
            if d not in by_device:
                by_device[d] = replica(pipe, d)
        self.members = [by_device[d] for d in self.devices]

    def infer_group(self, group: list[np.ndarray]) -> list[list[dict[str, Any]]]:
        """group: up to `n` sequences [T_i, H, W, 3] (uint8 or float32 in
        [0, 1]), all at the pipeline's original resolution. Returns
        per-sequence detection lists with exactly the serial
        `infer_sequence` contract."""
        if not 1 <= len(group) <= self.n:
            raise ValueError(f"a group holds 1 to {self.n} sequences, got {len(group)}")
        real = len(group)
        group = list(group) + [group[0]] * (self.n - real)  # wrap-fill the trailing group
        steps = range(0, max(g.shape[0] for g in group), self.pipe.superchunk)
        use_carry = self.pipe.sf.fast > 1

        def run(k):
            member, seq = self.members[k], group[k]
            carry, pending = None, []
            with torch.inference_mode():
                for c in steps:
                    outs, next_carry = member.chunk_step(seq, c, carry, self.instance_masks)
                    carry = next_carry if use_carry else None
                    pending.append(outs)
                if k >= real:
                    return None
                return frame_detections(pending, seq.shape[0], seq.shape[2], self.instance_masks)

        return on_members(run, self.devices)[:real]
