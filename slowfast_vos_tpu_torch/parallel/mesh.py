"""Device lists: the port's meshes.

The JAX package lays its devices out as a `jax.sharding.Mesh` with a "data"
axis (`slowfast_vos_tpu/parallel/mesh.py:20`, `dp_infer.py:33`) and runs one
SPMD program over it. The port has two parallel layers instead:

* data-parallel training and process-sharded evaluation run over the ranks
  of a `torch.distributed` process group, one process per GPU
  (`parallel/distributed.py`, `parallel/sharded.py`);
* device-parallel inference and lockstep OSVOS run in one process over an
  explicit list of `torch.device`s, one model replica per member
  (`parallel/dp_infer.py`, `parallel/lockstep.py`), each member driven from
  its own host thread (`on_members`). That list is the port's mesh; it may
  repeat a device.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

from slowfast_vos_tpu_torch.parallel.distributed import get_world_size


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first `n_devices` visible CUDA devices (all of them by default).
    Raises when fewer are visible."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else n_devices
    if n > visible or n < 1:
        raise ValueError(f"make_mesh: {n} CUDA devices asked, {visible} visible")
    return [torch.device("cuda", i) for i in range(n)]


def infer_mesh(max_devices: int | None = None) -> list[torch.device] | None:
    """The visible CUDA devices for device-parallel inference, or None when
    fewer than two are visible (the serial path is then strictly better)."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if max_devices is None else min(visible, max_devices)
    if n <= 1:
        return None
    return make_mesh(n)


def parallel_devices(pipe, device_parallel: bool | None, devices=None):
    """The device list a process spreads its sequences over, or None for
    the serial loop. `device_parallel=False`: None. Otherwise `devices` where
    the caller names them, else every visible GPU where the pipeline runs
    on one and the process group has one rank (`infer_mesh`: None with
    fewer than two); None under a multi-process launch, where each process
    drives one GPU, and on the CPU."""
    if device_parallel is False:
        return None
    if devices is not None:
        return devices
    if pipe.device.type != "cuda" or get_world_size() > 1:
        return None
    return infer_mesh()


def on_members(fn, devices: list[torch.device]) -> list:
    """[fn(k) for each member k of `devices`], each call on its own host
    thread with its member's GPU as the thread's current device. The calls
    overlap wherever one waits on its device (a host synchronize releases
    the GIL), so members on distinct GPUs run side by side; members that
    share a device queue on its stream. Raises the first member's error."""

    def run(k):
        device = devices[k]
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            return fn(k)

    if len(devices) == 1:
        return [run(0)]
    with ThreadPoolExecutor(len(devices), thread_name_prefix="member") as pool:
        return list(pool.map(run, range(len(devices))))
