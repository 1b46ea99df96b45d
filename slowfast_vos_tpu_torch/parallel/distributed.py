"""Multi-process initialization and process utilities over `torch.distributed`.

The port's counterpart of `slowfast_vos_tpu/parallel/distributed.py`, itself
the replacement for the reference's `init_distributed_mode`
(`code/maskrcnn/utils.py:305-327`): discover RANK / WORLD_SIZE (or
SLURM_PROCID) from the environment, initialize a process group, pin a GPU,
and gate printing to the master rank. One process drives one GPU, the
PyTorch idiom (`torchrun --nproc_per_node N`, or one SLURM task per GPU);
the JAX package runs one controller per host over a global device mesh
instead.

Environment contracts honored (first match wins), in the reference's
env/SLURM fallthrough order:

* torch-style (what `utils.py:307-312` reads): ``RANK`` + ``WORLD_SIZE``
  [+ ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``], as `torchrun` sets;
* SLURM (`utils.py:313-315`): ``SLURM_PROCID`` + ``SLURM_NTASKS``
  [+ ``SLURM_LOCALID``], the first host of ``SLURM_STEP_NODELIST`` (or
  ``SLURM_NODELIST``) as the rendezvous address.

The JAX package's ``JAX_*`` variables and its TPU-pod autodetection have no
counterpart here. If nothing matches, this is single-process mode and
`init_distributed_mode` returns False, the reference's "Not using
distributed mode" branch (`utils.py:313-316`).

Two groups: the device group (the default group: `nccl` where CUDA is
present, `gloo` otherwise) carries gradients and running statistics; a
`gloo` group carries every host-side collective (barriers, the merges of
evaluation and OSVOS results), as the JAX package moves those payloads as
host numpy. Both have a 1800 s timeout.
"""
from __future__ import annotations

import builtins
import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=1800)

# The gloo group of host-side collectives, made by `init_distributed_mode`
# (the default group itself when that is gloo).
_host_group = None


def distributed_env() -> dict | None:
    """Discover multi-process launch parameters from the environment.

    Returns {init_method, world_size, rank, local_rank}, or None when the
    environment describes a single-process run."""
    env = os.environ
    port = env.get("MASTER_PORT", "29500")
    if "RANK" in env and "WORLD_SIZE" in env:  # utils.py:307-312
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        rank = int(env["RANK"])
        return {
            "init_method": f"tcp://{addr}:{port}",
            "world_size": int(env["WORLD_SIZE"]),
            "rank": rank,
            "local_rank": int(env.get("LOCAL_RANK", rank)),
        }
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:  # utils.py:313-315
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        first = _first_slurm_host(nodelist) or "127.0.0.1"
        rank = int(env["SLURM_PROCID"])
        return {
            "init_method": f"tcp://{first}:{port}",
            "world_size": int(env["SLURM_NTASKS"]),
            "rank": rank,
            "local_rank": int(env.get("SLURM_LOCALID", rank)),
        }
    return None


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist: 'node[3-7,9],gpu2' -> 'node3'.

    Minimal expansion (stem + first range start, zero-padding preserved),
    enough to name the rendezvous host without shelling out to scontrol."""
    head = nodelist.split(",")[0]
    if "[" not in head:
        return head
    stem, rng = head.split("[", 1)
    first = rng.rstrip("]").split(",")[0].split("-")[0]
    return stem + first


def init_distributed_mode(*, backend: str | None = None, verbose: bool = True) -> bool:
    """Initialize the process group if the environment asks for it.

    Safe to call unconditionally from every CLI (idempotent). Returns True
    when running multi-process. Single-process: prints "Not using
    distributed mode" and returns False (`utils.py:313-316`). The backend
    is `nccl` where CUDA is available and `gloo` otherwise; an explicit
    `backend` wins (`gloo` for a CPU run on a machine with GPUs). Where CUDA
    is available the process takes GPU `local_rank % device_count` as its
    current device."""
    global _host_group
    kwargs = distributed_env()
    if kwargs is None:
        if verbose:
            print("Not using distributed mode")
        return False
    if not dist.is_initialized():
        local_rank = kwargs.pop("local_rank")
        if torch.cuda.is_available():
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        dist.init_process_group(backend=backend, timeout=TIMEOUT, **kwargs)
        _host_group = None if backend == "gloo" else dist.new_group(backend="gloo", timeout=TIMEOUT)
    if verbose and is_main_process():
        print(f"Initialized torch.distributed ({dist.get_backend()}): {get_world_size()} processes")
    setup_printing(is_main_process())
    return True


def host_barrier(name: str, timeout_s: int = 1800) -> None:
    """Block until every process reaches this barrier.

    A gloo `monitored_barrier` with a real `timeout_s`: processes reach a
    barrier skewed by whole sequences of work (one process drew one more
    evaluation sequence than another), so the wait must outlast such skew,
    which a short rendezvous timeout would not (the JAX package's barrier
    avoids its 30 s Gloo rendezvous for this reason). A rank that does not
    arrive in time is named in the error. Single-process: no-op. Every
    process must run the same sequence of barriers (`name` documents the
    call site)."""
    if get_world_size() == 1:
        return
    del name
    dist.monitored_barrier(group=_host_group, timeout=datetime.timedelta(seconds=timeout_s))


def all_gather_host(obj) -> list:
    """Every process's `obj` (a picklable host object), in rank order, over
    the gloo group; `[obj]` in a single process. Pickling moves float64
    values bit for bit."""
    if get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj, group=_host_group)
    return out


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs):
    """Run a checkpoint/artifact write only on process 0 (the reference's
    `save_on_master`, `utils.py:300-302`). Returns the fn result on master,
    None elsewhere."""
    if is_main_process():
        return save_fn(*args, **kwargs)
    return None


def setup_printing(is_master: bool) -> None:
    """Silence `print` on non-master processes unless forced, the
    reference's `setup_for_distributed` (`utils.py:261-274`)."""
    builtin_print = getattr(builtins, "_slowfast_vos_print", builtins.print)
    builtins._slowfast_vos_print = builtin_print

    def gated_print(*args, force: bool = False, **kwargs):
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = gated_print


def local_batch_slice(global_size: int) -> slice:
    """The contiguous slice of a globally-ordered batch this process feeds
    (replaces DistributedSampler, `code/maskrcnn/train.py:73-74`); sizes
    must divide evenly (pad upstream)."""
    w, r = get_world_size(), get_rank()
    if global_size % w:
        raise ValueError(f"global batch {global_size} does not split over {w} processes")
    per = global_size // w
    return slice(r * per, (r + 1) * per)
