"""Shared pieces of the port's command-line entry points (`scripts/torch_*.py`).

A CLI parses its arguments before it imports torch or the rest of the port,
so `--help` stays fast and builds no kernel: this module imports neither at
its top. Every CLI builds its pipeline through `build` and starts its weights
through `init_model`.
"""
from __future__ import annotations


def add_device_argument(parser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the model runs: the card (bf16, the hand-written kernels; raises where CUDA is "
        "absent) or the CPU (float32, the kernels' plain versions)",
    )


def init_distributed(device: str) -> bool:
    """`parallel.distributed.init_distributed_mode` for a CLI that runs on
    `device`: a no-op returning False in a single process; under a
    multi-process launch (`torchrun`, SLURM) the process group, on `gloo`
    for a CPU run and on the default backend otherwise."""
    from slowfast_vos_tpu_torch.parallel.distributed import init_distributed_mode

    return init_distributed_mode(backend="gloo" if device == "cpu" else None)


def build(slow: int, fast: int, original_hw, *, device: str, dtype=None, use_slow_fast: bool = True):
    """(pipe, model) of `models.pipeline.build_pipeline` with torch's
    default init: bf16 on the card, float32 on the CPU, unless `dtype` is
    given."""
    import torch

    from slowfast_vos_tpu_torch.models.pipeline import build_pipeline

    if dtype is None:
        dtype = torch.bfloat16 if device == "cuda" else torch.float32
    return build_pipeline(
        slow, fast, tuple(original_hw), dtype=dtype, device=device, use_slow_fast=use_slow_fast
    )


def init_model(model, seed: int, checkpoint: str | None) -> dict | None:
    """Seeded random weights, then the checkpoint's tensors over them where
    one is given (`convert.load_init`, whose report is printed and
    returned)."""
    from slowfast_vos_tpu_torch.convert.from_torchvision import load_init
    from slowfast_vos_tpu_torch.models.pipeline import init_weights

    init_weights(model, seed)
    if checkpoint is None:
        return None
    report = load_init(checkpoint, model)
    print(
        f"converted {report['converted']} tensors from {checkpoint}; "
        f"{len(report['unused_source_keys'])} unused; {len(report['untouched'])} left at init"
        + "".join(f"; {key} remapped to the model's stem" for key in report["migrated"])
    )
    return report
