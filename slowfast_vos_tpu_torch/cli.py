"""Shared pieces of the port's command-line entry points (`scripts/torch_*.py`).

A CLI parses its arguments before it imports torch or the rest of the port,
so `--help` stays fast and builds no kernel: this module imports neither at
its top. Every CLI builds its pipeline through `build` and starts its weights
through `init_model`.
"""
from __future__ import annotations

import os


def add_device_argument(parser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the model runs: the card (bf16, the hand-written kernels; raises where CUDA is "
        "absent) or the CPU (float32, the kernels' plain versions)",
    )


def require_single_process() -> None:
    """Raise under a multi-process launch: the port runs serially until its
    parallel layer lands (ROADMAP.md, queue 1), and every process would
    otherwise do the same work."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        if int(os.environ.get(var, "1")) > 1:
            raise RuntimeError(
                f"{var}={os.environ[var]}: the PyTorch port has no parallel layer yet "
                "(ROADMAP.md, queue 1); run one process"
            )


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
    )
    return report
