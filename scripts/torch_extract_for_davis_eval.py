#!/usr/bin/env python3
"""Headless mask extraction CLI of the PyTorch port — write the DAVIS
results PNG layout without scoring (the `code/extract_for_davis_eval.py`
workload; the port's `scripts/extract_for_davis_eval.py`)."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slowfast_vos_tpu_torch import cli  # noqa: E402  (imports no torch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--davis-root", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--slow", type=int, default=3)
    p.add_argument("--fast", type=int, default=3)
    p.add_argument("--year", default="2016")
    p.add_argument("--subset", default="val")
    p.add_argument("--original-hw", type=int, nargs=2, default=(480, 854))
    cli.add_device_argument(p)
    args = p.parse_args(argv)
    # Multi-process launches (torchrun, SLURM) join the process group here;
    # a no-op in a single process (the reference's init_distributed_mode).
    cli.init_distributed(args.device)

    from slowfast_vos_tpu_torch.eval.glue import extract_masks

    pipe, model = cli.build(args.slow, args.fast, args.original_hw, device=args.device)
    report = cli.init_model(model, 0, args.checkpoint)
    extract_masks(
        pipe, args.davis_root, args.out_dir,
        subset=args.subset, year=args.year, progress=lambda s: print(f"done {s}"),
    )
    return {"load": report}


if __name__ == "__main__":
    main()
