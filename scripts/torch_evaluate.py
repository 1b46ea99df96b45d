#!/usr/bin/env python3
"""DAVIS evaluation CLI of the PyTorch port — run the model over DAVIS-2016
val, write result PNGs and score J&F (the `helpers/davis_evaluate.py`
workload; the port's `scripts/evaluate.py`)."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slowfast_vos_tpu_torch import cli  # noqa: E402  (imports no torch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--davis-root", required=True)
    p.add_argument("--results-root", default="output/results")
    p.add_argument("--checkpoint", required=True, help="the port's checkpoint or a reference .pth")
    p.add_argument("--slow", type=int, default=3)
    p.add_argument("--fast", type=int, default=3)
    p.add_argument("--year", default="2016")
    p.add_argument("--subset", default="val")
    p.add_argument("--sequence", default=None, help="single sequence = semi-supervised task")
    p.add_argument("--original-hw", type=int, nargs=2, default=(480, 854))
    cli.add_arch_argument(p)
    cli.add_device_argument(p)
    args = p.parse_args(argv)
    # Multi-process launches (torchrun, SLURM) join the process group here;
    # a no-op in a single process (the reference's init_distributed_mode).
    cli.init_distributed(args.device)

    from slowfast_vos_tpu_torch.eval.glue import davis_evaluation

    pipe, model = cli.build(args.slow, args.fast, args.original_hw, device=args.device, **cli.arch_kwargs(args))
    report = cli.init_model(model, 0, args.checkpoint)

    jf, summary, per_object, wall = davis_evaluation(
        pipe,
        davis_root=args.davis_root,
        results_root=args.results_root,
        model_name=f"slowfast_{args.slow}-{args.fast}",
        sequences=args.sequence,
        subset=args.subset,
        year=args.year,
    )
    print("--------------------------- Global results ---------------------------")
    for k, v in summary.items():
        print(f"{k}: {v:.4f}")
    print("---------- Per sequence ----------")
    for name, vals in per_object.items():
        print(f"{name}: J={vals['J-Mean']:.4f} F={vals['F-Mean']:.4f}")
    print(f"Total time: {wall:.1f}s")
    return {"jf": jf, "summary": summary, "per_object": per_object, "wall": wall, "load": report}


if __name__ == "__main__":
    main()
