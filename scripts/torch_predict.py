#!/usr/bin/env python3
"""Prediction/visualization CLI of the PyTorch port — run the best model
over DAVIS val, dump per-frame IoU + overlay images (the `code/prediction.py`
workload; the port's `scripts/predict.py`)."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slowfast_vos_tpu_torch import cli  # noqa: E402  (imports no torch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--davis-root", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out-dir", default="output/predictions")
    p.add_argument("--slow", type=int, default=3)
    p.add_argument("--fast", type=int, default=3)
    p.add_argument("--year", default="2016")
    p.add_argument("--subset", default="val")
    p.add_argument("--save-all", action="store_true")
    p.add_argument("--original-hw", type=int, nargs=2, default=(480, 854))
    cli.add_device_argument(p)
    args = p.parse_args(argv)
    cli.require_single_process()

    from slowfast_vos_tpu_torch.eval.visualize import evaluate_with_visualization

    pipe, model = cli.build(args.slow, args.fast, args.original_hw, device=args.device)
    report = cli.init_model(model, 0, args.checkpoint)
    miou = evaluate_with_visualization(
        pipe, davis_root=args.davis_root, out_dir=args.out_dir,
        subset=args.subset, year=args.year, save_all_imgs=args.save_all,
    )
    print(f"mean IoU: {miou:.4f}; overlays in {args.out_dir}")
    return {"miou": miou, "load": report}


if __name__ == "__main__":
    main()
