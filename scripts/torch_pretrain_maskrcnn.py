#!/usr/bin/env python3
"""Mask R-CNN DAVIS fine-tune CLI of the PyTorch port — produces the
`maskrcnn_model` checkpoint the SlowFast stage starts from; also dumps RPN
proposals (the `code/maskrcnn/maskrcnn_src.py` workload; --predict-boxes =
its `train=False` mode; the port's `scripts/pretrain_maskrcnn.py`)."""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slowfast_vos_tpu_torch import cli  # noqa: E402  (imports no torch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--davis-root", required=True)
    p.add_argument("--output", default="output/maskrcnn")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--year", default="2017")
    p.add_argument("--init-checkpoint", default=None,
                   help="a reference .pth (e.g. COCO weights) or the port's checkpoint")
    p.add_argument("--predict-boxes", action="store_true",
                   help="skip training; dump RPN proposals for --subset")
    p.add_argument("--subset", default="train")
    p.add_argument("--original-hw", type=int, nargs=2, default=(480, 854))
    cli.add_device_argument(p)
    args = p.parse_args(argv)
    cli.require_single_process()

    from slowfast_vos_tpu_torch.train.pretrain import extract_rpn_proposals, train_maskrcnn

    # The single-frame Mask R-CNN of `train.pretrain.build_maskrcnn_pipeline`.
    pipe, model = cli.build(1, 1, args.original_hw, device=args.device, use_slow_fast=False)
    report = cli.init_model(model, 63, args.init_checkpoint)

    if args.predict_boxes:
        os.makedirs(args.output, exist_ok=True)
        out = extract_rpn_proposals(
            pipe, davis_root=args.davis_root,
            output_path=f"{args.output}/predicted_proposals_{args.subset}_{args.year}.npz",
            subset=args.subset, year=args.year,
        )
        print(f"wrote {out}")
        return {"proposals": out, "load": report}

    _trainer, history = train_maskrcnn(
        pipe, davis_root=args.davis_root, output_dir=args.output,
        epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
        year=args.year, state_dict=model.state_dict(),
    )
    for h in history:
        print(f"epoch {h['epoch']}: loss={h['loss']:.4f}")
    return {"history": history, "load": report}


if __name__ == "__main__":
    main()
