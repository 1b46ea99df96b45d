#!/usr/bin/env python3
"""Unsupervised VOS training CLI of the PyTorch port — the `code/train.py`
workload: train the SlowFast segmentation model on DAVIS-2017 train,
evaluate per epoch on DAVIS-2016 val, keep best/last/resume checkpoints
(the port's `scripts/train.py`)."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slowfast_vos_tpu_torch import cli  # noqa: E402  (imports no torch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train-root", required=True, help="DAVIS-2017 root")
    p.add_argument("--eval-root", default=None, help="DAVIS-2016 root (per-epoch eval)")
    p.add_argument("--output", default="output/unsupervised")
    p.add_argument("--slow", type=int, default=3)
    p.add_argument("--fast", type=int, default=3)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=63)
    p.add_argument("--original-hw", type=int, nargs=2, default=(480, 854))
    p.add_argument("--continue-training", action="store_true")
    p.add_argument("--init-checkpoint", default=None,
                   help="the port's checkpoint or a reference .pth to start from")
    p.add_argument("--tensorboard", action="store_true",
                   help="also write TensorBoard event files (reference train.py:82)")
    p.add_argument("--no-data-parallel", action="store_true",
                   help="force serial steps on every process even under a multi-process launch")
    cli.add_device_argument(p)
    args = p.parse_args(argv)
    # Multi-process launches (torchrun, SLURM) join the process group here;
    # a no-op in a single process (the reference's init_distributed_mode).
    cli.init_distributed(args.device)

    from slowfast_vos_tpu_torch.train.trainer import train_unsupervised

    pipe, model = cli.build(args.slow, args.fast, args.original_hw, device=args.device)
    report = cli.init_model(model, args.seed, args.init_checkpoint)
    _trainer, history = train_unsupervised(
        pipe,
        train_root=args.train_root,
        eval_root=args.eval_root,
        output_dir=args.output,
        epochs=args.epochs,
        lr=args.lr,
        seed=args.seed,
        continue_training=args.continue_training,
        state_dict=model.state_dict(),
        tensorboard=args.tensorboard,
        data_parallel=False if args.no_data_parallel else None,
    )
    for h in history:
        ev = h["eval"] or {}
        print(f"epoch {h['epoch']}: loss={h['loss']:.4f} jf={ev.get('jf', float('nan')):.4f}")
    return {"history": history, "load": report}


if __name__ == "__main__":
    main()
