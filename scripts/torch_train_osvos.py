#!/usr/bin/env python3
"""OSVOS-style per-sequence online fine-tuning CLI of the PyTorch port (the
`code/osvos/train_osvos.py` / `run_osvos_for_all_seq.py` /
`run_osvos_experiments.py` workloads, selected via --mode; the port's
`scripts/train_osvos.py`). Every mode runs its fine-tunes one after
another."""
import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slowfast_vos_tpu_torch import cli  # noqa: E402  (imports no torch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="single", choices=["single", "all", "experiments"])
    p.add_argument("--davis-root", required=True, help="DAVIS-2016 root")
    p.add_argument("--checkpoint", required=True, help="best unsupervised weights")
    p.add_argument("--sequence", default="bmx-trees")
    p.add_argument("--results-root", default="output/osvos_results")
    p.add_argument("--output-json", default="output/osvos_all_results.json")
    p.add_argument("--experiments-dir", default="output/osvos_experiments")
    p.add_argument("--slow", type=int, default=3)
    p.add_argument("--fast", type=int, default=3)
    p.add_argument("--freeze", default="SF", choices=["none", "SF", "BB_SF"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--scale", type=float, default=0.25)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--original-hw", type=int, nargs=2, default=(480, 854))
    p.add_argument(
        "--parity-exact", action="store_true",
        help="reference-exact parity mode for J&F-gated runs: the model computes in float32. "
        "Slower; use for the RUNBOOK 0.5-pt gates.",
    )
    cli.add_device_argument(p)
    args = p.parse_args(argv)
    cli.require_single_process()

    import torch

    from slowfast_vos_tpu_torch.train import osvos

    pipe, model = cli.build(
        args.slow, args.fast, args.original_hw, device=args.device,
        dtype=torch.float32 if args.parity_exact else None,
    )
    cli.init_model(model, 63, args.checkpoint)
    cfg = osvos.ExperimentConfig(freeze=args.freeze, lr=args.lr, scale=args.scale, epochs=args.epochs)

    if args.mode == "single":
        results = osvos.train_osvos_sequence(
            pipe, model.state_dict(), davis_root=args.davis_root,
            sequence_name=args.sequence, results_root=args.results_root, cfg=cfg,
        )
        print(json.dumps({str(k): v for k, v in results.items()}, indent=2))
        return results
    if args.mode == "all":
        os.makedirs(os.path.dirname(os.path.abspath(args.output_json)), exist_ok=True)
        results = osvos.run_osvos_for_all_sequences(
            pipe, model.state_dict(), davis_root=args.davis_root,
            results_root=args.results_root, output_json=args.output_json, cfg=cfg,
        )
        print(f"wrote {args.output_json}")
        return results
    osvos.run_osvos_experiments(
        pipe, model.state_dict(), davis_root=args.davis_root,
        results_root=args.results_root, experiments_dir=args.experiments_dir,
    )
    return None


if __name__ == "__main__":
    main()
