#!/usr/bin/env python3
"""Standalone scorer CLI of the PyTorch port — score an existing results
directory against DAVIS ground truth, with CSV caching of global and
per-sequence tables (the `davis2017_evaluation/evaluation_method.py`
workload; the port's `scripts/score.py`). Scoring runs on the host and
needs no card."""
import argparse
import csv
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--davis-root", required=True)
    p.add_argument("--results-path", required=True, help="dir containing <seq>/<frame>.png")
    p.add_argument("--task", default="unsupervised", choices=["unsupervised", "semi-supervised"])
    p.add_argument("--set", default="val", dest="gt_set")
    p.add_argument("--year", default="2016")
    p.add_argument("--codalab", action="store_true",
                   help="also write scores.txt in CodaLab format (the "
                        "evaluation_codalab.py harness)")
    args = p.parse_args(argv)

    from slowfast_vos_tpu_torch.eval.scorer import DavisScorer, summarize

    csv_global = os.path.join(args.results_path, f"global_results-{args.gt_set}.csv")
    csv_seq = os.path.join(args.results_path, f"per-sequence_results-{args.gt_set}.csv")
    if os.path.exists(csv_global) and os.path.exists(csv_seq):
        print(f"Using precomputed results in {csv_global}")
        with open(csv_global) as f:
            print(f.read())
        return None

    t0 = time.time()
    scorer = DavisScorer(args.davis_root, task=args.task, gt_set=args.gt_set, year=args.year)
    metrics = scorer.evaluate(args.results_path)
    summary = summarize(metrics)

    with open(csv_global, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(summary))
        w.writerow([f"{v:.6f}" for v in summary.values()])
    with open(csv_seq, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Sequence", "J-Mean", "F-Mean"])
        for name in metrics["J"]["M_per_object"]:
            w.writerow(
                [name, metrics["J"]["M_per_object"][name], metrics["F"]["M_per_object"][name]]
            )

    if args.codalab:
        with open(os.path.join(args.results_path, "scores.txt"), "w") as f:
            for k, v in summary.items():
                f.write(f"{k.replace('&', 'AND').replace('-', '_')}: {v:.6f}\n")

    for k, v in summary.items():
        print(f"{k}: {v:.4f}")
    print(f"Total time: {time.time() - t0:.1f}s")
    return summary


if __name__ == "__main__":
    main()
