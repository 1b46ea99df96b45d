#!/usr/bin/env python3
"""Run one cell of the benchmark of `slowfast_vos_tpu_torch` on this
machine's NVIDIA GPU and print its result as the last line of standard
output.

    python vosbench/run.py --workload sf3-3.infer.davis16val --seed 7 --seconds 30 --trace 0

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics, read from the benchmark's host spans and a
`torch.profiler` trace of the window's first units of work. Before the
result line, standard error ends with each number that decided `correct`
beside its limit; the result line carries them last, under `checks`.
Exits 1 without a result where CUDA is absent or has fewer devices than the
cell asks for, and 3 where JAX, flax or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "slowfast_vos_tpu"}


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from vosbench import harness

    chips = harness.cell_spec(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vosbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    result = harness.execute(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"vosbench: the run loaded {', '.join(found)}; the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    details = result.pop("details")
    print(f"details {json.dumps(details)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
