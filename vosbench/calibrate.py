#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card.

    python vosbench/calibrate.py --workload sf3-3.infer.davis16val --seeds 1,2,3 --control 4,5,6

For each seed of `--seeds`, the program's own numbers: set-up and the
traffic's sample driven through the timed path (inference: the sampled
sequences through `infer_sequence`; training: the checked steps of the
trainer through its feed), then the reference, as a run does. For each seed
of `--control`, the control's: the reference computed with float8 e4m3
operands (`reference/model.py::set_fp8`) put in the program's place. For
each of `--half-batch` (training), the reference that keeps half the centre
frames and scales them to the whole, in the program's place. `--witness`
runs the program in float32 with TF32 off, a second path of the program
that the reference should match to rounding. Prints one JSON line per
reading; `--dump DIR` also writes each reading's raw arrays there.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def inference_control(cell, fp8_model, f32_model, geom) -> tuple[dict, dict]:
    """The fp8 reference in the program's place, judged by the f32 one."""
    import numpy as np
    import torch

    from vosbench import compare
    from vosbench.reference import run as ref_run

    program, reference = [], []
    for idx in sorted(cell.sample):
        frames = torch.from_numpy(cell.sequences[idx]).to(cell.device)
        out = ref_run.infer_sequence(fp8_model, geom, frames)
        dets = [{"boxes": out["boxes"][g].cpu().numpy(), "scores": out["scores"][g].cpu().numpy(),
                 "labels": np.ones(out["valid"].shape[1], np.int32), "valid": out["valid"][g].cpu().numpy(),
                 "union_mask": out["union"][g].cpu().numpy()} for g in range(frames.shape[0])]
        teacher = {k: torch.as_tensor(np.stack([d[k] for d in dets])).to(cell.device) for k in ("boxes", "labels", "valid")}
        ref = ref_run.infer_sequence(f32_model, geom, frames, teacher=teacher)
        program.append(dets)
        reference.append({k: v.cpu().numpy() for k, v in ref.items()})
    gaps, extra = compare.inference_gaps(program, reference)
    return {**gaps, **extra}, {"program": program, "reference": reference}


def strip(program, reference) -> dict:
    """The compared arrays without the pixel masks, small enough to keep."""
    import numpy as np

    return {"program": [{k: np.stack([d[k] for d in dets]) for k in ("boxes", "scores", "labels", "valid")}
                        for dets in program],
            "reference": [{k: v for k, v in ref.items() if "union" not in k} for ref in reference]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--half-batch", type=seeds, default=[])
    ap.add_argument("--witness", type=seeds, default=[])
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    import importlib

    import numpy as np
    import torch

    from vosbench import compare, harness, trace
    from vosbench.reference import model as ref_model
    from vosbench.reference import run as ref_run

    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 1
    spec = harness.cell_spec(args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    driver = importlib.import_module(f"vosbench.drivers.{traffic['driver']}")
    generator = importlib.import_module(f"vosbench.generators.{traffic['generator']}")
    geom = ref_model.Geometry(tuple(cfg["original_hw"]), cfg["min_size"], cfg["max_size"])
    det = ref_model.Detection(**cfg["detection"])
    infer = traffic["driver"] == "infer"

    def emit(kind, seed, gaps, details, raw=None):
        line = {"kind": kind, "seed": seed, "gaps": gaps, "details": details, "card": torch.cuda.get_device_name()}
        print(json.dumps(line, default=float), flush=True)
        if args.dump and raw is not None:
            Path(args.dump).mkdir(parents=True, exist_ok=True)
            torch.save(raw, Path(args.dump) / f"{args.workload}.{kind}.{seed}.pt")

    runs = [("program", s) for s in args.seeds] + [("witness", s) for s in args.witness]
    for kind, seed in runs:
        c = cfg if kind == "program" else harness.merged(cfg, {"dtype": "float32"})
        # The program as a run has it (PyTorch's defaults); the witness with TF32 off.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = kind == "program"
        cell = driver.Cell(c, traffic, generator, seed, "cuda", trace.Spans())
        t0 = time.perf_counter()
        try:
            cell.setup()
            if infer:
                for idx in sorted(cell.sample):
                    cell.kept[idx] = cell.pipe.infer_sequence(cell.sequences[idx], transport=c["transport"])
            setup = time.perf_counter() - t0
            cell.release()
            gaps, details = cell.check()
            details["setup_and_sample_s"] = setup
            raw = None
            if infer and args.dump:
                raw = strip(*cell.compared)
            if not infer:
                ref = cell.reference_steps()
                keep = compare.kept_leaves(ref["grad"])
                details["grad_gaps"] = compare.leaf_gaps(cell.program["grad"], ref["grad"], keep)
                details["step_gaps"] = compare.leaf_gaps(cell.program["change"], ref["change"], keep)
                details["buffer_gaps"] = compare.leaf_gaps(cell.program["buffers"], ref["buffers"], sorted(ref["buffers"]))
            emit(kind, seed, gaps, details, raw)
        finally:
            if hasattr(cell, "close"):
                cell.close()
        del cell
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kind, group in (("control", args.control), ("half_batch", args.half_batch)):
        for seed in group:
            cell = driver.Cell(cfg, traffic, generator, seed, "cuda", trace.Spans())
            try:
                cell.prepare()
                if infer:
                    rank = getattr(torch, cfg["dtype"])
                    fp8 = ref_run.build(cfg["slow"], cfg["fast"], det, cell.state, "cuda", fp8=True, rank_dtype=rank)
                    f32 = ref_run.build(cfg["slow"], cfg["fast"], det, cell.state, "cuda", rank_dtype=rank)
                    gaps, raw = inference_control(cell, fp8, f32, geom)
                    emit(kind, seed, gaps, {"sampled": [len(cell.sequences[i]) for i in sorted(cell.sample)]},
                         strip(raw["program"], raw["reference"]))
                else:
                    ref = cell.reference_steps()
                    other = cell.reference_steps(fp8=kind == "control", half_batch=kind == "half_batch")
                    gaps, details = compare.training_gaps(other, ref)
                    keep = compare.kept_leaves(ref["grad"])
                    details["grad_gaps"] = compare.leaf_gaps(other["grad"], ref["grad"], keep)
                    details["step_gaps"] = compare.leaf_gaps(other["change"], ref["change"], keep)
                    details["buffer_gaps"] = compare.leaf_gaps(other["buffers"], ref["buffers"], sorted(ref["buffers"]))
                    emit(kind, seed, gaps, details)
            finally:
                if hasattr(cell, "close"):
                    cell.close()
            del cell
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
