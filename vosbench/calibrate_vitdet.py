#!/usr/bin/env python3
"""Readings that the limits of `vitdet-b-sf3-3.infer.davis16val` are set
from, on the card (`calibrate.py`'s, for the ViTDet driver).

    python vosbench/calibrate_vitdet.py --seeds 1,2,3 --control 4,5,6 --fault rel_w_dropped:7

For each seed of `--seeds`, the program's own numbers: set-up, the
traffic's sample through `infer_sequence`, then the reference, as a run
does. For each seed of `--control`, the reference computed with float8
e4m3 operands (`reference/vitdet.py`'s `set_fp8`) in the program's place,
judged by the float32 reference. `--fault NAME:SEED,...` runs the program
with a part broken (`FAULTS`) as a sound seed runs. Prints one JSON line a
reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CELL = "vitdet-b-sf3-3.infer.davis16val"


def _rel_w_dropped(original):
    def terms(q, rel_pos_h, rel_pos_w, hw):
        rel_h, rel_w = original(q, rel_pos_h, rel_pos_w, hw)
        return rel_h, rel_w * 0
    return terms


def _pos_dropped(original):
    def pos(pos_embed, hw, dtype):
        return original(pos_embed, hw, dtype) * 0
    return pos


FAULTS = {"rel_w_dropped": ("rel_pos_terms", _rel_w_dropped), "pos_embed_dropped": ("abs_pos", _pos_dropped)}


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def faults(text: str) -> list[tuple[str, int]]:
    return [(name, int(seed)) for name, seed in (item.split(":") for item in text.split(",") if item)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", type=faults, default=[])
    args = ap.parse_args(argv)

    import torch

    from slowfast_vos_tpu_torch.models import vit
    from vosbench import harness, trace
    from vosbench.calibrate import inference_control
    from vosbench.drivers import infer_vitdet
    from vosbench.generators import blob_videos

    if not torch.cuda.is_available():
        print("calibrate_vitdet: CUDA is not available", file=sys.stderr)
        return 1
    spec = harness.cell_spec(CELL)
    cfg, traffic = spec["config"], spec["traffic"]

    def emit(kind, seed, gaps, details):
        line = {"kind": kind, "seed": seed, "gaps": gaps, "details": details, "card": torch.cuda.get_device_name()}
        print(json.dumps(line, default=float), flush=True)

    for kind, seed in [("program", s) for s in args.seeds] + list(args.fault):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True  # the program as a run has it (PyTorch's defaults)
        cell = infer_vitdet.Cell(cfg, traffic, blob_videos, seed, "cuda", trace.Spans())
        patched = None
        if kind in FAULTS:
            name, fault = FAULTS[kind]
            patched = (name, getattr(vit, name))
            setattr(vit, name, fault(patched[1]))
        t0 = time.perf_counter()
        try:
            cell.setup()
            for idx in sorted(cell.sample):
                cell.kept[idx] = cell.pipe.infer_sequence(cell.sequences[idx], transport=cfg["transport"])
            setup = time.perf_counter() - t0
            cell.release()
            gaps, details = cell.check()
            details["setup_and_sample_s"] = setup
            emit(kind, seed, gaps, details)
        finally:
            if patched is not None:
                setattr(vit, *patched)
            cell.close()
        del cell
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.control:
        cell = infer_vitdet.Cell(cfg, traffic, blob_videos, seed, "cuda", trace.Spans())
        cell.prepare()
        gaps, _ = inference_control(cell, cell.reference(fp8=True), cell.reference(), infer_vitdet.geometry(cfg))
        emit("control", seed, gaps, {"sampled": [len(cell.sequences[i]) for i in sorted(cell.sample)]})
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
