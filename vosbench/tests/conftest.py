"""Shared set-up of the benchmark's tests: the cells at a tiny size on the
CPU, where the port runs its plain versions in float32."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

TINY_DETECTION = dict(rpn_pre_nms_top_n_train=64, rpn_post_nms_top_n_train=32, rpn_pre_nms_top_n_test=64,
                      rpn_post_nms_top_n_test=32, box_batch_size_per_image=32, mask_train_rois=8,
                      detections_per_img=5, max_gt=3)
TINY_CONFIG = {"original_hw": [60, 100], "min_size": 64, "max_size": 128, "superchunk": 4, "dtype": "float32",
               "graphs": False, "detection": TINY_DETECTION}
TINY_TRAFFIC = {
    "infer": {"lengths": [6, 9, 5], "objects": [1, 2, 1], "sample": 2},
    "train": {"lengths": [6, 8], "objects": [1, 2]},
}
INFER_CELL = "sf3-3.infer.davis16val"
TRAIN_CELL = "sf3-3.train.davis17"
SEED = 2**31 + 12345  # past 32 signed bits: seeds may be that large
# The tiny model's masks cover all or none of a frame on some seeds, where
# the mask numbers have nothing to judge; on this one they cover part of
# every frame in both inference cells, so that the fault tests judge them.
FAULT_SEED = 2**31 + 11


def tiny(kind: str) -> dict:
    return {"config": TINY_CONFIG, "traffic": TINY_TRAFFIC[kind]}


@pytest.fixture
def run_tiny():
    """`harness.execute` of a cell on the CPU at the tiny size."""
    from vosbench import harness

    def run(cell, seconds=1.0, trace=False, seed=SEED):
        kind = "infer" if "infer" in cell else "train"
        return harness.execute(cell, seed, seconds, trace, device="cpu", overrides=tiny(kind))

    return run
