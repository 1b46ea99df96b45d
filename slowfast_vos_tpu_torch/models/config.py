"""Static configuration for the detection stack.

Defaults mirror the torchvision Mask R-CNN hyperparameters the reference
inherits, plus its one explicit override `detections_per_img=10`
(`code/helpers/model.py:187`). SlowFast pathway sizes correspond to the
reference's central "m-n" hyperparameter (`code/helpers/constants.py:7-8`).
All counts here are static tensor shapes.

A copy of `slowfast_vos_tpu/models/config.py`: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    num_classes: int = 2

    # RPN proposal filtering
    rpn_pre_nms_top_n_train: int = 2000
    rpn_pre_nms_top_n_test: int = 1000
    rpn_post_nms_top_n_train: int = 2000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 1e-3

    # RPN training
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5

    # Box head training
    box_fg_iou: float = 0.5
    box_bg_iou: float = 0.5
    box_batch_size_per_image: int = 512
    box_positive_fraction: float = 0.25
    bbox_reg_weights: tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)

    # Box head inference
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_min_size: float = 1e-2
    detections_per_img: int = 10  # reference override, code/helpers/model.py:187

    # Mask head
    mask_roi_size: int = 14
    mask_out_size: int = 28
    # Static cap on positive rois fed to the mask head in training
    # (box_batch_size_per_image * box_positive_fraction).
    mask_train_rois: int = 128

    # Static gt padding
    max_gt: int = 8


@dataclasses.dataclass(frozen=True)
class SlowFastConfig:
    """Reference pathway sizes: slow sees `slow` centered frames of the `fast`
    window (`code/helpers/constants.py:7-8`, configs 1-1 .. 7-7)."""

    slow: int = 3
    fast: int = 3

    def __post_init__(self):
        assert self.slow <= self.fast, "slow pathway must fit inside fast window"
