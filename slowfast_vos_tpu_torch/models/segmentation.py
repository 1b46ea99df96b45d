"""SlowFastMaskRCNN: frozen Mask R-CNN backbone and RPN, SlowFast temporal
fusion of the FPN levels, RoI heads.

Port of `slowfast_vos_tpu/models/segmentation.py`. The module tree is the
reference's (a torchvision `maskrcnn_resnet50_fpn` plus `slow_fast.*`), so
`load_state_dict(strict=True)` takes a reference state dict as it is.
Orchestration lives in `pipeline.py` (inference) and `train/train_step.py`
(training). Only the SlowFast module behaves differently in train mode
(its BatchNorms); the frozen backbone's are buffers.
"""
from __future__ import annotations

import torch
from torch import nn

from slowfast_vos_tpu_torch.models.config import DetectionConfig, SlowFastConfig
from slowfast_vos_tpu_torch.models.heads import RoIHeads
from slowfast_vos_tpu_torch.models.resnet_fpn import ResNet50FPN
from slowfast_vos_tpu_torch.models.rpn import RegionProposalNetwork
from slowfast_vos_tpu_torch.models.slowfast import SlowFastTemporal

# The top-level modules the default training updates (`segmentation.py:31`,
# whose slow_fast, box_head and mask_head are this port's slow_fast and
# roi_heads).
TRAINABLE_TOPLEVEL = ("slow_fast", "roi_heads")


class SlowFastMaskRCNN(nn.Module):
    def __init__(
        self,
        cfg: DetectionConfig = DetectionConfig(),
        sf: SlowFastConfig = SlowFastConfig(),
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.cfg, self.sf, self.dtype = cfg, sf, dtype
        self.backbone = ResNet50FPN(dtype)
        self.rpn = RegionProposalNetwork()
        self.roi_heads = RoIHeads(cfg.num_classes, dtype)
        self.slow_fast = SlowFastTemporal(sf.slow, sf.fast, dtype=dtype)

    def backbone_feats(self, images: torch.Tensor) -> list[torch.Tensor]:
        """[T, H, W, 3] -> 5 FPN levels [T, H/s, W/s, 256], strides 4..64."""
        return self.backbone(images)

    def rpn_predict(self, feats):
        return self.rpn(feats)

    def enhance(self, feats, pre_padded: bool = False) -> list[torch.Tensor]:
        """SlowFast-enhance the 4 RoI levels with the shared module (the
        stride-64 level feeds only the RPN). In train mode each level's call
        updates the SlowFast running statistics in turn, as the four calls
        of one flax `apply` do."""
        return [self.slow_fast(f, pre_padded=pre_padded) for f in feats[:4]]

    def box_predict(self, pooled):
        return self.roi_heads.box_predict(pooled)

    def mask_predict(self, pooled):
        return self.roi_heads.mask_predict(pooled)
