"""SlowFastMaskRCNN: frozen Mask R-CNN backbone and RPN, SlowFast temporal
fusion of the FPN levels, RoI heads.

Port of `slowfast_vos_tpu/models/segmentation.py`. The module tree is the
reference's (a torchvision `maskrcnn_resnet50_fpn` plus `slow_fast.*`) under
the reference's names, less its `maskrcnn_model.` prefix: a reference
`.pth` enters through `convert/from_torchvision.py::load_init`, which strips
that prefix and keeps tensors the file lacks at their init.
With `use_slow_fast=False` (the Mask R-CNN fine-tune, JAX
`segmentation.py:40,63-69`) there is no SlowFast module: the RoI heads take
the raw FPN levels, and the state dict is a plain Mask R-CNN's.
With `arch="vitdet-b"` the backbone is ViTDet-B's ViT and simple feature
pyramid (`models/vit.py`), the RPN head has two convs and the RoI heads
are ViTDet's (4conv1fc box head, LayerNorm mask head): the same NHWC P2-P6,
SlowFast and RoI pools run over it.
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
from slowfast_vos_tpu_torch.models.vit import SimpleFeaturePyramid, ViTConfig

# The top-level modules the default training updates (`segmentation.py:31`,
# whose slow_fast, box_head and mask_head are this port's slow_fast and
# roi_heads).
TRAINABLE_TOPLEVEL = ("slow_fast", "roi_heads")
ARCHS = ("resnet50-fpn", "vitdet-b")


class SlowFastMaskRCNN(nn.Module):
    def __init__(
        self,
        cfg: DetectionConfig = DetectionConfig(),
        sf: SlowFastConfig = SlowFastConfig(),
        dtype: torch.dtype = torch.bfloat16,
        use_slow_fast: bool = True,
        arch: str = "resnet50-fpn",
        vit: ViTConfig = ViTConfig(),
    ):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"arch must be one of {ARCHS}, not {arch!r}")
        self.cfg, self.sf, self.dtype, self.arch = cfg, sf, dtype, arch
        self.use_slow_fast = use_slow_fast
        vitdet = arch == "vitdet-b"
        self.backbone = SimpleFeaturePyramid(vit, dtype) if vitdet else ResNet50FPN(dtype)
        self.rpn = RegionProposalNetwork(num_convs=2 if vitdet else 1)
        self.roi_heads = RoIHeads(cfg.num_classes, dtype, vitdet=vitdet)
        if use_slow_fast:
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
        of one flax `apply` do. Without SlowFast the levels pass through,
        less the pre-padded halo."""
        if not self.use_slow_fast:
            f = self.sf.fast
            if pre_padded and f > 1:
                lo, hi = f // 2, -(-f // 2) - 1
                return [x[lo : x.shape[0] - hi] for x in feats[:4]]
            return list(feats[:4])
        return [self.slow_fast(f, pre_padded=pre_padded) for f in feats[:4]]

    def box_predict(self, pooled):
        return self.roi_heads.box_predict(pooled)

    def mask_predict(self, pooled):
        return self.roi_heads.mask_predict(pooled)
