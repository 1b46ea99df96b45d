"""Region Proposal Network: head and proposal filtering (test mode).

Port of `slowfast_vos_tpu/models/rpn.py`: torchvision's `RPNHead` module tree
(`rpn.head.conv`, `rpn.head.cls_logits`, `rpn.head.bbox_pred`) and
`filter_proposals` as the JAX package runs it at inference
(`rpn.py:144-205`): per-level top-k, decode, clip to the resized image,
min-size filter, one independent NMS per level, cross-level top-k. The NMS
runs batched over frames and levels at once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.layers import Conv2d, nchw, nhwc
from slowfast_vos_tpu_torch.ops.boxes import clip_boxes, decode_boxes, remove_small_boxes_mask
from slowfast_vos_tpu_torch.ops.nms import nms_mask, sort_desc, top_k_after_nms


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 1x1 box-delta heads per FPN level."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = Conv2d(channels, num_anchors, 1)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: list[torch.Tensor]):
        """feats: NHWC levels [T, H, W, C] -> (logits [T, H, W, A],
        deltas [T, H, W, A, 4]), in the compute dtype."""
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(nchw(f)))
            logits.append(nhwc(self.cls_logits(t)))
            d = nhwc(self.bbox_pred(t))
            deltas.append(d.reshape(*d.shape[:-1], self.num_anchors, 4))
        return logits, deltas


class RegionProposalNetwork(nn.Module):
    """Holds the head under torchvision's `rpn.head` name."""

    def __init__(self):
        super().__init__()
        self.head = RPNHead()

    def forward(self, feats):
        return self.head(feats)


def filter_proposals(objectness, deltas, anchors, *, image_hw, cfg: DetectionConfig):
    """Test-mode proposal filtering for a clip. objectness[l]: [T, H, W, A];
    deltas[l]: [T, H, W, A, 4]; anchors[l]: [H*W*A, 4].

    Returns (proposals [T, post, 4] f32, scores [T, post] f32, valid [T, post]).
    The head outputs stay in the compute dtype through the per-level top-k
    (ordering of bf16 values equals that of their f32 casts)."""
    pre, post = cfg.rpn_pre_nms_top_n_test, cfg.rpn_post_nms_top_n_test
    t = objectness[0].shape[0]
    objectness = [o.reshape(t, -1) for o in objectness]
    deltas = [d.reshape(t, -1, 4) for d in deltas]
    kmax = min(pre, max(o.shape[1] for o in objectness))
    cand_boxes, cand_scores, cand_valid = [], [], []
    for obj, dlt, anc in zip(objectness, deltas, anchors):
        k = min(pre, obj.shape[1])
        top_s, top_i = sort_desc(obj)
        top_s, top_i = top_s[:, :k].float(), top_i[:, :k]
        d = torch.gather(dlt, 1, top_i[..., None].expand(t, k, 4)).float()
        boxes = clip_boxes(decode_boxes(d, anc[top_i]), image_hw)
        lvalid = remove_small_boxes_mask(boxes, cfg.rpn_min_size)
        if k < kmax:  # pad small levels so levels stack
            boxes = F.pad(boxes, (0, 0, 0, kmax - k))
            top_s = F.pad(top_s, (0, kmax - k), value=-float("inf"))
            lvalid = F.pad(lvalid, (0, kmax - k))
        cand_boxes.append(boxes)
        cand_scores.append(top_s)
        cand_valid.append(lvalid)
    boxes = torch.stack(cand_boxes, dim=1)  # [T, L, K, 4]
    scores = torch.stack(cand_scores, dim=1)
    valid = torch.stack(cand_valid, dim=1)

    # torchvision's batched_nms over FPN levels never lets levels suppress
    # each other, so it is exactly one independent NMS per (frame, level).
    keep, _order = nms_mask(boxes, scores, valid, iou_threshold=cfg.rpn_nms_thresh)
    flat_s = scores.reshape(t, -1)
    idx, out_valid = top_k_after_nms(keep.reshape(t, -1), flat_s, post)
    props = torch.gather(boxes.reshape(t, -1, 4), 1, idx[..., None].expand(*idx.shape, 4))
    return props, torch.gather(flat_s, 1, idx), out_valid
