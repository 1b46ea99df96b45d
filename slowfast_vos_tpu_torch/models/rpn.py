"""Region Proposal Network: head, proposal filtering and training loss.

Port of `slowfast_vos_tpu/models/rpn.py`: torchvision's `RPNHead` module tree
(`rpn.head.conv`, `rpn.head.cls_logits`, `rpn.head.bbox_pred`),
`filter_proposals` (`rpn.py:144-205`): per-level top-k, decode, clip to the
resized image, min-size filter, one independent NMS per level, cross-level
top-k, with the NMS batched over frames and levels at once; and `rpn_loss`
(`rpn.py:208-277`), batched over frames.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.layers import Conv2d, nchw, nhwc
from slowfast_vos_tpu_torch.models.matching import BELOW_LOW, match_to_gt, sample_balanced_indices
from slowfast_vos_tpu_torch.ops.boxes import box_iou, clip_boxes, decode_boxes, encode_boxes, remove_small_boxes_mask
from slowfast_vos_tpu_torch.ops.nms import nms_mask, sort_desc, top_k_after_nms


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 1x1 box-delta heads per FPN level.
    `num_convs=2` is detectron2's StandardRPNHead with `conv_dims=[-1, -1]`
    (ViTDet): two 3x3 convs, each with its relu, under `conv.0`, `conv.1`."""

    def __init__(self, channels: int = 256, num_anchors: int = 3, num_convs: int = 1):
        super().__init__()
        self.num_anchors = num_anchors
        if num_convs == 1:
            self.conv = Conv2d(channels, channels, 3, padding=1)
        else:
            self.conv = nn.ModuleList([Conv2d(channels, channels, 3, padding=1) for _ in range(num_convs)])
        self.cls_logits = Conv2d(channels, num_anchors, 1)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats: list[torch.Tensor]):
        """feats: NHWC levels [T, H, W, C] -> (logits [T, H, W, A],
        deltas [T, H, W, A, 4]), in the compute dtype."""
        convs = self.conv if isinstance(self.conv, nn.ModuleList) else [self.conv]
        logits, deltas = [], []
        for f in feats:
            t = nchw(f)
            for conv in convs:
                t = F.relu(conv(t))
            logits.append(nhwc(self.cls_logits(t)))
            d = nhwc(self.bbox_pred(t))
            deltas.append(d.reshape(*d.shape[:-1], self.num_anchors, 4))
        return logits, deltas


class RegionProposalNetwork(nn.Module):
    """Holds the head under torchvision's `rpn.head` name."""

    def __init__(self, num_convs: int = 1):
        super().__init__()
        self.head = RPNHead(num_convs=num_convs)

    def forward(self, feats):
        return self.head(feats)


def filter_proposals(objectness, deltas, anchors, *, image_hw, cfg: DetectionConfig, training: bool = False):
    """Proposal filtering for a clip. objectness[l]: [T, H, W, A];
    deltas[l]: [T, H, W, A, 4]; anchors[l]: [H*W*A, 4]. `training` picks the
    `*_train` pre- and post-NMS top-n (`rpn.py:163-164`), else `*_test`.

    Returns (proposals [T, post, 4] f32, scores [T, post] f32, valid [T, post]).
    The head outputs stay in the compute dtype through the per-level top-k
    (ordering of bf16 values equals that of their f32 casts)."""
    pre = cfg.rpn_pre_nms_top_n_train if training else cfg.rpn_pre_nms_top_n_test
    post = cfg.rpn_post_nms_top_n_train if training else cfg.rpn_post_nms_top_n_test
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


def smooth_l1(x: torch.Tensor, beta: float) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rpn_loss(
    objectness,
    deltas,
    anchors,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: DetectionConfig,
    u_pos: torch.Tensor,
    u_neg: torch.Tensor,
):
    """RPN training loss of a clip, torchvision semantics (`rpn.py:213-277`):
    matcher at 0.3/0.7 with low-quality matches, `rpn_batch_size_per_image`
    samples at `rpn_positive_fraction`, BCE objectness over the sampled
    anchors and smooth-l1 (beta 1/9) box loss over the positives, both over
    the number sampled; each a mean over the T frames.

    objectness[l]: [T, H, W, A]; deltas[l]: [T, H, W, A, 4] (any float
    dtype, the loss runs in f32); anchors[l]: [H*W*A, 4]; gt_boxes
    [T, G, 4] canvas XYXY; gt_valid [T, G]; u_pos, u_neg: [T, num anchors]
    uniform draws of the sampler. Returns (objectness loss, box loss)."""
    t = gt_boxes.shape[0]
    obj = torch.cat([o.reshape(t, -1) for o in objectness], dim=1).float()
    dlt = torch.cat([d.reshape(t, -1, 4) for d in deltas], dim=1).float()
    anc = torch.cat(list(anchors), dim=0)
    matches = match_to_gt(
        box_iou(anc, gt_boxes), gt_valid,
        high_threshold=cfg.rpn_fg_iou, low_threshold=cfg.rpn_bg_iou, allow_low_quality=True,
    )
    idx, is_pos, valid = sample_balanced_indices(
        matches >= 0, matches == BELOW_LOW, u_pos, u_neg,
        batch_size=cfg.rpn_batch_size_per_image, positive_fraction=cfg.rpn_positive_fraction,
    )
    num_sampled = valid.sum(-1).clamp(min=1)
    gt_idx = torch.gather(matches, 1, idx).clamp(min=0)
    matched_gt = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(*gt_idx.shape, 4))
    reg_targets = encode_boxes(matched_gt, anc[idx])
    sampled_dlt = torch.gather(dlt, 1, idx[..., None].expand(*idx.shape, 4))
    box_l = smooth_l1(sampled_dlt - reg_targets, beta=1.0 / 9.0).sum(-1)
    zero = torch.zeros((), device=box_l.device)
    box_loss = torch.where(is_pos & valid, box_l, zero).sum(-1) / num_sampled

    o = torch.gather(obj, 1, idx)
    labels = (is_pos & valid).float()
    bce = o.clamp(min=0) - o * labels + torch.log1p(torch.exp(-o.abs()))
    obj_loss = torch.where(valid, bce, zero).sum(-1) / num_sampled
    return obj_loss.mean(), box_loss.mean()
