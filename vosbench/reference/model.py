"""The plain reference of SlowFast Mask R-CNN: modules, losses and the
proposal and detection stages, in plain PyTorch.

A frozen copy of the port's plain path, kept beside the benchmark so that
the yardstick does not move when the program does: ResNet-50 + FPN with
frozen BatchNorm (torchvision's module names, so the same state dict
loads), the RPN head, proposal filtering and loss, the SlowFast temporal
block (each valid temporal convolution as summed 2-D convolutions; eval
BatchNorm folded, train BatchNorm as flax's biased statistics with momentum
0.9), the box and mask heads, training-sample selection and the losses,
and torchvision's detection postprocess. It runs in the dtype of its
input: float32 with TF32 off is the reference.

`fp8`: every convolution and linear layer rounds its input and its weight
to float8 e4m3 with one scale a tensor (the largest magnitude onto 448)
before a float32 product. That is the control, the step below the bf16
that the configurations state, and `set_fp8` turns it on.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vosbench.reference import ops

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FPN_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = (32, 64, 128, 256, 512)


@dataclasses.dataclass(frozen=True)
class Detection:
    """torchvision Mask R-CNN's settings with `detections_per_img` 10."""

    num_classes: int = 2
    rpn_pre_nms_top_n_train: int = 2000
    rpn_pre_nms_top_n_test: int = 1000
    rpn_post_nms_top_n_train: int = 2000
    rpn_post_nms_top_n_test: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 1e-3
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_size_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    box_fg_iou: float = 0.5
    box_bg_iou: float = 0.5
    box_batch_size_per_image: int = 512
    box_positive_fraction: float = 0.25
    bbox_reg_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    box_min_size: float = 1e-2
    detections_per_img: int = 10
    mask_roi_size: int = 14
    mask_out_size: int = 28
    mask_train_rois: int = 128
    max_gt: int = 8


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale that maps its largest
    magnitude onto 448, and returned in x's dtype."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    for m in model.modules():
        m.fp8 = on
    return model


def _operands(module, x, w):
    w = w.to(x.dtype)
    if getattr(module, "fp8", False):
        return fp8_round(x), fp8_round(w)
    return x, w


class Conv2d(nn.Conv2d):
    def forward(self, x):
        x, w = _operands(self, x, self.weight)
        return self._conv_forward(x, w, None if self.bias is None else self.bias.to(x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        x, w = _operands(self, x, self.weight)
        return F.conv_transpose2d(x, w, None if self.bias is None else self.bias.to(x.dtype), self.stride)


class Linear(nn.Linear):
    def forward(self, x):
        x, w = _operands(self, x, self.weight)
        return F.linear(x, w, None if self.bias is None else self.bias.to(x.dtype))


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv.to(x.dtype)[:, None, None] + (self.bias - self.running_mean * inv).to(x.dtype)[:, None, None]


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- backbone


class Bottleneck(nn.Module):
    def __init__(self, cin, features, stride=1):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(cin, features, 1, bias=False), FrozenBatchNorm2d(features)
        self.conv2, self.bn2 = Conv2d(features, features, 3, stride, padding=1, bias=False), FrozenBatchNorm2d(features)
        self.conv3, self.bn3 = Conv2d(features, features * 4, 1, bias=False), FrozenBatchNorm2d(features * 4)
        self.downsample = None
        if stride != 1 or cin != features * 4:
            self.downsample = nn.Sequential(Conv2d(cin, features * 4, 1, stride, bias=False),
                                            FrozenBatchNorm2d(features * 4))

    def forward(self, x):
        short = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + short)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(3, 64, 7, 2, padding=3, bias=False), FrozenBatchNorm2d(64)
        cin, features = 64, 64
        for stage, nblocks in enumerate((3, 4, 6, 3)):
            blocks = []
            for i in range(nblocks):
                blocks.append(Bottleneck(cin, features, 2 if (stage > 0 and i == 0) else 1))
                cin = features * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            features *= 2

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        outs = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    def __init__(self, cins=(256, 512, 1024, 2048), cout=256):
        super().__init__()
        self.inner_blocks = nn.ModuleList([Conv2d(c, cout, 1) for c in cins])
        self.layer_blocks = nn.ModuleList([Conv2d(cout, cout, 3, padding=1) for _ in cins])

    def forward(self, inputs):
        last = self.inner_blocks[-1](inputs[-1])
        outs = [self.layer_blocks[-1](last)]
        for i in range(len(inputs) - 2, -1, -1):
            lat = self.inner_blocks[i](inputs[i])
            h, w = lat.shape[-2:]
            last = lat + F.interpolate(last, scale_factor=2, mode="nearest")[..., :h, :w]
            outs.insert(0, self.layer_blocks[i](last))
        outs.append(F.max_pool2d(outs[-1], 1, 2))
        return outs


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = ResNet50()
        self.fpn = FPN()

    def forward(self, canvas):
        """canvas [T, Hc, Wc, 3] -> 5 levels [T, h, w, 256]."""
        return [nhwc(p) for p in self.fpn(self.body(nchw(canvas).contiguous()))]


# ---------------------------------------------------------------- RPN


class RPNHead(nn.Module):
    def __init__(self, channels=256, anchors=3):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)
        self.cls_logits = Conv2d(channels, anchors, 1)
        self.bbox_pred = Conv2d(channels, anchors * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(nchw(f)))
            logits.append(nhwc(self.cls_logits(t)))
            d = nhwc(self.bbox_pred(t))
            deltas.append(d.reshape(*d.shape[:-1], 3, 4))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.head = RPNHead()

    def forward(self, feats):
        return self.head(feats)


def cell_anchors(size):
    ratios = np.asarray((0.5, 1.0, 2.0), np.float32)
    hr = np.sqrt(ratios)
    ws, hs = size / hr, hr * size
    return np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0).astype(np.float32)


def anchors_for(feature_hws, device):
    out = []
    for (h, w), stride, size in zip(feature_hws, FPN_STRIDES, ANCHOR_SIZES):
        sx, sy = np.meshgrid(np.arange(w, dtype=np.float32) * stride, np.arange(h, dtype=np.float32) * stride)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        out.append(torch.from_numpy((shifts + cell_anchors(size)[None]).reshape(-1, 4)).to(device))
    return out


def filter_proposals(objectness, deltas, anchors, image_hw, cfg: Detection, training: bool,
                     rank_dtype=torch.float32):
    """Per level: top-k objectness, decode, clip, min size, NMS at 0.7; then
    the top proposals over all levels. -> (proposals [T, P, 4], valid).
    Objectness ranks as a value of `rank_dtype`, the compute dtype that the
    configuration states, ties to the lower index: that is how the model
    orders its proposals, and a float32 value would break the ties of the
    coarser type in another order."""
    pre = cfg.rpn_pre_nms_top_n_train if training else cfg.rpn_pre_nms_top_n_test
    post = cfg.rpn_post_nms_top_n_train if training else cfg.rpn_post_nms_top_n_test
    t = objectness[0].shape[0]
    objectness = [o.reshape(t, -1) for o in objectness]
    deltas = [d.reshape(t, -1, 4) for d in deltas]
    kmax = min(pre, max(o.shape[1] for o in objectness))
    cb, cs, cv = [], [], []
    for obj, dlt, anc in zip(objectness, deltas, anchors):
        k = min(pre, obj.shape[1])
        top_s, top_i = ops.sort_desc(obj.to(rank_dtype))
        top_s, top_i = top_s[:, :k].float(), top_i[:, :k]
        d = torch.gather(dlt, 1, top_i[..., None].expand(t, k, 4)).float()
        boxes = ops.clip_boxes(ops.decode_boxes(d, anc[top_i]), image_hw)
        lvalid = ops.remove_small_boxes_mask(boxes, cfg.rpn_min_size)
        if k < kmax:
            boxes = F.pad(boxes, (0, 0, 0, kmax - k))
            top_s = F.pad(top_s, (0, kmax - k), value=-float("inf"))
            lvalid = F.pad(lvalid, (0, kmax - k))
        cb.append(boxes)
        cs.append(top_s)
        cv.append(lvalid)
    boxes, scores, valid = torch.stack(cb, 1), torch.stack(cs, 1), torch.stack(cv, 1)
    keep = ops.nms_keep(boxes, scores, valid, cfg.rpn_nms_thresh)
    flat_s = scores.reshape(t, -1)
    idx, out_valid = ops.top_k_after_nms(keep.reshape(t, -1), flat_s, post)
    props = torch.gather(boxes.reshape(t, -1, 4), 1, idx[..., None].expand(*idx.shape, 4))
    return props, out_valid


def smooth_l1(x, beta):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


BELOW_LOW, BETWEEN = -1, -2


def match_to_gt(iou, gt_valid, high, low, allow_low_quality):
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    vals = iou.amax(dim=-1)
    matches = iou.argmax(dim=-1)
    out = torch.where(vals < low, torch.full_like(matches, BELOW_LOW), matches)
    out = torch.where((vals >= low) & (vals < high), torch.full_like(matches, BETWEEN), out)
    if allow_low_quality:
        best = iou.amax(dim=-2, keepdim=True)
        out = torch.where(((iou == best) & gt_valid[..., None, :]).any(dim=-1), matches, out)
    return out


def _rank(priority):
    order = ops.sort_desc(priority).indices
    ar = torch.arange(priority.shape[-1], device=priority.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


def sample_balanced(positive, negative, u_pos, u_neg, batch_size, fraction):
    num_pos = positive.sum(-1).clamp(max=int(batch_size * fraction))
    num_neg = torch.minimum(negative.sum(-1), batch_size - num_pos)

    def pick(u, mask, count):
        return mask & (_rank(torch.where(mask, u, torch.full_like(u, -1.0))) < count[..., None])

    return pick(u_pos, positive, num_pos), pick(u_neg, negative, num_neg)


def rpn_loss(objectness, deltas, anchors, gt_boxes, gt_valid, cfg: Detection, u_pos, u_neg):
    t = gt_boxes.shape[0]
    obj = torch.cat([o.reshape(t, -1) for o in objectness], 1).float()
    dlt = torch.cat([d.reshape(t, -1, 4) for d in deltas], 1).float()
    anc = torch.cat(list(anchors))
    matches = match_to_gt(ops.box_iou(anc, gt_boxes), gt_valid, cfg.rpn_fg_iou, cfg.rpn_bg_iou, True)
    n = matches.shape[-1]
    max_pos, bsz = min(int(cfg.rpn_batch_size_per_image * cfg.rpn_positive_fraction), n), min(cfg.rpn_batch_size_per_image, n)
    positive, negative = matches >= 0, matches == BELOW_LOW
    num_pos = positive.sum(-1).clamp(max=max_pos)
    num_neg = torch.minimum(negative.sum(-1), cfg.rpn_batch_size_per_image - num_pos)
    m1 = torch.full_like(u_pos, -1.0)
    idx = torch.cat([ops.sort_desc(torch.where(positive, u_pos, m1)).indices[..., :max_pos],
                     ops.sort_desc(torch.where(negative, u_neg, m1)).indices[..., :bsz]], -1)
    dev = gt_boxes.device
    valid = torch.cat([torch.arange(max_pos, device=dev) < num_pos[..., None],
                       torch.arange(bsz, device=dev) < num_neg[..., None]], -1)
    is_pos = torch.cat([torch.ones(max_pos, dtype=torch.bool, device=dev),
                        torch.zeros(bsz, dtype=torch.bool, device=dev)]).expand_as(valid)
    num = valid.sum(-1).clamp(min=1)
    gi = torch.gather(matches, 1, idx).clamp(min=0)
    targets = ops.encode_boxes(torch.gather(gt_boxes, 1, gi[..., None].expand(*gi.shape, 4)), anc[idx])
    sd = torch.gather(dlt, 1, idx[..., None].expand(*idx.shape, 4))
    box_loss = torch.where(is_pos & valid, smooth_l1(sd - targets, 1.0 / 9.0).sum(-1), 0.0).sum(-1) / num
    o = torch.gather(obj, 1, idx)
    lab = (is_pos & valid).float()
    bce = o.clamp(min=0) - o * lab + torch.log1p(torch.exp(-o.abs()))
    return (torch.where(valid, bce, 0.0).sum(-1) / num).mean(), box_loss.mean()


# ---------------------------------------------------------------- SlowFast


def pathway_kernel_sizes(size):
    div, rem = divmod(size, 3)
    return ((div, div + 1, div + 1), (div + 1, div + 1, div + 1), (div + 1, div + 1, div + 2))[rem]


def fuse_kernel_size(slow_in, slow_k, fast_in, fast_k):
    out_s, out_f = slow_in - slow_k + 1, fast_in - fast_k + 1
    return out_f - out_s + 1, out_s, out_f


class SlowFast(nn.Module):
    """The two-pathway temporal block of one FPN level, shared by P2-P5."""

    def __init__(self, slow, fast, channels=256):
        super().__init__()
        self.slow, self.fast = slow, fast
        ks, kf = pathway_kernel_sizes(slow), pathway_kernel_sizes(fast)
        kfuse1, s1, f1 = fuse_kernel_size(slow, ks[0], fast, kf[0])
        kfuse2, _, _ = fuse_kernel_size(s1, ks[1], f1, kf[1])

        def conv(cin, cout, kt):
            return nn.Conv3d(cin, cout, (kt, 3, 3), padding=(0, 1, 1))

        def fuse(kt):
            return nn.Conv3d(32, 64, (kt, 1, 1), bias=False)

        self.fast_conv1, self.bn_f1 = conv(channels, 32, kf[0]), nn.BatchNorm3d(32)
        self.slow_conv1, self.bn_s1 = conv(channels, 192, ks[0]), nn.BatchNorm3d(192)
        self.conv_f2s1, self.bn_f2s1 = fuse(kfuse1), nn.BatchNorm3d(64)
        self.fast_conv2, self.bn_f2 = conv(32, 32, kf[1]), nn.BatchNorm3d(32)
        self.slow_conv2, self.bn_s2 = conv(256, 192, ks[1]), nn.BatchNorm3d(192)
        self.conv_f2s2, self.bn_f2s2 = fuse(kfuse2), nn.BatchNorm3d(64)
        self.fast_conv3, self.bn_f3 = conv(32, 32, kf[2]), nn.BatchNorm3d(32)
        self.slow_conv3, self.bn_s3 = conv(256, 224, ks[2]), nn.BatchNorm3d(224)

    def temporal(self, x, weight, bias, padding):
        """Valid-time conv of a clip [T, C, H, W]: out[t] = sum_i conv2d(x[t + i], w[:, :, i]) + b.
        PyTorch's own convolution (im2col and a GEMM), not cuDNN's: cuDNN's
        heuristic picks float32 kernels for these shapes that run ten times
        slower, and its autotuning costs more than the whole reference."""
        kt = weight.shape[2]
        tout = x.shape[0] - kt + 1
        out = None
        for i in range(kt):
            xi, wi = _operands(self, x[i : i + tout], weight[:, :, i].contiguous())
            with torch.backends.cudnn.flags(enabled=False):
                o = F.conv2d(xi, wi, padding=padding)
            out = o if out is None else out + o
        return out if bias is None else out + bias.to(x.dtype)[:, None, None]

    def conv_bn(self, x, conv, bn, relu):
        if not self.training:
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * s
            w = conv.weight * s[:, None, None, None, None]
            b = shift if conv.bias is None else conv.bias * s + shift
            y = self.temporal(x, w, b, conv.padding[1:])
        else:
            y = self.temporal(x, conv.weight, conv.bias, conv.padding[1:])
            yf = y.to(torch.float32)
            mean = yf.mean(dim=(0, 2, 3))
            var = ((yf * yf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                bn.running_mean.mul_(0.9).add_(0.1 * mean)
                bn.running_var.mul_(0.9).add_(0.1 * var)
            inv = torch.rsqrt(var + bn.eps) * bn.weight
            y = ((yf - mean[:, None, None]) * inv[:, None, None] + bn.bias[:, None, None]).to(x.dtype)
        return F.relu(y) if relu else y

    def forward(self, x):
        """x: a clip [T + F - 1, H, W, C] with its halo -> [T, H, W, 256]."""
        s, f = self.slow, self.fast
        x = nchw(x).contiguous()
        t = x.shape[0] - (f - 1)
        d = f // 2 - s // 2
        slow_x, fast_x = x[d : d + t + s - 1], x
        slow_x = self.conv_bn(slow_x, self.slow_conv1, self.bn_s1, True)
        fast_x = self.conv_bn(fast_x, self.fast_conv1, self.bn_f1, True)
        slow_x = torch.cat([slow_x, self.conv_bn(fast_x, self.conv_f2s1, self.bn_f2s1, True)], 1)
        slow_x = self.conv_bn(slow_x, self.slow_conv2, self.bn_s2, True)
        fast_x = self.conv_bn(fast_x, self.fast_conv2, self.bn_f2, True)
        slow_x = torch.cat([slow_x, self.conv_bn(fast_x, self.conv_f2s2, self.bn_f2s2, True)], 1)
        slow_x = self.conv_bn(slow_x, self.slow_conv3, self.bn_s3, False)
        fast_x = self.conv_bn(fast_x, self.fast_conv3, self.bn_f3, False)
        return nhwc(torch.cat([slow_x, fast_x], 1))


# ---------------------------------------------------------------- RoI heads


class BoxHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc6 = Linear(256 * 7 * 7, 1024)
        self.fc7 = Linear(1024, 1024)


class BoxPredictor(nn.Module):
    def __init__(self, k):
        super().__init__()
        self.cls_score = Linear(1024, k)
        self.bbox_pred = Linear(1024, k * 4)


class MaskHead(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(256, 256, 3, padding=1))


class MaskPredictor(nn.Module):
    def __init__(self, k):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(256, 256, 2, 2)
        self.mask_fcn_logits = Conv2d(256, k, 1)


class RoIHeads(nn.Module):
    def __init__(self, k):
        super().__init__()
        self.box_head, self.box_predictor = BoxHead(), BoxPredictor(k)
        self.mask_head, self.mask_predictor = MaskHead(), MaskPredictor(k)

    def box_predict(self, pooled):
        """[N, 7, 7, C] -> (logits [N, K], deltas [N, K, 4])."""
        x = nchw(pooled).reshape(pooled.shape[0], -1)
        x = F.relu(self.box_head.fc7(F.relu(self.box_head.fc6(x))))
        return self.box_predictor.cls_score(x), self.box_predictor.bbox_pred(x).reshape(x.shape[0], -1, 4)

    def mask_predict(self, pooled):
        """[N, 14, 14, C] -> logits [N, 28, 28, K]."""
        x = nchw(pooled)
        for i in range(1, 5):
            x = F.relu(getattr(self.mask_head, f"mask_fcn{i}")(x))
        return nhwc(self.mask_predictor.mask_fcn_logits(F.relu(self.mask_predictor.conv5_mask(x))))


class Model(nn.Module):
    """SlowFast Mask R-CNN under the port's state-dict names."""

    def __init__(self, slow: int, fast: int, cfg: Detection, rank_dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.rank_dtype = rank_dtype
        self.backbone = Backbone()
        self.rpn = RPN()
        self.roi_heads = RoIHeads(cfg.num_classes)
        self.slow_fast = SlowFast(slow, fast)


def postprocess(class_logits, box_regression, proposals, prop_valid, image_hw, cfg: Detection,
                rank_dtype=torch.float32):
    """Softmax, per-class decode and clip, score threshold, min size,
    class-keyed NMS at 0.5, top detections. Also returns every proposal's
    foreground candidate (boxes [..., P(K-1), 4], scores), before the
    threshold and the NMS. The class logits are values of `rank_dtype` (as
    `filter_proposals`'s objectness), so that the scores rank and tie as
    the model's do."""
    k = class_logits.shape[-1]
    lead, p = proposals.shape[:-2], proposals.shape[-2]
    scores = torch.softmax(class_logits.to(rank_dtype).float(), dim=-1)
    boxes = ops.clip_boxes(ops.decode_boxes(box_regression, proposals[..., :, None, :], cfg.bbox_reg_weights), image_hw)
    fg_boxes = boxes[..., 1:, :].reshape(*lead, -1, 4)
    fg_scores = scores[..., 1:].reshape(*lead, -1)
    fg_labels = torch.arange(1, k, dtype=torch.int32, device=proposals.device).repeat(p).expand(*lead, -1)
    fg_valid = prop_valid.repeat_interleave(k - 1, dim=-1)
    valid = fg_valid & (fg_scores > cfg.box_score_thresh) & ops.remove_small_boxes_mask(fg_boxes, cfg.box_min_size)
    keep = ops.batched_nms_keep(fg_boxes, fg_scores, fg_labels, valid, cfg.box_nms_thresh)
    idx, out_valid = ops.top_k_after_nms(keep, fg_scores, cfg.detections_per_img)
    det = (torch.gather(fg_boxes, -2, idx[..., None].expand(*idx.shape, 4)), torch.gather(fg_scores, -1, idx),
           torch.gather(fg_labels, -1, idx), out_valid)
    return det, (fg_boxes, torch.where(fg_valid, fg_scores, 0.0))


def select_training_samples(proposals, prop_valid, gt_boxes, gt_labels, gt_valid, cfg: Detection, u_pos, u_neg):
    props = torch.cat([proposals, gt_boxes], -2)
    pvalid = torch.cat([prop_valid, gt_valid], -1)
    iou = torch.where(pvalid[..., None], ops.box_iou(props, gt_boxes), -1.0)
    matches = match_to_gt(iou, gt_valid, cfg.box_fg_iou, cfg.box_bg_iou, False)
    pos_mask, neg_mask = sample_balanced((matches >= 0) & pvalid, (matches == BELOW_LOW) & pvalid, u_pos, u_neg,
                                         cfg.box_batch_size_per_image, cfg.box_positive_fraction)
    total = min(cfg.box_batch_size_per_image, props.shape[-2])
    top, idx = ops.sort_desc(pos_mask.to(torch.int32) * 2 + neg_mask.to(torch.int32))
    top, idx = top[..., :total], idx[..., :total]
    is_pos, valid = top == 2, top > 0
    boxes = torch.gather(props, -2, idx[..., None].expand(*idx.shape, 4))
    matched = torch.gather(matches, -1, idx).clamp(min=0)
    labels = torch.where(is_pos, torch.gather(gt_labels, -1, matched), torch.zeros_like(matched))
    gtb = torch.gather(gt_boxes, -2, matched[..., None].expand(*matched.shape, 4))
    return {"boxes": boxes, "labels": labels, "reg_targets": ops.encode_boxes(gtb, boxes, cfg.bbox_reg_weights),
            "matched_gt": matched, "is_pos": is_pos, "valid": valid}


def fastrcnn_loss(class_logits, box_regression, samples):
    labels, valid = samples["labels"].long(), samples["valid"]
    num = valid.sum(-1).clamp(min=1)
    ce = -torch.gather(torch.log_softmax(class_logits, -1), -1, labels[..., None])[..., 0]
    reg = torch.gather(box_regression, -2, labels[..., None, None].expand(*labels.shape, 1, 4))[..., 0, :]
    bl = smooth_l1(reg - samples["reg_targets"], 1.0 / 9.0).sum(-1)
    return torch.where(valid, ce, 0.0).sum(-1) / num, torch.where(samples["is_pos"], bl, 0.0).sum(-1) / num


def project_masks(masks, gt_idx, boxes, out_size):
    """Gt masks [T, G, H, W] sampled at rois [T, R, 4] -> [T, R, out, out]
    (RoIAlign at scale 1, 2x2 samples a bin)."""
    h, w = masks.shape[-2:]
    t, r = boxes.shape[:2]
    b = boxes.reshape(-1, 4).float()
    out_t = torch.tensor(float(out_size), device=b.device)
    a_y = ops.interp_matrix_1d(b[:, 1], (b[:, 3] - b[:, 1]).clamp(min=1.0) / out_t, h, out_size, 2)
    a_x = ops.interp_matrix_1d(b[:, 0], (b[:, 2] - b[:, 0]).clamp(min=1.0) / out_t, w, out_size, 2)
    frame = torch.arange(t, device=b.device)[:, None]
    sel = masks.float()[frame, gt_idx].reshape(-1, h, w)
    return torch.bmm(torch.bmm(a_y, sel), a_x.transpose(1, 2)).reshape(t, r, out_size, out_size)


def maskrcnn_loss(mask_logits, targets, labels, valid):
    m = mask_logits.shape[-2]
    sel = torch.gather(mask_logits, -1, labels.long()[..., None, None, None].expand(*labels.shape, m, m, 1))[..., 0]
    bce = sel.clamp(min=0) - sel * targets + torch.log1p(torch.exp(-sel.abs()))
    return torch.where(valid, bce.mean(dim=(-2, -1)), 0.0).sum(-1) / valid.sum(-1).clamp(min=1)


# ---------------------------------------------------------------- geometry


@dataclasses.dataclass(frozen=True)
class Geometry:
    """torchvision's resize (short side to `min_size` unless the long side
    passes `max_size`, floored) and the zero-padded canvas, a multiple of 64."""

    original_hw: tuple
    min_size: int = 800
    max_size: int = 1333

    @property
    def resized_hw(self):
        h, w = self.original_hw
        s = min(self.min_size / min(h, w), self.max_size / max(h, w))
        return math.floor(h * s), math.floor(w * s)

    @property
    def canvas_hw(self):
        rh, rw = self.resized_hw
        return -(-rh // 64) * 64, -(-rw // 64) * 64

    @property
    def feature_hws(self):
        ch, cw = self.canvas_hw
        return [(ch // s, cw // s) for s in FPN_STRIDES]

    @property
    def ratios(self):
        rh, rw = self.resized_hw
        h, w = self.original_hw
        return rw / w, rh / h

    def canvas(self, images):
        """uint8 [T, H, W, 3] -> normalized, resized, padded [T, Hc, Wc, 3] f32."""
        x = images.permute(0, 3, 1, 2).float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
        rh, rw = self.resized_hw
        ch, cw = self.canvas_hw
        x = F.interpolate((x - mean) / std, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
        return F.pad(x, (0, cw - rw, 0, ch - rh)).permute(0, 2, 3, 1)

    def to_canvas(self, boxes):
        rx, ry = self.ratios
        return boxes * torch.tensor((rx, ry, rx, ry), dtype=boxes.dtype, device=boxes.device)

    def to_original(self, boxes):
        rx, ry = self.ratios
        return boxes / torch.tensor((rx, ry, rx, ry), dtype=boxes.dtype, device=boxes.device)

    def masks_to_canvas(self, masks):
        h, w = masks.shape[-2:]
        rh, rw = self.resized_hw
        ch, cw = self.canvas_hw
        x = F.interpolate(masks.reshape(-1, 1, h, w).float(), size=(rh, rw), mode="bilinear", align_corners=False,
                          antialias=False)
        return F.pad((x >= 0.5).float(), (0, cw - rw, 0, ch - rh)).reshape(*masks.shape[:-2], ch, cw)
