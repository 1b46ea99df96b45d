"""The plain reference of ViTDet-B + SlowFast 3-3 inference, in plain
PyTorch, float32.

ViTDet-B as detectron2 publishes it (`modeling/backbone/vit.py`,
`projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`; Li et al.,
arXiv:2203.16527): patch embedding, the 14x14 pretraining position
embedding without its cls entry, resized bicubically to the token grid;
pre-norm blocks, windowed (14x14, zero padded after `norm1`, padded keys
attended to unmasked, cropped after `proj`) or global (blocks 2, 5, 8, 11);
attention materialized with the published `add_decomposed_rel_pos`, a
frame at a time so that it fits; the simple feature pyramid with channel
LayerNorms and P6 as `max_pool2d(P5, 1, 2)`; the 2-conv RPN head; the
4conv1fc box head and the LayerNorm mask head. SlowFast, proposal
filtering, the predictors, the postprocess and the paste are
`reference/model.py`'s, imported unchanged, as is the sequence driver
(`reference/run.py::infer_sequence`), which calls a model by the same
attribute names. Nothing of the port is imported.

The canvas is detectron2's: `ResizeShortestEdge(1024, max_size=1024)`,
whose `int(x + 0.5)` makes 480x854 576x1024, then a 1024x1024 square zero
padded after the normalization (`SquareGeometry`). RoIAlign and the box
coder stay torchvision's, as the configuration states.

`set_fp8` (the control): every convolution and linear layer, and the
attention's q, k, v and probabilities, round to float8 e4m3 with one
scale a tensor before a float32 product.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from vosbench.reference.model import (
    BoxPredictor,
    Conv2d,
    ConvTranspose2d,
    Detection,
    Geometry,
    Linear,
    MaskPredictor,
    SlowFast,
    fp8_round,
    nchw,
    nhwc,
    set_fp8,
)

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Widths:
    """ViTDet-B's widths (the defaults)."""

    embed: int = 768
    depth: int = 12
    heads: int = 12
    mlp: int = 3072
    patch: int = 16
    window: int = 14
    global_blocks: tuple = (2, 5, 8, 11)
    pretrain_grid: int = 14
    image: int = 1024


@dataclasses.dataclass(frozen=True)
class SquareGeometry(Geometry):
    """detectron2's resize (`ResizeShortestEdge.get_output_shape`, rounded
    `int(x + 0.5)`) and a `square` canvas."""

    square: int = 1024

    @property
    def resized_hw(self):
        h, w = self.original_hw
        size = float(self.min_size)
        scale = size / min(h, w)
        newh, neww = (size, scale * w) if h < w else (scale * h, size)
        if max(newh, neww) > self.max_size:
            scale = self.max_size / max(newh, neww)
            newh, neww = newh * scale, neww * scale
        return int(newh + 0.5), int(neww + 0.5)

    @property
    def canvas_hw(self):
        return self.square, self.square


# ---------------------------------------------------------------- ViT (detectron2 `vit.py` and `utils.py`)


def get_rel_pos(q_size, k_size, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1), size=max_rel_dist,
                                        mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(
        B, q_h * q_w, k_h * k_w)
    return attn


def get_abs_pos(abs_pos, has_cls_token, hw):
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    xy_num = abs_pos.shape[1]
    size = int(math.sqrt(xy_num))
    if size != h or size != w:
        new_abs_pos = F.interpolate(abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2), size=(h, w),
                                    mode="bicubic", align_corners=False)
        return new_abs_pos.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim**-0.5
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        fp8 = getattr(self, "fp8", False)
        if fp8:
            q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        if fp8:
            attn = fp8_round(attn)
        x = (attn @ v).view(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, w: Widths, window_size):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(w.embed, eps=LN_EPS)
        self.attn = Attention(w.embed, w.heads, window_size if window_size else w.image // w.patch)
        self.norm2 = nn.LayerNorm(w.embed, eps=LN_EPS)
        self.mlp = Mlp(w.embed, w.mlp)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    def __init__(self, w: Widths):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv2d(3, w.embed, w.patch, w.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + w.pretrain_grid**2, w.embed))
        self.blocks = nn.ModuleList([Block(w, 0 if i in w.global_blocks else w.window) for i in range(w.depth)])

    def forward(self, x):
        """NCHW canvas -> NHWC [B, H/16, W/16, embed]."""
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        x = x + get_abs_pos(self.pos_embed, True, (x.shape[1], x.shape[2]))
        for blk in self.blocks:
            x = blk(x)
        return x


def channel_ln(x, norm):
    """detectron2's channel LayerNorm of an NCHW tensor."""
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + norm.eps)
    return norm.weight[:, None, None] * x + norm.bias[:, None, None]


class PyramidLevel(nn.Module):
    def __init__(self, dim, scale, channels):
        super().__init__()
        self.scale = scale
        out = dim
        if scale == 4.0:
            self.deconv1 = ConvTranspose2d(dim, dim // 2, 2, 2)
            self.norm = nn.LayerNorm(dim // 2, eps=LN_EPS)
            self.deconv2 = ConvTranspose2d(dim // 2, dim // 4, 2, 2)
            out = dim // 4
        elif scale == 2.0:
            self.deconv1 = ConvTranspose2d(dim, dim // 2, 2, 2)
            out = dim // 2
        self.lateral = Conv2d(out, channels, 1, bias=False)
        self.lateral_norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.output = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.output_norm = nn.LayerNorm(channels, eps=LN_EPS)

    def forward(self, x):
        if self.scale == 4.0:
            x = self.deconv2(F.gelu(channel_ln(self.deconv1(x), self.norm)))
        elif self.scale == 2.0:
            x = self.deconv1(x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x, kernel_size=2, stride=2)
        return channel_ln(self.output(channel_ln(self.lateral(x), self.lateral_norm)), self.output_norm)


class Backbone(nn.Module):
    """The ViT and the simple feature pyramid, a frame at a time."""

    def __init__(self, w: Widths):
        super().__init__()
        self.net = ViT(w)
        for stage, scale in zip((2, 3, 4, 5), (4.0, 2.0, 1.0, 0.5)):
            self.add_module(f"simfp_{stage}", PyramidLevel(w.embed, scale, 256))

    def levels(self, frame):
        feat = self.net(frame).permute(0, 3, 1, 2)
        out = [getattr(self, f"simfp_{stage}")(feat) for stage in (2, 3, 4, 5)]
        out.append(F.max_pool2d(out[-1], kernel_size=1, stride=2, padding=0))
        return [nhwc(p) for p in out]

    def forward(self, canvas):
        """canvas [T, Hc, Wc, 3] -> 5 levels [T, h, w, 256]."""
        x = nchw(canvas).contiguous()
        per_frame = [self.levels(x[t : t + 1]) for t in range(x.shape[0])]
        return [torch.cat(lvl) for lvl in zip(*per_frame)]


# ---------------------------------------------------------------- RPN and RoI heads


class RPNHead(nn.Module):
    """detectron2's StandardRPNHead with two 3x3 convs, each with its relu."""

    def __init__(self, channels=256, anchors=3):
        super().__init__()
        self.conv = nn.ModuleList([Conv2d(channels, channels, 3, padding=1) for _ in range(2)])
        self.cls_logits = Conv2d(channels, anchors, 1)
        self.bbox_pred = Conv2d(channels, anchors * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = nchw(f)
            for conv in self.conv:
                t = F.relu(conv(t))
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


class ConvBoxHead(nn.Module):
    """FastRCNNConvFCHead, 4conv1fc with LN: 4x (3x3 conv without bias, LN,
    relu), flatten in CHW order, fc 1024, relu."""

    def __init__(self):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"conv{i}", Conv2d(256, 256, 3, padding=1, bias=False))
            self.add_module(f"norm{i}", nn.LayerNorm(256, eps=LN_EPS))
        self.fc1 = Linear(256 * 7 * 7, 1024)


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead's convs with LN: 4x (3x3 conv without bias, LN, relu)."""

    def __init__(self):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(256, 256, 3, padding=1, bias=False))
            self.add_module(f"mask_fcn{i}_norm", nn.LayerNorm(256, eps=LN_EPS))


class RoIHeads(nn.Module):
    def __init__(self, k):
        super().__init__()
        self.box_head, self.box_predictor = ConvBoxHead(), BoxPredictor(k)
        self.mask_head, self.mask_predictor = MaskHead(), MaskPredictor(k)

    def box_predict(self, pooled):
        """[N, 7, 7, C] -> (logits [N, K], deltas [N, K, 4])."""
        x = nchw(pooled)
        for i in range(1, 5):
            x = F.relu(channel_ln(getattr(self.box_head, f"conv{i}")(x), getattr(self.box_head, f"norm{i}")))
        x = F.relu(self.box_head.fc1(torch.flatten(x, start_dim=1)))
        return self.box_predictor.cls_score(x), self.box_predictor.bbox_pred(x).reshape(x.shape[0], -1, 4)

    def mask_predict(self, pooled):
        """[N, 14, 14, C] -> logits [N, 28, 28, K]."""
        x = nchw(pooled)
        for i in range(1, 5):
            x = F.relu(channel_ln(getattr(self.mask_head, f"mask_fcn{i}")(x), getattr(self.mask_head, f"mask_fcn{i}_norm")))
        return nhwc(self.mask_predictor.mask_fcn_logits(F.relu(self.mask_predictor.conv5_mask(x))))


class Model(nn.Module):
    """ViTDet-B + SlowFast under the port's state-dict names, with the
    attributes `reference/run.py::infer_sequence` calls."""

    def __init__(self, slow: int, fast: int, cfg: Detection, rank_dtype=torch.float32, widths: Widths = Widths()):
        super().__init__()
        self.cfg = cfg
        self.rank_dtype = rank_dtype
        self.backbone = Backbone(widths)
        self.rpn = RPN()
        self.roi_heads = RoIHeads(cfg.num_classes)
        self.slow_fast = SlowFast(slow, fast)


def build(slow: int, fast: int, cfg: Detection, state: dict, device, fp8: bool = False, rank_dtype=torch.float32,
          widths: Widths = Widths()) -> Model:
    """The reference in float32 with `state` loaded; `fp8` the control."""
    model = Model(slow, fast, cfg, rank_dtype, widths).to(device)
    model.load_state_dict(state, strict=True)
    set_fp8(model, fp8)
    return model.eval()
