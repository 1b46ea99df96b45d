"""ViTDet's backbone: a plain ViT with windowed and global attention, and
the simple feature pyramid.

ViTDet-B (Li, Mao, Girshick, He, "Exploring Plain Vision Transformer
Backbones for Object Detection", arXiv:2203.16527; detectron2
`modeling/backbone/vit.py`, `projects/ViTDet/configs/COCO/
mask_rcnn_vitdet_b_100ep.py`): patches of 16 embedded to 768 channels, the
absolute position embedding of a 224 pretraining (14x14, its cls entry
dropped) interpolated bicubically to the token grid, 12 pre-norm blocks of
12 heads of 64 with an exact-GELU MLP of 3072, LayerNorm eps 1e-6 and qkv
bias. Blocks 2, 5, 8 and 11 attend over the whole grid, the others within
14x14 windows; every block adds decomposed relative positions
(`ops/attention.py`, K7). In a window block the grid is zero padded after
`norm1` to a multiple of the window (64 -> 70), the padded tokens carry
only the qkv bias and are attended to unmasked, and they are cropped after
`proj`, as detectron2 does.

`SimpleFeaturePyramid` turns the stride-16 map into P2-P5 (scales 4, 2, 1,
1/2: two 2x2 deconvolutions with a LayerNorm and GELU between, one, none,
a 2x2 max pool), each then a 1x1 and a 3x3 convolution to 256 channels
without bias, each followed by a LayerNorm over channels, and P6 as the
stride-2 subsample of P5. It emits the NHWC levels of `ResNet50FPN`, so
SlowFast, the RPN and the RoI pools take it unchanged.

Module names follow detectron2's where it has one (`net.patch_embed.proj`,
`net.pos_embed`, `net.blocks.<i>.attn.qkv`, `.rel_pos_h`, `.mlp.fc1`,
`simfp_<stage>`). Compute runs in the backbone's dtype; the matrix products
of qkv, proj and the MLP go to `F.linear`.

Stage marks (`utils/profiling.py::TRACER`), read under graphs:
`vit.patch_embed`, `vit.window` and `vit.global` (one a block, summed by
kind), `pyramid`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from slowfast_vos_tpu_torch.models.layers import (
    LN_EPS,
    Conv2d,
    ConvTranspose2d,
    Linear,
    channel_norm,
    layer_norm,
    nchw,
    nhwc,
)
from slowfast_vos_tpu_torch.ops.attention import attention, rel_pos_terms
from slowfast_vos_tpu_torch.utils.profiling import TRACER

CHANNELS = 256  # the pyramid's width: the RPN head, SlowFast and the RoI heads take 256


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViTDet-B's widths (the defaults) and the square canvas it reads."""

    embed: int = 768
    depth: int = 12
    heads: int = 12
    mlp: int = 3072
    patch: int = 16
    window: int = 14
    global_blocks: tuple = (2, 5, 8, 11)
    pretrain_grid: int = 14
    image: int = 1024

    @property
    def grid(self) -> int:
        return self.image // self.patch


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> ([B * nw, window, window, C], padded (Hp, Wp)), zero
    padded at the bottom and right."""
    b, h, w, c = x.shape
    ph, pw = -h % window, -w % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // window, window, wp // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    """The inverse of `window_partition`, cropped to `hw`."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.view(b, hp // window, wp // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def abs_pos(pos_embed: torch.Tensor, hw, dtype) -> torch.Tensor:
    """detectron2's `get_abs_pos`: the pretraining grid without its cls
    entry, bicubically resized (align_corners=False) to `hw`: [1, H, W, C]."""
    grid = int((pos_embed.shape[1] - 1) ** 0.5)
    table = pos_embed[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
    if (grid, grid) != tuple(hw):
        table = F.interpolate(table, size=hw, mode="bicubic", align_corners=False)
    return table.permute(0, 2, 3, 1).to(dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, input_size: int):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.scale = self.head_dim**-0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, self.head_dim))

    def forward(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        b, h, w, c = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # [B, heads, N, hd] views
        rel_h, rel_w = rel_pos_terms(q, self.rel_pos_h, self.rel_pos_w, (h, w))
        out = attention(q, k, v, rel_h, rel_w, self.scale, kind)  # [B, N, heads, hd]
        return self.proj(out.reshape(b, h, w, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, window: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(cfg.embed, eps=LN_EPS)
        self.attn = Attention(cfg.embed, cfg.heads, window if window else cfg.grid)
        self.norm2 = nn.LayerNorm(cfg.embed, eps=LN_EPS)
        self.mlp = Mlp(cfg.embed, cfg.mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = layer_norm(x, self.norm1)
        if self.window:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window)
            x = window_unpartition(self.attn(x, "window"), self.window, pad_hw, hw)
        else:
            x = self.attn(x, "global")
        x = shortcut + x
        return x + self.mlp(layer_norm(x, self.norm2))


class ViT(nn.Module):
    """Patch embedding, the absolute positions and the blocks: [T, Hc, Wc, 3]
    NHWC canvas -> [T, Hc/16, Wc/16, embed] NHWC."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv2d(3, cfg.embed, cfg.patch, cfg.patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pretrain_grid**2, cfg.embed))
        self.blocks = nn.ModuleList(
            [Block(cfg, 0 if i in cfg.global_blocks else cfg.window) for i in range(cfg.depth)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc(self.patch_embed.proj(x)).contiguous()
        x = x + abs_pos(self.pos_embed, x.shape[1:3], x.dtype)
        TRACER.mark("vit.patch_embed")
        for blk in self.blocks:
            x = blk(x)
            TRACER.mark("vit.window" if blk.window else "vit.global")
        return x


class PyramidLevel(nn.Module):
    """One scale of the simple feature pyramid: `up` (deconvolutions, or a
    max pool for 1/2), then the 1x1 `lateral` and 3x3 `output` convolutions
    to `channels`, each with a channel LayerNorm."""

    def __init__(self, dim: int, scale: float, channels: int):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scale == 4.0:
            x = self.deconv2(F.gelu(channel_norm(self.deconv1(x), self.norm)))
        elif self.scale == 2.0:
            x = self.deconv1(x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x, 2, 2)
        x = channel_norm(self.lateral(x), self.lateral_norm)
        return channel_norm(self.output(x), self.output_norm)


class SimpleFeaturePyramid(nn.Module):
    """ViT -> NHWC P2-P6 at 256 channels: the backbone of `arch="vitdet-b"`,
    called as `ResNet50FPN` is."""

    SCALES = (4.0, 2.0, 1.0, 0.5)

    def __init__(self, cfg: ViTConfig = ViTConfig(), dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.net = ViT(cfg)
        for stage, scale in zip((2, 3, 4, 5), self.SCALES):
            self.add_module(f"simfp_{stage}", PyramidLevel(cfg.embed, scale, CHANNELS))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = nchw(images).to(self.dtype).contiguous(memory_format=torch.channels_last)
        feat = nchw(self.net(x))  # channels-last NCHW view
        levels = [getattr(self, f"simfp_{stage}")(feat) for stage in (2, 3, 4, 5)]
        levels.append(F.max_pool2d(levels[-1], 1, 2))
        TRACER.mark("pyramid")
        return [nhwc(p) for p in levels]
