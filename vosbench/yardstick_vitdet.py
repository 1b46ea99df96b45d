"""The yardstick of ViTDet-B + SlowFast: model FLOPs a frame and K7's
operations and bytes, from the configuration's shapes.

As `yardstick.py`: the required multiply-add FLOPs of convolutions and
matrix products (2 x outputs x taps x input channels), nothing an
implementation spends besides. The canvas is the configuration's square
(`vit.image`), never the harness's `canvas_hw`. Window blocks count their
linear layers on the zero-padded grid (70x70 for 64x64 tokens in windows
of 14), which the model computes; attention counts 4 N^2 d a head (QK^T
and the weighted sum) and the relative-position terms 2 N S d each.
"""
from __future__ import annotations

from vosbench.yardstick import (
    BF16,
    PEAK_BF16_FLOPS,
    PEAK_HBM_BYTES,
    conv,
    enhance_per_frame,
    levels,
    mask_head_per_roi,
)


def canvas(cfg: dict) -> tuple[int, int]:
    side = cfg["vit"]["image"]
    return side, side


def blocks(v: dict):
    """(kind, tokens a frame the linears see, sequences a frame, N, grid side)
    of each block."""
    grid = v["image"] // v["patch"]
    padded = -(-grid // v["window"]) * v["window"]
    out = []
    for i in range(v["depth"]):
        if i in v["global_blocks"]:
            out.append(("global", grid * grid, 1, grid * grid, grid))
        else:
            out.append(("window", padded * padded, (padded // v["window"]) ** 2, v["window"] ** 2, v["window"]))
    return out


def attention_call(v: dict, kind: str) -> tuple[int, int]:
    """(operations, bytes) of K7 a frame for one block of `kind`: 4 N^2 d a
    head plus the two bias adds a logit; q, k, v, o and both terms read or
    written once, bf16."""
    d = v["embed"] // v["heads"]
    _, _, seqs, n, side = next(b for b in blocks(v) if b[0] == kind)
    heads = seqs * v["heads"]
    ops = heads * (4 * n * n * d + 2 * n * n)
    nbytes = heads * (4 * n * d + 2 * n * side) * BF16
    return ops, nbytes


def vit_flops(v: dict) -> int:
    grid = v["image"] // v["patch"]
    e, d = v["embed"], v["embed"] // v["heads"]
    total = conv((grid, grid), v["patch"], 3, e)
    for _, tokens, seqs, n, side in blocks(v):
        total += 2 * tokens * e * (3 * e + e + 2 * v["mlp"])
        total += seqs * v["heads"] * (4 * n * n * d + 2 * 2 * n * side * d)
    return total


def pyramid_flops(v: dict) -> int:
    grid = v["image"] // v["patch"]
    e, c = v["embed"], 256
    deconv = 2 * (2 * grid) ** 2 * e * (e // 2)  # 2x2, stride 2: one tap an output
    total = deconv + 2 * (4 * grid) ** 2 * (e // 2) * (e // 4) + deconv
    for scale, cin in ((4, e // 4), (2, e // 2), (1, e), (0.5, e)):
        hw = (int(grid * scale), int(grid * scale))
        total += conv(hw, 1, cin, c) + conv(hw, 3, c, c)
    return total


def rpn_head_flops(cv) -> int:
    """Two 3x3 convs and the 1x1 heads on P2-P6."""
    return sum(2 * conv(hw, 3, 256, 256) + conv(hw, 1, 256, 3) + conv(hw, 1, 256, 12) for hw in levels(cv))


def box_head_per_roi(num_classes: int) -> int:
    """4conv1fc: four 3x3 convs of 256 on 7x7, fc 12544 -> 1024, the predictors."""
    return 4 * conv((7, 7), 3, 256, 256) + 2 * (7 * 7 * 256 * 1024 + 1024 * num_classes * 5)


def infer_flops_per_frame(cfg: dict) -> int:
    """Model FLOPs of one inference frame: the ViT, the pyramid, the RPN
    head on five levels, SlowFast on four, the box head on every proposal
    and the mask head on every detection."""
    v, det = cfg["vit"], cfg["detection"]
    cv = canvas(cfg)
    return (vit_flops(v) + pyramid_flops(v) + rpn_head_flops(cv) + enhance_per_frame(cv, cfg["slow"], cfg["fast"])
            + det["rpn_post_nms_top_n_test"] * box_head_per_roi(det["num_classes"])
            + det["detections_per_img"] * mask_head_per_roi(det["num_classes"], det["mask_roi_size"]))


def k7_bound_s(backbone_frames: int, cfg: dict) -> float:
    """K7's least time over `backbone_frames` frames through the backbone:
    each block's calls at the larger of operations at the bf16 peak and
    bytes at the HBM peak."""
    v = cfg["vit"]
    per_frame = 0.0
    for kind, *_ in blocks(v):
        ops, nbytes = attention_call(v, kind)
        per_frame += max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return backbone_frames * per_frame
