"""The yardstick: the card's peaks, the model's FLOPs and the kernels'
operations and bytes, all computed from shapes.

FLOPs are the model's required multiply-add FLOPs of its convolutions and
matrix products (2 x outputs x taps x input channels), not what any
implementation spends: padding, gathers, NMS and the paste are left out,
so they show as lost share. The per-frame inference count is the
arithmetic of `scripts/profile_flops.py` (842.7 GFLOP a frame for 3-3 at
the 768x1344 canvas), computed here from the configuration's file.
"""
from __future__ import annotations

# NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

BF16 = 2
F32 = 4
FPN_STRIDES = (4, 8, 16, 32, 64)


def conv(hw, k, cin, cout) -> int:
    return 2 * hw[0] * hw[1] * k * k * cin * cout


def resnet50(canvas) -> int:
    h, w = canvas
    total = conv((h // 2, w // 2), 7, 3, 64)
    hw = (h // 4, w // 4)
    cin = 64
    for stage, (features, blocks) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)]):
        if stage > 0:
            hw = (hw[0] // 2, hw[1] // 2)
        for i in range(blocks):
            total += conv(hw, 1, cin if i == 0 else features * 4, features)
            total += conv(hw, 3, features, features)
            total += conv(hw, 1, features, features * 4)
            if i == 0:
                total += conv(hw, 1, cin, features * 4)
        cin = features * 4
    return total


def levels(canvas):
    return [(canvas[0] // s, canvas[1] // s) for s in FPN_STRIDES]


def fpn(canvas) -> int:
    lv = levels(canvas)[:4]
    return sum(conv(hw, 1, c, 256) for hw, c in zip(lv, (256, 512, 1024, 2048))) + sum(conv(hw, 3, 256, 256) for hw in lv)


def rpn_head(canvas) -> int:
    return sum(conv(hw, 3, 256, 256) + conv(hw, 1, 256, 3) + conv(hw, 1, 256, 12) for hw in levels(canvas))


def pathway_kernel_sizes(size: int):
    div, rem = divmod(size, 3)
    return ((div, div + 1, div + 1), (div + 1, div + 1, div + 1), (div + 1, div + 1, div + 2))[rem]


def fuse_kernel_size(slow_in, slow_k, fast_in, fast_k):
    out_s, out_f = slow_in - slow_k + 1, fast_in - fast_k + 1
    return out_f - out_s + 1, out_s, out_f


def slowfast_layers(slow: int, fast: int, outputs: int):
    """SlowFast's convolutions over a clip of `outputs` output frames and its
    halo: (name, taps, kernel, cin, cout, output frames) for each, in order.
    A valid temporal convolution of kt taps costs kt 2-D convolutions per
    output frame; an inner stage computes the frames the next stages need."""
    ks, kf = pathway_kernel_sizes(slow), pathway_kernel_sizes(fast)
    kfuse1, s1, f1 = fuse_kernel_size(slow, ks[0], fast, kf[0])
    kfuse2, _, _ = fuse_kernel_size(s1, ks[1], f1, kf[1])
    t = outputs
    s_in, f_in = t + slow - 1, t + fast - 1
    s1o, f1o = s_in - ks[0] + 1, f_in - kf[0] + 1
    s2o, f2o = s1o - ks[1] + 1, f1o - kf[1] + 1
    return [
        ("slow_conv1", ks[0], 3, 256, 192, s1o), ("fast_conv1", kf[0], 3, 256, 32, f1o),
        ("conv_f2s1", kfuse1, 1, 32, 64, f1o - kfuse1 + 1),
        ("slow_conv2", ks[1], 3, 256, 192, s2o), ("fast_conv2", kf[1], 3, 32, 32, f2o),
        ("conv_f2s2", kfuse2, 1, 32, 64, f2o - kfuse2 + 1),
        ("slow_conv3", ks[2], 3, 256, 224, s2o - ks[2] + 1), ("fast_conv3", kf[2], 3, 32, 32, f2o - kf[2] + 1),
    ]


def enhance_per_frame(canvas, slow: int, fast: int) -> int:
    """SlowFast over P2-P5 per output frame of a long clip (halo not counted)."""
    return sum(kt * conv(hw, k, cin, cout) for hw in levels(canvas)[:4]
               for _, kt, k, cin, cout, _ in slowfast_layers(slow, fast, 1))


def box_head_per_roi(num_classes: int) -> int:
    return 2 * (7 * 7 * 256 * 1024 + 1024 * 1024 + 1024 * num_classes * 5)


def mask_head_per_roi(num_classes: int, roi: int = 14) -> int:
    return 4 * conv((roi, roi), 3, 256, 256) + 2 * 4 * 256 * 256 * (2 * roi) ** 2 + conv((2 * roi, 2 * roi), 1, 256, num_classes)


def infer_flops_per_frame(cfg: dict) -> int:
    """Model FLOPs of one inference frame: backbone, FPN, RPN head on five
    levels, SlowFast on four, the box head on every proposal and the mask
    head on every detection."""
    canvas = cfg["canvas_hw"]
    det = cfg["detection"]
    return (resnet50(canvas) + fpn(canvas) + rpn_head(canvas) + enhance_per_frame(canvas, cfg["slow"], cfg["fast"])
            + det["rpn_post_nms_top_n_test"] * box_head_per_roi(det["num_classes"])
            + det["detections_per_img"] * mask_head_per_roi(det["num_classes"], det["mask_roi_size"]))


def train_flops_per_step(cfg: dict, n_center: int) -> int:
    """Model FLOPs of one unsupervised training step on a window of
    `n_center` centre frames and the halo: the frozen backbone, FPN and RPN
    head forward; SlowFast forward, its weight gradients and its input
    gradients except into the frozen features; the box head on every
    sampled roi and the mask head on every mask roi, forward, input and
    weight gradients (3x)."""
    canvas = cfg["canvas_hw"]
    det = cfg["detection"]
    k = det["num_classes"]
    frames = n_center + cfg["fast"] - 1
    total = frames * (resnet50(canvas) + fpn(canvas)) + n_center * rpn_head(canvas)
    for hw in levels(canvas)[:4]:
        for name, kt, ksz, cin, cout, t in slowfast_layers(cfg["slow"], cfg["fast"], n_center):
            fwd = t * kt * conv(hw, ksz, cin, cout)
            total += fwd * (2 if name in ("slow_conv1", "fast_conv1") else 3)
    rois = min(det["box_batch_size_per_image"], det["rpn_post_nms_top_n_train"] + det["max_gt"])
    total += 3 * n_center * rois * box_head_per_roi(k)
    total += 3 * n_center * min(det["mask_train_rois"], rois) * mask_head_per_roi(k, det["mask_roi_size"])
    return total


def k1_bound_s(superchunks: int, cfg: dict) -> float:
    """K1's least time for `superchunks` superchunks: each pools its
    proposals at 7x7 and its detections at 14x14 over 256 channels (bf16
    outputs written once, f32 rois and int32 levels read once), and each
    output element averages 2x2 bilinear samples of 4 taps (32 f32
    operations). Bytes at the HBM peak against operations at the f32 peak,
    the larger."""
    det = cfg["detection"]
    sc = cfg["superchunk"]
    total_bytes = total_ops = 0
    for rois, out in ((det["rpn_post_nms_top_n_test"], 7), (det["detections_per_img"], det["mask_roi_size"])):
        elems = sc * rois * out * out * 256
        total_bytes += elems * BF16 + sc * rois * (4 * F32 + 4)
        total_ops += elems * 32
    return superchunks * max(total_bytes / PEAK_HBM_BYTES, total_ops / PEAK_F32_FLOPS)


def bn_calls(cfg: dict, n_center: int):
    """The (rows, channels) of K6's 32 calls a training step: SlowFast's eight
    BatchNorms on each of P2-P5, rows = output frames x H x W."""
    out = []
    for hw in levels(cfg["canvas_hw"])[:4]:
        for _, _, _, _, cout, t in slowfast_layers(cfg["slow"], cfg["fast"], n_center):
            out.append((t * hw[0] * hw[1], cout))
    return out


def k6_bound_s(cfg: dict, n_center: int) -> tuple[float, float]:
    """K6's least time a step, (forward, backward): forward reads x and
    writes y once, backward reads x and dy and writes dx once, bf16, at the
    HBM peak."""
    elems = sum(r * c for r, c in bn_calls(cfg, n_center))
    return 2 * elems * BF16 / PEAK_HBM_BYTES, 3 * elems * BF16 / PEAK_HBM_BYTES
