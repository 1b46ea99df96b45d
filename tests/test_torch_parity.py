"""Differential tests against torch (cpu), closing the torchvision-convention
parity risks WITHOUT needing torchvision itself (VERDICT.md round-1 item #3):

(a) `ImageTransform` resize — sizes AND values vs
    `F.interpolate(mode='bilinear', align_corners=False, scale_factor=s,
    recompute_scale_factor=True)`, the exact call torchvision's
    `GeneralizedRCNNTransform._resize_image_and_masks` makes
    (reference `code/helpers/model.py:283`);
(b) `match_to_gt` vs a faithful port of torchvision's `Matcher` on tie-heavy
    quantized IoU matrices (incl. the zero-best-IoU low-quality quirk);
(c) `postprocess_detections_single` vs a sequential numpy/torch oracle of
    torchvision `RoIHeads.postprocess_detections` (softmax -> per-class decode
    -> clip -> score thresh -> small-box -> batched NMS -> top-k),
    reference `code/helpers/model.py:346-347`;
(d) a full torch-built ResNet Bottleneck stage and FPN vs the flax modules
    with layout-converted weights (extends tests/test_convert.py beyond
    single layers).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from slowfast_vos_tpu.models.config import DetectionConfig
from slowfast_vos_tpu.models.matching import match_to_gt
from slowfast_vos_tpu.models.transform import ImageTransform, resized_hw


# ---------------------------------------------------------------------------
# (a) resize convention
# ---------------------------------------------------------------------------

RESOLUTIONS = [(480, 854), (500, 889), (60, 100), (480, 640), (1080, 1920), (720, 1280), (61, 101), (479, 853),
               (1079, 1919)]


@pytest.mark.parametrize("hw", RESOLUTIONS)
def test_resized_extent_matches_torch_interpolate(hw):
    h, w = hw
    s = min(800 / min(h, w), 1333 / max(h, w))
    with torch.no_grad():
        out = F.interpolate(
            torch.zeros(1, 1, h, w), scale_factor=s, mode="bilinear",
            align_corners=False, recompute_scale_factor=True,
        )
    assert resized_hw(hw) == tuple(out.shape[2:])


def test_resize_values_match_torch_bilinear():
    """Pixel values of the transform's resize (pre-normalization removed by
    using mean-0/std-1-equivalent check on the normalized output) vs torch."""
    rng = np.random.default_rng(63)
    for hw in [(48, 86), (108, 192)]:  # one upsample, one downsample
        h, w = hw
        tr = ImageTransform(hw, min_size=64, max_size=128)
        rh, rw = tr.resized_hw
        img = rng.random((2, h, w, 3)).astype(np.float32)
        got = np.asarray(tr(jnp.asarray(img)))[:, :rh, :rw]  # un-padded region

        from slowfast_vos_tpu.models.transform import IMAGENET_MEAN, IMAGENET_STD

        x = (img - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
        with torch.no_grad():
            want = F.interpolate(
                torch.tensor(x.transpose(0, 3, 1, 2)), size=(rh, rw),
                mode="bilinear", align_corners=False,
            ).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, want, atol=1e-4)


# ---------------------------------------------------------------------------
# (b) Matcher
# ---------------------------------------------------------------------------

def torch_matcher(iou_gt_by_cand, high, low, allow_low_quality):
    """Faithful port of torchvision `Matcher.__call__` +
    `set_low_quality_matches_` (match_quality_matrix is [num_gt, num_cand])."""
    matched_vals, matches = iou_gt_by_cand.max(dim=0)
    all_matches = matches.clone()
    below = matched_vals < low
    between = (matched_vals >= low) & (matched_vals < high)
    matches[below] = -1
    matches[between] = -2
    if allow_low_quality:
        highest_foreach_gt, _ = iou_gt_by_cand.max(dim=1)
        gt_pred = torch.where(iou_gt_by_cand == highest_foreach_gt[:, None])
        pred_inds = gt_pred[1]
        matches[pred_inds] = all_matches[pred_inds]
    return matches.numpy()


@pytest.mark.parametrize("thresholds,allow_low", [
    ((0.7, 0.3), True),   # RPN settings
    ((0.5, 0.5), False),  # RoI-head settings
    ((0.7, 0.3), False),
])
def test_matcher_parity_on_tie_heavy_cases(thresholds, allow_low):
    high, low = thresholds
    rng = np.random.default_rng(7)
    for trial in range(20):
        num_gt = int(rng.integers(1, 5))
        num_cand = 50
        # Quantized IoU forces frequent exact ties (incl. zeros).
        iou = rng.integers(0, 11, (num_cand, num_gt)).astype(np.float32) / 10.0
        if trial % 4 == 0:
            iou[:, 0] = 0.0  # a gt whose best IoU is exactly 0 (torch quirk)
        want = torch_matcher(torch.tensor(iou.T), high, low, allow_low)
        got = np.asarray(match_to_gt(
            jnp.asarray(iou), jnp.ones((num_gt,), bool),
            high_threshold=high, low_threshold=low, allow_low_quality=allow_low,
        ))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_matcher_padded_gt_equals_torch_on_valid_submatrix():
    rng = np.random.default_rng(11)
    iou = rng.integers(0, 11, (30, 6)).astype(np.float32) / 10.0
    gt_valid = np.array([True, True, False, True, False, False])
    want = torch_matcher(torch.tensor(iou[:, gt_valid].T), 0.7, 0.3, True)
    # map torch's submatrix gt indices back to padded indices
    remap = np.nonzero(gt_valid)[0]
    want = np.where(want >= 0, remap[np.clip(want, 0, None)], want)
    got = np.asarray(match_to_gt(
        jnp.asarray(iou), jnp.asarray(gt_valid),
        high_threshold=0.7, low_threshold=0.3, allow_low_quality=True,
    ))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (c) postprocess_detections
# ---------------------------------------------------------------------------

def _oracle_decode(deltas, boxes, weights):
    """torchvision BoxCoder.decode_single in numpy."""
    wx, wy, ww, wh = weights
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = np.minimum(deltas[..., 2] / ww, math.log(1000.0 / 16.0))
    dh = np.minimum(deltas[..., 3] / wh, math.log(1000.0 / 16.0))
    pcx = dx * widths[:, None] + ctr_x[:, None]
    pcy = dy * heights[:, None] + ctr_y[:, None]
    pw = np.exp(dw) * widths[:, None]
    ph = np.exp(dh) * heights[:, None]
    return np.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], axis=-1
    )


def _oracle_nms(boxes, scores, thresh):
    """Sequential greedy NMS, torchvision semantics (score-descending; equal
    scores keep original order via stable sort)."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        bi = boxes[i]
        for j in order:
            if suppressed[j] or j == i:
                continue
            xx1 = max(bi[0], boxes[j][0]); yy1 = max(bi[1], boxes[j][1])
            xx2 = min(bi[2], boxes[j][2]); yy2 = min(bi[3], boxes[j][3])
            inter = max(0.0, xx2 - xx1) * max(0.0, yy2 - yy1)
            a1 = (bi[2] - bi[0]) * (bi[3] - bi[1])
            a2 = (boxes[j][2] - boxes[j][0]) * (boxes[j][3] - boxes[j][1])
            union = a1 + a2 - inter
            if union > 0 and inter / union > thresh:
                suppressed[j] = True
    return np.asarray(keep, np.int64)


def _oracle_postprocess(class_logits, box_regression, proposals, image_hw, cfg):
    """torchvision RoIHeads.postprocess_detections for one image, numpy."""
    scores = np.asarray(torch.softmax(torch.tensor(class_logits), -1))
    boxes = _oracle_decode(box_regression, proposals, cfg.bbox_reg_weights)
    h, w = image_hw
    boxes[..., [0, 2]] = boxes[..., [0, 2]].clip(0, w)
    boxes[..., [1, 3]] = boxes[..., [1, 3]].clip(0, h)
    # drop background, flatten
    c = scores.shape[1]
    fb = boxes[:, 1:].reshape(-1, 4)
    fs = scores[:, 1:].reshape(-1)
    fl = np.tile(np.arange(1, c), (len(proposals), 1)).reshape(-1)
    keep = fs > cfg.box_score_thresh
    ws, hs = fb[:, 2] - fb[:, 0], fb[:, 3] - fb[:, 1]
    keep &= (ws >= cfg.box_min_size) & (hs >= cfg.box_min_size)
    fb, fs, fl = fb[keep], fs[keep], fl[keep]
    # batched_nms offset trick
    off = fl.astype(np.float64) * (fb.max() + 1.0 if len(fb) else 1.0)
    k = _oracle_nms(fb + off[:, None], fs, cfg.box_nms_thresh)
    k = k[: cfg.detections_per_img]
    return fb[k], fs[k], fl[k]


def test_postprocess_detections_parity():
    from slowfast_vos_tpu.models.heads import postprocess_detections_single

    cfg = DetectionConfig(num_classes=4, detections_per_img=12)
    rng = np.random.default_rng(17)
    image_hw = (120.0, 200.0)
    for trial in range(5):
        p = 64
        proposals = np.zeros((p, 4), np.float32)
        proposals[:, 0] = rng.uniform(0, 150, p)
        proposals[:, 1] = rng.uniform(0, 90, p)
        proposals[:, 2] = proposals[:, 0] + rng.uniform(5, 50, p)
        proposals[:, 3] = proposals[:, 1] + rng.uniform(5, 30, p)
        logits = rng.normal(size=(p, 4)).astype(np.float32) * 2
        reg = rng.normal(size=(p, 4, 4)).astype(np.float32) * 0.3

        wb, ws, wl = _oracle_postprocess(logits, reg, proposals, image_hw, cfg)

        gb, gs, gl, gv = postprocess_detections_single(
            jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(proposals),
            jnp.ones((p,), bool), image_hw, cfg,
        )
        gb, gs, gl, gv = map(np.asarray, (gb, gs, gl, gv))
        n = gv.sum()
        assert n == len(wb), f"trial {trial}: {n} vs {len(wb)} detections"
        np.testing.assert_allclose(gs[:n], ws, atol=1e-5, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(gl[:n], wl, err_msg=f"trial {trial}")
        np.testing.assert_allclose(gb[:n], wb, atol=1e-3, err_msg=f"trial {trial}")


# ---------------------------------------------------------------------------
# (d) Bottleneck stage + FPN with converted weights
# ---------------------------------------------------------------------------

def _torch_bottleneck(cin, f, stride, proj):
    m = torch.nn.Module()
    m.conv1 = torch.nn.Conv2d(cin, f, 1, bias=False)
    m.bn1 = torch.nn.BatchNorm2d(f)
    m.conv2 = torch.nn.Conv2d(f, f, 3, stride=stride, padding=1, bias=False)
    m.bn2 = torch.nn.BatchNorm2d(f)
    m.conv3 = torch.nn.Conv2d(f, f * 4, 1, bias=False)
    m.bn3 = torch.nn.BatchNorm2d(f * 4)
    m.downsample = None
    if proj:
        m.downsample = torch.nn.Sequential(
            torch.nn.Conv2d(cin, f * 4, 1, stride=stride, bias=False),
            torch.nn.BatchNorm2d(f * 4),
        )
    # randomize BN stats so the test is not trivially mean-0/var-1
    rng = np.random.default_rng(int(cin + f + stride))
    for bn in [m.bn1, m.bn2, m.bn3] + ([m.downsample[1]] if proj else []):
        with torch.no_grad():
            bn.weight.copy_(torch.tensor(rng.random(bn.num_features).astype(np.float32) + 0.5))
            bn.bias.copy_(torch.tensor(rng.normal(size=bn.num_features).astype(np.float32)))
            bn.running_mean.copy_(torch.tensor(rng.normal(size=bn.num_features).astype(np.float32)))
            bn.running_var.copy_(torch.tensor(rng.random(bn.num_features).astype(np.float32) + 0.5))
    m.eval()

    def fwd(x):
        identity = x
        out = F.relu(m.bn1(m.conv1(x)))
        out = F.relu(m.bn2(m.conv2(out)))
        out = m.bn3(m.conv3(out))
        if m.downsample is not None:
            identity = m.downsample(x)
        return F.relu(out + identity)

    m.fwd = fwd
    return m


def _bottleneck_params(tm, proj):
    from slowfast_vos_tpu.convert.torchvision_weights import _conv

    def bn(b):
        return {
            "scale": jnp.asarray(b.weight.detach().numpy()),
            "bias": jnp.asarray(b.bias.detach().numpy()),
            "mean": jnp.asarray(b.running_mean.numpy()),
            "var": jnp.asarray(b.running_var.numpy()),
        }

    p = {}
    for i in "123":
        p[f"conv{i}"] = {"kernel": jnp.asarray(_conv(getattr(tm, f"conv{i}").weight.detach().numpy()))}
        p[f"bn{i}"] = bn(getattr(tm, f"bn{i}"))
    if proj:
        p["downsample_conv"] = {"kernel": jnp.asarray(_conv(tm.downsample[0].weight.detach().numpy()))}
        p["downsample_bn"] = bn(tm.downsample[1])
    return p


@pytest.mark.parametrize("cin,f,stride,proj", [
    (64, 64, 1, True),    # layer1 block 0
    (256, 64, 1, False),  # layer1 block 1/2
    (256, 128, 2, True),  # layer2 block 0 (stride-2 path)
])
def test_bottleneck_block_parity(cin, f, stride, proj):
    from slowfast_vos_tpu.models.resnet_fpn import Bottleneck

    tm = _torch_bottleneck(cin, f, stride, proj)
    rng = np.random.default_rng(23)
    x = rng.normal(size=(2, 16, 16, cin)).astype(np.float32)
    with torch.no_grad():
        want = tm.fwd(torch.tensor(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)

    blk = Bottleneck(f, stride=stride, use_projection=proj, dtype=jnp.float32)
    got = np.asarray(blk.apply({"params": _bottleneck_params(tm, proj)}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_bottleneck_stage_chain_parity():
    """Three chained blocks (a full torchvision layer1) through converted
    weights — catches inter-block layout/padding drift single blocks miss."""
    from slowfast_vos_tpu.models.resnet_fpn import Bottleneck

    tms = [_torch_bottleneck(64, 64, 1, True),
           _torch_bottleneck(256, 64, 1, False),
           _torch_bottleneck(256, 64, 1, False)]
    rng = np.random.default_rng(29)
    x = rng.normal(size=(1, 16, 16, 64)).astype(np.float32)
    t = torch.tensor(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        for tm in tms:
            t = tm.fwd(t)
    want = t.numpy().transpose(0, 2, 3, 1)

    y = jnp.asarray(x)
    for i, tm in enumerate(tms):
        blk = Bottleneck(64, stride=1, use_projection=(i == 0), dtype=jnp.float32)
        y = blk.apply({"params": _bottleneck_params(tm, i == 0)}, y)
    np.testing.assert_allclose(np.asarray(y), want, atol=1e-3)


def test_fpn_parity():
    """torchvision FeaturePyramidNetwork(+LastLevelMaxPool) vs flax FPN with
    converted weights, on exact-power-of-two level sizes."""
    from slowfast_vos_tpu.convert.torchvision_weights import _conv
    from slowfast_vos_tpu.models.resnet_fpn import FPN

    rng = np.random.default_rng(31)
    chans = [64, 128, 256, 512]
    sizes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    inputs = [rng.normal(size=(1, h, w, c)).astype(np.float32) for (h, w), c in zip(sizes, chans)]

    inner = [torch.nn.Conv2d(c, 256, 1) for c in chans]
    layer = [torch.nn.Conv2d(256, 256, 3, padding=1) for _ in chans]

    with torch.no_grad():
        laterals = [m(torch.tensor(x.transpose(0, 3, 1, 2))) for m, x in zip(inner, inputs)]
        outs = [None] * 4
        prev = laterals[-1]
        outs[-1] = prev
        for i in range(2, -1, -1):
            up = F.interpolate(prev, size=laterals[i].shape[-2:], mode="nearest")
            prev = laterals[i] + up
            outs[i] = prev
        outs = [m(o) for m, o in zip(layer, outs)]
        pool = F.max_pool2d(outs[-1], 1, stride=2)
        want = [o.numpy().transpose(0, 2, 3, 1) for o in outs + [pool]]

    params = {}
    for i in range(4):
        params[f"inner_{i}"] = {
            "kernel": jnp.asarray(_conv(inner[i].weight.detach().numpy())),
            "bias": jnp.asarray(inner[i].bias.detach().numpy()),
        }
        params[f"layer_{i}"] = {
            "kernel": jnp.asarray(_conv(layer[i].weight.detach().numpy())),
            "bias": jnp.asarray(layer[i].bias.detach().numpy()),
        }
    got = FPN(dtype=jnp.float32).apply({"params": params}, [jnp.asarray(x) for x in inputs])
    assert len(got) == 5
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), wnt, atol=2e-4)


def test_fpn_dilated_p2_combine_matches_materialized():
    """The last-level rewrite smooth(lat)+dilconv(prev) must equal the
    materialized sum-then-smooth form (f32) — the upper levels share one
    code path with it by construction."""
    import numpy as np, jax.numpy as jnp
    from slowfast_vos_tpu.models.resnet_fpn import FPN

    rng = np.random.default_rng(11)
    chans = [64, 128, 256, 512]
    sizes = [(32, 48), (16, 24), (8, 12), (4, 6)]
    inputs = [jnp.asarray(rng.normal(size=(2, h, w, c)).astype(np.float32)) for (h, w), c in zip(sizes, chans)]
    fpn = FPN(dtype=jnp.float32)
    params = fpn.init(jax.random.PRNGKey(0), inputs)["params"]
    got = fpn.apply({"params": params}, inputs)

    # materialized reference: run the generic combine for level 0 by feeding
    # a lat whose shape defeats the 2x fast path (crop one row), then fix up.
    lat0 = jnp.einsum("nhwc,cd->nhwd", inputs[0], params["inner_0"]["kernel"][0, 0]) + params["inner_0"]["bias"]
    lat1 = jnp.einsum("nhwc,cd->nhwd", inputs[1], params["inner_1"]["kernel"][0, 0]) + params["inner_1"]["bias"]
    lat2 = jnp.einsum("nhwc,cd->nhwd", inputs[2], params["inner_2"]["kernel"][0, 0]) + params["inner_2"]["bias"]
    lat3 = jnp.einsum("nhwc,cd->nhwd", inputs[3], params["inner_3"]["kernel"][0, 0]) + params["inner_3"]["bias"]
    up = lambda x: jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    s2 = lat2 + up(lat3)
    s1 = lat1 + up(s2)
    s0 = lat0 + up(s1)
    want = jax.lax.conv_general_dilated(
        s0, params["layer_0"]["kernel"], (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + params["layer_0"]["bias"]
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want), atol=2e-4)


# ---------------------------------------------------------------------------
# (e) RPN filter_proposals vs a torchvision-transcribed oracle
# ---------------------------------------------------------------------------

def _oracle_filter_proposals(
    objectness, deltas, anchors, image_hw, *,
    pre_nms_top_n, post_nms_top_n, nms_thresh, min_size,
):
    """torchvision `RegionProposalNetwork.filter_proposals` (v0.8-era, the
    reference's vintage) for one image, numpy, transcribed step by step:
    per-level top-k of objectness (`_get_top_n_idx`), BoxCoder decode with
    the log(1000/16) clamp, clip to image, `remove_small_boxes`, level-keyed
    `batched_nms`, truncation to post_nms_top_n in NMS (score-desc) order.
    Tie semantics are made explicit with stable sorts: torch's CPU topk/sort
    keep the lower index first on equal scores, which is also `lax.top_k`'s
    documented behavior."""
    boxes_all, scores_all, levels_all = [], [], []
    for lvl, (obj, dlt, anc) in enumerate(zip(objectness, deltas, anchors)):
        scores = obj.reshape(-1)
        dl = dlt.reshape(-1, 4)
        k = min(pre_nms_top_n, len(scores))
        idx = np.argsort(-scores, kind="stable")[:k]
        boxes = _oracle_decode(dl[idx][:, None, :], anc[idx], (1.0, 1.0, 1.0, 1.0))[:, 0]
        h, w = image_hw
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
        boxes_all.append(boxes)
        scores_all.append(scores[idx])
        levels_all.append(np.full(k, lvl, np.int64))
    boxes = np.concatenate(boxes_all)
    scores = np.concatenate(scores_all)
    levels = np.concatenate(levels_all)
    ws, hs = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    keep = (ws >= min_size) & (hs >= min_size)
    boxes, scores, levels = boxes[keep], scores[keep], levels[keep]
    off = levels.astype(np.float64) * (boxes.max() + 1.0 if len(boxes) else 1.0)
    k = _oracle_nms(boxes + off[:, None], scores, nms_thresh)
    k = k[:post_nms_top_n]
    return boxes[k], scores[k]


def _rpn_case(rng, level_hw, num_anchors=3, tie_quantize=None, dup_frac=0.0):
    """Random per-level objectness/deltas/anchors; optionally quantize scores
    to force ties and duplicate anchor+delta rows to force identical boxes."""
    objectness, deltas, anchors = [], [], []
    for h, w in level_hw:
        n = h * w * num_anchors
        obj = rng.normal(size=(h, w, num_anchors)).astype(np.float32)
        if tie_quantize is not None:
            obj = (np.round(obj * tie_quantize) / tie_quantize).astype(np.float32)
        dlt = (rng.normal(size=(h, w, num_anchors, 4)) * 0.4).astype(np.float32)
        x1 = rng.uniform(0, 180, n).astype(np.float32)
        y1 = rng.uniform(0, 110, n).astype(np.float32)
        anc = np.stack(
            [x1, y1, x1 + rng.uniform(2, 60, n).astype(np.float32),
             y1 + rng.uniform(2, 40, n).astype(np.float32)], axis=1,
        )
        if dup_frac:
            ndup = int(n * dup_frac)
            src = rng.integers(0, n, ndup)
            dst = rng.integers(0, n, ndup)
            anc[dst] = anc[src]
            df = dlt.reshape(-1, 4)
            df[dst] = df[src]
            of = obj.reshape(-1)
            of[dst] = of[src]
        objectness.append(obj)
        deltas.append(dlt)
        anchors.append(anc)
    return objectness, deltas, anchors


@pytest.mark.parametrize(
    "tie_quantize,dup_frac,pre,post,min_size",
    [
        (None, 0.0, 40, 20, 1e-3),     # plain random
        (2.0, 0.3, 40, 20, 1e-3),      # heavy score ties + duplicate boxes
        (1.0, 0.5, 24, 16, 2.0),       # extreme ties + small-box filtering
    ],
)
def test_rpn_filter_proposals_parity(tie_quantize, dup_frac, pre, post, min_size):
    from slowfast_vos_tpu.models.rpn import filter_proposals_single

    rng = np.random.default_rng(41)
    image_hw = (120.0, 200.0)
    for trial in range(3):
        objectness, deltas, anchors = _rpn_case(
            rng, [(6, 6), (3, 3), (2, 2)], tie_quantize=tie_quantize, dup_frac=dup_frac
        )
        wb, wscores = _oracle_filter_proposals(
            objectness, deltas, anchors, image_hw,
            pre_nms_top_n=pre, post_nms_top_n=post,
            nms_thresh=0.7, min_size=min_size,
        )
        gb, gs, gv = filter_proposals_single(
            tuple(jnp.asarray(o) for o in objectness),
            tuple(jnp.asarray(d) for d in deltas),
            tuple(jnp.asarray(a) for a in anchors),
            image_hw=image_hw, pre_nms_top_n=pre, post_nms_top_n=post,
            nms_thresh=0.7, min_size=min_size,
        )
        gb, gs, gv = map(np.asarray, (gb, gs, gv))
        n = int(gv.sum())
        assert n == len(wb), f"trial {trial}: {n} vs {len(wb)} proposals"
        np.testing.assert_allclose(gs[:n], wscores, atol=0, err_msg=f"trial {trial}")
        np.testing.assert_allclose(gb[:n], wb, atol=1e-4, err_msg=f"trial {trial}")
