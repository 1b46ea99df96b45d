"""Parity of the PyTorch port's training pieces with the JAX package at f32
on the same seeded inputs: the matcher (exact), both samplers and the RoI
sample selection (index-exact, given the uniform draws the JAX functions
make from their key, in their split order), the RPN, Fast R-CNN and Mask
R-CNN losses (rel 1e-5) and the gt-mask projection (1e-5, also against the
gather oracle of `tests/test_train_step.py`). The port's functions take a
leading frame dimension where JAX vmaps, and each is held against the JAX
function frame by frame."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_common import t
from slowfast_vos_tpu.models import heads as jheads
from slowfast_vos_tpu.models import matching as jmatching
from slowfast_vos_tpu.models.anchors import grid_anchors
from slowfast_vos_tpu.models.config import DetectionConfig
from slowfast_vos_tpu.models.rpn import rpn_loss as jax_rpn_loss
from slowfast_vos_tpu_torch.models import heads as pheads
from slowfast_vos_tpu_torch.models import matching as pmatching
from slowfast_vos_tpu_torch.models.rpn import rpn_loss
from slowfast_vos_tpu_torch.ops.boxes import box_iou

LOSS_RTOL = 1e-5


def draws(key, n):
    """The (positive, negative) uniform draws of a JAX sampler given `key`."""
    kp, kn = jax.random.split(key)
    return np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,)))


def frame_draws(key, frames, n):
    """Per-frame draws [frames, n] of samplers vmapped over split(key, frames)."""
    pairs = [draws(k, n) for k in jax.random.split(key, frames)]
    return t(np.stack([p for p, _ in pairs])), t(np.stack([q for _, q in pairs]))


def boxes(rng, shape, extent=100.0, quantum=None):
    xy = rng.uniform(0, extent, (*shape, 2))
    wh = rng.uniform(2, extent / 2, (*shape, 2))
    b = np.concatenate([xy, xy + wh], -1)
    if quantum:  # coarse grid: duplicate boxes, exact IoU ties
        b = np.round(b / quantum) * quantum
    return b.astype(np.float32)


@pytest.mark.parametrize("allow_low", [False, True])
def test_match_to_gt_exact(allow_low):
    """Tie-heavy IoU with padded gt, a gt that overlaps nothing (its best
    IoU is 0: the low-quality rule then restores every zero-overlap
    candidate) and candidates between the thresholds."""
    rng = np.random.default_rng(0)
    gt = boxes(rng, (3, 4), quantum=10.0)
    gt[:, 3] = [500.0, 500.0, 510.0, 510.0]  # overlaps no candidate
    cand = np.concatenate([boxes(rng, (3, 40), quantum=10.0), gt], 1)
    gt_valid = rng.uniform(size=(3, 4)) > 0.2
    gt_valid[:, 3] = True
    got = pmatching.match_to_gt(
        box_iou(t(cand), t(gt)), t(gt_valid), high_threshold=0.7, low_threshold=0.3, allow_low_quality=allow_low
    )
    for f in range(3):
        want = jmatching.match_to_gt(
            jnp.asarray(box_iou(t(cand[f]), t(gt[f])).numpy()), jnp.asarray(gt_valid[f]),
            high_threshold=0.7, low_threshold=0.3, allow_low_quality=allow_low,
        )
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))
    assert (got == pmatching.BETWEEN).any() and (got == pmatching.BELOW_LOW).any()


def test_samplers_index_exact():
    """`sample_balanced` (masks) and `sample_balanced_indices` (compact):
    the same selection as JAX, entry for entry, when fewer and when more
    candidates than wanted exist in each class."""
    rng = np.random.default_rng(1)
    n = 60
    for npos, nneg in ((5, 50), (40, 10), (0, 60)):
        positive = np.zeros(n, bool)
        negative = np.zeros(n, bool)
        perm = rng.permutation(n)
        positive[perm[:npos]] = True
        negative[perm[npos : npos + nneg]] = True
        key = jax.random.PRNGKey(npos)
        up, un = draws(key, n)
        kw = dict(batch_size=32, positive_fraction=0.25)
        jp, jn = jmatching.sample_balanced(key, jnp.asarray(positive), jnp.asarray(negative), **kw)
        pp, pn = pmatching.sample_balanced(t(positive), t(negative), t(up), t(un), **kw)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
        ji, jpos, jv = jmatching.sample_balanced_indices(key, jnp.asarray(positive), jnp.asarray(negative), **kw)
        pi, ppos, pv = pmatching.sample_balanced_indices(t(positive), t(negative), t(up), t(un), **kw)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(pi.numpy()[pv.numpy()], np.asarray(ji)[np.asarray(jv)])


CFG = DetectionConfig(box_batch_size_per_image=24, max_gt=3)


def _training_inputs(rng, frames=2, p=30, g=3):
    gt = boxes(rng, (frames, g))
    gt_valid = np.ones((frames, g), bool)
    gt_valid[1, 2] = False
    # Proposals around the gt (positives) and elsewhere (negatives).
    jitter = rng.normal(size=(frames, p // 2, 4)).astype(np.float32) * 3
    near = gt[:, rng.integers(0, g, p // 2)] + jitter
    props = np.concatenate([near, boxes(rng, (frames, p - p // 2))], 1).astype(np.float32)
    pvalid = rng.uniform(size=(frames, p)) > 0.1
    labels = rng.integers(1, 3, (frames, g)).astype(np.int32)
    return props, pvalid, gt, labels, gt_valid


def _jax_samples(key, props, pvalid, gt, labels, gt_valid, cfg):
    return [
        jax.device_get(jheads.select_training_samples(
            k, jnp.asarray(props[f]), jnp.asarray(pvalid[f]), jnp.asarray(gt[f]),
            jnp.asarray(labels[f]), jnp.asarray(gt_valid[f]), cfg,
        ))
        for f, k in enumerate(jax.random.split(key, props.shape[0]))
    ]


def test_select_training_samples_index_exact():
    rng = np.random.default_rng(2)
    props, pvalid, gt, labels, gt_valid = _training_inputs(rng)
    key = jax.random.PRNGKey(3)
    up, un = frame_draws(key, 2, props.shape[1] + gt.shape[1])
    got = pheads.select_training_samples(t(props), t(pvalid), t(gt), t(labels), t(gt_valid), CFG, up, un)
    want = _jax_samples(key, props, pvalid, gt, labels, gt_valid, CFG)
    for f in range(2):
        for k in ("labels", "matched_gt", "is_pos", "valid"):
            np.testing.assert_array_equal(got[k][f].numpy(), want[f][k], err_msg=k)
        np.testing.assert_array_equal(got["boxes"][f].numpy(), want[f]["boxes"])
        np.testing.assert_allclose(got["reg_targets"][f].numpy(), want[f]["reg_targets"], atol=1e-6)
        assert want[f]["is_pos"].any() and (want[f]["valid"] & ~want[f]["is_pos"]).any()


def test_rpn_loss_matches_jax():
    """Two levels of anchors, tied objectness logits, a frame whose gt
    are all padding."""
    rng = np.random.default_rng(4)
    cfg = DetectionConfig(rpn_batch_size_per_image=64, max_gt=3)
    levels = ((8, 12), (4, 6))
    anchors = [grid_anchors(hw, s, size) for hw, s, size in zip(levels, (8, 16), (32.0, 64.0))]
    obj = [(np.round(rng.normal(size=(2, h, w, 3)) * 2) / 2).astype(np.float32) for h, w in levels]
    dlt = [(rng.normal(size=(2, h, w, 3, 4)) * 0.3).astype(np.float32) for h, w in levels]
    gt = boxes(rng, (2, 3))
    gt_valid = np.array([[True, True, False], [False, False, False]])
    key = jax.random.PRNGKey(5)
    n_anchors = sum(a.shape[0] for a in anchors)
    up, un = frame_draws(key, 2, n_anchors)
    got = rpn_loss([t(o) for o in obj], [t(d) for d in dlt], [t(a) for a in anchors], t(gt), t(gt_valid), cfg, up, un)
    want = jax_rpn_loss(
        key, [jnp.asarray(o) for o in obj], [jnp.asarray(d) for d in dlt], [jnp.asarray(a) for a in anchors],
        jnp.asarray(gt), jnp.asarray(gt_valid), cfg,
    )
    for g_, w_ in zip(got, want):
        assert float(w_) > 0
        assert abs(float(g_) - float(w_)) <= LOSS_RTOL * abs(float(w_))


def test_fastrcnn_and_maskrcnn_losses_match_jax():
    rng = np.random.default_rng(6)
    props, pvalid, gt, labels, gt_valid = _training_inputs(rng)
    key = jax.random.PRNGKey(7)
    up, un = frame_draws(key, 2, props.shape[1] + gt.shape[1])
    samples = pheads.select_training_samples(t(props), t(pvalid), t(gt), t(labels), t(gt_valid), CFG, up, un)
    want_samples = _jax_samples(key, props, pvalid, gt, labels, gt_valid, CFG)
    b, k, m = samples["boxes"].shape[1], 3, 6
    cls = rng.normal(size=(2, b, k)).astype(np.float32)
    reg = rng.normal(size=(2, b, k, 4)).astype(np.float32) * 0.5
    logits = rng.normal(size=(2, b, m, m, k)).astype(np.float32) * 3
    targets = rng.uniform(size=(2, b, m, m)).astype(np.float32)
    cl, bl = pheads.fastrcnn_loss(t(cls), t(reg), samples)
    ml = pheads.maskrcnn_loss(t(logits), t(targets), samples["labels"], samples["is_pos"])
    for f in range(2):
        s = {kk: jnp.asarray(v) for kk, v in want_samples[f].items()}
        jc, jb = jheads.fastrcnn_loss(jnp.asarray(cls[f]), jnp.asarray(reg[f]), s)
        jm = jheads.maskrcnn_loss(jnp.asarray(logits[f]), jnp.asarray(targets[f]), s["labels"], s["is_pos"])
        for got, want in ((cl[f], jc), (bl[f], jb), (ml[f], jm)):
            assert float(want) > 0
            assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))


def _gather_oracle(masks, gt_idx, boxes_, out, sr=2):
    """torchvision roi_align(spatial_scale=1) by its four bilinear taps
    (`tests/test_train_step.py:103-157`)."""
    g, h, w = masks.shape
    s = out * sr
    want = np.zeros((len(boxes_), out, out), np.float32)
    for r, (bx, gi) in enumerate(zip(boxes_, gt_idx)):
        x1, y1, x2, y2 = bx
        rh, rw = max(y2 - y1, 1.0), max(x2 - x1, 1.0)
        steps = np.arange(s) + 0.5
        acc = np.zeros((s, s), np.float32)
        for i, yc in enumerate(y1 + steps * rh / s):
            for j, xc in enumerate(x1 + steps * rw / s):
                if not (-1.0 <= yc <= h and -1.0 <= xc <= w):
                    continue
                y, x = min(max(yc, 0.0), h - 1.0), min(max(xc, 0.0), w - 1.0)
                y0, x0 = int(np.floor(y)), int(np.floor(x))
                y1i, x1i = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
                ly, lx = y - y0, x - x0
                mm = masks[gi]
                acc[i, j] = (mm[y0, x0] * (1 - ly) * (1 - lx) + mm[y0, x1i] * (1 - ly) * lx
                             + mm[y1i, x0] * ly * (1 - lx) + mm[y1i, x1i] * ly * lx)
        want[r] = acc.reshape(out, sr, out, sr).mean(axis=(1, 3))
    return want


def test_project_masks_on_boxes_matches_jax_and_gather_oracle():
    rng = np.random.default_rng(7)
    g, h, w, out = 4, 40, 64, 14
    masks = (rng.random((2, g, h, w)) > 0.5).astype(np.float32)
    bx = np.array([
        [5.3, 7.1, 30.2, 25.9],
        [-6.0, -3.0, 10.0, 12.0],  # crosses the top-left border
        [50.0, 30.0, 80.0, 55.0],  # crosses the bottom-right border
        [12.0, 9.0, 12.4, 9.2],  # sub-pixel: the 1 px floor
        [0.0, 0.0, 63.0, 39.0],  # whole canvas
    ], np.float32)
    bx = np.stack([bx, bx[::-1] + 1.5])
    gt_idx = np.array([[0, 1, 2, 3, 1], [3, 3, 0, 2, 1]])
    got = pheads.project_masks_on_boxes(t(masks), t(gt_idx), t(bx), out).numpy()
    for f in range(2):
        want = np.asarray(jheads.project_masks_on_boxes(jnp.asarray(masks[f]), jnp.asarray(gt_idx[f]), jnp.asarray(bx[f]), out))
        np.testing.assert_allclose(got[f], want, atol=1e-5)
        np.testing.assert_allclose(got[f], _gather_oracle(masks[f], gt_idx[f], bx[f], out), atol=1e-5)


def test_masks_to_sorted_indices_puts_positives_first_lower_index_first():
    rng = np.random.default_rng(8)
    pos = rng.uniform(size=(3, 50)) > 0.8
    neg = ~pos & (rng.uniform(size=(3, 50)) > 0.5)
    idx, is_pos, valid = pheads.masks_to_sorted_indices(t(pos), t(neg), 40)
    for f in range(3):
        ji, jp, jv = jheads._masks_to_sorted_indices(jnp.asarray(pos[f]), jnp.asarray(neg[f]), 40)
        np.testing.assert_array_equal(idx[f].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(is_pos[f].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(valid[f].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(valid.sum(-1).numpy(), np.minimum((pos | neg).sum(-1), 40))
