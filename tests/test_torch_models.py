"""Parity of the PyTorch port's modules (`slowfast_vos_tpu_torch/models/`)
with the JAX package at f32, on the same seeded inputs and weights (JAX
variables with every leaf redrawn, carried over by `state_dict_from_flax`):
transform, FrozenBatchNorm, ResNet-50 + FPN, RPN head and proposal filtering,
SlowFast temporal fusion (eval and train mode), box and mask heads,
detection postprocess, and the training transforms of boxes and gt masks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import make_models, noisy_variables, rel_err, t
from slowfast_vos_tpu.models.anchors import grid_anchors
from slowfast_vos_tpu.models.config import DetectionConfig
from slowfast_vos_tpu.models.heads import postprocess_detections_single as jax_postprocess
from slowfast_vos_tpu.models.layers import FrozenBatchNorm as JaxFrozenBN
from slowfast_vos_tpu.models.rpn import filter_proposals as jax_filter_proposals
from slowfast_vos_tpu.models.slowfast import SlowFastTemporal as JaxSlowFast
from slowfast_vos_tpu.models.transform import ImageTransform as JaxTransform
from slowfast_vos_tpu_torch.convert.from_flax import slow_fast_state_dict
from slowfast_vos_tpu_torch.models.heads import postprocess_detections, postprocess_detections_single
from slowfast_vos_tpu_torch.models.layers import FrozenBatchNorm2d
from slowfast_vos_tpu_torch.models.rpn import filter_proposals
from slowfast_vos_tpu_torch.models.slowfast import SlowFastTemporal
from slowfast_vos_tpu_torch.models.transform import ImageTransform

# f32 convolutions in another library sum in another order; through the 50
# layers of the backbone the relative drift stays near 3e-6 (measured), so
# 1e-4 of the largest magnitude is the bound for network outputs.
NET_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return make_models(slow=3, fast=3)


def apply(jmodel, variables, method, *args, **kw):
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=method, **kw))(variables, *args)


@pytest.mark.parametrize(
    "hw,dtype",
    [((120, 200), np.uint8), ((108, 192), np.uint8), ((61, 101), np.uint8), ((119, 201), np.uint8),
     ((120, 200), np.float32)],
    ids=["hw0", "hw1", "hw2", "hw3", "float32"],
)
def test_transform_matches_jax(hw, dtype):
    """uint8 frames at even and odd sizes, and float32 frames in [0, 1]."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    if dtype == np.float32:
        images = (images / 255.0).astype(np.float32)
    jt, pt = JaxTransform(hw, min_size=128, max_size=256), ImageTransform(hw, min_size=128, max_size=256)
    assert (pt.resized_hw, pt.canvas_hw) == (jt.resized_hw, jt.canvas_hw)
    got = pt(t(images))
    assert got.shape == (2, *jt.canvas_hw, 3)
    # the resize tolerance of tests/test_torch_parity.py
    np.testing.assert_allclose(got.numpy(), np.asarray(jt(jnp.asarray(images))), atol=1e-4)
    boxes = rng.uniform(0, 100, (5, 4)).astype(np.float32)
    np.testing.assert_allclose(pt.inverse_boxes(t(boxes)).numpy(), np.asarray(jt.inverse_boxes(boxes)), rtol=1e-6)


def test_frozen_batchnorm_matches_jax():
    rng = np.random.default_rng(1)
    stats = {k: rng.uniform(0.5, 1.5, 6).astype(np.float32) for k in ("scale", "bias", "mean", "var")}
    x = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    want = JaxFrozenBN(6).apply({"params": stats}, jnp.asarray(x))
    bn = FrozenBatchNorm2d(6)
    for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
        getattr(bn, name).copy_(t(stats[key]))
    got = bn(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_backbone_and_rpn_head_match_jax(models):
    jmodel, variables, pmodel = models
    images = np.random.default_rng(2).normal(size=(2, 64, 128, 3)).astype(np.float32)
    jfeats = apply(jmodel, variables, "backbone_feats", jnp.asarray(images))
    with torch.inference_mode():
        pfeats = pmodel.backbone_feats(t(images))
    assert [tuple(f.shape) for f in pfeats] == [f.shape for f in jfeats]
    for a, b in zip(pfeats, jfeats):
        assert rel_err(a, b) < NET_RTOL
    jobj, jdlt = apply(jmodel, variables, "rpn_predict", jfeats)
    with torch.inference_mode():
        pobj, pdlt = pmodel.rpn_predict([t(f) for f in jfeats])
    for a, b in zip(pobj + pdlt, list(jobj) + list(jdlt)):
        assert a.shape == b.shape
        assert rel_err(a, b) < 1e-5  # two convolutions deep


def test_filter_proposals_matches_jax():
    """Tie-heavy quantized scores over two levels of different sizes
    (tests/test_rpn_postprocess.py): the same proposals, index for index."""
    cfg = DetectionConfig(rpn_pre_nms_top_n_test=32, rpn_post_nms_top_n_test=16)
    anchors = (grid_anchors((6, 6), 8, 32.0), grid_anchors((3, 3), 16, 64.0))
    rng = np.random.default_rng(7)
    obj = [(np.round(rng.normal(size=(3, h, w, 3)) * 4) / 4).astype(np.float32) for h, w in ((6, 6), (3, 3))]
    dlt = [(rng.normal(size=(3, h, w, 3, 4)) * 0.1).astype(np.float32) for h, w in ((6, 6), (3, 3))]
    jb, js, jv = jax_filter_proposals(
        [jnp.asarray(o) for o in obj], [jnp.asarray(d) for d in dlt], [jnp.asarray(a) for a in anchors],
        image_hw=(48.0, 48.0), cfg=cfg, training=False,
    )
    pb, ps, pv = filter_proposals(
        [t(o) for o in obj], [t(d) for d in dlt], [t(a) for a in anchors], image_hw=(48.0, 48.0), cfg=cfg
    )
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-4)  # decode: exp order


def _slowfast_pair(slow, fast, c=16):
    jmod = JaxSlowFast(slow=slow, fast=fast, channels=c, dtype=jnp.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((fast, 4, 4, c)))
    variables = noisy_variables(shapes, seed=slow * 10 + fast)
    pmod = SlowFastTemporal(slow, fast, channels=c, dtype=torch.float32)
    pmod.load_state_dict(slow_fast_state_dict(variables["params"], variables["batch_stats"]), strict=True)
    return jmod, variables, pmod.eval()


@pytest.mark.parametrize("slow,fast", [(1, 1), (3, 3), (1, 7), (3, 7)])
def test_slowfast_matches_jax_and_window_mode(slow, fast):
    """Whole-clip SlowFast against the JAX module (its merged stage-1 convs
    are TPU rewrites of the separate convs the port runs) and against the
    port's own per-window form (the reference's sliding window)."""
    tt, h, w = 6, 8, 8
    jmod, variables, pmod = _slowfast_pair(slow, fast)
    feats = np.random.default_rng(3).normal(size=(tt, h, w, 16)).astype(np.float32)
    want = np.asarray(jmod.apply(variables, jnp.asarray(feats)))
    with torch.inference_mode():
        got = pmod(t(feats))
        assert got.shape == (tt, h, w, 256)
        assert rel_err(got, want) < 1e-5
        left, right = fast // 2, -(-fast // 2) - 1
        padded = torch.nn.functional.pad(t(feats), (0, 0, 0, 0, 0, 0, left, right))
        for frame in range(tt):
            win = pmod(padded[frame : frame + fast], pre_padded=True)
            assert win.shape == (1, h, w, 256)
            np.testing.assert_allclose(win[0].numpy(), got[frame].numpy(), atol=1e-5, err_msg=f"frame {frame}")


def test_heads_match_jax(models):
    jmodel, variables, pmodel = models
    rng = np.random.default_rng(4)
    pooled7 = rng.normal(size=(5, 7, 7, 256)).astype(np.float32)
    pooled14 = rng.normal(size=(3, 14, 14, 256)).astype(np.float32)
    jcls, jreg = apply(jmodel, variables, "box_predict", jnp.asarray(pooled7))
    jmask = apply(jmodel, variables, "mask_predict", jnp.asarray(pooled14))
    with torch.inference_mode():
        pcls, preg = pmodel.box_predict(t(pooled7))
        pmask = pmodel.mask_predict(t(pooled14))
    assert pcls.shape == jcls.shape and preg.shape == jreg.shape and pmask.shape == jmask.shape
    for a, b in ((pcls, jcls), (preg, jreg), (pmask, jmask)):
        assert rel_err(a, b) < 1e-5


def test_postprocess_matches_jax():
    """Per-frame postprocess, and its batched form over frames, against the
    JAX function: same detections, index for index."""
    cfg = DetectionConfig(num_classes=3, detections_per_img=6)
    rng = np.random.default_rng(5)
    p = 40
    xy = rng.uniform(0, 150, (3, p, 2))
    proposals = np.concatenate([xy, xy + rng.uniform(5, 60, (3, p, 2))], -1).astype(np.float32)
    logits = (np.round(rng.normal(size=(3, p, 3)) * 2) / 2).astype(np.float32)  # tied scores
    reg = (rng.normal(size=(3, p, 3, 4)) * 0.5).astype(np.float32)
    pvalid = rng.uniform(size=(3, p)) > 0.2
    batched = postprocess_detections(t(logits), t(reg), t(proposals), t(pvalid), (120.0, 200.0), cfg)
    for f in range(3):
        want = jax_postprocess(logits[f], reg[f], proposals[f], pvalid[f], (120.0, 200.0), cfg)
        got = postprocess_detections_single(t(logits[f]), t(reg[f]), t(proposals[f]), t(pvalid[f]), (120.0, 200.0), cfg)
        for g, bg, w in zip(got, batched, want):
            np.testing.assert_array_equal(g.numpy(), bg[f].numpy())
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert got[3].any()


@pytest.mark.parametrize("slow,fast", [(1, 3), (3, 3)])
def test_slowfast_train_mode_matches_flax(slow, fast):
    """Train mode (`self.training`) against flax's
    nn.BatchNorm(use_running_average=False, momentum=0.9) on a pre-padded
    window, as the train step runs it: outputs to rel 1e-4, the updated
    running mean and variance to rel 1e-5; eval mode is untouched by it."""
    tt, h, w = 4, 6, 8
    jmod, variables, pmod = _slowfast_pair(slow, fast)
    feats = np.random.default_rng(6).normal(size=(tt + fast - 1, h, w, 16)).astype(np.float32)
    want, upd = jax.jit(
        lambda v, x: jmod.apply(v, x, train=True, pre_padded=True, mutable=["batch_stats"])
    )(variables, jnp.asarray(feats))
    pmod.train()
    got = pmod(t(feats), pre_padded=True)
    assert got.shape == (tt, h, w, 256)
    assert rel_err(got.detach(), want) < 1e-4
    new_stats = slow_fast_state_dict(variables["params"], jax.device_get(upd["batch_stats"]))
    for name, v in pmod.state_dict().items():
        if "running" in name:
            assert rel_err(v, new_stats[name]) < 1e-5, name
            assert not torch.equal(v, t(np.asarray(slow_fast_state_dict(variables["params"], variables["batch_stats"])[name])))


def test_enhance_train_mode_chains_running_stats_over_levels(models):
    """The whole model's `enhance` in train mode: the shared SlowFast module
    updates its running statistics level after level, as the four calls of
    one flax `apply` do."""
    jmodel, variables, pmodel = models
    rng = np.random.default_rng(7)
    feats = [rng.normal(size=(4, 8 // s, 12 // s, 256)).astype(np.float32) for s in (1, 1, 2, 4)]
    want, upd = jax.jit(
        lambda v, fs: jmodel.apply(v, fs, method="enhance", train=True, pre_padded=True, mutable=["batch_stats"])
    )(variables, [jnp.asarray(f) for f in feats])
    before = {k: v.clone() for k, v in pmodel.slow_fast.state_dict().items()}
    pmodel.train()
    try:
        got = pmodel.enhance([t(f) for f in feats], pre_padded=True)
        after = {k: v.clone() for k, v in pmodel.slow_fast.state_dict().items()}
    finally:  # the fixture's model is shared: back to eval and its statistics
        pmodel.eval()
        pmodel.slow_fast.load_state_dict(before)
    for a, b in zip(got, want):
        assert rel_err(a.detach(), b) < 1e-4
    new_stats = slow_fast_state_dict(variables["params"]["slow_fast"], jax.device_get(upd["batch_stats"]["slow_fast"]))
    for name, v in after.items():
        if "running" in name:
            assert rel_err(v, new_stats[name]) < 1e-5, name


def test_training_transforms_match_jax():
    """`transform_boxes` (ratios of the rounded resized size) and the gt
    mask resize to the canvas (bilinear, >= 0.5, zero pad) on enlarging
    resizes, where `jax.image.resize`'s antialiasing does not act."""
    rng = np.random.default_rng(8)
    for hw, lo, hi in (((60, 100), 64, 128), ((120, 200), 128, 256)):
        jt, pt = JaxTransform(hw, min_size=lo, max_size=hi), ImageTransform(hw, min_size=lo, max_size=hi)
        assert pt.resized_hw[0] > hw[0]
        boxes = rng.uniform(0, 100, (2, 3, 4)).astype(np.float32)
        np.testing.assert_array_equal(pt.transform_boxes(t(boxes)).numpy(), np.asarray(jt.transform_boxes(jnp.asarray(boxes))))
        masks = np.zeros((2, 3, *hw), np.uint8)
        for f in range(2):
            for g in range(3):
                y, x = rng.integers(0, hw[0] - 20), rng.integers(0, hw[1] - 30)
                masks[f, g, y : y + rng.integers(3, 20), x : x + rng.integers(3, 30)] = 1
        got = pt.masks_to_canvas(t(masks))
        rh, rw = jt.resized_hw
        ch, cw = jt.canvas_hw
        resized = jax.image.resize(jnp.asarray(masks, jnp.float32), (2, 3, rh, rw), method="bilinear")
        want = np.pad(np.asarray(resized >= 0.5, np.float32), ((0, 0), (0, 0), (0, ch - rh), (0, cw - rw)))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_filter_proposals_training_takes_train_top_n():
    cfg = DetectionConfig(rpn_pre_nms_top_n_test=8, rpn_post_nms_top_n_test=4,
                          rpn_pre_nms_top_n_train=24, rpn_post_nms_top_n_train=12)
    anchors = (grid_anchors((6, 6), 8, 32.0), grid_anchors((3, 3), 16, 64.0))
    rng = np.random.default_rng(9)
    obj = [rng.normal(size=(2, h, w, 3)).astype(np.float32) for h, w in ((6, 6), (3, 3))]
    dlt = [(rng.normal(size=(2, h, w, 3, 4)) * 0.1).astype(np.float32) for h, w in ((6, 6), (3, 3))]
    for training, post in ((False, 4), (True, 12)):
        jb, js, jv = jax_filter_proposals(
            [jnp.asarray(o) for o in obj], [jnp.asarray(d) for d in dlt], [jnp.asarray(a) for a in anchors],
            image_hw=(48.0, 48.0), cfg=cfg, training=training,
        )
        pb, ps, pv = filter_proposals(
            [t(o) for o in obj], [t(d) for d in dlt], [t(a) for a in anchors], image_hw=(48.0, 48.0), cfg=cfg, training=training
        )
        assert pb.shape == (2, post, 4)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-4)
