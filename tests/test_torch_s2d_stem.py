"""The space-to-depth stem of the PyTorch port against the JAX package's:
`space_to_depth`'s (p, q, c) channel order, the exact stem kernel remaps both
ways (and the warning when trained out-of-field taps are dropped),
`ResNet50(s2d_stem=True)` and the s2d `SlowFastMaskRCNN` against JAX's at
f32, the s2d model with a remapped conv1 against the standard model, and
`load_init` / `migrate_state_dict` carrying a checkpoint of one stem into a
model of the other."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import HW, SC, assert_detections_close
from torch_port_common import noisy_variables, t
from slowfast_vos_tpu.models import resnet_fpn as jrf
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu.models.segmentation import SlowFastMaskRCNN as JaxModel
from slowfast_vos_tpu.utils.checkpoint import migrate_params
from slowfast_vos_tpu_torch.convert import load_init, state_dict_from_flax
from slowfast_vos_tpu_torch.models import resnet_fpn as prf
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline, init_weights
from slowfast_vos_tpu_torch.models.segmentation import SlowFastMaskRCNN
from slowfast_vos_tpu_torch.train.train_step import trainable_parameters
from slowfast_vos_tpu_torch.utils.checkpoint import STEM_KEY, migrate_state_dict

# f32 convolutions of two libraries through 50 layers (tests/test_torch_models.py).
NET_ATOL = 1e-4


def w7(seed, o=64):
    return np.random.default_rng(seed).normal(size=(7, 7, 3, o)).astype(np.float32)


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 6, 10, 3)).astype(np.float32)
    got = prf.space_to_depth(t(x), 2)
    want = np.asarray(jrf.space_to_depth(jnp.asarray(x), 2))
    assert got.shape == want.shape == (2, 3, 5, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # channel (p * 2 + q) * 3 + c holds pixel (2i + p, 2j + q), channel c
    assert got[1, 2, 4, (1 * 2 + 0) * 3 + 2] == t(x)[1, 5, 8, 2]


@pytest.mark.parametrize("o", [8, 64])
def test_stem_kernel_remaps_equal_jax(o):
    w = w7(1, o)
    np.testing.assert_array_equal(prf.stem_kernel_to_s2d(w), jrf.stem_kernel_to_s2d(w))
    w44 = np.random.default_rng(2).normal(size=(4, 4, 12, o)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a random [4, 4, 12] kernel has out-of-field taps
        np.testing.assert_array_equal(prf.stem_kernel_from_s2d(w44), jrf.stem_kernel_from_s2d(w44))


def test_stem_kernel_roundtrip_both_ways():
    w = w7(3)
    s2d = prf.stem_kernel_to_s2d(w)
    np.testing.assert_array_equal(prf.stem_kernel_from_s2d(s2d), w)
    np.testing.assert_array_equal(prf.stem_kernel_to_s2d(prf.stem_kernel_from_s2d(s2d)), s2d)


def test_stem_weight_wrappers_are_the_remaps_in_oihw():
    """The OIHW pair for the port's [64, 3, 7, 7] <-> [64, 12, 4, 4]
    weights: the HWIO remaps transposed, exact both ways."""
    w = w7(4)
    oihw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    s2d = prf.stem_weight_to_s2d(oihw)
    assert tuple(s2d.shape) == (64, 12, 4, 4)
    np.testing.assert_array_equal(s2d.permute(2, 3, 1, 0).numpy(), jrf.stem_kernel_to_s2d(w))
    assert torch.equal(prf.stem_weight_from_s2d(s2d), oihw)


def test_from_s2d_warns_on_trained_out_of_field_taps():
    """A remapped kernel has zeros at the e = -4 slots (no warning); a
    fine-tuned s2d kernel may not, and dropping them warns (JAX
    `tests/test_s2d_stem.py::test_from_s2d_warns_on_trained_out_of_field_taps`)."""
    clean = prf.stem_kernel_to_s2d(w7(9))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        prf.stem_kernel_from_s2d(clean)
        prf.stem_weight_from_s2d(torch.from_numpy(clean).permute(3, 2, 0, 1))
    trained = clean.copy()
    trained[0, 2, 0:3] = 0.5  # ki = 0, pi = 0: tap ei = -4
    with pytest.warns(UserWarning, match="lossy"):
        prf.stem_kernel_from_s2d(trained)
    with pytest.warns(UserWarning, match="lossy"):
        prf.stem_weight_from_s2d(torch.from_numpy(trained).permute(3, 2, 0, 1))


@pytest.fixture(scope="module")
def s2d_models():
    """(JAX s2d model, its noisy f32 variables, the port's s2d model loaded
    strictly from `state_dict_from_flax` of them)."""
    jmodel = JaxModel(dtype=jnp.float32, s2d_stem=True)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=5)
    sd = state_dict_from_flax(variables)
    assert tuple(sd[STEM_KEY].shape) == (64, 12, 4, 4)
    pmodel = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=True)
    pmodel.load_state_dict(sd, strict=True)
    return jmodel, variables, pmodel.eval()


def test_resnet50_s2d_matches_jax(s2d_models):
    _, variables, pmodel = s2d_models
    x = np.random.default_rng(6).normal(size=(2, 64, 96, 3)).astype(np.float32)
    body = {"params": variables["params"]["backbone"]["body"]}
    want = jax.jit(jrf.ResNet50(dtype=jnp.float32, s2d_stem=True).apply)(body, jnp.asarray(x))
    with torch.inference_mode():
        got = pmodel.backbone.body(t(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=NET_ATOL)


def test_s2d_with_remapped_conv1_matches_standard_model():
    """One port model's weights, conv1 remapped, in an s2d model: the same
    FPN levels as the standard model (exact up to f32 summation order)."""
    std = init_weights(SlowFastMaskRCNN(dtype=torch.float32), seed=3).eval()
    sd = std.state_dict()
    s2d = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=True).eval()
    s2d.load_state_dict({**sd, STEM_KEY: prf.stem_weight_to_s2d(sd[STEM_KEY])}, strict=True)
    x = t(np.random.default_rng(7).normal(size=(2, 64, 128, 3)).astype(np.float32))
    with torch.inference_mode():
        for a, b in zip(s2d.backbone_feats(x), std.backbone_feats(x)):
            torch.testing.assert_close(a, b, atol=NET_ATOL, rtol=0)


def test_s2d_forward_superchunk_matches_jax():
    """A JAX s2d SlowFastMaskRCNN and the port's on one superchunk at the
    slice's shape and tolerances."""
    jpipe, jmodel = jax_build_pipeline(
        3, 3, HW, min_size=128, max_size=256, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC,
        s2d_stem=True,
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=12)
    images = np.random.default_rng(8).integers(0, 256, (SC + 2, *HW, 3), dtype=np.uint8)
    valid = np.array([False] + [True] * (SC + 1))
    images[~valid] = 0
    want = jax.device_get(jax.jit(jpipe.forward_superchunk)(variables, jnp.asarray(images), jnp.asarray(valid)))
    pipe, model = build_pipeline(
        3, 3, HW, min_size=128, max_size=256, dtype=torch.float32, device="cpu", superchunk=SC, s2d_stem=True
    )
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = [o.numpy() for o in pipe.forward_superchunk(t(images), t(valid))]
    assert_detections_close(got, want, HW[1])


def test_jax_s2d_tree_loads_into_a_7x7_model_through_migration(s2d_models):
    """`state_dict_from_flax` of a JAX s2d tree into a standard port model:
    the stem remapped as JAX's `migrate_params` remaps it."""
    _, variables, _ = s2d_models
    sd = state_dict_from_flax(variables)
    std = SlowFastMaskRCNN(dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # noisy s2d kernels carry out-of-field taps
        migrated = migrate_state_dict(sd, std.state_dict())
        jparams = migrate_params(variables["params"], {"backbone": {"body": {"conv1": {"kernel": np.zeros((7, 7, 3, 64))}}}})
    std.load_state_dict(migrated, strict=True)
    want = np.asarray(jparams["backbone"]["body"]["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(std.state_dict()[STEM_KEY].numpy(), want)


def test_migrate_state_dict_passes_other_layouts_through():
    std = SlowFastMaskRCNN(dtype=torch.float32).state_dict()
    s2d = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=True).state_dict()
    assert migrate_state_dict(std, std) is std
    assert migrate_state_dict(s2d, s2d) is s2d
    no_stem = {"rpn.head.conv.weight": std["rpn.head.conv.weight"]}
    assert migrate_state_dict(no_stem, s2d) is no_stem
    out = migrate_state_dict(std, s2d)
    assert out is not std and tuple(out[STEM_KEY].shape) == (64, 12, 4, 4)
    assert all(out[k] is std[k] for k in std if k != STEM_KEY)


@pytest.mark.parametrize("direction", ["7x7 file, s2d model", "s2d file, 7x7 model"])
def test_load_init_migrates_the_stem(direction, tmp_path):
    """A checkpoint of one stem into a model of the other: the stem is
    remapped and named in the report, every other tensor copied, and both
    models compute the same FPN levels."""
    src_s2d = direction.startswith("s2d")
    src = init_weights(SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=False), seed=4)
    if src_s2d:
        s2d = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=True)
        s2d.load_state_dict({**src.state_dict(), STEM_KEY: prf.stem_weight_to_s2d(src.state_dict()[STEM_KEY])})
        src = s2d
    path = str(tmp_path / "ckpt.pth")
    torch.save(src.state_dict(), path)
    dst = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=not src_s2d)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a remapped kernel drops nothing
        report = load_init(path, dst)
    assert report["migrated"] == [STEM_KEY]
    assert report["unused_source_keys"] == [] and report["untouched"] == []
    remap = prf.stem_weight_from_s2d if src_s2d else prf.stem_weight_to_s2d
    assert torch.equal(dst.state_dict()[STEM_KEY], remap(src.state_dict()[STEM_KEY]))
    x = t(np.random.default_rng(9).normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        for a, b in zip(dst.eval().backbone_feats(x), src.eval().backbone_feats(x)):
            torch.testing.assert_close(a, b, atol=NET_ATOL, rtol=0)


def test_load_init_same_stem_reports_no_migration_and_other_mismatches_raise(tmp_path):
    model = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=True)
    sd = model.state_dict()
    path = str(tmp_path / "same.pth")
    torch.save({STEM_KEY: sd[STEM_KEY].clone()}, path)
    assert load_init(path, model)["migrated"] == []
    torch.save({STEM_KEY: torch.zeros(64, 3, 7, 7), "backbone.body.bn1.weight": torch.ones(32)}, path)
    before = {k: v.clone() for k, v in sd.items()}
    with pytest.raises(ValueError, match="bn1.weight"):
        load_init(path, model)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())


def test_freeze_partition_finds_the_s2d_conv1():
    """`trainable_backbone_layers=5` trains conv1 under its name in either
    stem; 3 freezes it."""
    model = SlowFastMaskRCNN(dtype=torch.float32, s2d_stem=True)
    five = trainable_parameters(model, ("backbone",), trainable_backbone_layers=5)
    assert tuple(five[STEM_KEY].shape) == (64, 12, 4, 4)
    assert STEM_KEY not in trainable_parameters(model, ("backbone",), trainable_backbone_layers=3)
