"""The YUV 4:2:0 transport of the PyTorch port against the JAX package's:
`rgb_to_yuv420` byte for byte, `ImageTransform.from_yuv420` within the
resize tolerance, and the inference slice over it (`forward_superchunk` on a
(y, uv) window, `infer_sequence(transport="yuv420")` across a carry chunk)
within the slice's tolerances (tests/test_torch_pipeline.py: flags and
labels exact, boxes 0.05 px, scores 1e-4, 1% of mask pixels).

The two transports give different pixels by design (4:2:0 chroma), so the
port's yuv420 path is held against JAX's yuv420 path, never against rgb:
with random weights the detector is chaotic under a grey level of drift."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import HW, SC, assert_detections_close, port_pipeline
from torch_port_common import noisy_variables, t
from scripts import torch_bench
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu.models.transform import ImageTransform as JaxTransform
from slowfast_vos_tpu.models.transform import rgb_to_yuv420 as jax_rgb_to_yuv420
from slowfast_vos_tpu_torch.models.transform import ImageTransform, rgb_to_yuv420

SIZES = [(120, 200), (60, 100)]


def frames(hw, n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("hw", SIZES)
def test_rgb_to_yuv420_byte_equal_to_jax(hw):
    """Both call OpenCV in this process, so the planes are equal byte for
    byte (OpenCV versions differ between machines: compare in one)."""
    images = frames(hw)
    y, uv = rgb_to_yuv420(images)
    jy, juv = jax_rgb_to_yuv420(images)
    assert y.shape == (3, *hw) and uv.shape == (3, hw[0] // 2, hw[1] // 2, 2)
    assert y.dtype == uv.dtype == np.uint8
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)


def test_rgb_to_yuv420_needs_even_sizes():
    with pytest.raises(ValueError, match="even H, W"):
        rgb_to_yuv420(frames((61, 100), n=1))


@pytest.mark.parametrize("hw", SIZES)
def test_from_yuv420_matches_jax(hw):
    """The same planes through both decoders: chroma upsample, BT.601,
    normalize, resize, pad; `test_transform_matches_jax`'s tolerance."""
    y, uv = jax_rgb_to_yuv420(frames(hw, seed=1))
    jt, pt = JaxTransform(hw, min_size=128, max_size=256), ImageTransform(hw, min_size=128, max_size=256)
    got = pt.from_yuv420(t(y), t(uv))
    want = np.asarray(jt.from_yuv420(jnp.asarray(y), jnp.asarray(uv)))
    assert got.shape == want.shape == (3, *jt.canvas_hw, 3)
    assert got.dtype == torch.float32 and got.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_yuv420_roundtrip_close():
    """RGB -> YUV 4:2:0 on the host -> the canvas on the device stays close
    to the RGB canvas on smooth content (JAX
    `test_pipeline_inference.py::test_yuv420_roundtrip_close`, its
    thresholds)."""
    tf = ImageTransform((60, 100), min_size=64, max_size=128)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:60, 0:100].astype(np.float32)
    base = np.stack([yy * 2, xx * 1.5, (yy + xx)], -1)
    imgs = np.clip(base[None] + rng.normal(0, 2, (3, 60, 100, 3)), 0, 255).astype(np.uint8)

    ref = tf(t(imgs)).numpy()
    y, uv = rgb_to_yuv420(imgs)
    got = tf.from_yuv420(t(y), t(uv)).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref)  # normalized units: 0.1 is about 5.7 grey levels
    assert np.percentile(err, 99) < 0.12, np.percentile(err, 99)
    assert err.mean() < 0.03, err.mean()


@pytest.fixture(scope="module")
def sides():
    """The JAX pipeline at the slice's shape with seeded weights, and the
    port's CPU f32 pipeline with the same weights."""
    jpipe, jmodel = jax_build_pipeline(
        3, 3, HW, min_size=128, max_size=256, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=11)
    return jpipe, variables, port_pipeline(variables)


def test_forward_superchunk_on_yuv_planes_matches_jax(sides):
    jpipe, variables, pipe = sides
    images = frames(HW, n=SC + 2, seed=4)
    feat_valid = np.array([False, True, True, True, True, True])
    images[~feat_valid] = 0
    y, uv = rgb_to_yuv420(images)
    want = jax.device_get(
        jax.jit(jpipe.forward_superchunk)(variables, (jnp.asarray(y), jnp.asarray(uv)), jnp.asarray(feat_valid))
    )
    got = [o.numpy() for o in pipe.forward_superchunk((t(y), t(uv)), t(feat_valid))]
    assert [g.shape for g in got] == [np.shape(w) for w in want]
    assert_detections_close(got, want, HW[1])


def test_infer_sequence_yuv420_matches_jax(sides):
    """Six frames: a first chunk of 4 and a ragged carry chunk of 2, both
    uploaded as planes, against JAX's `infer_sequence(transport="yuv420")`."""
    jpipe, variables, pipe = sides
    clip = frames(HW, n=6, seed=5)
    got = pipe.infer_sequence(clip, transport="yuv420")
    want = jpipe.infer_sequence(variables, clip, transport="yuv420")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["union_mask"].shape == HW and g["union_mask"].dtype == bool
        assert_detections_close(
            *[(d["boxes"], d["scores"], d["labels"], d["valid"], np.packbits(d["union_mask"], axis=-1)) for d in (g, w)],
            HW[1],
        )


def test_chunk_inputs_upload_planes_at_half_the_bytes():
    """The carry chunk's window goes up as (y, uv) uint8 planes of the SC
    new frames: half the bytes of the RGB window, the same feat_valid."""
    pipe = port_pipeline(seed=0)
    clip = frames(HW, n=6, seed=6)
    rgb, valid = pipe.chunk_inputs(clip, SC, carried=True)
    (y, uv), yuv_valid = pipe.chunk_inputs(clip, SC, carried=True, transport="yuv420")
    assert tuple(rgb.shape) == (SC, *HW, 3) and tuple(y.shape) == (SC, *HW)
    assert tuple(uv.shape) == (SC, HW[0] // 2, HW[1] // 2, 2)
    assert 2 * (y.numel() + uv.numel()) == rgb.numel()
    assert torch.equal(valid, yuv_valid)
    want_y, want_uv = rgb_to_yuv420(rgb.numpy())  # the same window, zero frames included
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(uv.numpy(), want_uv)


def test_unknown_transport_raises():
    pipe = port_pipeline(seed=0)
    with pytest.raises(ValueError, match="transport"):
        pipe.infer_sequence(frames(HW, n=2), transport="yuv422")


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_bench_device_fps_runs_either_transport(transport):
    """`torch_bench.device_fps` uploads each chunk's window in the
    transport's form and runs the superchunks (the card is its place; the
    CPU pipeline checks the plumbing and measures nothing)."""
    best, median = torch_bench.device_fps(port_pipeline(seed=0), frames(HW, n=6, seed=7), transport, runs=1)
    assert best == median > 0
