"""The PyTorch port's checks that need the card: the RoIAlign kernel and
its backward against their plain versions, the level assignment on the
card against the CPU's, the YUV 4:2:0 decode on the card against the CPU's,
and the blocked NMS sweep on the card against the fixpoint.
Imports neither JAX's models nor flax, so it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q

Every test is marked `cuda` and skips where CUDA is absent."""
import numpy as np
import pytest
import torch

from torch_roi_cases import boundary_rois, clustered_batch, cuda_device, edge_case_batch  # noqa: F401 (fixture)
from slowfast_vos_tpu_torch.models.transform import ImageTransform
from slowfast_vos_tpu_torch.ops import nms as pnms
from slowfast_vos_tpu_torch.ops import roi_align as pra


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 256])
def test_cuda_kernel_matches_plain_version(cuda_device, c):
    """On the card, on the edge-case rois: the kernel against its plain
    version, f32 (TF32 off) atol 1e-5 + rtol 1e-5, bf16 against the plain
    version in f32 on the same bf16 inputs within one bf16 rounding (rtol
    2^-8). 256 channels are whole channel slices at both pools; 40 leave a
    partial slice, and in f32 a partial one of 16-byte vectors."""
    rng = np.random.default_rng(4)
    feats, rois = edge_case_batch(rng, 3, c=c)
    feats = [torch.from_numpy(f).to(cuda_device) for f in feats]
    rois = torch.from_numpy(rois).to(cuda_device)
    for out_size in (7, 14):
        before = pra.launches[out_size]
        got = pra.multiscale_roi_align(feats, rois, output_size=out_size)
        assert pra.launches[out_size] == before + 1
        want = pra.multiscale_roi_align_plain(feats, rois, output_size=out_size)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        f16 = [f.bfloat16() for f in feats]
        got = pra.multiscale_roi_align(f16, rois, output_size=out_size).float()
        want = pra.multiscale_roi_align_plain([f.float() for f in f16], rois, output_size=out_size)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=2.0**-8)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 256])
def test_cuda_backward_kernel_matches_plain_version(cuda_device, c):
    """On the card, on the edge-case rois: the backward kernel (K5) through
    the autograd pool against the plain backward, per pixel within
    1e-6 + 1e-5 B in f32 (TF32 off) and 1e-6 + 2^-8 B in bf16, where B is
    the plain backward of |g| (the sum of the contributions' magnitudes:
    the kernel adds them in a fixed order, but not in the plain
    version's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    feats, rois = edge_case_batch(rng, 2, c=c)
    rois = torch.from_numpy(rois).to(cuda_device)
    hws = [f.shape[1:3] for f in feats]
    for out_size in (7, 14):
        g = torch.from_numpy(rng.normal(size=(*rois.shape[:2], out_size, out_size, c)).astype(np.float32)).to(cuda_device)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-8)):
            levels = [torch.from_numpy(f).to(cuda_device, dtype).requires_grad_(True) for f in feats]
            gd = g.to(dtype)
            before = pra.launches["backward", out_size]
            pooled = pra.multiscale_roi_align(levels, rois, output_size=out_size)
            got = torch.autograd.grad(pooled, levels, gd)
            assert pra.launches["backward", out_size] == before + 1
            want = pra.multiscale_roi_align_backward_plain(gd.float(), rois, hws, output_size=out_size)
            bound = pra.multiscale_roi_align_backward_plain(gd.float().abs(), rois, hws, output_size=out_size)
            for gl, wl, bl in zip(got, want, bound):
                assert gl.dtype == dtype and gl.shape == wl.shape
                assert bool(((gl.float() - wl).abs() <= 1e-6 + rtol * bl).all()), (out_size, dtype)


def _backward_inputs(cuda_device, rng, feats, rois, out_size):
    rois = torch.from_numpy(rois).to(cuda_device)
    g = rng.normal(size=(*rois.shape[:2], out_size, out_size, feats[0].shape[-1])).astype(np.float32)
    return rois, torch.from_numpy(g).to(cuda_device), [f.shape[1:3] for f in feats]


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [7, 14])
def test_cuda_backward_kernel_is_deterministic(cuda_device, out_size):
    """Two backward calls on the same inputs give the same bits, f32 and
    bf16: every gradient pixel sums its rois' contributions in one fixed
    order. On the clustered batch, where most rois overlap."""
    rng = np.random.default_rng(6)
    feats, rois = clustered_batch(rng, 2, c=64)
    rois, g, hws = _backward_inputs(cuda_device, rng, feats, rois, out_size)
    for dtype in (torch.float32, torch.bfloat16):
        first = pra.roi_align_backward_cuda(g.to(dtype), rois, hws, output_size=out_size)
        second = pra.roi_align_backward_cuda(g.to(dtype), rois, hws, output_size=out_size)
        assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(first, second)), dtype


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 256])
def test_cuda_backward_kernel_matches_plain_on_clustered_rois(cuda_device, c):
    """On the card, 200 rois jittered around one object, the whole-level P5
    roi and the edge cases: the backward kernel against the plain backward
    per pixel within 1e-6 + rtol B (B the plain backward of |g|), rtol 1e-5
    in f32 (TF32 off) and 2^-8 in bf16, at both pools. 40 channels leave a
    partial channel slice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    feats, rois = clustered_batch(rng, 2, c=c)
    for out_size in (7, 14):
        rois_t, g, hws = _backward_inputs(cuda_device, rng, feats, rois, out_size)
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-8)):
            gd = g.to(dtype)
            got = pra.roi_align_backward_cuda(gd, rois_t, hws, output_size=out_size)
            want = pra.multiscale_roi_align_backward_plain(gd.float(), rois_t, hws, output_size=out_size)
            bound = pra.multiscale_roi_align_backward_plain(gd.float().abs(), rois_t, hws, output_size=out_size)
            for gl, wl, bl in zip(got, want, bound):
                assert gl.dtype == dtype and gl.shape == wl.shape
                assert bool(((gl.float() - wl).abs() <= 1e-6 + rtol * bl).all()), (out_size, dtype)


@pytest.mark.cuda
def test_cuda_backward_kernel_all_invalid_rois_give_zero(cuda_device):
    """Rois whose samples all fall outside [-1, H] (above, left of, and
    beyond the canvas, on every level) add nothing: the gradient is exactly
    zero, f32 and bf16, at both pools."""
    rng = np.random.default_rng(8)
    feats, _ = edge_case_batch(rng, 2, c=16)
    boxes = np.array([[-900.0, -900.0, -500.0, -500.0], [-2000.0, 10.0, -1200.0, 900.0],
                      [1300.0, 1100.0, 1900.0, 1500.0], [10.0, 1300.0, 20.0, 1310.0], [-100.0, -100.0, -60.0, -60.0]])
    rois = np.broadcast_to(boxes, (2, *boxes.shape)).astype(np.float32).copy()
    for out_size in (7, 14):
        rois_t, g, hws = _backward_inputs(cuda_device, rng, feats, rois, out_size)
        for dtype in (torch.float32, torch.bfloat16):
            got = pra.roi_align_backward_cuda(g.to(dtype), rois_t, hws, output_size=out_size)
            assert all(gl.dtype == dtype and not gl.any() for gl in got), (out_size, dtype)


@pytest.mark.cuda
def test_level_assignment_on_the_card_matches_cpu(cuda_device):
    """At the level boundaries the card must divide as the CPU does."""
    rois = boundary_rois()
    torch.testing.assert_close(pra.fpn_level_assignment(rois.to(cuda_device)).cpu(), pra.fpn_level_assignment(rois))


@pytest.mark.cuda
def test_from_yuv420_on_the_card_matches_cpu(cuda_device):
    """The same uint8 planes decoded on the card and on the CPU, f32 (the
    resize tolerance of tests/test_torch_models.py, atol 1e-4)."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.integers(0, 256, (3, 120, 200), dtype=np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (3, 60, 100, 2), dtype=np.uint8))
    tf = ImageTransform((120, 200), min_size=128, max_size=256)
    got = tf.from_yuv420(y.to(cuda_device), uv.to(cuda_device))
    torch.testing.assert_close(got.cpu(), tf.from_yuv420(y, uv), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_blocked_nms_on_the_card_matches_fixpoint(cuda_device):
    """Blocked sweep (B = 128, a ragged last block) on the card against the
    fixpoint on the card and on the CPU, index for index, on quantized
    boxes and scores (ties across block boundaries), two problems."""
    rng = np.random.default_rng(8)
    n = 1500
    xy = rng.uniform(0, 400, (2, n, 2))
    boxes = np.round(np.concatenate([xy, xy + rng.uniform(4, 80, (2, n, 2))], -1) / 8) * 8
    boxes = torch.from_numpy(boxes.astype(np.float32))
    scores = torch.from_numpy((np.round(rng.uniform(0, 1, (2, n)) * 16) / 16).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(2, n)) > 0.1)
    want = pnms.nms_mask(boxes, scores, valid, iou_threshold=0.7, algorithm="fixpoint")
    on_card = [b.to(cuda_device) for b in (boxes, scores, valid)]
    for algorithm in ("blocked", "fixpoint"):
        keep, order = pnms.nms_mask(*on_card, iou_threshold=0.7, algorithm=algorithm)
        assert torch.equal(order.cpu(), want[1]) and torch.equal(keep.cpu(), want[0]), algorithm
