"""The PyTorch port's checks that need the card: the RoIAlign kernel and
its backward against their plain versions, and the level assignment on the
card against the CPU's.
Imports neither JAX's models nor flax, so it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -q

Every test is marked `cuda` and skips where CUDA is absent."""
import numpy as np
import pytest
import torch

from torch_roi_cases import boundary_rois, cuda_device, edge_case_batch  # noqa: F401 (fixture)
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
    the kernel's atomics add them in no fixed order)."""
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


@pytest.mark.cuda
def test_level_assignment_on_the_card_matches_cpu(cuda_device):
    """At the level boundaries the card must divide as the CPU does."""
    rois = boundary_rois()
    torch.testing.assert_close(pra.fpn_level_assignment(rois.to(cuda_device)).cpu(), pra.fpn_level_assignment(rois))
