"""RoIAlign inputs for the PyTorch port's tests that need neither JAX nor
flax (so `tests/test_torch_cuda.py` runs on a machine that has only the
port's dependencies): rois that make duplicate and degenerate taps, rois on
the FPN level boundaries, and the `cuda_device` fixture."""
import numpy as np
import pytest
import torch

# Rois that make duplicate and degenerate taps, on a 1024x1152 canvas (P5 is
# 32x36, so a P5 roi can reach 28 distinct taps a side at pool7).
EDGE_CANVAS = (1024, 1152)
EDGE_ROIS = np.array(
    [
        [100.0, 1018.0, 106.0, 1024.0],  # samples in (H-1, H]: clamped, lo == hi
        [200.0, 200.0, 200.6, 200.4],  # sub-pixel
        [50.0, 50.0, 50.0, 50.0],  # zero area
        [-300.0, -200.0, 20.0, 10.0],  # mostly off-canvas: invalid samples
        [1100.0, 990.0, 1400.0, 1300.0],  # past the bottom-right corner
        [100.0, 2.0, 105.0, 1000.0],  # tall, ~200:1
        [5.0, 600.0, 1130.0, 650.0],  # wide, > 20:1
        [0.0, 0.0, 1000.0, 1000.0],  # P5, 28 distinct taps a side at pool7
        [300.0, 300.0, 330.0, 329.0],  # P2, a bin per ~1 px
    ],
    np.float32,
)


def edge_case_batch(rng, frames, c):
    """Pyramid [frames, H_l, W_l, c] of the 1024x1152 canvas and rois
    [frames, 24 random + the edge cases, 4], as numpy f32."""
    ch, cw = EDGE_CANVAS
    feats = [rng.normal(size=(frames, ch // s, cw // s, c)).astype(np.float32) for s in (4, 8, 16, 32)]
    xy = rng.uniform(-20, [cw, ch], (frames, 24, 2))
    wh = rng.uniform(1, 600, (frames, 24, 2))
    rois = np.concatenate([np.concatenate([xy, xy + wh], -1), np.broadcast_to(EDGE_ROIS, (frames, *EDGE_ROIS.shape))], 1)
    return feats, rois.astype(np.float32)


def clustered_batch(rng, frames, c, n=200):
    """Pyramid [frames, H_l, W_l, c] of the 1024x1152 canvas and rois
    [frames, n + 1 + the edge cases, 4], as numpy f32: n rois jittered
    around one object (a tile under it walks nearly all of them), the
    whole-level P5 roi (it meets every P5 tile) and the edge cases."""
    ch, cw = EDGE_CANVAS
    feats = [rng.normal(size=(frames, ch // s, cw // s, c)).astype(np.float32) for s in (4, 8, 16, 32)]
    obj = np.array([400.0, 300.0, 560.0, 520.0])
    jitter = obj + rng.normal(0, 1, (frames, n, 4)) * np.array([24.0, 30.0, 24.0, 30.0]) * rng.uniform(0.2, 2, (frames, n, 1))
    whole = np.broadcast_to(np.array([0.0, 0.0, cw, ch]), (frames, 1, 4))
    rois = np.concatenate([jitter, whole, np.broadcast_to(EDGE_ROIS, (frames, *EDGE_ROIS.shape))], 1)
    return feats, rois.astype(np.float32)


def boundary_rois():
    """Square rois [0, 0, a, a] whose level flips when sqrt(area) / 224 is
    taken as a multiply by float32(1/224) instead of a division: float32
    neighbours of 224 * 2^k * (1 - 1e-6), the level boundaries."""
    sides = []
    for k in (-1, 0, 1, 2):
        centre = np.float32(224 * 2.0**k * (1 - 1e-6))
        a = torch.from_numpy((centre.view(np.int32) + np.arange(-20000, 20000, dtype=np.int32)).view(np.float32))
        div = torch.floor(4 + torch.log2(a / torch.tensor(224.0) + 1e-6))
        mul = torch.floor(4 + torch.log2(a * torch.tensor(np.float32(1 / 224)) + 1e-6))
        sides.append(a[div != mul])
    sides = torch.cat(sides)
    assert len(sides) > 0
    return torch.stack([torch.zeros_like(sides), torch.zeros_like(sides), sides, sides], 1)


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; skips where CUDA is absent. Decided
    here, when the test runs, never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")
