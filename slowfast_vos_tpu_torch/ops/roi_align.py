"""Multi-scale RoIAlign over FPN levels: the CUDA kernel and its plain version.

Port of `slowfast_vos_tpu/ops/roi_align.py` (`fpn_level_assignment`,
`multiscale_roi_align`) and of the Pallas TPU kernel that carried the
1000-proposal 7x7 pool there, `slowfast_vos_tpu/ops/roi_align_pallas.py::_kernel`.
Semantics are torchvision's `aligned=False`: roi coordinates scaled with no
half-pixel offset, roi sides floored at 1, 2x2 bilinear samples per bin
averaged, samples with y < -1 or y > H (x alike) weighing zero.

`multiscale_roi_align` pools a [T, N] roi batch over 4 NHWC levels
[T, H_l, W_l, C] in one call; each roi reads the frame it belongs to.

* On CUDA tensors it launches `csrc/roi_align.cu` (one launch for the whole
  batch, f32 or bf16 features, output 7 or 14) or raises. The kernel
  samples the level directly, so it is exact: the TPU kernel's patch and
  its edge clamp for rois beyond ~5:1 (`roi_align_pallas.py:53-56`) are
  not reproduced. It pools separably, out = Wy . F[taps_y, taps_x] . Wx^T
  over each roi's distinct taps: a CTA per roi (pool7) or per (roi,
  channel slice) (pool14) builds the distinct taps, each bin's run of at
  most 4 of them and its f32 weights in shared memory once; a row pass
  over (bin, column, 16-byte channel vector) items, all loads in flight
  at once, writes f32 row sums to shared memory, and a column pass writes
  each output vector once (see the source's head note). Its bound on an
  H100 is bytes: device memory moves the output and the touched pyramid
  once (one DAVIS frame's 7x7 pool writes 25.1 MB), and L2 moves each
  roi's own footprint, the sum over rois of distinct taps x C x element
  size.
* On CPU tensors it runs `multiscale_roi_align_plain`, a transcription of
  the JAX gather form, which is also what the kernel is held against on
  the card.

FPN levels are assigned in PyTorch (`fpn_level_assignment`) for both
paths, so kernel and plain version pool every roi at the same level.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Sequence

import torch

from slowfast_vos_tpu_torch.ops import cuda_build

ROI_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)

# Kernel launches by output size; `chip_smoke.py` reads them to show that
# the main path went through the kernel.
launches: collections.Counter = collections.Counter()


def fpn_level_assignment(
    rois: torch.Tensor,
    num_levels: int = 4,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
    min_level: int = 2,
) -> torch.Tensor:
    """FPN level index per roi (torchvision LevelMapper):
    k = floor(k0 + log2(sqrt(area)/224 + 1e-6)), clamped to
    [min_level, min_level+num_levels-1], returned 0-based int32. The scale
    divides as a device tensor (see `sample_grid`): multiplying by its
    reciprocal, as CUDA division by a Python number does, moves rois at a
    level boundary to another level than the CPU's and JAX's."""
    wh = rois[..., 2:] - rois[..., :2]
    area = (wh[..., 0] * wh[..., 1]).clamp(min=0.0)
    scale = torch.full((), canonical_scale, dtype=area.dtype, device=area.device)
    k = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / scale + 1e-6))
    k = k.clamp(min_level, min_level + num_levels - 1)
    return (k - min_level).to(torch.int32)


def sample_grid(
    level_hws: Sequence[tuple[int, int]],
    rois: torch.Tensor,
    spatial_scales: Sequence[float] = ROI_SCALES,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> dict[str, torch.Tensor]:
    """Bilinear taps of every sample of every roi, as the gather form
    computes them (`roi_align.py:156-191`). rois: [T, N, 4]; levels are
    [T, H_l, W_l, C] with (H_l, W_l) in `level_hws`, flattened frame-major
    and level after level into one buffer of pixels.

    Returns [M = T*N] per-roi tensors `base` (the flat offset of the roi's
    frame on its level) and `width`, and [M, S = out*sr] per-axis tensors:
    tap indices `y0, y1, x0, x1`, fractions `ly, lx` (f32) and sample
    validity `my, mx`."""
    t, n = rois.shape[:2]
    dev = rois.device
    hs = torch.tensor([h for h, _ in level_hws], dtype=torch.float32, device=dev)
    ws = torch.tensor([w for _, w in level_hws], dtype=torch.float32, device=dev)
    plane = [h * w for h, w in level_hws]
    bases = torch.tensor([0] + [t * p for p in plane][:-1], device=dev).cumsum(0)
    planes = torch.tensor(plane, device=dev)
    scales = torch.tensor(list(spatial_scales), dtype=torch.float32, device=dev)

    boxes = rois.reshape(-1, 4).to(torch.float32)
    levels = fpn_level_assignment(boxes, num_levels=len(level_hws)).long()
    frame = torch.arange(t, device=dev).repeat_interleave(n)
    r_h, r_w = hs[levels], ws[levels]

    b = boxes * scales[levels][:, None]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    roi_w = (x2 - x1).clamp(min=1.0)
    roi_h = (y2 - y1).clamp(min=1.0)
    sr = sampling_ratio
    steps = torch.arange(output_size * sr, dtype=torch.float32, device=dev) + 0.5
    # Divide by device tensors, not Python numbers: PyTorch's CUDA division
    # by a host scalar multiplies by its reciprocal, an ulp away from the
    # IEEE quotient that torchvision's and this package's kernel compute.
    out_t, sr_t = torch.tensor([output_size, sr], dtype=torch.float32, device=dev)
    ys = y1[:, None] + steps[None, :] * (roi_h / out_t / sr_t)[:, None]  # [M, S]
    xs = x1[:, None] + steps[None, :] * (roi_w / out_t / sr_t)[:, None]

    y = torch.minimum(ys.clamp(min=0.0), r_h[:, None] - 1.0)
    x = torch.minimum(xs.clamp(min=0.0), r_w[:, None] - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    return {
        "base": bases[levels] + frame * planes[levels],
        "width": r_w.long(),
        "y0": y0,
        "y1": torch.minimum(y0 + 1, r_h.long()[:, None] - 1),
        "x0": x0,
        "x1": torch.minimum(x0 + 1, r_w.long()[:, None] - 1),
        "ly": y - y0.to(torch.float32),
        "lx": x - x0.to(torch.float32),
        "my": (ys >= -1.0) & (ys <= r_h[:, None]),
        "mx": (xs >= -1.0) & (xs <= r_w[:, None]),
    }


def multiscale_roi_align_plain(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    spatial_scales: Sequence[float] = ROI_SCALES,
    *,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Plain PyTorch multi-scale RoIAlign, a transcription of the JAX
    package's exact gather form (`roi_align.py:125-208`).

    feats: levels [T, H_l, W_l, C], fine-to-coarse; rois: [T, N, 4] XYXY in
    image coordinates -> [T, N, out, out, C] in the feature dtype. The
    pyramid is flattened into one [sum(T*H_l*W_l), C] buffer and each
    sample indexes it at its roi's level and frame. With bf16 features the
    interpolation weights are bf16 too, as in the JAX form. Rois are pooled
    in chunks so the gather temporaries stay bounded."""
    t, n = rois.shape[:2]
    c = feats[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    grid = sample_grid([f.shape[1:3] for f in feats], rois, spatial_scales, output_size, sampling_ratio)
    base, width = grid["base"], grid["width"]
    y0, y1, x0, x1, my, mx = (grid[k] for k in ("y0", "y1", "x0", "x1", "my", "mx"))
    wdt = flat.dtype
    ly = grid["ly"].to(wdt)
    lx = grid["lx"].to(wdt)
    hy = 1 - ly
    hx = 1 - lx

    sr = sampling_ratio
    s = output_size * sr
    m = base.shape[0]
    out = torch.empty((m, output_size, output_size, c), dtype=feats[0].dtype, device=rois.device)
    zero = torch.zeros((), dtype=wdt, device=rois.device)
    chunk = max(1, (1 << 22) // (s * s * c))
    for i in range(0, m, chunk):
        sl = slice(i, i + chunk)

        def g(yi, xi):
            idx = base[sl, None, None] + yi[sl, :, None] * width[sl, None, None] + xi[sl, None, :]
            return flat[idx]  # [m, S, S, C]

        def wgt(a, bb):
            return (a[sl, :, None] * bb[sl, None, :])[..., None]

        val = (
            g(y0, x0) * wgt(hy, hx)
            + g(y0, x1) * wgt(hy, lx)
            + g(y1, x0) * wgt(ly, hx)
            + g(y1, x1) * wgt(ly, lx)
        )
        mask = (my[sl, :, None] & mx[sl, None, :])[..., None]
        val = torch.where(mask, val, zero).to(torch.float32)
        pooled = val.reshape(-1, output_size, sr, output_size, sr, c).mean(dim=(2, 4))
        out[sl] = pooled.to(out.dtype)
    return out.reshape(t, n, output_size, output_size, c)


def _check_cuda_inputs(feats, rois, spatial_scales, output_size, sampling_ratio):
    if len(feats) != 4 or len(spatial_scales) != 4:
        raise ValueError("the kernel pools exactly 4 FPN levels")
    if output_size not in (7, 14) or sampling_ratio != 2:
        raise ValueError(f"the kernel takes output_size 7 or 14 and sampling_ratio 2, got {output_size}, {sampling_ratio}")
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16 features, got {dtype}")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4 or not rois.is_contiguous():
        raise ValueError("rois must be a contiguous float32 [T, N, 4] tensor")
    t = rois.shape[0]
    c = feats[0].shape[-1]
    vec = 16 // feats[0].element_size()
    if c % vec:
        raise ValueError(f"the kernel loads 16-byte channel vectors: C must be a multiple of {vec} in {dtype}, got {c}")
    for f in feats:
        if f.device != rois.device or f.dtype != dtype:
            raise ValueError("all levels must share the rois' device and one dtype")
        if f.dim() != 4 or f.shape[0] != t or f.shape[-1] != c or not f.is_contiguous():
            raise ValueError(f"each level must be a contiguous NHWC [T={t}, H, W, C={c}] tensor, got {tuple(f.shape)}")
        if f.data_ptr() % 16:
            raise ValueError("level data must be 16-byte aligned")
        if f.shape[1] * f.shape[2] * c > 2**31 - 1:
            raise ValueError("the kernel indexes one frame's level with 32-bit offsets")


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("roi_align.cu"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from `csrc/roi_align.cu`."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.sfvos_roi_align_forward
    fn.argtypes = [vp] * 4 + [ci] * 8 + [cf] * 4 + [vp, vp] + [ci] * 5 + [vp, vp]
    fn.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def roi_align_cuda(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    spatial_scales: Sequence[float] = ROI_SCALES,
    *,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Launch the CUDA kernel once over all [T, N] rois. Raises on any input
    the kernel does not take and on any launch error."""
    _check_cuda_inputs(feats, rois, spatial_scales, output_size, sampling_ratio)
    levels = fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
    return launch_kernel(feats, rois, levels, spatial_scales, output_size)


def launch_kernel(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    levels: torch.Tensor,
    spatial_scales: Sequence[float],
    output_size: int,
    lib: ctypes.CDLL | None = None,
) -> torch.Tensor:
    """The launch itself, on inputs `_check_cuda_inputs` accepted and
    precomputed int32 levels [T*N] (`fpn_level_assignment`), through `lib`
    (a `bind`-declared build of the kernel; default: this checkout's).
    Raises unless `levels` is such a tensor, contiguous on the rois'
    device."""
    t, n = rois.shape[:2]
    if (levels.dtype != torch.int32 or levels.dim() != 1 or levels.numel() != t * n
            or not levels.is_contiguous() or levels.device != rois.device):
        raise ValueError(f"levels must be a contiguous int32 [T*N={t * n}] tensor on {rois.device}")
    c = feats[0].shape[-1]
    out = torch.empty((t, n, output_size, output_size, c), dtype=feats[0].dtype, device=rois.device)
    if t * n == 0:
        return out
    lib = lib or _library()
    hw = [d for f in feats for d in (f.shape[1], f.shape[2])]
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfvos_roi_align_forward(
            *[f.data_ptr() for f in feats], *hw, *[float(s) for s in spatial_scales],
            rois.data_ptr(), levels.data_ptr(), t * n, n, c,
            output_size, int(feats[0].dtype == torch.bfloat16), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    launches[output_size] += 1
    return out


def multiscale_roi_align(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    spatial_scales: Sequence[float] = ROI_SCALES,
    *,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Multi-scale RoIAlign of rois [T, N, 4] over levels [T, H_l, W_l, C]
    -> [T, N, out, out, C]. CUDA tensors go through the kernel, CPU tensors
    through the plain version; there is no fallback between the two."""
    if rois.device.type == "cuda":
        return roi_align_cuda(feats, rois, spatial_scales, output_size=output_size, sampling_ratio=sampling_ratio)
    if rois.device.type == "cpu":
        return multiscale_roi_align_plain(feats, rois, spatial_scales, output_size=output_size, sampling_ratio=sampling_ratio)
    raise ValueError(f"no RoIAlign for device {rois.device}")
