"""Multi-scale RoIAlign over FPN levels: the CUDA kernel and its plain version.

Port of `slowfast_vos_tpu/ops/roi_align.py` (`fpn_level_assignment`,
`multiscale_roi_align`, and the single-map `roi_align`, plain PyTorch as in
JAX) and of the Pallas TPU kernel that carried the
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

The pool is differentiable with respect to the features (`_Pool`, a
`torch.autograd.Function`; the rois get no gradient, as in JAX). Its
backward is the transpose of the same linear map:

* on CUDA tensors `roi_align_backward_cuda` launches the second kernel of
  `csrc/roi_align.cu` (K5; it replaces the JAX package's custom VJP
  `roi_align_mm.py::_msra_mmgrad_bwd`, which XLA computes, there is no
  Pallas kernel for it): a small kernel builds each roi's tap tables with
  the forward's own device function, then one CTA per (frame, level,
  16x16-pixel tile, channel slice) walks the rois whose footprint meets
  its tile, in ascending order, sums what they add there in f32 in shared
  memory, and writes its tile once in the features' dtype. No atomics and
  no f32 pyramid: every pixel sums its contributions in a fixed order, so
  two calls agree bit for bit. Its bound is bytes (g read once, the
  gradient pyramid written once); the serial walk of the tiles under many
  rois sets its time (see the source's head note).
* on CPU tensors `multiscale_roi_align_backward_plain`, a transcription of
  `_msra_mmgrad_bwd`: per level and frame, A_y^T . g . A_x over the rois
  assigned there, as dense matmuls.

FPN levels are assigned in PyTorch (`fpn_level_assignment`) for both
paths, so kernel and plain version pool every roi at the same level; on
CUDA the backward takes the levels its forward computed.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Sequence

import torch

from slowfast_vos_tpu_torch.ops import cuda_build
from slowfast_vos_tpu_torch.ops.constants import device_constant

ROI_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)

# Kernel launches: the forward's by output size (7, 14), the backward's by
# ("backward", output size), in the counter every kernel wrapper shares.
launches = cuda_build.launches
_count_launch = cuda_build.count_launch


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
    hs = device_constant(tuple(h for h, _ in level_hws), torch.float32, dev)
    ws = device_constant(tuple(w for _, w in level_hws), torch.float32, dev)
    plane = tuple(h * w for h, w in level_hws)
    bases = device_constant(tuple(itertools.accumulate([0] + [t * p for p in plane][:-1])), torch.int64, dev)
    planes = device_constant(plane, torch.int64, dev)
    scales = device_constant(tuple(spatial_scales), torch.float32, dev)

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
    out_t, sr_t = device_constant((output_size, sr), torch.float32, dev)
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


def interp_matrix_1d(starts: torch.Tensor, bins: torch.Tensor, extent: int, out_size: int, sr: int) -> torch.Tensor:
    """[N, out_size, extent] f32 matrix averaging the sr bilinear taps of each
    bin along one axis (`roi_align_mm.py::_interp_matrix_1d`): sample k of a
    roi sits at starts + (k + 1/2) * bins / sr, samples outside
    [-1, extent] weigh zero, others clamp to [0, extent - 1].

    starts: [N] roi start coordinate; bins: [N] bin size, both f32. The
    sample step divides by a device tensor (see `sample_grid`), so the
    samples sit where the gather form and the kernels put them."""
    dev = starts.device
    n = starts.shape[0]
    s = out_size * sr
    steps = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    coords = starts[:, None] + steps[None, :] * (bins / device_constant(float(sr), torch.float32, dev))[:, None]  # [N, S]
    in_range = (coords >= -1.0) & (coords <= extent)
    c = coords.clamp(0.0, extent - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    k = torch.arange(extent, dtype=torch.float32, device=dev)
    is0 = k[None, None, :] == c0[:, :, None]
    is1 = k[None, None, :] == torch.minimum(c0 + 1, torch.full_like(c0, extent - 1.0))[:, :, None]
    a = is0 * (1.0 - frac)[:, :, None] + is1 * frac[:, :, None]
    a = a * in_range[:, :, None]
    return a.reshape(n, out_size, sr, extent).mean(dim=2)


def multiscale_roi_align_backward_plain(
    g: torch.Tensor,
    rois: torch.Tensor,
    level_hws: Sequence[tuple[int, int]],
    spatial_scales: Sequence[float] = ROI_SCALES,
    *,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> list[torch.Tensor]:
    """Gradient of `multiscale_roi_align` with respect to the levels: a
    transcription of `roi_align_mm.py::_msra_mmgrad_bwd`. Per level l and
    frame, grad_l = sum over the frame's rois on l of A_y^T . g . A_x
    (`interp_matrix_1d`), as two dense matmuls, in f32.

    g: [T, N, out, out, C]; rois: [T, N, 4] -> levels [T, H_l, W_l, C] in
    g's dtype. Rois are taken in chunks, so the [rois, H_l, out, C]
    temporary stays bounded."""
    t, n = rois.shape[:2]
    c = g.shape[-1]
    dev = rois.device
    boxes = rois.reshape(-1, 4).to(torch.float32)
    levels = fpn_level_assignment(boxes, num_levels=len(level_hws))
    frame = torch.arange(t, device=dev).repeat_interleave(n)
    gf = g.reshape(t * n, output_size, output_size, c).to(torch.float32)
    out_t = device_constant(float(output_size), torch.float32, dev)
    grads = []
    for li, ((h, w), scale) in enumerate(zip(level_hws, spatial_scales)):
        grad = torch.zeros((t, h, w, c), dtype=torch.float32, device=dev)
        chunk = max(1, (1 << 25) // (h * output_size * c))
        for f in range(t):
            idx = torch.nonzero((levels == li) & (frame == f))[:, 0]
            for i in range(0, idx.numel(), chunk):
                sel = idx[i : i + chunk]
                b = boxes[sel] * scale
                x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
                a_y = interp_matrix_1d(y1, (y2 - y1).clamp(min=1.0) / out_t, h, output_size, sampling_ratio)
                a_x = interp_matrix_1d(x1, (x2 - x1).clamp(min=1.0) / out_t, w, output_size, sampling_ratio)
                u = torch.einsum("nph,npqc->nhqc", a_y, gf[sel])
                grad[f] += torch.einsum("nhqc,nqw->hwc", u, a_x)
        grads.append(grad.to(g.dtype))
    return grads


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
    if hasattr(lib, "sfvos_roi_align_backward_scratch_bytes"):  # older builds have another backward or none
        lib.sfvos_roi_align_backward_scratch_bytes.argtypes = [ci, ci]
        lib.sfvos_roi_align_backward_scratch_bytes.restype = ctypes.c_longlong
        bwd = lib.sfvos_roi_align_backward
        bwd.argtypes = [vp] * 4 + [ctypes.c_longlong] + [vp] * 4 + [ci] * 8 + [cf] * 4 + [ci] * 6 + [vp]
        bwd.restype = ci
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
    _count_launch(output_size, stream)
    return out


def roi_align_backward_cuda(
    g: torch.Tensor,
    rois: torch.Tensor,
    level_hws: Sequence[tuple[int, int]],
    spatial_scales: Sequence[float] = ROI_SCALES,
    *,
    output_size: int = 7,
    levels: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """Launch the backward kernel (K5) once over all [T, N] rois: g
    [T, N, out, out, C] (f32 or bf16, the features' dtype) -> the gradient
    of each level [T, H_l, W_l, C] in g's dtype. `levels`: precomputed
    int32 [T*N] levels (default: `fpn_level_assignment`, as the forward
    assigns them). Raises on any input the kernel does not take and on any
    launch error."""
    t, n = rois.shape[:2]
    if output_size not in (7, 14):
        raise ValueError(f"the backward kernel takes output_size 7 or 14, got {output_size}")
    if len(level_hws) != 4 or len(spatial_scales) != 4:
        raise ValueError("the backward kernel takes exactly 4 FPN levels")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the backward kernel takes float32 or bfloat16 gradients, got {g.dtype}")
    if rois.dtype != torch.float32 or rois.dim() != 3 or rois.shape[-1] != 4 or not rois.is_contiguous():
        raise ValueError("rois must be a contiguous float32 [T, N, 4] tensor")
    if g.dim() != 5 or tuple(g.shape[:4]) != (t, n, output_size, output_size) or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous [T={t}, N={n}, {output_size}, {output_size}, C] tensor, got {tuple(g.shape)}")
    if g.device != rois.device:
        raise ValueError("g and rois must share one device")
    c = g.shape[-1]
    vec = 16 // g.element_size()
    if c % vec:
        raise ValueError(f"the backward kernel stores 16-byte channel vectors: C must be a multiple of {vec} in {g.dtype}, got {c}")
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned")
    for h, w in level_hws:
        if h * w * c > 2**31 - 1:
            raise ValueError("the kernel indexes one frame's level with 32-bit offsets")
    if levels is None:
        levels = fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
    return launch_backward(g, rois, levels, level_hws, spatial_scales, output_size)


def launch_backward(
    g: torch.Tensor,
    rois: torch.Tensor,
    levels: torch.Tensor,
    level_hws: Sequence[tuple[int, int]],
    spatial_scales: Sequence[float],
    output_size: int,
    lib: ctypes.CDLL | None = None,
) -> list[torch.Tensor]:
    """The backward launch itself, on inputs `roi_align_backward_cuda`
    accepted, through `lib` (a `bind`-declared build; default: this
    checkout's). The kernel writes every element of the gradient once, so
    the levels are allocated uninitialized; its per-roi tables go to a
    scratch buffer of a few KB a roi. Raises unless `levels` is a
    contiguous int32 [T*N] tensor on the rois' device."""
    t, n = rois.shape[:2]
    if (levels.dtype != torch.int32 or levels.dim() != 1 or levels.numel() != t * n
            or not levels.is_contiguous() or levels.device != rois.device):
        raise ValueError(f"levels must be a contiguous int32 [T*N={t * n}] tensor on {rois.device}")
    c = g.shape[-1]
    grads = [torch.empty((t, h, w, c), dtype=g.dtype, device=rois.device) for h, w in level_hws]
    if t * n == 0:
        return [x.zero_() for x in grads]
    lib = lib or _library()
    scratch_bytes = lib.sfvos_roi_align_backward_scratch_bytes(output_size, t * n)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=rois.device)
    hw = [d for h, w in level_hws for d in (h, w)]
    with torch.cuda.device(rois.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sfvos_roi_align_backward(
            g.data_ptr(), rois.data_ptr(), levels.data_ptr(), scratch.data_ptr(), scratch_bytes,
            *[x.data_ptr() for x in grads], *hw, *[float(s) for s in spatial_scales],
            t, t * n, n, c, output_size, int(g.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"roi_align backward kernel launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    _count_launch(("backward", output_size), stream)
    return grads


class _Pool(torch.autograd.Function):
    """The pool, differentiable with respect to the levels. Forward: the
    kernel on CUDA, the plain gather on the CPU; backward: K5 on CUDA, the
    plain transpose on the CPU. The rois get no gradient, as in JAX
    (`roi_align_mm.py:156`; the train step detaches them besides)."""

    @staticmethod
    def forward(ctx, rois, spatial_scales, output_size, sampling_ratio, *feats):
        if rois.device.type == "cuda":
            _check_cuda_inputs(feats, rois, spatial_scales, output_size, sampling_ratio)
            levels = fpn_level_assignment(rois.reshape(-1, 4)).contiguous()
            out = launch_kernel(feats, rois, levels, spatial_scales, output_size)
        else:
            levels = None
            out = multiscale_roi_align_plain(feats, rois, spatial_scales, output_size=output_size,
                                             sampling_ratio=sampling_ratio)
        ctx.save_for_backward(rois, levels)
        ctx.geometry = ([tuple(f.shape[1:3]) for f in feats], tuple(spatial_scales), output_size, sampling_ratio)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        rois, levels = ctx.saved_tensors
        hws, scales, output_size, sampling_ratio = ctx.geometry
        g = g.contiguous()
        if rois.device.type == "cuda":
            # The forward's levels: a roi is differentiated where it was pooled.
            grads = roi_align_backward_cuda(g, rois, hws, scales, output_size=output_size, levels=levels)
        else:
            grads = multiscale_roi_align_backward_plain(
                g, rois, hws, scales, output_size=output_size, sampling_ratio=sampling_ratio
            )
        return (None, None, None, None, *grads)


def multiscale_roi_align(
    feats: Sequence[torch.Tensor],
    rois: torch.Tensor,
    spatial_scales: Sequence[float] = ROI_SCALES,
    *,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Multi-scale RoIAlign of rois [T, N, 4] over levels [T, H_l, W_l, C]
    -> [T, N, out, out, C], differentiable with respect to the levels. CUDA
    tensors go through the kernels, CPU tensors through the plain versions;
    there is no fallback between the two."""
    if rois.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RoIAlign for device {rois.device}")
    return _Pool.apply(rois, tuple(spatial_scales), output_size, sampling_ratio, *feats)


def roi_align(
    feat: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float,
    *,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoIAlign on a single feature map (JAX `roi_align.py:65-101`, a plain
    gather there too): `multiscale_roi_align_plain` with one level, in plain
    PyTorch on any device, differentiable by autograd.

    feat: [H, W, C] (channels-last); rois: [N, 4] XYXY in image coordinates;
    spatial_scale: the map's stride reciprocal (0.25 for P2). Returns
    [N, out, out, C] in the feature dtype."""
    return multiscale_roi_align_plain(
        [feat[None]], rois[None], (spatial_scale,), output_size=output_size, sampling_ratio=sampling_ratio
    )[0]
