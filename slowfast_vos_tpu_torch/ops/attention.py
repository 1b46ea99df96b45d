"""Attention with decomposed relative positions (K7): ViTDet's attention.

K7 replaces no TPU kernel: the JAX package has no transformer. It was added
with the ViTDet-B backbone (`models/vit.py`), whose every block adds
detectron2's decomposed relative-position bias to the logits
(`add_decomposed_rel_pos`):

    logits[q, k] = scale * q . k + rel_h[q, k // S_w] + rel_w[q, k % S_w]

with `rel_h = q . Rh[q_row, k_row]` and `rel_w = q . Rw[q_col, k_col]`
taken from the unscaled q (`rel_pos_terms`, one small matmul each). The
published code materializes the [heads, N, N] logits; a global block of
ViTDet-B (N = 4096) would write and re-read 403 MB a frame in bf16. K7 adds
the bias inside the tile loop of an online softmax, so that no [.., N, N]
tensor exists in device memory.

One kernel, two regimes (H100, bf16), in `csrc/attention.cu` (flash
attention on `mma.sync`, 64 queries a CTA, key tiles of 64; its header has
the design):

* global blocks, N = 4096 (a 64x64 grid): 51.5 GFLOP and ~38 MB a frame,
  bound by the tensor cores (52 us at 989 TFLOP/s against 11 us at 3.35
  TB/s). A key tile is one row of the key grid: its `rel_h` entry is the
  tile's index and its `rel_w` entry the key's column;
* window blocks, N = 196 (14x14 windows, 25 a frame): 2.95 GFLOP and
  ~33 MB a frame, bound by memory (10 us against 3 us). Key tiles cross
  key rows, so each key's row and column come from a table.

q, k and v are [B, heads, N, 64] views of the qkv projection (any strides
whose rows start on 16 bytes: nothing is copied; others are made
contiguous first); the output is [B, N, heads, 64], the layout the output
projection reads. The logits, the running max and sum and the accumulator
are float32; the probabilities enter the second product in bf16.

`attention_plain` is the plain version: the published materialized form,
run on the CPU and used as the oracle on the card. `attention` launches K7
on CUDA tensors (counted in `ops/cuda_build.py::launches` under
("attention", kind), kind "global" or "window") and takes the plain version
on the CPU. The kernel is built by `ops/cuda_build.py` at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from slowfast_vos_tpu_torch.ops import cuda_build
from slowfast_vos_tpu_torch.ops.constants import device_constant
from slowfast_vos_tpu_torch.ops.cuda_build import count_launch, launches  # noqa: F401 (launches: the counts, by key)

KINDS = ("global", "window")
HEAD_DIM = 64
MAX_SIDE = 64  # the key grid's sides, as `csrc/attention.cu` holds them


def rel_coords(q_size: int, k_size: int) -> torch.Tensor:
    """detectron2's `get_rel_pos` indices: (q - k) + (k_size - 1), scaled
    where the sizes differ; [q_size, k_size] long."""
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return ((q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)).long()


def _coords(size: int, device) -> torch.Tensor:
    """`rel_coords(size, size)` on `device`, built once (graph captures
    copy nothing from the host)."""
    return device_constant(tuple(map(tuple, rel_coords(size, size).tolist())), torch.long, torch.device(device))


def rel_pos_terms(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor, hw: tuple[int, int]):
    """q: [B, heads, N, C] (unscaled), N = H * W; rel_pos_h [2H - 1, C],
    rel_pos_w [2W - 1, C] -> (rel_h [B, heads, N, H], rel_w [B, heads, N, W])
    in q's dtype, as `add_decomposed_rel_pos` computes them."""
    h, w = hw
    b, heads, n, c = q.shape
    rh = rel_pos_h.to(q.dtype)[_coords(h, q.device)]  # [H, H, C]
    rw = rel_pos_w.to(q.dtype)[_coords(w, q.device)]  # [W, W, C]
    r_q = q.reshape(b, heads, h, w, c)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rh).reshape(b, heads, n, h)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rw).reshape(b, heads, n, w)
    return rel_h, rel_w


def attention_plain(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The materialized form: [B, heads, N, C] q, k, v and the two terms ->
    [B, N, heads, C]. Softmax in float32."""
    b, heads, n, c = q.shape
    s_h, s_w = rel_h.shape[-1], rel_w.shape[-1]
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = (attn.view(b, heads, n, s_h, s_w) + rel_h[..., :, None] + rel_w[..., None, :]).view(b, heads, n, n)
    p = attn.float().softmax(dim=-1).to(v.dtype)
    return (p @ v).transpose(1, 2).contiguous()


def _check(q, k, v, rel_h, rel_w):
    b, heads, n, c = q.shape
    if c != HEAD_DIM:
        raise ValueError(f"K7 takes heads of {HEAD_DIM}, not {c}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    if rel_h.shape[:3] != (b, heads, n) or rel_w.shape[:3] != (b, heads, n):
        raise ValueError(f"rel_h {tuple(rel_h.shape)} / rel_w {tuple(rel_w.shape)} do not match q {tuple(q.shape)}")
    if rel_h.shape[-1] * rel_w.shape[-1] != n:
        raise ValueError(f"the key grid {rel_h.shape[-1]}x{rel_w.shape[-1]} does not hold {n} keys")
    if any(t.stride(-1) != 1 for t in (q, k, v, rel_h, rel_w)):
        raise ValueError("K7 takes tensors with a unit last stride")
    if rel_h.shape[-1] > MAX_SIDE or rel_w.shape[-1] > MAX_SIDE:
        raise ValueError(f"K7 takes key grids of at most {MAX_SIDE} a side, not {rel_h.shape[-1]}x{rel_w.shape[-1]}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"K7 computes in bf16, not {q.dtype}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The library of `csrc/attention.cu`, built at first use, its C
    interface declared."""
    lib = cuda_build.load("attention.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sfvos_k7_attention.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
                                       ci, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.sfvos_k7_attention.restype = ci
    lib.sfvos_cuda_error_string.argtypes = [ci]
    lib.sfvos_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every 64-element row of `t` starts on 16 bytes, as K7's
    vector loads read them."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])


def attention_cuda(q, k, v, rel_h, rel_w, scale: float, kind: str) -> torch.Tensor:
    """K7 on CUDA tensors: [B, heads, N, 64] q, k, v, rel_h [B, heads, N,
    S_h], rel_w [B, heads, N, S_w] -> [B, N, heads, 64] in q's dtype."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    if q.device.type != "cuda":
        raise ValueError("attention_cuda takes CUDA tensors")
    _check(q, k, v, rel_h, rel_w)
    b, heads, n, c = q.shape
    s_h, s_w = rel_h.shape[-1], rel_w.shape[-1]
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    rel_h, rel_w = rel_h.to(q.dtype), rel_w.to(q.dtype)
    out = torch.empty((b, n, heads, c), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 18)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *rel_h.stride()[:3],
                                       *rel_w.stride()[:3], *out.stride()[:3])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.sfvos_k7_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                                    out.data_ptr(), strides, b, heads, n, s_h, s_w, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: {lib.sfvos_cuda_error_string(rc).decode()}")
    count_launch(("attention", kind), stream)
    return out


def attention(q, k, v, rel_h, rel_w, scale: float, kind: str) -> torch.Tensor:
    """K7 on CUDA tensors, the plain version on the CPU; see the module."""
    if q.device.type == "cuda":
        return attention_cuda(q, k, v, rel_h, rel_w, scale, kind)
    return attention_plain(q, k, v, rel_h, rel_w, scale)
