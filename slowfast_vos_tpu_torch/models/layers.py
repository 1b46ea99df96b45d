"""Shared building blocks.

Port of `slowfast_vos_tpu/models/layers.py`. Parameters stay float32, as the
JAX package keeps them; each layer casts its weights to the dtype of its
input at use, so the compute dtype (bf16 on the card, f32 in the CPU tests)
is set once, where a model casts its input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics and affine parameters (torchvision
    `FrozenBatchNorm2d`, eps 1e-5): a per-channel scale and shift, folded in
    float32 (`fold_frozen_batch_norms`, the ResNet's own fold) and applied
    in the activation dtype (`layers.py:20-31`)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # torchvision checkpoints may carry BatchNorm2d's counter; it has no use here.
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = fold_frozen_batch_norms(self)[self]
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def fold_frozen_batch_norms(module: nn.Module) -> dict[FrozenBatchNorm2d, tuple[torch.Tensor, torch.Tensor]]:
    """Every `FrozenBatchNorm2d` under `module` as its float32 (scale, shift),
    scale = weight * rsqrt(running_var + eps) and shift = bias - running_mean
    * scale, computed over all their channels at once: one `cat` of the
    buffers and four elementwise kernels, whatever their number. The
    buffers are read, never changed; each pair is a view of two shared
    tensors."""
    bns = [m for m in module.modules() if isinstance(m, FrozenBatchNorm2d)]
    eps = {m.eps for m in bns}
    if len(eps) != 1:
        raise ValueError(f"the frozen BatchNorms under one fold share one eps, not {sorted(eps)}")
    stats = torch.cat([getattr(m, name) for name in ("weight", "bias", "running_mean", "running_var") for m in bns])
    weight, bias, mean, var = stats.view(4, -1)
    scale = weight * torch.rsqrt(var + eps.pop())
    shift = torch.addcmul(bias, mean, scale, value=-1.0)
    sizes = [m.weight.numel() for m in bns]
    return dict(zip(bns, zip(scale.split(sizes), shift.split(sizes))))


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in the input's dtype (no output_size)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups, self.dilation,
        )


class Linear(nn.Linear):
    """`nn.Linear` computing in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


LN_EPS = 1e-6  # ViTDet's LayerNorms (detectron2's `LayerNorm` and `partial(nn.LayerNorm, eps=1e-6)`)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """`norm` over x's last dim, computing in x's dtype (float32 statistics
    on the card)."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype), norm.bias.to(x.dtype), norm.eps)


def channel_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """detectron2's channel `LayerNorm` of an NCHW tensor, taken over the NHWC
    view's last dim (contiguous where x is channels-last)."""
    return nchw(layer_norm(nhwc(x), norm))


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC [..., H, W, C] view -> NCHW view (channels-last memory when x is
    contiguous NHWC)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (contiguous when x is channels-last)."""
    return x.permute(0, 2, 3, 1)


def lecun_normal_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the JAX package's init distributions: every
    weight of a conv or linear layer ~ N(0, 1/fan_in) (flax lecun_normal,
    without its truncation), biases zero, frozen and SlowFast BatchNorms the
    identity. Draws on the CPU generator, so a seed gives the same weights on
    every device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, nn.ConvTranspose2d)):
                w = m.weight
                # fan_in = input width x kernel taps; ConvTranspose2d keeps
                # its input axis first ([I, O, kh, kw]).
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
                fan_in = cin * w[0, 0].numel()
                w.copy_(torch.randn(w.shape, generator=generator) / fan_in**0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
            elif isinstance(m, FrozenBatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
