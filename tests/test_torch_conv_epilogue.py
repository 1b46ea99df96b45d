"""The backbone's folded frozen BatchNorms and its convolution epilogue (K8)
on the CPU.

`models/resnet_fpn.py` folds each frozen BatchNorm's scale into its
convolution's weights and ends every convolution in one epilogue pass
(`ops/conv_epilogue.py`: the plain version here, K8 on the card, held in
`tests/test_torch_cuda.py`). Held here against the form it replaced, kept in
this file as its own reference (`unfolded_backbone`: each
`FrozenBatchNorm2d`, ReLU and residual add on its own, the FPN's biases in
its convolutions), in float32: outputs, the state dict and
buffers, a torchvision-named checkpoint, and the gradients of a fine-tune
that trains backbone layers 2-4."""
import pytest
import torch
import torch.nn.functional as F

from slowfast_vos_tpu_torch.models.layers import FrozenBatchNorm2d, fold_frozen_batch_norms, lecun_normal_, nchw, nhwc
from slowfast_vos_tpu_torch.models.resnet_fpn import ResNet50FPN
from slowfast_vos_tpu_torch.ops import conv_epilogue as pce
from slowfast_vos_tpu_torch.train.train_step import body_layers_to_train

IMAGES = (2, 64, 96, 3)  # [N, H, W, 3]: every level at least 1x2, P6 included


def seeded_backbone(seed: int = 0) -> ResNet50FPN:
    """A float32 backbone whose every frozen BatchNorm has its own scale,
    shift and statistics and whose FPN convolutions have biases (the
    benchmark's weight draws), so a dropped or misplaced term shows."""
    model = lecun_normal_(ResNet50FPN(torch.float32), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                m.weight.copy_(0.8 + 0.4 * torch.rand(m.weight.shape, generator=g))
                m.running_var.copy_(0.8 + 0.45 * torch.rand(m.running_var.shape, generator=g))
                m.bias.copy_(0.02 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.02 * torch.randn(m.running_mean.shape, generator=g))
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def unfolded_backbone(model: ResNet50FPN, images: torch.Tensor) -> list[torch.Tensor]:
    """The backbone's forward before the fold, on the same modules: each
    convolution through its own forward (the FPN's with its bias), each
    `FrozenBatchNorm2d.forward` after it, then the residual add and the
    ReLUs as separate passes."""
    body, fpn = model.body, model.fpn
    x = nchw(images).to(model.dtype).contiguous(memory_format=torch.channels_last)
    x = F.max_pool2d(F.relu(body.bn1(body.conv1(x))), 3, 2, padding=1)
    feats = []
    for layer in (body.layer1, body.layer2, body.layer3, body.layer4):
        for b in layer:
            shortcut = x if b.downsample is None else b.downsample(x)
            y = F.relu(b.bn1(b.conv1(x)))
            y = F.relu(b.bn2(b.conv2(y)))
            x = F.relu(b.bn3(b.conv3(y)) + shortcut)
        feats.append(x)
    last = fpn.inner_blocks[-1](feats[-1])
    outs = [fpn.layer_blocks[-1](last)]
    for i in range(len(feats) - 2, -1, -1):
        lat = fpn.inner_blocks[i](feats[i])
        h, w = lat.shape[-2:]
        last = lat + F.interpolate(last, scale_factor=2, mode="nearest")[..., :h, :w]
        outs.insert(0, fpn.layer_blocks[i](last))
    outs.append(F.max_pool2d(outs[-1], 1, 2))
    return [nhwc(p) for p in outs]


def images(seed: int = 2) -> torch.Tensor:
    return torch.rand(IMAGES, generator=torch.Generator().manual_seed(seed))


def assert_close_to_max(got: torch.Tensor, want: torch.Tensor, rel: float, what: str) -> None:
    """|got - want| within `rel` of want's largest magnitude, everywhere."""
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert scale > 0 and err <= rel * scale, f"{what}: max abs err {err:.3e} against {scale:.3e}"


def test_folded_backbone_matches_unfolded_form():
    model = seeded_backbone()
    x = images()
    with torch.no_grad():
        got, want = model(x), unfolded_backbone(model, x)
    assert len(got) == len(want) == 5
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert_close_to_max(g, w, 1e-5, f"P{level + 2}")


def test_fold_leaves_state_dict_and_buffers_as_they_are():
    """The fold reads the buffers at each call and stores nothing: the state
    dict has torchvision's keys and the same tensors after a forward; a
    torchvision-named checkpoint (with BatchNorm2d's counters) loads
    strictly and gives the same outputs."""
    model = seeded_backbone()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert "body.bn1.running_var" in before and "body.layer1.0.downsample.1.weight" in before
    # 53 frozen BatchNorms' four buffers, 53 body convolutions, 8 FPN convolutions with biases
    assert "fpn.inner_blocks.0.bias" in before and len(before) == 53 * 4 + 53 + 8 * 2
    with torch.no_grad():
        want = model(images())
    after = model.state_dict()
    assert list(after) == list(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    bns = [n for n, m in model.named_modules() if isinstance(m, FrozenBatchNorm2d)]
    assert len(bns) == 53
    checkpoint = dict(before, **{f"{n}.num_batches_tracked": torch.tensor(0) for n in bns})
    other = ResNet50FPN(torch.float32)
    other.load_state_dict(checkpoint, strict=True)
    with torch.no_grad():
        for g, w in zip(other(images()), want):
            assert torch.equal(g, w)


def test_fold_of_each_batch_norm_is_its_forward():
    """x * scale + shift, from one fold over the whole body, is each frozen
    BatchNorm's own forward (a fold of it alone) in float32: the body's
    buffers, taken together, split back to each BatchNorm's channels. The
    fold's formula is held against JAX's frozen BatchNorm in
    `tests/test_torch_models.py::test_frozen_batchnorm_matches_jax`."""
    model = seeded_backbone()
    folds = fold_frozen_batch_norms(model.body)
    assert len(folds) == 53
    x = torch.randn(2, 2048, 3, 3, generator=torch.Generator().manual_seed(3))
    for bn, (scale, shift) in folds.items():
        c = scale.shape[0]
        assert scale.dtype == shift.dtype == torch.float32 and shift.shape == (c,)
        xs = x[:, :c]
        torch.testing.assert_close(xs * scale[:, None, None] + shift[:, None, None], bn(xs), rtol=1e-6, atol=1e-6)


def test_folded_backbone_gradients_match_unfolded_form():
    """A fine-tune with `trainable_backbone_layers=3` (conv1 and layer1
    frozen; layers 2-4 and the FPN train): every trainable leaf's gradient
    through the folded form against the unfolded one, within 1e-5 of the
    leaf's gradient norm; the frozen leaves get none. Activations in
    float64 (the folds stay float32, as the buffers are): in float32 a
    pre-activation within rounding of 0 takes the other side of a ReLU in
    one of the two forms, and that alone moves a layer2 leaf's gradient by
    ~1e-3 of its norm."""
    model = seeded_backbone()
    model.dtype = torch.float64
    to_train = body_layers_to_train(3)
    trained = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        p.requires_grad_(parts[0] == "fpn" or any(parts[1].startswith(t) for t in to_train))
        if p.requires_grad:
            trained[name] = p
    assert any(n.startswith("body.layer2.") for n in trained) and not any(n.startswith("body.layer1.") for n in trained)
    x = images()
    weights = [torch.randn(o.shape, generator=torch.Generator().manual_seed(4 + i), dtype=torch.float64)
               for i, o in enumerate(unfolded_backbone(model, x))]

    def grads(forward):
        model.zero_grad(set_to_none=True)
        sum((o * w).sum() for o, w in zip(forward(x), weights)).backward()
        return {n: p.grad.clone() for n, p in trained.items()}, [p.grad for n, p in model.named_parameters()
                                                                 if n not in trained]

    got, frozen = grads(model)
    want, _ = grads(lambda images: unfolded_backbone(model, images))
    assert all(g is None for g in frozen)
    for name, g in got.items():
        w = want[name]
        assert float(w.norm()) > 0, name
        assert float((g - w).norm() / w.norm()) <= 1e-5, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, True)],
                         ids=["bias", "bias_relu", "bias_residual_relu"])
def test_plain_epilogue_is_one_rounding_of_the_float32_sum(dtype, residual, relu):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, 5, 7, generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
    bias = torch.randn(64, generator=g)
    res = torch.randn(x.shape, generator=g).to(dtype).contiguous(memory_format=torch.channels_last) if residual else None
    want = x.float() + bias[:, None, None] + (res.float() if residual else 0.0)
    want = (want.clamp(min=0) if relu else want).to(dtype)
    got = pce.conv_epilogue(x, bias, res, relu)
    assert got.dtype == dtype and torch.equal(got, want)


CL = torch.channels_last
REFUSED = {
    "nchw": lambda x, b: (x.contiguous(), b, None),
    "float16": lambda x, b: (x.half(), b, None),
    "c_not_multiple_of_8": lambda x, b: (x[:, :60].contiguous(memory_format=CL), b[:60], None),
    "bias_bf16": lambda x, b: (x, b.bfloat16(), None),
    "residual_nchw": lambda x, b: (x, b, x.contiguous()),
    "residual_dtype": lambda x, b: (x, b, x.bfloat16()),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_epilogue_refuses_what_k8_cannot_take(case):
    """The checks K8's wrapper makes before a launch, on the CPU: another
    layout, dtype, a C that is not a multiple of 8, a bias that is not
    float32, a residual unlike x. Nothing is copied to make a tensor fit."""
    x = torch.zeros(2, 64, 3, 5).contiguous(memory_format=CL)
    bias = torch.zeros(64)
    pce._check(x, bias, x)
    pce._check(x.bfloat16(), bias, x.bfloat16())
    with pytest.raises(ValueError):
        pce._check(*REFUSED[case](x, bias))
