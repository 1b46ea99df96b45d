"""ViTDet-B + SlowFast (`build_pipeline(arch="vitdet-b")`) against its plain
float32 reference (`tests/vitdet_reference.py`, detectron2's equations) on
the CPU at a tiny size: embed 64, 2 heads, depth 6 (window, window, global,
twice), windows of 3 on an 8x8 token grid (so the grid is padded to 9x9),
a 4x4 pretraining position grid resized to 8x8, a 128x128 square canvas.
Block by block, the pyramid's levels and a whole `infer_sequence` of three
superchunks with the carry; K7's plain version against the published
materialized form; faults that the comparison must catch; the ResNet
path's state dict; the trainer's refusal."""
import numpy as np
import pytest
import torch

import vitdet_reference as ref
from slowfast_vos_tpu_torch.models import vit
from slowfast_vos_tpu_torch.models.config import DetectionConfig
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.models.transform import ImageTransform
from slowfast_vos_tpu_torch.ops import attention as patt
from slowfast_vos_tpu_torch.train import Trainer
from vosbench import compare
from vosbench.reference import model as ref_model
from vosbench.reference import run as ref_run

TINY = dict(embed=64, depth=6, heads=2, mlp=128, window=3, global_blocks=(2, 5), pretrain_grid=4, image=128)
DETECTION = dict(rpn_pre_nms_top_n_test=64, rpn_post_nms_top_n_test=32, detections_per_img=5, max_gt=3)
HW = (60, 100)
SEED = 2**31 + 19
ATOL = RTOL = 1e-4  # float32 on both sides; sums in other orders


def draw_state(seed=SEED):
    """Seeded weights over the reference's tree (the port's names): weights
    N(0, 1/fan_in), norm scales U(0.8, 1.2), biases N(0, 0.02^2), the
    position embedding N(0, 0.5^2), the relative-position tables N(0,
    0.1^2), SlowFast's running variances U(0.8, 1.25)."""
    g = torch.Generator().manual_seed(seed)
    model = ref.Model(3, 3, ref_model.Detection(**DETECTION), widths=ref.Widths(**TINY))
    state = {}
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            state[name] = t.clone()
        elif name.endswith("pos_embed"):
            state[name] = 0.5 * torch.randn(t.shape, generator=g)
        elif name.endswith(("rel_pos_h", "rel_pos_w")):
            state[name] = 0.1 * torch.randn(t.shape, generator=g)
        elif name.endswith("running_var"):
            state[name] = 0.8 + 0.45 * torch.rand(t.shape, generator=g)
        elif name.endswith(".weight") and t.dim() > 1:
            fan_in = (t.shape[0] if ".deconv" in name or "conv5_mask" in name else t.shape[1]) * t[0, 0].numel()
            state[name] = torch.randn(t.shape, generator=g) * fan_in**-0.5
        elif name.endswith(".weight"):
            state[name] = 0.8 + 0.4 * torch.rand(t.shape, generator=g)
        else:
            state[name] = 0.02 * torch.randn(t.shape, generator=g)
    return state


@pytest.fixture(scope="module")
def models():
    state = draw_state()
    pipe, model = build_pipeline(3, 3, HW, cfg=DetectionConfig(**DETECTION), dtype=torch.float32, min_size=128,
                                 max_size=128, device="cpu", superchunk=4, arch="vitdet-b", vit=vit.ViTConfig(**TINY))
    model.load_state_dict(state, strict=True)
    reference = ref.build(3, 3, ref_model.Detection(**DETECTION), state, "cpu", widths=ref.Widths(**TINY))
    return pipe, model, reference


def frames(seed, t=3):
    return torch.from_numpy((np.random.default_rng(seed).random((t, *HW, 3)) * 255).astype(np.uint8))


def canvas(t=3):
    geom = ref.SquareGeometry(HW, 128, 128, 128)
    return geom.canvas(frames(5, t))


def port_levels(model, x):
    with torch.no_grad():
        return model.backbone_feats(x)


def gap(a_levels, b_levels):
    return max(float((a - b).abs().max()) for a, b in zip(a_levels, b_levels))


@pytest.mark.parametrize("index", range(6))
def test_block_matches_reference(models, index):
    _, model, reference = models
    x = torch.randn((2, 8, 8, 64), generator=torch.Generator().manual_seed(index))
    with torch.no_grad():
        got = model.backbone.net.blocks[index](x)
        want = reference.backbone.net.blocks[index](x)
    assert model.backbone.net.blocks[index].window == (0 if index in (2, 5) else 3)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_patch_embedding_and_positions_match_reference(models):
    _, model, reference = models
    x = canvas().permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = vit.nhwc(model.backbone.net.patch_embed.proj(x))
        got = got + vit.abs_pos(model.backbone.net.pos_embed, (8, 8), got.dtype)
        want = reference.backbone.net.patch_embed.proj(x).permute(0, 2, 3, 1)
        want = want + ref.get_abs_pos(reference.backbone.net.pos_embed, True, (8, 8))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("level", range(5))
def test_pyramid_level_matches_reference(models, level):
    pipe, model, reference = models
    x = canvas()
    got = port_levels(model, pipe.transform(frames(5)))[level]
    with torch.no_grad():
        want = reference.backbone(x)[level]
    assert got.shape == want.shape == (3, 128 // 4 // 2**level, 128 // 4 // 2**level, 256)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_pipeline_with_carry_matches_reference(models):
    """Nine frames in superchunks of 4: the first, then two carried ones."""
    pipe, _, reference = models
    clip = frames(7, 9).numpy()
    dets = pipe.infer_sequence(clip)
    teacher = {k: torch.as_tensor(np.stack([d[k] for d in dets])) for k in ("boxes", "labels", "valid")}
    out = ref_run.infer_sequence(reference, ref.SquareGeometry(HW, 128, 128, 128), torch.from_numpy(clip),
                                 teacher=teacher)
    gaps, extra = compare.inference_gaps([dets], [{k: v.numpy() for k, v in out.items()}])
    assert gaps["mask_gap"] == 0.0 and gaps["score_gap"] < 1e-4 and gaps["box_gap"] < 1e-4
    assert 0.02 < extra["union_share"] < 0.98  # the masks have something to judge
    np.testing.assert_allclose(np.stack([d["boxes"] for d in dets]), out["boxes"].numpy(), atol=1e-3)


@pytest.mark.parametrize("windows,grid", [(1, 8), (9, 3)], ids=["global", "window"])
def test_k7_plain_version_matches_published_form(windows, grid):
    g = torch.Generator().manual_seed(grid)
    heads, d = 2, 32
    q, k, v = (torch.randn((windows, heads, grid * grid, d), generator=g) for _ in range(3))
    tables = [0.3 * torch.randn((2 * grid - 1, d), generator=g) for _ in range(2)]
    got = patt.attention_plain(q, k, v, *patt.rel_pos_terms(q, *tables, (grid, grid)), d**-0.5)
    qf, kf, vf = (t.reshape(windows * heads, grid * grid, d) for t in (q, k, v))
    attn = ref.add_decomposed_rel_pos((qf * d**-0.5) @ kf.transpose(-2, -1), qf, *tables, (grid, grid), (grid, grid))
    want = (attn.softmax(-1) @ vf).view(windows, heads, grid * grid, d).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_rel_coords_are_detectrons():
    for size in (3, 14, 64):
        table = torch.arange(2 * size - 1)[:, None].float()
        torch.testing.assert_close(table[patt.rel_coords(size, size)][..., 0], ref.get_rel_pos(size, size, table)[..., 0])


# ---------------------------------------------------------------- faults the comparison must catch


def _rel_w_dropped(original):
    def terms(q, rel_pos_h, rel_pos_w, hw):
        rel_h, rel_w = original(q, rel_pos_h, rel_pos_w, hw)
        return rel_h, torch.zeros_like(rel_w)
    return terms


def _bilinear_positions(original):
    def pos(pos_embed, hw, dtype):
        grid = int((pos_embed.shape[1] - 1) ** 0.5)
        table = pos_embed[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
        table = torch.nn.functional.interpolate(table, size=hw, mode="bilinear", align_corners=False)
        return table.permute(0, 2, 3, 1).to(dtype)
    return pos


def _padded_keys_masked(original):
    """Window attention that leaves out the keys of the zero-padded tokens,
    through a -1e9 bias on their rows and columns of the key window."""
    def forward(self, x):
        if not self.window:
            return original(self, x)
        shortcut = x
        h, w = x.shape[1:3]
        y, pad_hw = vit.window_partition(vit.layer_norm(x, self.norm1), self.window)
        valid, _ = vit.window_partition(torch.ones((x.shape[0], h, w, 1)), self.window)
        rows, cols = valid[..., 0].amax(2) > 0, valid[..., 0].amax(1) > 0  # [B * nw, window]
        attn = self.attn
        b, n = y.shape[0], self.window**2
        qkv = attn.qkv(y).reshape(b, n, 3, attn.heads, attn.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        rel_h, rel_w = patt.rel_pos_terms(q, attn.rel_pos_h, attn.rel_pos_w, (self.window, self.window))
        rel_h = rel_h + torch.where(rows, 0.0, -1e9)[:, None, None, :]
        rel_w = rel_w + torch.where(cols, 0.0, -1e9)[:, None, None, :]
        out = attn.proj(patt.attention_plain(q, k, v, rel_h, rel_w, attn.scale).reshape(b, self.window, self.window, -1))
        x = shortcut + vit.window_unpartition(out, self.window, pad_hw, (h, w))
        return x + self.mlp(vit.layer_norm(x, self.norm2))
    return forward


@pytest.mark.parametrize("owner,name,fault", [
    (vit, "rel_pos_terms", _rel_w_dropped), (vit, "abs_pos", _bilinear_positions),
    (vit.Block, "forward", _padded_keys_masked)], ids=["rel_w_dropped", "bilinear_positions", "padded_keys_masked"])
def test_faults_fail_the_comparison(models, monkeypatch, owner, name, fault):
    pipe, model, reference = models
    with torch.no_grad():
        want = reference.backbone(canvas())
    assert gap(port_levels(model, pipe.transform(frames(5))), want) < ATOL * 50
    monkeypatch.setattr(owner, name, fault(getattr(owner, name)))
    assert gap(port_levels(model, pipe.transform(frames(5))), want) > 1e-2


# ---------------------------------------------------------------- the rest of the port


def test_resnet_path_state_dict_is_unchanged():
    """`arch="resnet50-fpn"` (the default) keeps torchvision's tree: the
    frozen reference's names and shapes, key for key."""
    _, model = build_pipeline(3, 3, HW, dtype=torch.float32, device="cpu")
    with torch.device("meta"):
        frozen = ref_model.Model(3, 3, ref_model.Detection())
    want = {k: tuple(v.shape) for k, v in frozen.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert model.arch == "resnet50-fpn"


def test_square_transform_is_detectrons_resize_and_pad():
    t = ImageTransform((480, 854), min_size=1024, max_size=1024, square=1024)
    assert t.resized_hw == (576, 1024) and t.canvas_hw == (1024, 1024)
    assert ref.SquareGeometry((480, 854), 1024, 1024, 1024).resized_hw == (576, 1024)
    small = ImageTransform(HW, min_size=128, max_size=128, square=128)
    x = small(frames(3, 2))
    assert x.shape == (2, 128, 128, 3) and small.resized_hw == (77, 128)
    assert float(x[:, 77:].abs().max()) == 0.0 and float(x[:, :77].abs().max()) > 0.0
    with pytest.raises(ValueError, match="square canvas"):
        ImageTransform((480, 854), min_size=1024, max_size=2048, square=1024).canvas_hw


def test_training_refuses_vitdet(models):
    pipe, _, _ = models
    with pytest.raises(NotImplementedError, match="vitdet-b"):
        Trainer(pipe)


def test_unknown_arch_is_refused():
    with pytest.raises(ValueError, match="arch"):
        build_pipeline(3, 3, HW, dtype=torch.float32, device="cpu", arch="vit-huge")


def test_cli_builds_vitdet_on_its_square():
    import argparse

    from slowfast_vos_tpu_torch import cli

    p = argparse.ArgumentParser()
    cli.add_arch_argument(p)
    assert cli.arch_kwargs(p.parse_args([])) == {}
    args = p.parse_args(["--arch", "vitdet-b"])
    with pytest.raises(ValueError, match="arch"):
        cli.build(3, 3, (480, 854), device="cpu", **cli.arch_kwargs(p.parse_args(["--arch", "vit-huge"])))
    pipe, model = cli.build(3, 3, (480, 854), device="cpu", **cli.arch_kwargs(args))
    assert model.arch == "vitdet-b" and pipe.transform.canvas_hw == (1024, 1024)
    assert pipe.transform.resized_hw == (576, 1024) and pipe.image_hw == (576.0, 1024.0)
    assert len(model.backbone.net.blocks) == 12 and model.backbone.net.pos_embed.shape == (1, 197, 768)
