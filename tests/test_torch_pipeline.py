"""The PyTorch port's inference slice as a whole: `forward_superchunk`
against the JAX package's at the `__graft_entry__` shape (120x200 frames,
min 128, max 256, superchunk 4, SlowFast 3-3) in f32, `infer_sequence`
across a carry chunk against the port's own plain superchunks, the bit
packing, the device rules, and a static check that no port file imports JAX.

Tolerances of the whole slice (f32 on the CPU, two libraries summing in
different orders): valid flags and labels exact; boxes within 0.05 px at the
original 120x200 resolution; scores within 1e-4; at most 1% of union-mask
pixels may differ (a pixel whose pasted probability sits at 0.5 may flip)."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import cuda_device, noisy_variables  # noqa: F401 (fixture)
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu_torch.convert import state_dict_from_flax
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline, init_weights, packbits
from slowfast_vos_tpu_torch.ops import roi_align

ROOT = pathlib.Path(__file__).resolve().parent.parent
HW = (120, 200)
SC = 4
BOX_ATOL = 0.05
SCORE_ATOL = 1e-4
MASK_SHARE = 0.01


def port_pipeline(variables=None, seed=0):
    pipe, model = build_pipeline(
        3, 3, HW, min_size=128, max_size=256, dtype=torch.float32, device="cpu", superchunk=SC
    )
    if variables is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pipe


def assert_detections_close(got, want, width):
    """got, want: (boxes, scores, labels, valid, packed masks) as numpy."""
    gb, gs, gl, gv, gm = got
    wb, ws, wl, wv, wm = want
    np.testing.assert_array_equal(gv, wv)
    assert gv.any()
    np.testing.assert_array_equal(np.where(gv, gl, 0), np.where(wv, wl, 0))
    np.testing.assert_allclose(gb[gv], wb[wv], atol=BOX_ATOL)
    np.testing.assert_allclose(gs[gv], ws[wv], atol=SCORE_ATOL)
    gmask = np.unpackbits(gm, axis=-1, count=width).astype(bool)
    wmask = np.unpackbits(wm, axis=-1, count=width).astype(bool)
    assert (gmask != wmask).mean() <= MASK_SHARE


def test_forward_superchunk_matches_jax():
    jpipe, jmodel = jax_build_pipeline(
        3, 3, HW, min_size=128, max_size=256, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=11)
    images = np.random.default_rng(0).integers(0, 256, (SC + 2, *HW, 3), dtype=np.uint8)
    feat_valid = np.array([False, True, True, True, True, True])  # a zero halo frame at the start
    images[~feat_valid] = 0

    want = jax.device_get(jax.jit(jpipe.forward_superchunk)(variables, jnp.asarray(images), jnp.asarray(feat_valid)))
    got = port_pipeline(variables).forward_superchunk(torch.from_numpy(images), torch.from_numpy(feat_valid))
    got = [o.numpy() for o in got]
    assert [g.shape for g in got] == [np.shape(w) for w in want]
    assert got[4].dtype == np.uint8
    assert_detections_close(got, want, HW[1])


def test_infer_sequence_carry_matches_plain_superchunks():
    """Six frames: a first chunk of 4 and a ragged carry chunk of 2 that
    reuses the overlap frames' backbone features. Against each window run
    through `forward_superchunk` whole (no carry)."""
    pipe = port_pipeline(seed=1)
    t = 6
    clip = np.random.default_rng(1).integers(0, 256, (t, *HW, 3), dtype=np.uint8)
    dets = pipe.infer_sequence(clip)
    assert len(dets) == t
    hl, hr = pipe.halo_left, pipe.halo_right
    for c in range(0, t, SC):
        widx = np.arange(c - hl, c + SC + hr)
        valid = (widx >= 0) & (widx < t)
        window = np.where(valid[:, None, None, None], clip[np.clip(widx, 0, t - 1)], 0).astype(np.uint8)
        want = [o.numpy() for o in pipe.forward_superchunk(torch.from_numpy(window), torch.from_numpy(valid))]
        for f in range(min(SC, t - c)):
            d = dets[c + f]
            assert d["union_mask"].shape == HW and d["union_mask"].dtype == bool
            got = (d["boxes"], d["scores"], d["labels"], d["valid"], np.packbits(d["union_mask"], axis=-1))
            assert_detections_close(got, [w[f] for w in want], HW[1])


@pytest.mark.parametrize("width", [8, 13, 200])
def test_packbits_matches_numpy(width):
    x = np.random.default_rng(width).uniform(size=(2, 3, width)) > 0.5
    np.testing.assert_array_equal(packbits(torch.from_numpy(x)).numpy(), np.packbits(x, axis=-1))


def test_entry_points_default_to_the_card(monkeypatch):
    """No CUDA: `build_pipeline()` raises instead of running on the CPU, and
    the RoIAlign wrapper takes only CUDA (kernel) or CPU (plain) tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(1, 1, HW, min_size=128, max_size=256)
    feats = [torch.zeros((1, 4, 4, 2), device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="no RoIAlign for device"):
        roi_align.multiscale_roi_align(feats, torch.zeros((1, 1, 4), device="meta"))


def _port_sources():
    files = sorted((ROOT / "slowfast_vos_tpu_torch").rglob("*.py"))
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    return files + [ROOT / "chip_smoke.py", *scripts, ROOT / "tests" / "torch_roi_cases.py", ROOT / "tests" / "test_torch_cuda.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """Static check (a site hook can fool a sys.modules check): no port file
    imports jax, flax or the JAX package, not even a module of it that does
    not import JAX itself."""
    banned = ("jax", "jaxlib", "flax", "optax", "slowfast_vos_tpu")
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "import_module", "__import__"
        ):
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.cuda
def test_card_matches_cpu(cuda_device):
    """On the card in f32 (TF32 off), through the kernel: the same outputs as
    the CPU run through the plain versions, within the slice's tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = np.random.default_rng(2).integers(0, 256, (SC + 2, *HW, 3), dtype=np.uint8)
    valid = np.ones(SC + 2, bool)
    outs = []
    for device in (cuda_device, "cpu"):
        pipe, model = build_pipeline(3, 3, HW, min_size=128, max_size=256, dtype=torch.float32, device=device, superchunk=SC)
        init_weights(model, 0)
        outs.append([o.cpu().numpy() for o in pipe.forward_superchunk(torch.from_numpy(images), torch.from_numpy(valid))])
    assert_detections_close(outs[0], outs[1], HW[1])
