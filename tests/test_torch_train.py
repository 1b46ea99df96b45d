"""The PyTorch port's training step as a whole, against the JAX package's
`Trainer._loss_fn` at `tests/test_train_step.py`'s TINY_CFG shape (60x100
frames, min 64, max 128, SlowFast 3-3, one window of 2 centre frames), f32
on the CPU, same weights (JAX variables with every leaf redrawn, carried
over by `state_dict_from_flax`) and the same sampler draws (made with
`jax.random` from the JAX step's key, in its split order).

Tolerances: each loss to rel 1e-4; every trainable gradient to max-abs
1e-3 x the tensor's max |grad|; the SlowFast running statistics to rel
1e-4; parameters after one SGD step to atol 1e-6. Sampling is index-exact
given the draws, so any misselection shows as a loss far outside these.

The gradient is piecewise smooth: where a ReLU's input lies within the
two libraries' f32 drift of zero, the two sides take different branches
and a few gradient entries differ by up to a few percent while the losses
agree to 1e-6. Measured over seeds 0-19 of this set-up, 17 flip at least
one ReLU (in SlowFast, the box head or the mask head). So both steps get
the same frozen-backbone features (the JAX backbone's: frozen, they carry
no gradient, and the port's backbone is held to JAX at 1e-4 in
`test_torch_models.py`), which removes the 50 layers' drift, and the
weights and batch are seed 5's, where no ReLU flips (largest gradient
error 6.9e-5 of the tensor's max). A fault in the port's gradient moves it
on every seed.

The JAX side is built and compiled once for the module (about 30 s)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_common import jax_draws, noisy_variables, rel_err
from slowfast_vos_tpu.data.davis import decode_frame_annotation, save_palette_mask
from slowfast_vos_tpu.data.synthetic import _draw_sequence as jax_draw_sequence
from slowfast_vos_tpu.data.windows import train_windows as jax_train_windows
from slowfast_vos_tpu.models.config import DetectionConfig
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu.train import Trainer as JaxTrainer
from slowfast_vos_tpu.train.train_step import make_optimizer as jax_make_optimizer
from slowfast_vos_tpu.train.train_step import split_params, trainable_labels
from slowfast_vos_tpu_torch.convert import state_dict_from_flax
from slowfast_vos_tpu_torch.data import draw_sequence, sequence_arrays, train_windows
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.train import Trainer, make_optimizer

# tests/test_train_step.py's TINY_CFG (copied: that module builds a JAX
# pipeline and initializes it when imported by a fixture).
TINY_CFG = DetectionConfig(
    rpn_pre_nms_top_n_train=64,
    rpn_post_nms_top_n_train=32,
    rpn_pre_nms_top_n_test=64,
    rpn_post_nms_top_n_test=32,
    box_batch_size_per_image=32,
    mask_train_rois=8,
    detections_per_img=5,
    max_gt=3,
)
HW = (60, 100)
PIPE_KW = dict(original_hw=HW, min_size=64, max_size=128, cfg=TINY_CFG)
SEED = 5
LOSS_RTOL = 1e-4
GRAD_SHARE = 1e-3
STATS_RTOL = 1e-4


def make_batch(rng, n_center=2, fast=3, max_gt=3):
    """tests/test_train_step.py's batch: 2 box-shaped objects per centre frame."""
    w = n_center + fast - 1
    h0, w0 = HW
    images = rng.uniform(0, 1, (w, h0, w0, 3)).astype(np.float32)
    boxes = np.zeros((n_center, max_gt, 4), np.float32)
    masks = np.zeros((n_center, max_gt, h0, w0), np.uint8)
    gt_valid = np.zeros((n_center, max_gt), bool)
    for f in range(n_center):
        for g in range(2):
            x1, y1 = rng.uniform(5, 40, 2)
            bw, bh = rng.uniform(15, 30, 2)
            x2, y2 = min(x1 + bw, w0 - 1), min(y1 + bh, h0 - 1)
            boxes[f, g] = [x1, y1, x2, y2]
            masks[f, g, int(y1) : int(y2), int(x1) : int(x2)] = 1
            gt_valid[f, g] = True
    return {
        "images": images,
        "feat_valid": np.ones((w,), bool),
        "frame_valid": np.ones((n_center,), bool),
        "boxes": boxes,
        "labels": np.ones((n_center, max_gt), np.int32),
        "gt_valid": gt_valid,
        "masks": masks,
    }


class SharedBackbone:
    """The JAX model, with `backbone_feats` answered from `feats`."""

    def __init__(self, model, feats):
        self.model, self.feats = model, feats

    def apply(self, variables, *args, method=None, **kw):
        if method == "backbone_feats":
            return self.feats
        return self.model.apply(variables, *args, method=method, **kw)


def port_trainer(variables, **kw):
    pipe, model = build_pipeline(3, 3, dtype=torch.float32, device="cpu", superchunk=4, **PIPE_KW)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pipe, Trainer(pipe, **kw)


def grads_as_port(jax_grads, variables):
    """The JAX gradient tree in the port's names: a copy of the variables
    with the trainable subtrees replaced by their gradients, through
    `state_dict_from_flax` (a linear map: transposes and permutations)."""
    params = {**jax.tree.map(np.zeros_like, variables["params"]), **jax.device_get(jax_grads)}
    return state_dict_from_flax({"params": params, "batch_stats": variables["batch_stats"]})


@pytest.fixture(scope="module")
def setup():
    """One JAX value_and_grad of the window loss, and the inputs for the port."""
    jpipe, jmodel = jax_build_pipeline(3, 3, dtype=jnp.float32, backbone_batch=4, chunk=4, **PIPE_KW)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=SEED)
    batch = make_batch(np.random.default_rng(SEED))
    key = jax.random.PRNGKey(SEED + 7)
    feats = jax.jit(lambda v, x: jmodel.apply(v, jpipe.transform(x), method="backbone_feats"))(
        variables, jnp.asarray(batch["images"])
    )
    jpipe.model = SharedBackbone(jmodel, feats)
    jtr = JaxTrainer(jpipe)
    trainable, frozen = split_params(variables["params"], jtr.trainable_keys)
    fn = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))
    (_, (metrics, new_bn)), grads = fn(
        trainable, frozen, variables["batch_stats"], key, jax.tree.map(jnp.asarray, batch)
    )
    tx = jax_make_optimizer()
    updates, _ = tx.update(grads, tx.init(trainable), trainable)
    stepped = optax.apply_updates(trainable, updates)
    n_anchors = sum(a.shape[0] for a in jpipe.anchors)
    draws = jax_draws(key, 2, n_anchors, TINY_CFG.rpn_post_nms_top_n_train + TINY_CFG.max_gt)
    return {
        "variables": variables, "batch": batch, "draws": draws,
        "feats": [torch.from_numpy(np.array(f)) for f in feats],
        "metrics": jax.device_get(metrics), "grads": grads_as_port(grads, variables),
        "stats": state_dict_from_flax({"params": variables["params"], "batch_stats": jax.device_get(new_bn)}),
        "stepped": state_dict_from_flax({"params": {**variables["params"], **jax.device_get(stepped)},
                                         "batch_stats": variables["batch_stats"]}),
    }


@pytest.fixture(scope="module")
def port_step(setup):
    """The port's loss and backward on the same batch, weights and draws,
    then one SGD step."""
    pipe, tr = port_trainer(setup["variables"])
    tr.model.backbone_feats = lambda images: setup["feats"]
    tr.model.train()
    total, metrics = tr.loss(setup["batch"], setup["draws"])
    total.backward()
    tr.model.eval()
    grads = {name: p.grad.clone() for name, p in tr.params.items()}
    stats = {k: v.clone() for k, v in tr.model.state_dict().items() if "running" in k}
    tr.optimizer.step()
    return {"trainer": tr, "metrics": metrics, "grads": grads, "stats": stats}


def test_losses_match_jax(setup, port_step):
    for name, want in setup["metrics"].items():
        got = float(port_step["metrics"][name])
        assert abs(got - float(want)) <= LOSS_RTOL * abs(float(want)), (name, got, float(want))
    assert float(setup["metrics"]["loss_mask"]) > 0 and float(setup["metrics"]["loss_box_reg"]) > 0


def _feeds_train_bn(name):
    """A SlowFast conv bias: a train-mode BatchNorm follows it and subtracts
    the batch mean, so its gradient is zero but for f32 rounding."""
    return name.startswith("slow_fast.") and "conv" in name and name.endswith(".bias")


def test_gradients_match_jax(setup, port_step):
    grads = port_step["grads"]
    trainable = [k for k in setup["grads"] if k.startswith(("slow_fast.", "roi_heads.")) and "running" not in k and "num_batches" not in k]
    assert sorted(grads) == sorted(trainable)
    sf_scale = max(float(g.abs().max()) for k, g in grads.items() if k.startswith("slow_fast."))
    for name, got in grads.items():
        want = setup["grads"][name].numpy()
        if _feeds_train_bn(name):
            assert max(np.abs(want).max(), float(got.abs().max())) <= 1e-5 * sf_scale, name
            continue
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got.numpy() - want).max() <= GRAD_SHARE * scale, name


def test_slowfast_running_stats_match_jax(setup, port_step):
    for name, got in port_step["stats"].items():
        if name.startswith("slow_fast."):
            assert rel_err(got, setup["stats"][name]) < STATS_RTOL, name
        else:  # FrozenBatchNorm statistics are buffers: untouched
            assert torch.equal(got, setup["stats"][name]), name


def test_sgd_step_matches_optax(setup, port_step):
    """torch SGD (lr 1e-3, momentum 0.9, weight decay 1e-4) after one step
    against optax's add_decayed_weights + sgd on the JAX gradients."""
    for name, p in port_step["trainer"].params.items():
        np.testing.assert_allclose(p.detach().numpy(), setup["stepped"][name].numpy(), atol=1e-6, err_msg=name)


def test_optimizer_equals_optax_chain():
    """On the same gradients over three steps, torch SGD and the JAX
    package's optax chain give the same parameters: the decay joins the
    gradient before the momentum trace, and the first trace is the
    gradient itself in both."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    tx = jax_make_optimizer()
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp])
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


def test_frozen_parts_stay_bit_identical(setup):
    """Three port steps: the backbone, the RPN and every FrozenBatchNorm
    buffer are bit-identical; the SlowFast and head weights and the
    SlowFast running statistics moved."""
    pipe, tr = port_trainer(setup["variables"])
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for _ in range(3):
        metrics = tr.step(setup["batch"])
        assert all(torch.isfinite(v) for v in metrics.values())
    assert not tr.model.training
    after = tr.model.state_dict()
    for k, v in after.items():
        if k.startswith(("backbone.", "rpn.")):
            assert torch.equal(v, before[k]), k
        elif "num_batches_tracked" not in k:
            assert not torch.equal(v, before[k]), k


def test_invalid_frames_give_zero_trainable_loss(setup):
    pipe, tr = port_trainer(setup["variables"])
    batch = dict(setup["batch"], frame_valid=np.zeros(2, bool))
    metrics = tr.step(batch)
    for name in ("loss_classifier", "loss_box_reg", "loss_mask"):
        assert float(metrics[name]) == 0.0


def test_accumulate_steps_once_per_k_calls(setup):
    """accumulate=2 (optax MultiSteps): the first call leaves every weight
    as it was, the second steps SGD once with the mean of both calls'
    gradients and then zeroes them."""
    pipe, tr = port_trainer(setup["variables"], accumulate=2)
    w0 = {k: p.detach().clone() for k, p in tr.params.items()}
    draws = [tr.make_draws(3) for _ in range(2)]
    mean = {k: torch.zeros_like(p) for k, p in tr.params.items()}
    for i, d in enumerate(draws):
        tr.model.train()
        total, _ = tr.loss(setup["batch"], d)
        tr.model.eval()
        for k, g in zip(tr.params, torch.autograd.grad(total, list(tr.params.values()))):
            mean[k] += g / 2
        tr.step(setup["batch"], d)
        if i == 0:
            assert all(torch.equal(p, w0[k]) for k, p in tr.params.items())
            assert all(p.grad is not None for p in tr.params.values())
    assert all(p.grad is not None and not p.grad.any() for p in tr.params.values())  # zeroed in place
    ref = [torch.nn.Parameter(w0[k].clone()) for k in tr.params]
    for p, k in zip(ref, tr.params):
        p.grad = mean[k]
    make_optimizer(ref).step()
    for p, (k, q) in zip(ref, tr.params.items()):
        assert not torch.equal(q, w0[k]), k
        torch.testing.assert_close(q.detach(), p.detach(), rtol=0, atol=1e-6, msg=k)


def test_infer_after_steps_equals_fresh_pipeline(setup):
    """After steps the pipeline infers on the SlowFast running statistics:
    `infer_sequence` on the trained pipeline equals a fresh pipeline that
    loaded `eval_state_dict()`."""
    pipe, tr = port_trainer(setup["variables"])
    tr.step(setup["batch"])
    clip = (setup["batch"]["images"] * 255).astype(np.uint8)
    got = pipe.infer_sequence(clip)
    fresh, model = build_pipeline(3, 3, dtype=torch.float32, device="cpu", superchunk=4, **PIPE_KW)
    model.load_state_dict(tr.eval_state_dict(), strict=True)
    want = fresh.infer_sequence(clip)
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _jax_label_tree(variables, trainable_keys, tbl):
    """1.0 where the JAX trainer's optimizer updates a leaf, else 0.0, over
    the whole variable tree (`Trainer.__init__`: `trainable_labels` over
    the trainable subtrees, `trainable_backbone_layers` only with a
    trainable backbone)."""
    trainable, frozen = split_params(variables["params"], trainable_keys)
    labels = trainable_labels(trainable, tbl)
    ones = jax.tree.map(lambda x, lab: np.full(np.shape(x), float(lab == "train"), np.float32), trainable, labels)
    zeros = jax.tree.map(lambda x: np.zeros(np.shape(x), np.float32), frozen)
    return {"params": {**ones, **zeros}, "batch_stats": jax.tree.map(lambda x: np.zeros(np.shape(x), np.float32), variables["batch_stats"])}


@pytest.mark.parametrize("kw", [
    {},
    {"train_backbone": True},  # OSVOS 'none'
    {"train_backbone": True, "train_slow_fast": False},  # OSVOS 'SF'
    {"train_backbone": True, "trainable_backbone_layers": 3},  # pretrain
    {"train_backbone": True, "trainable_backbone_layers": 5},
], ids=["default", "none", "SF", "tbl3", "tbl5"])
def test_trainable_partition_matches_jax_labels(setup, kw):
    """The parameters that get `requires_grad` and go to the optimizer are
    exactly those the JAX trainer labels 'train', mapped through
    `state_dict_from_flax`; FrozenBatchNorm leaves ('freeze' in JAX) are
    buffers in the port."""
    variables = setup["variables"]
    jpipe, _ = jax_build_pipeline(3, 3, dtype=jnp.float32, **PIPE_KW)
    jtr = JaxTrainer(jpipe, **kw)
    tbl = kw.get("trainable_backbone_layers") if jtr.backbone_trainable else None
    want = state_dict_from_flax(_jax_label_tree(variables, jtr.trainable_keys, tbl))
    _, tr = port_trainer(variables, **kw)
    params = dict(tr.model.named_parameters())
    opt_params = {id(p) for p in tr.optimizer.param_groups[0]["params"]}
    for name, v in want.items():
        if name in params:
            train = bool(v.min() == 1.0)
            assert train == (name in tr.params) == params[name].requires_grad == (id(params[name]) in opt_params), name
            assert bool(v.max() == v.min()), name
        else:
            assert float(v.abs().max()) == 0.0, name  # a buffer: never updated in JAX either


def test_train_windows_match_jax():
    rng = np.random.default_rng(1)
    t, g = 5, 2
    seq = {
        "images": rng.integers(0, 256, (t, 8, 10, 3), dtype=np.uint8),
        "frame_valid": rng.uniform(size=t) > 0.3,
        "boxes": rng.uniform(0, 8, (t, g, 4)).astype(np.float32),
        "gt_valid": rng.uniform(size=(t, g)) > 0.3,
        "masks": (rng.uniform(size=(t, g, 8, 10)) > 0.5).astype(np.uint8),
    }
    for fast in (1, 3, 7):
        got, want = list(train_windows(seq, fast)), list(jax_train_windows(seq, fast))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthetic_sequence_matches_jax(tmp_path):
    """The moving-blobs generator and the box derivation from mask extents
    against the JAX package's generator and its DAVIS annotation decode."""
    images, ids = draw_sequence(np.random.default_rng(4), 3, 30, 50, 2)
    jimages, jids = jax_draw_sequence(np.random.default_rng(4), 3, 30, 50, 2)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_array_equal(ids, jids)
    seq = sequence_arrays(images, ids, max_gt=3)
    for f in range(3):
        path = str(tmp_path / f"{f}.png")
        save_palette_mask(ids[f], path)
        for got, want in zip((seq["boxes"][f], seq["masks"][f], seq["gt_valid"][f]), decode_frame_annotation(path, 3)):
            np.testing.assert_array_equal(got, want)
    assert seq["gt_valid"].sum() == 6 and seq["frame_valid"].all()
