"""Weights carried from the JAX package to the PyTorch port:
`state_dict_from_flax` is the exact inverse of the JAX package's
`convert_state_dict`, and its output loads into the port with
`load_state_dict(strict=True)` under torchvision's names."""
import jax
import numpy as np
import pytest

from torch_port_common import make_models
from slowfast_vos_tpu.convert.torchvision_weights import convert_state_dict
from slowfast_vos_tpu_torch.convert import state_dict_from_flax


@pytest.mark.parametrize("slow,fast", [(3, 3), (1, 7)])
def test_round_trip_through_convert_state_dict(slow, fast):
    """JAX tree -> port state dict -> JAX tree gives back every leaf exactly,
    BN statistics included, with no source key left unused. The target
    template is zeroed, so nothing passes by being already in place."""
    _, variables, _ = make_models(slow=slow, fast=fast, seed=slow + fast)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    template = jax.tree.map(np.zeros_like, variables)
    back, report = convert_state_dict(sd, template)
    assert report["unused_source_keys"] == []
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_state_dict_uses_torchvision_names_and_loads_strict():
    """`make_models` already loads with strict=True; here the names and
    torch layouts of a few anchors of the reference checkpoint."""
    _, variables, pmodel = make_models()
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(pmodel.state_dict())
    shapes = {
        "backbone.body.conv1.weight": (64, 3, 7, 7),
        "backbone.body.layer1.0.conv1.weight": (64, 64, 1, 1),
        "backbone.body.layer4.0.downsample.0.weight": (2048, 1024, 1, 1),
        "backbone.body.layer2.0.bn2.running_var": (128,),
        "backbone.fpn.inner_blocks.3.weight": (256, 2048, 1, 1),
        "rpn.head.cls_logits.weight": (3, 256, 1, 1),
        "roi_heads.box_head.fc6.weight": (1024, 256 * 7 * 7),
        "roi_heads.box_predictor.bbox_pred.weight": (8, 1024),
        "roi_heads.mask_predictor.conv5_mask.weight": (256, 256, 2, 2),
        "slow_fast.fast_conv1.weight": (32, 256, 1, 3, 3),
        "slow_fast.conv_f2s1.weight": (64, 32, 1, 1, 1),
        "slow_fast.bn_s3.running_mean": (224,),
    }
    for name, shape in shapes.items():
        assert tuple(sd[name].shape) == shape, name
    # fc6 takes torch's CHW flatten: column c*49 + h*7 + w is the JAX row
    # (h*7 + w)*256 + c.
    k = np.asarray(variables["params"]["box_head"]["fc6"]["kernel"])
    fc6 = sd["roi_heads.box_head.fc6.weight"].numpy()
    for c, h, w in ((0, 0, 0), (5, 2, 3), (255, 6, 6)):
        np.testing.assert_array_equal(fc6[:, c * 49 + h * 7 + w], k[(h * 7 + w) * 256 + c])
