"""Lockstep OSVOS of the PyTorch port (`parallel/lockstep.py`,
`train/osvos.py::train_osvos_sequences_lockstep`) with two members on
`[cpu, cpu]`, at the driver tests' tiny set-up (60x100 frames, SlowFast
1-3, TINY_CFG, superchunk 4, f32, noisy JAX weights), a 2016 val tree of 2
sequences x 4 frames, freeze BB_SF, 1 epoch of 2 items (one update):

* each member equals its serial `train_osvos_sequence` exactly (a member
  is the serial fine-tune on its own replica; no collective crosses
  members), but for each evaluation's wall time;
* a member's results do not depend on the group: a wrap-filled group of
  one reproduces the full group's member 0 exactly;
* against the JAX lockstep driver on a mesh of 2 at f32 within rel 1e-5
  (`tests/test_osvos_lockstep.py`'s f32 bound);
* the caller's `pipe.model` keeps its weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_port_common import TINY_HW, TINY_KW, noisy_variables
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu.train.osvos import ExperimentConfig as JaxExperimentConfig
from slowfast_vos_tpu.train.osvos import train_osvos_sequences_lockstep as jax_lockstep
from slowfast_vos_tpu_torch.convert import state_dict_from_flax
from slowfast_vos_tpu_torch.data import make_synthetic_davis
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline
from slowfast_vos_tpu_torch.train.osvos import ExperimentConfig, train_osvos_sequence, train_osvos_sequences_lockstep

SC = 4
ITEMS = 2
CPUS = [torch.device("cpu")] * 2
EXP = dict(freeze="BB_SF", lr=1e-3, scale=0.25, epochs=1)


def strip_time(results):
    return {e: {k: v for k, v in r.items() if k != "eval_time"} for e, r in results.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("d16"))
    names = make_synthetic_davis(root, num_sequences=2, frames=4, hw=TINY_HW, num_objects=1, year="2016",
                                 subset="val", seed=11)
    jpipe, jmodel = jax_build_pipeline(1, 3, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC, **TINY_KW)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=2)
    pipe, model = build_pipeline(1, 3, dtype=torch.float32, device="cpu", superchunk=SC, **TINY_KW)
    state_dict = state_dict_from_flax(variables)
    model.load_state_dict(state_dict, strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lock = train_osvos_sequences_lockstep(
        pipe, state_dict, davis_root=root, sequence_names=names, results_root=str(tmp_path_factory.mktemp("lock")),
        cfg=ExperimentConfig(**EXP), items_per_epoch=ITEMS, devices=CPUS,
    )
    return {"root": root, "names": names, "jpipe": jpipe, "variables": variables, "pipe": pipe,
            "state_dict": state_dict, "before": before, "lock": lock}


def test_lockstep_leaves_the_callers_model(setup):
    after = setup["pipe"].model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in setup["before"].items())


def test_each_member_equals_its_serial_fine_tune(setup, tmp_path):
    lock = setup["lock"]
    assert list(lock) == setup["names"]
    for name in setup["names"]:
        serial = train_osvos_sequence(
            setup["pipe"], setup["state_dict"], davis_root=setup["root"], sequence_name=name,
            results_root=str(tmp_path / name), cfg=ExperimentConfig(**EXP), items_per_epoch=ITEMS,
        )
        assert sorted(lock[name]) == [-1, 0]
        assert strip_time(lock[name]) == strip_time(serial), name
    setup["pipe"].model.load_state_dict(setup["state_dict"])


def test_member_results_do_not_depend_on_the_group(setup, tmp_path):
    name = setup["names"][0]
    single = train_osvos_sequences_lockstep(
        setup["pipe"], setup["state_dict"], davis_root=setup["root"], sequence_names=[name],
        results_root=str(tmp_path), cfg=ExperimentConfig(**EXP), items_per_epoch=ITEMS, devices=CPUS,
    )
    assert list(single) == [name]
    assert strip_time(single[name]) == strip_time(setup["lock"][name])


def test_lockstep_matches_jax_lockstep_at_f32(setup, tmp_path):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    want = jax_lockstep(
        setup["jpipe"], setup["variables"], davis_root=setup["root"], sequence_names=setup["names"],
        results_root=str(tmp_path), cfg=JaxExperimentConfig(**EXP), items_per_epoch=ITEMS, mesh=mesh,
    )
    for name in setup["names"]:
        got, w = strip_time(setup["lock"][name]), strip_time(want[name])
        assert sorted(got) == sorted(w) == [-1, 0]
        for epoch in w:
            for metric, value in w[epoch].items():
                np.testing.assert_allclose(got[epoch][metric], value, rtol=1e-5, atol=1e-7, err_msg=f"{name} {epoch} {metric}")
