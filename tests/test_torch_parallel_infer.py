"""The port's device-parallel inference (`parallel/dp_infer.py`) over a
device list on the CPU (`[cpu, cpu]`: a list may repeat a device), at the
driver tests' tiny set-up (60x100 frames, min 64 / max 128, TINY_CFG,
SlowFast 1-3, superchunk 4, f32, noisy JAX weights).

* `infer_group` equals the serial `infer_sequence` exactly, for ragged
  lengths over several superchunks (the carry path) and a wrap-filled
  trailing group (the JAX `tests/test_dp_infer.py` claims);
* member pipelines with their own weights, each on its own thread
  (`mesh.on_members`, how lockstep OSVOS evaluates), each equal the serial
  run of their weights;
* against the JAX `DeviceParallelInference.infer_group` on a mesh of 2, at
  the slice's inference tolerance (`tests/test_torch_pipeline.py`: flags
  and labels exact, boxes 0.05 px, scores 1e-4, 1% of mask pixels);
* `extract_masks(devices=...)` writes a PNG tree byte-identical to the
  serial one; without a device list the default picks the serial loop."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_pipeline import assert_detections_close
from torch_port_common import TINY_HW, TINY_KW, noisy_variables
from slowfast_vos_tpu.models.pipeline import build_pipeline as jax_build_pipeline
from slowfast_vos_tpu.parallel.dp_infer import DeviceParallelInference as JaxDeviceParallelInference
from slowfast_vos_tpu_torch.convert import state_dict_from_flax
from slowfast_vos_tpu_torch.data import make_synthetic_davis
from slowfast_vos_tpu_torch.eval import glue
from slowfast_vos_tpu_torch.eval.glue import extract_masks
from slowfast_vos_tpu_torch.models.pipeline import build_pipeline, init_weights
from slowfast_vos_tpu_torch.parallel import DeviceParallelInference
from slowfast_vos_tpu_torch.parallel.dp_infer import replica
from slowfast_vos_tpu_torch.parallel.mesh import on_members, parallel_devices

SC = 4
CPUS = [torch.device("cpu")] * 2


def port_pipeline(state_dict=None, seed=0):
    pipe, model = build_pipeline(1, 3, dtype=torch.float32, device="cpu", superchunk=SC, **TINY_KW)
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return pipe


@pytest.fixture(scope="module")
def setup():
    jpipe, jmodel = jax_build_pipeline(1, 3, dtype=jnp.float32, backbone_batch=SC, chunk=SC, superchunk=SC, **TINY_KW)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((3, 64, 64, 3), jnp.float32))
    variables = noisy_variables(shapes, seed=11)
    rng = np.random.default_rng(7)
    # 9 frames = 3 superchunks (carry twice), 3 = one, 6 = two.
    seqs = [rng.integers(0, 256, (t, *TINY_HW, 3), dtype=np.uint8) for t in (9, 3, 6)]
    pipe = port_pipeline(state_dict_from_flax(variables))
    return {"jpipe": jpipe, "variables": variables, "pipe": pipe, "seqs": seqs}


def assert_same_dets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_infer_group_equals_serial_with_ragged_lengths_and_wrap_fill(setup):
    pipe, seqs = setup["pipe"], setup["seqs"]
    dp = DeviceParallelInference(pipe, CPUS)
    full = dp.infer_group(seqs[:2])  # 9 and 3 frames: the short one pads two chunks
    trailing = dp.infer_group(seqs[2:])  # one sequence on two members: wrap-filled
    assert len(full) == 2 and len(trailing) == 1
    for seq, dets in zip(seqs, full + trailing):
        assert_same_dets(dets, pipe.infer_sequence(seq))


def test_per_member_weights_equal_each_members_serial_run(setup):
    pipe, seqs = setup["pipe"], setup["seqs"]
    members = [replica(pipe, d) for d in CPUS]
    init_weights(members[1].model, 3)
    got = on_members(lambda k: members[k].infer_sequence(seqs[1]), CPUS)
    want0 = pipe.infer_sequence(seqs[1])
    other = replica(pipe, CPUS[0])
    init_weights(other.model, 3)
    want1 = other.infer_sequence(seqs[1])
    assert_same_dets(got[0], want0)
    assert_same_dets(got[1], want1)
    assert any((a["valid"] != b["valid"]).any() or (a["scores"] != b["scores"]).any() for a, b in zip(want0, want1))


def test_infer_group_matches_jax_on_a_mesh_of_2(setup):
    pipe, seqs = setup["pipe"], setup["seqs"]
    group = [seqs[2], seqs[1]]  # 6 and 3 frames: a first and a carry step
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    want = JaxDeviceParallelInference(setup["jpipe"], mesh).infer_group(setup["variables"], group)
    got = DeviceParallelInference(pipe, CPUS).infer_group(group)
    for g_seq, w_seq in zip(got, want):
        assert len(g_seq) == len(w_seq)
        for g, w in zip(g_seq, w_seq):
            pack = lambda d: (d["boxes"], d["scores"], d["labels"], d["valid"], np.packbits(d["union_mask"], axis=-1))  # noqa: E731
            assert_detections_close(pack(g), pack(w), TINY_HW[1])


def test_extract_masks_device_parallel_tree_is_byte_identical(setup, tmp_path, monkeypatch):
    pipe = setup["pipe"]
    built = []
    monkeypatch.setattr(glue, "DeviceParallelInference", lambda *a, **kw: built.append(a[1]) or DeviceParallelInference(*a, **kw))
    root = str(tmp_path / "davis")
    make_synthetic_davis(root, num_sequences=3, frames=5, hw=TINY_HW, num_objects=1, year="2016", subset="val", seed=11)
    serial, dp = tmp_path / "serial", tmp_path / "dp"
    assert parallel_devices(pipe, None) is None  # the CPU default: the serial loop
    assert parallel_devices(pipe, None, CPUS) == CPUS and parallel_devices(pipe, False, CPUS) is None
    extract_masks(pipe, root, str(serial), year="2016", devices=CPUS, device_parallel=False)
    assert built == []
    extract_masks(pipe, root, str(dp), year="2016", devices=CPUS)  # naming devices turns the list on
    assert built == [CPUS]
    seqs = sorted(os.listdir(serial))
    assert sorted(os.listdir(dp)) == seqs and len(seqs) == 3
    for seq in seqs:
        files = sorted(os.listdir(serial / seq))
        assert sorted(os.listdir(dp / seq)) == files and len(files) == 5
        for fn in files:
            assert (serial / seq / fn).read_bytes() == (dp / seq / fn).read_bytes(), (seq, fn)
