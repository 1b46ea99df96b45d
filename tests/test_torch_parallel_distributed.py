"""The port's process discovery and process utilities
(`parallel/distributed.py`), its device lists (`parallel/mesh.py`) and the
trainer's group split, against the JAX package's where it has the same
function, in one process (the multi-process runs are the other
`tests/test_torch_parallel_*.py` files)."""
import builtins
import sys
import threading

import pytest
import torch

from slowfast_vos_tpu.parallel import distributed as jax_distributed
from slowfast_vos_tpu_torch.ops import roi_align
from slowfast_vos_tpu_torch.parallel import distributed, make_mesh
from slowfast_vos_tpu_torch.parallel.mesh import infer_mesh, on_members
from slowfast_vos_tpu_torch.parallel.sharded import fold_in
from slowfast_vos_tpu_torch.train.trainer import wrap_filled_groups

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
               "SLURM_LOCALID", "SLURM_STEP_NODELIST", "SLURM_NODELIST", "JAX_COORDINATOR_ADDRESS",
               "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "JAX_AUTODETECT_DISTRIBUTED")


@pytest.fixture
def clean_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def as_jax(env: dict) -> dict:
    """The port's discovery in the JAX function's terms."""
    return {"coordinator_address": env["init_method"].removeprefix("tcp://"),
            "num_processes": env["world_size"], "process_id": env["rank"]}


@pytest.mark.parametrize("launch", [
    {"RANK": "3", "WORLD_SIZE": "8", "MASTER_ADDR": "10.0.0.5", "MASTER_PORT": "29511", "LOCAL_RANK": "3"},
    {"RANK": "1", "WORLD_SIZE": "2"},
    {"SLURM_PROCID": "5", "SLURM_NTASKS": "16", "SLURM_LOCALID": "1", "SLURM_STEP_NODELIST": "node[3-7,9],gpu2"},
    {"SLURM_PROCID": "0", "SLURM_NTASKS": "4", "SLURM_NODELIST": "gpu07", "MASTER_PORT": "1234"},
], ids=["torchrun", "torch-defaults", "slurm-step", "slurm-nodelist"])
def test_distributed_env_matches_jax(launch, clean_env):
    for k, v in launch.items():
        clean_env.setenv(k, v)
    got, want = distributed.distributed_env(), jax_distributed.distributed_env()
    assert as_jax(got) == want
    assert got["local_rank"] == int(launch.get("LOCAL_RANK", launch.get("SLURM_LOCALID", got["rank"])))


def test_single_process_environment(clean_env, capsys):
    assert distributed.distributed_env() is None and jax_distributed.distributed_env() is None
    assert distributed.init_distributed_mode() is False
    assert capsys.readouterr().out == "Not using distributed mode\n"
    assert distributed.get_rank() == 0 and distributed.get_world_size() == 1 and distributed.is_main_process()
    distributed.host_barrier("nothing to wait for")
    assert distributed.all_gather_host({"a": 1}) == [{"a": 1}]


@pytest.mark.parametrize("nodelist", ["node[3-7,9],gpu2", "node[03-05]", "gpu2", "a[1],b[2-3]", ""])
def test_first_slurm_host_matches_jax(nodelist):
    assert distributed._first_slurm_host(nodelist) == jax_distributed._first_slurm_host(nodelist)
    assert distributed._first_slurm_host("node[3-7,9],gpu2") == "node3"


def test_local_batch_slice_and_save_on_master(monkeypatch):
    monkeypatch.setattr(distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(distributed, "get_rank", lambda: 1)
    assert distributed.local_batch_slice(4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        distributed.local_batch_slice(3)
    calls = []
    assert distributed.save_on_master(calls.append, 1) is None and calls == []
    monkeypatch.setattr(distributed, "get_rank", lambda: 0)
    assert distributed.local_batch_slice(4) == slice(0, 2)
    distributed.save_on_master(calls.append, 1)
    assert calls == [1]


@pytest.mark.parametrize("is_master", [True, False])
def test_printing_is_gated_to_the_master(is_master, capsys):
    original = builtins.print
    try:
        distributed.setup_printing(is_master)
        print("everyone")
        print("forced", force=True)
    finally:
        builtins.print = original
    assert capsys.readouterr().out == ("everyone\nforced\n" if is_master else "forced\n")


def test_device_lists():
    if not torch.cuda.is_available():
        assert infer_mesh() is None
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh()


def test_on_members_runs_each_member_on_its_own_thread():
    cpus = [torch.device("cpu")] * 3
    barrier = threading.Barrier(3, timeout=30)  # passes only if all three calls run at once

    def member(k):
        barrier.wait()
        return k, threading.get_ident()

    got = on_members(member, cpus)
    assert [k for k, _ in got] == [0, 1, 2] and len({ident for _, ident in got}) == 3
    assert on_members(lambda k: threading.get_ident(), cpus[:1]) == [threading.get_ident()]

    def fail(k):
        if k == 1:
            raise RuntimeError("member 1 failed")
        return k

    with pytest.raises(RuntimeError, match="member 1 failed"):
        on_members(fail, cpus)


def test_launch_counts_survive_concurrent_members():
    """Member threads count kernel launches into one Counter: no update may
    be lost (more threads than cores, a short switch interval)."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        on_members(lambda k: [roi_align._count_launch("stress") for _ in range(2000)], [torch.device("cpu")] * 16)
    finally:
        sys.setswitchinterval(switch)
    assert roi_align.launches.pop("stress") == 16 * 2000


def test_fold_in_gives_each_rank_its_own_seed():
    seeds = [fold_in(63, r) for r in range(4)]
    assert len(set(seeds)) == 4 and seeds == [fold_in(63, r) for r in range(4)]
    assert all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("n_windows, size, want", [
    (3, 2, [(["w0", "w1"], 2), (["w2", "w0"], 1)]),
    (4, 2, [(["w0", "w1"], 2), (["w2", "w3"], 2)]),
    (5, 4, [(["w0", "w1", "w2", "w3"], 4), (["w4", "w0", "w1", "w2"], 1)]),
    (1, 3, [(["w0", "w0", "w0"], 1)]),
    (2, 1, [(["w0"], 1), (["w1"], 1)]),
])
def test_wrap_filled_groups(n_windows, size, want):
    """The trailing group is filled from the epoch's first windows
    (DistributedSampler's padding; JAX `trainer.py:148-176`)."""
    assert list(wrap_filled_groups((f"w{i}" for i in range(n_windows)), size)) == want
