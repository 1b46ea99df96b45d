"""The parallel layer of the PyTorch port (`slowfast_vos_tpu/parallel/`):
process-group discovery and host collectives (`distributed.py`), device
lists (`mesh.py`), the data-parallel train step (`sharded.py`),
device-parallel inference (`dp_infer.py`) and lockstep fine-tunes
(`lockstep.py`)."""
from slowfast_vos_tpu_torch.parallel.distributed import (
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    local_batch_slice,
    save_on_master,
)
from slowfast_vos_tpu_torch.parallel.dp_infer import DeviceParallelInference
from slowfast_vos_tpu_torch.parallel.mesh import infer_mesh, make_mesh
from slowfast_vos_tpu_torch.parallel.sharded import make_sharded_train_step, replicate_state

__all__ = [
    "DeviceParallelInference",
    "get_rank",
    "get_world_size",
    "infer_mesh",
    "init_distributed_mode",
    "is_main_process",
    "local_batch_slice",
    "make_mesh",
    "make_sharded_train_step",
    "replicate_state",
    "save_on_master",
]
