"""Host utilities of the PyTorch port: background prefetch, metrics
logging, checkpoints; smoothed meters (`smoothing.py`) and a stage timer
with a `torch.profiler` trace (`profiling.py`)."""
from slowfast_vos_tpu_torch.utils.checkpoint import load_checkpoint, restore_checkpoint, save_checkpoint
from slowfast_vos_tpu_torch.utils.metrics import MetricsLogger
from slowfast_vos_tpu_torch.utils.prefetch import PrefetchIterator, prefetch

__all__ = ["MetricsLogger", "PrefetchIterator", "load_checkpoint", "prefetch", "restore_checkpoint", "save_checkpoint"]
