"""Host-side data handling of the PyTorch port: the DAVIS tree, the
synthetic generator, augmentation, the OSVOS and frame-level datasets, and
the training windows."""
from slowfast_vos_tpu_torch.data.davis import DavisIndex, SequenceInfo, load_sequence, save_palette_mask
from slowfast_vos_tpu_torch.data.frames import DavisFrameDataset, frame_batches
from slowfast_vos_tpu_torch.data.osvos_dataset import OsvosFirstFrameDataset
from slowfast_vos_tpu_torch.data.synthetic import draw_sequence, make_synthetic_davis, sequence_arrays
from slowfast_vos_tpu_torch.data.windows import train_windows

__all__ = [
    "DavisFrameDataset", "DavisIndex", "OsvosFirstFrameDataset", "SequenceInfo", "draw_sequence",
    "frame_batches", "load_sequence", "make_synthetic_davis", "save_palette_mask", "sequence_arrays",
    "train_windows",
]
