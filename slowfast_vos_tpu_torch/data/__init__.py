"""Host-side data handling of the PyTorch port."""
from slowfast_vos_tpu_torch.data.synthetic import draw_sequence, sequence_arrays
from slowfast_vos_tpu_torch.data.windows import train_windows

__all__ = ["draw_sequence", "sequence_arrays", "train_windows"]
