"""Training of the PyTorch port: the window train step and the drivers
(unsupervised training, OSVOS fine-tuning, the Mask R-CNN fine-tune)."""
from slowfast_vos_tpu_torch.train.train_step import Trainer, make_optimizer, trainable_parameters

__all__ = ["Trainer", "make_optimizer", "trainable_parameters"]
