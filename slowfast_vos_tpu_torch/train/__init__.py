"""Training of the PyTorch port: the window train step."""
from slowfast_vos_tpu_torch.train.train_step import Trainer, make_optimizer, trainable_parameters

__all__ = ["Trainer", "make_optimizer", "trainable_parameters"]
