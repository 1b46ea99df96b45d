"""The plain reference: SlowFast Mask R-CNN in plain PyTorch (`model.py`,
`ops.py`), the DAVIS decode and training windows (`data.py`), and the
inference and training that `correct` is held against (`run.py`). It
imports nothing of the program."""
