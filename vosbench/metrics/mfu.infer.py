"""The model FLOPs of the window's completed work (`yardstick.py`: real
frames for inference, whole steps for training) over the window's seconds
times the H100 SXM's dense bf16 peak, in %."""

from vosbench import yardstick


def read(record):
    seconds = record["counts"].get("window_s")
    if not record.get("flops") or not seconds:
        return None
    return 100.0 * record["flops"] / (seconds * yardstick.PEAK_BF16_FLOPS)
