"""Host time in `next()` on the training feed (the benchmark's `next_batch`
span: waiting for the prefetch thread's decode and windowing) per step of
the window, in ms."""


def read(record):
    steps = record["counts"].get("steps")
    seconds = record["spans"].get("next_batch")
    if not steps or seconds is None:
        return None
    return 1e3 * seconds / steps
