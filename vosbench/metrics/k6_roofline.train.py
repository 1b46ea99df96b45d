"""K6 (`csrc/batch_norm.cu`, `bn_forward_kernel` and `bn_backward_kernel`)
against its least time, in %: `yardstick.k6_bound_s` (each way's bytes at
the HBM peak) for the steps of the traced part of the window over the two
kernels' device time there."""

from vosbench import yardstick


def read(record):
    dev, traced = record.get("device"), record.get("traced")
    if not dev or not traced or not traced.get("steps"):
        return None
    seconds = sum(s for name, (s, _) in dev["by_name"].items() if "bn_forward_kernel" in name or "bn_backward_kernel" in name)
    if not seconds:
        return None
    bound = sum(yardstick.k6_bound_s(record["config"], record["traffic"]["n_center"]))
    return 100.0 * bound * traced["steps"] / seconds
