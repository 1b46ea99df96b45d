"""K1 (`csrc/roi_align.cu`, `roi_align_kernel`, both pools) against its
least time, in %: `yardstick.k1_bound_s` for the superchunks of the traced
part of the window over K1's device time there by kernel name. The bound
counts the pooled outputs and the rois, not the pyramid bytes the rois
touch, which only the program could count: it understates K1's work."""

from vosbench import yardstick


def read(record):
    dev, traced = record.get("device"), record.get("traced")
    if not dev or not traced or not traced.get("superchunks"):
        return None
    seconds = sum(s for name, (s, _) in dev["by_name"].items() if "roi_align_kernel" in name)
    if not seconds:
        return None
    return 100.0 * yardstick.k1_bound_s(traced["superchunks"], record["config"]) / seconds
