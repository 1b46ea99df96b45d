"""K7 (`ops/attention.py`, `k7_rel_pos_attention_kernel`, global and window
blocks) against its least time, in %: `yardstick_vitdet.k7_bound_s` for the
frames the traced superchunks sent through the backbone over K7's device
time there by kernel name. The bound counts q, k, v, the output and both
position terms once, and 4 N^2 d operations a head plus the bias adds."""

from vosbench import yardstick_vitdet


def read(record):
    dev, traced = record.get("device"), record.get("traced")
    if not dev or not traced or not traced.get("backbone_frames"):
        return None
    seconds = sum(s for name, (s, _) in dev["by_name"].items() if "rel_pos_attention" in name)
    if not seconds:
        return None
    return 100.0 * yardstick_vitdet.k7_bound_s(traced["backbone_frames"], record["config"]) / seconds
