"""K7's device time (`k7_rel_pos_attention_kernel`, by kernel name) in the
traced part of the window per real frame completed there, in ms."""


def read(record):
    dev, traced = record.get("device"), record.get("traced")
    if not dev or not traced or not traced.get("frames"):
        return None
    seconds = sum(s for name, (s, _) in dev["by_name"].items() if "rel_pos_attention" in name)
    return 1e3 * seconds / traced["frames"] if seconds else None
